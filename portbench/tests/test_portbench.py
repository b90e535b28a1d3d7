"""CPU tests of the benchmark harness (`python -m pytest portbench/tests`).

The program runs with device="cpu" (the kernels' plain versions) at
sizes a test can hold; the chip test at the end runs a cell on the card
and skips without one.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import cell, check, port, stats, traffic  # noqa: E402
from portbench.lib.dataset import Dataset  # noqa: E402

SMALL = {"testdb": {"fact_rows": 40_000, "dim_rows": 4000},
         "ssb": {"lineorder_rows": 60_000, "customer_rows": 3000,
                 "supplier_rows": 200, "part_rows": 20_000}}
# every mix file, the ones no cell runs yet included
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                      "traffic")))
SCHEMA_CONFIG = {"testdb": "testdb_20m", "ssb": "ssb_sf20"}
# cells kept for later, with no entry in BENCHMARK.json yet: their
# configuration and mix files stay under portbench/
KEPT = {"testdb_20m.agg_scan": ("testdb_20m", "agg_scan"),
        "testdb_20m.star_join": ("testdb_20m", "star_join")}
_load_cell = cell.load_cell


def _json(*parts: str) -> dict:
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


def small_config(schema: str) -> dict:
    cfg = _json("configs", SCHEMA_CONFIG[schema] + ".json")
    return {**cfg, **SMALL[schema]}


def load_kept_cell(root: str, workload: str):
    """`cell.load_cell`, which also finds the cells of KEPT."""
    if workload not in KEPT:
        return _load_cell(root, workload)
    config, traffic_name = KEPT[workload]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = {"name": workload, "config": config, "traffic": traffic_name,
          "chips": 1, "why": "kept for later"}
    return (bench, wl, _json("configs", config + ".json"),
            _json("traffic", traffic_name + ".json"))


def generate(cfg: dict, seed: int) -> Dataset:
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    return gen.generate(cfg, seed)


def planes(d: Dataset) -> list:
    return [(t, c, col.type, col.data.tobytes(), tuple(col.dictionary or ()))
            for t, cols in sorted(d.tables.items())
            for c, col in sorted(cols.items())]


@pytest.mark.parametrize("schema", sorted(SMALL))
def test_generator_repeats_by_seed(schema):
    cfg = small_config(schema)
    big = 2**31 + 12345
    a, b = generate(cfg, big), generate(cfg, big)
    assert planes(a) == planes(b)
    assert planes(generate(cfg, big + 1)) != planes(a)
    assert planes(generate(cfg, -3)) == planes(generate(cfg, -3))


def test_md5_text_matches_hashlib():
    from portbench.lib.md5text import md5_text_col
    v = np.concatenate([[0, 9, 10, 99, 100, 10**8 - 1, 10**14 + 7],
                        np.arange(1, 3000) * 7919])
    c = md5_text_col(v)
    want = [hashlib.md5(str(x).encode()).hexdigest() for x in v.tolist()]
    assert [c.dictionary[k] for k in c.data] == want
    assert c.dictionary == sorted(want)


def test_testdb_generator_keeps_the_text_payloads():
    cfg = small_config("testdb")
    d = generate(cfg, 3)
    z = d.col("t0", "z")
    assert len(z.dictionary) == cfg["fact_rows"]
    for i in (0, 1, cfg["fact_rows"] - 1):
        assert z.dictionary[z.data[i]] == hashlib.md5(
            str(i + 1).encode()).hexdigest()
    for i, c in enumerate("abcd", start=1):
        t = d.col(f"t{i}", f"{c}text")
        assert t.dictionary[t.data[0]] == hashlib.md5(
            str(1 + i).encode()).hexdigest()
        assert len(t.data) == cfg["dim_rows"]


def test_ssb_generator_shapes():
    cfg = small_config("ssb")
    d = generate(cfg, 9)
    lo = d.tables["lineorder"]
    assert len(lo) == 17 and d.nrows("lineorder") == cfg["lineorder_rows"]
    assert len(d.tables["date"]) == 17 and d.nrows("date") == 2556
    assert len(d.col("part", "p_brand1").dictionary) == 1000
    assert len(d.col("supplier", "s_region").dictionary) == 5
    # every fact key finds its dimension row
    for fk, dim, pk in (("lo_custkey", "customer", "c_custkey"),
                        ("lo_partkey", "part", "p_partkey"),
                        ("lo_suppkey", "supplier", "s_suppkey"),
                        ("lo_orderdate", "date", "d_datekey")):
        assert np.isin(lo[fk].data, d.col(dim, pk).data).all()
    ext, disc = lo["lo_extendedprice"].data, lo["lo_discount"].data
    assert (lo["lo_revenue"].data
            == ext.astype(np.int64) * (100 - disc) // 100).all()


def small_mix(name: str):
    mix = _json("traffic", name + ".json")
    return small_config(mix["schema"]), mix


@pytest.mark.parametrize("name", MIXES)
def test_reference_equals_port_every_template(name):
    cfg, mix = small_mix(name)
    data = generate(cfg, 4242)
    port.set_device("cpu")
    db = port.load(data)
    stream = traffic.queries(mix, 4242)
    qs = [next(stream) for _ in range(2 * len(mix["templates"]))]
    want = cell.reference_answers(qs, mix, data)
    for q, (rows, exact, ordered) in zip(qs, want):
        got = port.execute(q.sql, db)
        bad, gap = check.compare(got, rows, exact, ordered)
        assert not bad, (q.sql, got[:3], rows[:3])
        assert gap <= mix["limits"].get("float_rel_gap", 0.0), q.sql
        assert rows, q.sql


@pytest.mark.parametrize("name", MIXES)
def test_control_is_not_correct(name):
    from portbench import control
    cfg, mix = small_mix(name)
    data = generate(cfg, 77)
    r = control.readings(mix, data, 77, 2 * len(mix["templates"]))
    assert any(c["value"] > c["limit"] for c in r.values()), r


def test_percentiles_and_bytes():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50.5
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    cfg = small_config("testdb")
    d = generate(cfg, 1)
    n = cfg["fact_rows"]
    # cat (text code) 4 B, x and y 8 B each; 26 result rows of 4 values
    assert stats.logical_bytes(d, {"t0": ["cat", "x", "y"]}, 26, 4) == \
        n * 20 + 26 * 4 * 8


def _record(ms, covered=10, err=None):
    q = traffic.Query(0, "t", "", {})
    return cell.Record(q, 0.0, ms / 1e3, [] if err is None else None, err,
                       covered=covered)


def test_end_to_end_readers():
    recs = [_record(float(i)) for i in range(1, 201)] + \
        [_record(5000.0, err="boom")]
    ctx = cell.Context(recs, window_s=2.0, setup_s=7.5,
                       cold_query_ms=12.0)
    read = lambda n: importlib.import_module(  # noqa: E731
        f"portbench.metrics.{n}").read(ctx)
    assert read("query_ms_p50") == pytest.approx(100.5)
    assert read("query_ms_p95") == pytest.approx(190.05)
    assert read("rows_per_s") == pytest.approx(200 * 10 / 2.0)
    assert read("setup_s") == 7.5 and read("cold_query_ms") == 12.0
    assert read("device_idle_share") is None
    assert read("device_roofline") is None


def test_trace_busy_union():
    from portbench.lib.trace import _covered, _union
    s, e = _union([(0, 1), (0.5, 2), (3, 4), (3.5, 3.7), (5, 6)])
    assert list(s) == [0, 3, 5] and list(e) == [2, 4, 6]
    cum = np.concatenate([[0.0], np.cumsum(e - s)])
    assert _covered(s, e, cum, 1, 3.5) == pytest.approx(1.5)
    assert _covered(s, e, cum, -1, 10) == pytest.approx(4.0)
    assert _covered(s, e, cum, 2.5, 2.9) == 0.0


def _run_tiny_rc(root: str, workload: str, seconds: float = 1.0,
                 trace: bool = False):
    """(exit code, result, stderr) of a run of the cell at the small size
    on the CPU, in a fresh process."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from portbench.lib.cell import run_cell\n"
        "from portbench.lib.cell import load_cell\n"
        "small = %r\n"
        "cfg = load_cell(%r, %r)[2]\n"
        "rc, res = run_cell(%r, %r, 11, %r, %r, device='cpu',\n"
        "                   config_override=small[cfg['schema']])\n"
        "if res is not None:\n"
        "    res['banned'] = sorted({m.split('.')[0] for m in sys.modules}\n"
        "        & {'jax', 'jaxlib', 'flax', 'pg_strom_tpu'})\n"
        "print(json.dumps(res))\n"
        "sys.exit(rc)\n") % (root, SMALL, root, workload, root, workload,
                             seconds, trace)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    return (out.returncode,
            json.loads(out.stdout.strip().splitlines()[-1]), out.stderr)


def _run_tiny(root: str, workload: str, seconds: float = 1.0,
              trace: bool = False) -> dict:
    rc, res, err = _run_tiny_rc(root, workload, seconds, trace)
    assert rc == 0, err[-3000:]
    return res


def _copy_tree(root: str) -> None:
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "pg_strom_tpu_torch"),
               os.path.join(root, "pg_strom_tpu_torch"))


def _tree_hash(root: str) -> dict:
    out = {}
    for dp, _, fs in os.walk(os.path.join(root, "portbench")):
        if "__pycache__" in dp or "_cache" in dp:
            continue
        for f in fs:
            p = os.path.join(dp, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_mix_and_metric_are_found_by_name(tmp_path):
    root = str(tmp_path)
    _copy_tree(root)
    before = _tree_hash(root)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    mix = json.load(open(os.path.join(root, "portbench", "traffic",
                                      "q1_1.json")))
    mix["check_per_template"] = 2
    with open(os.path.join(root, "portbench/traffic/q1_1_few.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "portbench/metrics/queries_done.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.ok))\n")
    bench["workloads"].append({"name": "ssb_sf20.q1_1_few",
                               "config": "ssb_sf20",
                               "traffic": "q1_1_few", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "queries_done", "unit": "queries",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    res = _run_tiny(root, "ssb_sf20.q1_1_few")
    assert res["correct"] and res["metrics"]["queries_done"]["value"] >= 1
    after = _tree_hash(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"portbench/traffic/q1_1_few.json",
                                        "portbench/metrics/queries_done.py"}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_jax_loaded_by_a_metric_reader_withholds_the_result(tmp_path, kind):
    """A reader imported after the window that loads a module named `jax`
    (here a stub in the checkout) leaves the run without a result."""
    root = str(tmp_path)
    _copy_tree(root)
    with open(os.path.join(root, "jax.py"), "w") as f:
        f.write("LOADED = True\n")
    with open(os.path.join(root, "portbench/metrics/jax_probe.py"),
              "w") as f:
        f.write("import jax\n\n\ndef read(ctx):\n    return 1.0\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    entry = {"name": "jax_probe", "unit": "ms", "better": "lower",
             "source": "host_clock"}
    if kind == "end_to_end":
        entry["bound"] = 0.1
    else:
        entry.update(layer="probe", moves="query_ms_p50")
    bench[kind].append(entry)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    rc, res, err = _run_tiny_rc(root, "ssb_sf20.q1_1", 0.5,
                                kind == "per_layer")
    assert rc == 4 and res is None, err[-3000:]
    assert "no result: modules loaded in this process: ['jax']" in err


@pytest.mark.parametrize("trace", [False, True])
def test_run_loads_no_jax(trace):
    res = _run_tiny(ROOT, "ssb_sf20.q1_1", 1.0, trace)
    assert res["banned"] == []
    assert res["correct"]
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in
             json.load(open(os.path.join(ROOT, "BENCHMARK.json")))[kind]}
    # on the CPU the device readers find nothing to read
    assert set(res["metrics"]) <= names
    assert list(res)[-2] == "checks"


# faults planted under the timed path: each must make `correct` false
def _stale(real):
    last = {}

    def run(sql, db):
        rows = real(sql, db)
        out = last.get("rows", rows)
        last["rows"] = rows
        return out
    return run


def _altered(real):
    def run(sql, db):
        rows = [list(r) for r in real(sql, db)]
        i = next(j for j, v in enumerate(rows[0]) if isinstance(v, int)
                 and not isinstance(v, bool))
        rows[0][i] += 1
        return [tuple(r) for r in rows]
    return run


def _half(real):
    def run(sql, db):
        from pg_strom_tpu_torch import Database, Table
        half = Database()
        for name, t in db.tables.items():
            cols = t.columns
            if t.nrows > 10_000:
                cols = {c: _head(col, t.nrows // 2) for c, col in cols.items()}
            half.create(Table.from_columns(name, cols))
        return real(sql, half)
    return run


def _head(col, n):
    import dataclasses
    from pg_strom_tpu_torch.datastore import next_column_uid
    return dataclasses.replace(col, data=col.data[:n], valid=col.valid[:n],
                               uid=next_column_uid())


@pytest.mark.parametrize("fault", [_stale, _altered, _half])
@pytest.mark.parametrize("workload", ["testdb_20m.agg_scan",
                                      "ssb_sf20.q1_1"])
def test_planted_fault_is_not_correct(fault, workload, monkeypatch):
    monkeypatch.setattr(port, "execute", fault(port.execute))
    monkeypatch.setattr(cell, "load_cell", load_kept_cell)
    _, wl, cfg, _ = cell.load_cell(ROOT, workload)
    rc, res = cell.run_cell(ROOT, workload, 5, 2.0, False, device="cpu",
                            config_override=SMALL[cfg["schema"]])
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.gpu
def test_cell_on_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, res = cell.run_cell(ROOT, "ssb_sf20.q1_1", 3, 2.0, True,
                            config_override={"lineorder_rows": 1 << 20})
    assert rc == 0 and res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.-]{1,16}$"


def test_benchmark_json_keeps_the_contract():
    import re
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    one_line = lambda s: 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s  # noqa: E731
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and one_line(c["source"])
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and re.match(NAME, w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        used.add(w["config"])
    assert used == names
    metric_names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.add(m["name"])
    assert "setup_s" in metric_names
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in metric_names and one_line(m["layer"])
        layers.add(m["layer"])
        metric_names.add(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "metrics", m["name"] + ".py"))
    assert len(metric_names) == len(bench["end_to_end"]) + len(
        bench["per_layer"])


def test_round_robin_shares_are_exact():
    mix = {"templates": [
        {"name": "a", "sql": "a {x}", "params": [["x", {"int": [1, 9]}]]},
        {"name": "b", "weight": 2, "sql": "b {g}",
         "params": [["g", {"cycle": [64, 256], "warm_all": True}]]}]}
    assert traffic.turn_order(mix) == [0, 1, 1]
    qs = [q for _, q in zip(range(300), traffic.queries(mix, 5))]
    assert sum(q.template == "b" for q in qs) == 200
    gs = [q.params["g"] for q in qs if q.template == "b"]
    assert gs.count(64) == gs.count(256) == 100
    assert [q.sql for q in traffic.warmup_queries(mix, 5)][1:] == \
        ["b 64", "b 256"]
    again = [q.sql for _, q in zip(range(300), traffic.queries(mix, 5))]
    assert again == [q.sql for q in qs]
