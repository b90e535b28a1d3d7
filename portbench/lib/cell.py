"""One run of one cell: set up, warm up, a closed loop of one client for
the window, then the checks, the metrics and the result line.

Everything that belongs to one configuration, mix or metric is a file
found by its name in `BENCHMARK.json`:
  portbench/configs/<config>.json     sizes and guarantees (its `file`)
  portbench/generators/<generator>.py the configuration's data, from a seed
  portbench/traffic/<traffic>.json    the mix (lib/traffic.py)
  portbench/reference/<family>.py     the plain reference of a template
  portbench/metrics/<metric>.py       `read(ctx)`: the metric, or None
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time

from portbench.lib import check, port, stats, traffic
from portbench.lib.dataset import Dataset
from portbench.lib.trace import Reduced, profiled, reduce, span

BANNED_MODULES = ("jax", "jaxlib", "flax", "pg_strom_tpu")
SAMPLE_STREAM = 7


@dataclasses.dataclass
class Record:
    query: traffic.Query
    start: float
    end: float
    rows: list | None
    error: str | None
    plan_ms: float | None = None
    covered: int = 0                 # fact rows the query covers
    logical_bytes: int = 0

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    records: list
    window_s: float
    setup_s: float
    cold_query_ms: float
    trace: Reduced | None = None
    exec_spans: list | None = None   # (record, start, end), profiler clock
    ladder: dict | None = None       # {"counts": {...}, "queries": n}

    @property
    def ok(self) -> list:
        return [r for r in self.records if r.error is None]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(root: str, workload: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, centry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           wl["traffic"] + ".json")) as f:
        mix = json.load(f)
    if mix["schema"] != cfg["schema"]:
        raise SystemExit(f"mix {wl['traffic']} is for schema {mix['schema']},"
                         f" config {wl['config']} is {cfg['schema']}")
    return bench, wl, cfg, mix


def card_line(device: str) -> str:
    if device != "cuda":
        return "card: none (cpu)"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return "card: " + r.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi failed ({e})"


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def run_query(q, db, data: Dataset, tpl: dict, traced: bool) -> Record:
    start = time.perf_counter()
    plan_ms = None
    try:
        if traced:
            with span(f"{q.template}.plan"):
                pq = port.plan(q.sql, db)
            plan_ms = (time.perf_counter() - start) * 1e3
            with span(f"{q.template}.exec"):
                rows = pq.execute()
        else:
            rows = port.execute(q.sql, db)
        err = None
    except Exception as e:  # a failed query counts in `failed`
        rows, err = None, f"{type(e).__name__}: {e}"
    end = time.perf_counter()
    rec = Record(q, start, end, rows, err, plan_ms)
    if err is None:
        rec.covered = data.nrows(tpl["fact"])
        rec.logical_bytes = stats.logical_bytes(
            data, tpl["reads"], len(rows), len(rows[0]) if rows else 0)
    return rec


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             config_override: dict | None = None) -> tuple[int, dict | None]:
    """(exit code, result) of one run; result is None when the run may
    print none."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, wl, cfg, mix = load_cell(root, workload)
    if config_override:
        cfg = {**cfg, **config_override}
    if device == "cuda":
        import torch
        want = int(wl["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            log(f"no result: this cell needs {want} CUDA device(s); "
                f"available={torch.cuda.is_available()}")
            return 3, None
    port.check_package(root)
    port.set_device(device)

    # interpreter start, imports and the device check
    split = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    data = gen.generate(cfg, seed)
    split["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    db = port.load(data)
    split["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    port.init_device(device)
    split["device_init_s"] = time.perf_counter() - t
    reads: dict = {}
    for tpl in mix["templates"]:
        for table, cols in tpl["reads"].items():
            reads.setdefault(table, set()).update(cols)
    t = time.perf_counter()
    port.column_statistics(db, reads)
    split["statistics_s"] = time.perf_counter() - t
    warm = traffic.warmup_queries(mix, seed)
    t = time.perf_counter()
    first = run_query(warm[0], db, data,
                      traffic.template(mix, warm[0].template), False)
    sync(device)
    split["cold_query_s"] = time.perf_counter() - t
    cold_query_ms = (split["statistics_s"] + split["cold_query_s"]) * 1e3
    t = time.perf_counter()
    warm_errors = [first.error] if first.error else []
    for q in warm[1:]:
        r = run_query(q, db, data, traffic.template(mix, q.template), False)
        if r.error:
            warm_errors.append(r.error)
    sync(device)
    split["warmup_s"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log("setup split: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f", total setup_s {setup_s:.3f} (warm-up queries {len(warm)})")
    for e in warm_errors:
        log(f"warm-up query failed: {e}")

    # the window: one client, no think time
    records: list[Record] = []
    tpls = {t["name"]: t for t in mix["templates"]}
    stream = traffic.queries(mix, seed)
    between = None
    with profiled(trace) as prof:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for q in stream:
            if time.perf_counter() >= deadline:
                break
            if between is not None:
                between.__exit__(None, None, None)
            records.append(run_query(q, db, data, tpls[q.template], trace))
            if trace:
                between = span("between_queries")
                between.__enter__()
        if between is not None:
            between.__exit__(None, None, None)
        window_s = records[-1].end - t0
        sync(device)
    ctx = Context(records, window_s, setup_s, cold_query_ms)
    log(f"queries in window: {len(records)} in {window_s:.3f} s; "
        + ", ".join(f"{n} {sum(r.query.template == n for r in records)}"
                    for n in tpls))
    by_tpl = {n: [r.ms for r in ctx.ok if r.query.template == n]
              for n in tpls}
    for q in (50, 95):
        log(f"template p{q} ms: " + ", ".join(
            f"{n} {stats.percentile(ms, q):.3f}"
            for n, ms in by_tpl.items() if ms))
    if trace:
        ctx.ladder = {"counts": {}, "queries": 0}
        for _ in range(len(tpls)):
            q = next(stream)
            counts = port.ladder_counts(q.sql, db)
            for k, v in counts.items():
                ctx.ladder["counts"][k] = ctx.ladder["counts"].get(k, 0) + v
            ctx.ladder["queries"] += 1
        names = {f"{n}.{p}" for n in tpls for p in ("plan", "exec")}
        names.add("between_queries")
        ctx.trace = reduce(prof, names)
        execs = sorted(iv for n in tpls for iv in
                       ctx.trace.spans.get(f"{n}.exec", []))
        started = [r for r in records if r.plan_ms is not None]
        ctx.exec_spans = [(r, s, e) for r, (s, e) in zip(started, execs)]
        del prof

    log(card_line(device))
    peak = 0
    kind = "cpu"
    if device == "cuda":
        import torch
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    port.free(db)
    del db
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()

    checks = check_answers(records, mix, data, seed)
    failed = sum(r.error is not None for r in records) + \
        checks["mismatched_answers"]["value"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind_key]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": int(wl["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window[1] - ctx.trace.window[0]
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    for r in records:
        if r.error:
            log(f"query failed: {r.query.template}: {r.error}")
            break
    result["checks"] = checks
    # last, once the references and the metric readers have been imported
    found = banned_modules()
    if found:
        log(f"no result: modules loaded in this process: {found}")
        return 4, None
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def banned_modules() -> list:
    """The top-level names of `sys.modules` that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED_MODULES))


def sample(records: list, mix: dict, seed: int) -> list:
    """The answers to check: `check_per_template` of each template's
    completed queries, drawn from the seed, and the slowest query."""
    rng = traffic.rng_of(seed, SAMPLE_STREAM)
    ok = [r for r in records if r.error is None]
    picked: dict = {}
    for tpl in mix["templates"]:
        mine = [r for r in ok if r.query.template == tpl["name"]]
        k = min(int(mix["check_per_template"]), len(mine))
        for i in rng.choice(len(mine), size=k, replace=False):
            picked[mine[int(i)].query.index] = mine[int(i)]
    if ok:
        slow = max(ok, key=lambda r: r.end - r.start)
        picked[slow.query.index] = slow
    return [picked[i] for i in sorted(picked)]


def reference_answers(queries: list, mix: dict, data: Dataset,
                      precision: str = "float64", workers: int = 8) -> list:
    """(rows, exact columns, ordered) of each query, by the reference; the
    queries run in threads (NumPy releases the interpreter lock)."""
    envs: dict = {}

    def one(q):
        spec = traffic.template(mix, q.template)["reference"]
        fam = importlib.import_module(f"portbench.reference.{spec['family']}")
        env = envs[spec["family"]]
        return (fam.evaluate(spec, q.params, env, precision),
                fam.exact_columns(spec, env), bool(spec.get("ordered")))

    for q in queries:
        fam = traffic.template(mix, q.template)["reference"]["family"]
        if fam not in envs:
            envs[fam] = importlib.import_module(
                f"portbench.reference.{fam}").Env(data)
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, queries))


def check_answers(records: list, mix: dict, data: Dataset, seed: int) -> dict:
    picked = sample(records, mix, seed)
    t = time.perf_counter()
    want = reference_answers([r.query for r in picked], mix, data)
    mismatched, gap = 0, 0.0
    for r, (rows, exact, ordered) in zip(picked, want):
        bad, g = check.compare(r.rows, rows, exact, ordered)
        if bad:
            mismatched += 1
            log(f"mismatched answer: query {r.query.index} {r.query.sql!r}: "
                f"program {r.rows[:4]!r} reference {rows[:4]!r}")
        gap = max(gap, g)
    log(f"reference: {len(picked)} answers checked in "
        f"{time.perf_counter() - t:.3f} s")
    limits = mix["limits"]
    checks = {"failed_queries": {"value": sum(r.error is not None
                                              for r in records),
                                 "limit": 0},
              "mismatched_answers": {"value": mismatched,
                                     "limit": limits["mismatched_answers"]}}
    if "float_rel_gap" in limits:
        checks["float_rel_gap"] = {"value": gap,
                                   "limit": limits["float_rel_gap"]}
    return checks

