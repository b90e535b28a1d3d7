"""Float8 is IEEE double in the port: no bits plane, no chunk-level range
rule, and a guard of its own in the float8 sum lanes.

The reference (pg_strom_tpu) replays on the host every chunk that holds a
float8 value with |v| > 1e37 or 0 < |v| < 1e-37 (its TPU f64 is emulated
with a narrower range).  The port drops that rule: compares, ORDER BY and
top-k, GROUP BY keys, min/max, DISTINCT and join keys run such rows on the
device.  Only a sum, avg, stddev or covariance whose summed quantity
(the value, its square or a product) leaves [2^-102, 1e37] replays
(ops/preagg_mxu.sum_quantity_out_of_range), a domain that holds the old
rule's for every argument.  Every query below runs
through both packages on the same table, and the rows must be equal as
PostgreSQL text at extra_float_digits=-3, or the errors equal, with no
tolerance.  The table holds float8 values across the whole double range:
0 and -0.0, NaN, +-inf, subnormals, 1e-300 and 1e-38, 1e37, 3.5e38, 1e300
and 1.7e308, normal values and NULLs.
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import pytest
import torch

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.expr.lower_jax import planes_of_column as r_planes
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.config import config as p_config
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.exec.devcache import TCACHE, CPU_BUDGET_MB
from pg_strom_tpu_torch.expr.lower_torch import planes_of_column as p_planes
from pg_strom_tpu_torch.ops import preagg_mxu as p_mxu
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query

N = 6000
CHUNK = 1024
TINY = (5e-324, 1e-310, 1e-300, 1e-38)
HUGE = (1e37, 3.5e38, 1e300)
SPECIAL = (0.0, -0.0, np.nan, np.inf, -np.inf, 1.7e308, -1.7e308, 1e300,
           5e-324, 1e-38)


def f8_values(rng, n: int, k: np.ndarray) -> np.ndarray:
    """v by k % 4: 0 normal (a discrete set), 1 tiny only, 2 huge only (both
    with random signs), 3 the specials, tiny, huge and normal mixed."""
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    normal = rng.integers(-2000, 2000, n) / 16.0
    tiny = sign * np.asarray(TINY)[rng.integers(0, len(TINY), n)]
    huge = sign * np.asarray(HUGE)[rng.integers(0, len(HUGE), n)]
    pool = np.concatenate([SPECIAL, np.asarray(TINY) * -1, HUGE,
                           np.asarray(HUGE) * -1, [1.5, -2.25, 100.0]])
    mixed = pool[rng.integers(0, len(pool), n)]
    return np.choose(k % 4, [normal, tiny, huge, mixed])


def _table():
    rng = np.random.default_rng(8)
    k = rng.integers(0, 32, N).astype(np.int32)
    v = f8_values(rng, N, k)
    w = rng.integers(-100000, 100000, N) / 64.0
    f8 = R.Table.from_columns("f8", {
        "id": R.column_from_numpy(R.T.INT8, np.arange(N, dtype=np.int64)),
        "k": R.column_from_numpy(R.T.INT4, k),
        "v": R.column_from_numpy(R.T.FLOAT8, v, rng.random(N) > 0.05),
        "w": R.column_from_numpy(R.T.FLOAT8, w, rng.random(N) > 0.05),
    })
    # one row per SQL-distinct float8 value (0.0 stands for -0.0 too)
    dv = np.asarray([0.0, np.nan, np.inf, -np.inf, 1.7e308, -1.7e308]
                    + [s * x for x in TINY + HUGE for s in (1.0, -1.0)]
                    + [1.5, -2.25])
    d8 = R.Table.from_columns("d8", {
        "v": R.column_from_numpy(R.T.FLOAT8, dv),
        "label": R.column_from_numpy(
            R.T.INT4, np.arange(len(dv), dtype=np.int32) * 10),
    })
    e8 = R.Table.from_columns("e8", {
        "x": R.column_from_values(R.T.FLOAT8, [1000.0, 2.0]),
        "n": R.column_from_values(R.T.NUMERIC, ["1e400", "1.5"]),
    })
    # a dimension over f8's k: g is k % 4, the kind of rows each k holds
    kd = R.Table.from_columns("kd", {
        "k": R.column_from_numpy(R.T.INT4, np.arange(32, dtype=np.int32)),
        "g": R.column_from_numpy(R.T.INT4, np.arange(32, dtype=np.int32) % 4),
    })
    return f8, d8, e8, kd


@pytest.fixture(scope="module")
def dbs():
    rdb = R.Database()
    for t in _table():
        rdb.create(t)
    return rdb, from_reference(rdb)


_CFG = {"debug_force_offload": True, "debug_force_tpupreagg": True,
        "perfmon": True, "chunk_rows": CHUNK}


def _outcome(run):
    try:
        res, counts = run()
    except Exception as e:           # compared as the reference's error
        return ("error", type(e).__name__, str(e)), {}
    return ("rows", tuple(res.columns), tuple(res.formatted(-3))), counts


def _run_both(sql, rdb, pdb, ref_cfg=None, port_cfg=None):
    """(reference outcome, counters), (port outcome, counters)."""
    def ref():
        with R.override(**_CFG), R.override(**(ref_cfg or {})):
            pq = r_plan_query(r_ast.parse(sql), rdb)
            rows = pq.execute()
        return (RResult(columns=pq.out_names, rows=rows, types=pq.out_types),
                dict(pq.perfmon.counts))

    def port():
        with P.override(device="cpu", mesh_shards=8, **_CFG), \
                P.override(**(port_cfg or {})):
            pq = p_plan_query(p_ast.parse(sql), pdb)
            rows = pq.execute()
        return (PResult(columns=pq.out_names, rows=rows, types=pq.out_types),
                dict(pq.perfmon.counts))
    return _outcome(ref), _outcome(port)


def _same(sql, dbs, ref_cfg=None, port_cfg=None):
    (rout, rc), (pout, pc) = _run_both(sql, *dbs, ref_cfg, port_cfg)
    assert pout == rout, f"{sql}\nreference: {rout}\nport:      {pout}"
    return rout, rc, pc


def _kernels(counts) -> int:
    """Device launches: kernel calls and distributed steps."""
    return sum(v for c, v in counts.items()
               if c.startswith("kernel ") or c == "dist_steps")


def test_range_rule_marks_chunks_only_in_the_reference(dbs):
    """The reference marks every chunk of f8 for host replay (each holds
    an out-of-range float8 row); the port marks none."""
    rdb, pdb = dbs
    for start in range(0, N, CHUNK):
        stop = min(start + CHUNK, N)
        assert R.datastore.Chunk.from_table(
            rdb.tables["f8"], start, stop, CHUNK).row_recheck.any()
        assert not P.datastore.Chunk.from_table(
            pdb.tables["f8"], start, stop, CHUNK).row_recheck.any()


# compare-, sort-, group- and join-only queries: exact on the device
DEVICE_QUERIES = {
    "where_gt_huge": "SELECT id, v FROM f8 WHERE v > 1e37 ORDER BY id",
    "where_lt_tiny": "SELECT id, v FROM f8 WHERE v < 0 AND v > -1e-30 "
                     "ORDER BY id",
    "where_eq_subnormal": "SELECT id, v FROM f8 WHERE v = 1e-310 "
                          "ORDER BY id",
    "where_col_vs_col": "SELECT id FROM f8 WHERE v >= w ORDER BY id",
    "order_limit_asc": "SELECT id, v FROM f8 ORDER BY v, id LIMIT 25",
    "order_limit_desc": "SELECT id, v FROM f8 ORDER BY v DESC, id LIMIT 25",
    "group_by_v": "SELECT v, count(*) FROM f8 GROUP BY v ORDER BY v",
    "min_max": "SELECT k, min(v), max(v), count(v) FROM f8 GROUP BY k "
               "ORDER BY k",
    "count_distinct": "SELECT k, count(DISTINCT v) FROM f8 GROUP BY k "
                      "ORDER BY k",
    "join_on_float8": "SELECT f8.id, d8.label FROM f8 JOIN d8 "
                      "ON f8.v = d8.v ORDER BY 1, 2",
}

# the queries whose only float8 work is a compare, a sort or a join key
NO_REPLAY = ("where_gt_huge", "where_lt_tiny", "where_eq_subnormal",
             "where_col_vs_col", "order_limit_asc", "order_limit_desc",
             "join_on_float8")


@pytest.mark.parametrize("name", list(DEVICE_QUERIES))
def test_device_queries_match_reference(dbs, name):
    # the reference's device scan cannot run a table of recheck chunks
    # (its scan_exec.py:99 concatenates zero-dimensional arrays; ROADMAP
    # section 3), so a WHERE-only query is held to its host tier
    ref_cfg = {"enabled": False} if name.startswith("where_") else None
    rout, rc, pc = _same(DEVICE_QUERIES[name], dbs, ref_cfg)
    assert rout[0] == "rows" and rout[2], rout
    assert pc.get("unported_host_exact", 0) == 0, pc
    assert _kernels(pc) > 0, pc
    if name in NO_REPLAY:
        # the port answers every chunk on the device; the reference
        # replays each of them on the host (its range rule marks them all)
        assert pc.get("recheck_chunks", 0) == 0, pc
        assert pc.get("cpu_fallback", 0) == 0, pc
        assert _kernels(rc) == 0, rc


SUM_QUERIES = {
    "sum_tiny": "SELECT k, sum(v) FROM f8 WHERE k % 4 = 1 GROUP BY k "
                "ORDER BY k",
    "avg_tiny": "SELECT k, avg(v) FROM f8 WHERE k % 4 = 1 GROUP BY k "
                "ORDER BY k",
    "stddev_tiny": "SELECT k, stddev(v) FROM f8 WHERE k % 4 = 1 GROUP BY k "
                   "ORDER BY k",
    "sum_huge": "SELECT k, sum(v) FROM f8 WHERE k % 4 = 2 GROUP BY k "
                "ORDER BY k",
    "avg_huge": "SELECT k, avg(v) FROM f8 WHERE k % 4 = 2 GROUP BY k "
                "ORDER BY k",
    "stddev_huge": "SELECT k, stddev(v) FROM f8 WHERE k % 4 = 2 GROUP BY k "
                   "ORDER BY k",
    # normal values scaled into [1e-20, 1e-17]: inside the old range rule,
    # but their squares lie below 2^-102, where the lanes' f32 tail is
    # subnormal (the stddev came out wrong from the 11th digit on)
    "stddev_small_squares": "SELECT k, stddev(v * 1e-20) FROM f8 "
                            "WHERE k % 4 = 0 GROUP BY k ORDER BY k",
}


@contextlib.contextmanager
def _lanes(on: bool):
    saved = p_mxu.F64_BLOCKS_ON_CPU
    p_mxu.F64_BLOCKS_ON_CPU = on
    try:
        yield
    finally:
        p_mxu.F64_BLOCKS_ON_CPU = saved


@pytest.mark.parametrize("lanes", [False, True], ids=["cpu_tier", "lanes"])
@pytest.mark.parametrize("name", list(SUM_QUERIES))
def test_sums_over_out_of_range_rows_replay(dbs, name, lanes):
    """On the CPU the float8 sums take the segment-sum side path; with
    F64_BLOCKS_ON_CPU they ride the double-float lanes (as on the card)
    and their guard.  Either way a sum whose quantity leaves [2^-102,
    1e37] must replay: the lanes would flush a tiny head and tail to zero
    and lose the row, and the squares of stddev under- or overflow where
    PostgreSQL's accumulation does not."""
    with _lanes(lanes):
        rout, _, pc = _same(SUM_QUERIES[name], dbs)
    if name == "stddev_huge":
        # the squares of 1e300 overflow in PostgreSQL's accumulation too:
        # only the host replay raises this error (the device never does)
        assert rout == ("error", "SqlError", "value out of range: overflow")
        return
    assert rout[0] == "rows" and rout[2], rout
    assert pc.get("recheck_chunks", 0) == -(-N // CHUNK), pc


@pytest.mark.parametrize("hosts", [1, 2], ids=["flat", "hosts2"])
@pytest.mark.parametrize("name", list(SUM_QUERIES))
def test_sums_over_out_of_range_rows_replay_through_the_mesh(dbs, name,
                                                             hosts):
    """The mesh's data-parallel aggregation sums in IEEE f64 under the same
    domain: its err lane ends the distributed step (dist_recheck), and the
    single-device executor replays the chunks on the host."""
    cfg = {"distributed": True, "dist_mesh_hosts": hosts}
    rout, _, pc = _same(SUM_QUERIES[name], dbs, port_cfg=cfg)
    if name == "stddev_huge":
        assert rout == ("error", "SqlError", "value out of range: overflow")
        return
    assert rout[0] == "rows" and rout[2], rout
    # v * 1e-20 under- and overflows on f8's tiny and huge rows, where the
    # float8 multiply keeps PostgreSQL's check: the mesh's argument lane
    # defers to the host before the step runs
    stepped = name != "stddev_small_squares"
    assert pc.get("dist_prepare", 0) == 1, pc
    assert pc.get("dist_recheck", 0) == int(stepped), pc
    assert pc.get("dist_steps", 0) == 0, pc
    assert pc.get("recheck_chunks", 0) == -(-N // CHUNK), pc


@pytest.mark.parametrize("lanes", [False, True], ids=["cpu_tier", "lanes"])
def test_join_narrowed_sums_keep_the_guard(dbs, lanes):
    """A join+aggregate reads f8's cached planes under the join's matched
    rows.  A first join that matches only normal rows must not let a later
    one over the same cached chunks, matching the tiny rows, pass the
    guard: that one replays and equals the reference."""
    TCACHE.clear()
    with _lanes(lanes):
        for g, replays in ((0, False), (1, True), (0, False)):
            sql = ("SELECT kd.g, sum(f8.v), avg(f8.v), count(*) FROM f8 "
                   f"JOIN kd ON f8.k = kd.k WHERE kd.g = {g} GROUP BY kd.g")
            rout, _, pc = _same(sql, dbs)
            assert rout[0] == "rows" and len(rout[2]) == 1, rout
            assert _kernels(pc) > 0, pc
            assert pc.get("tcache_hits", 0) > 0 or g == 0, pc
            assert (pc.get("recheck_chunks", 0) > 0) is replays, (g, pc)


@pytest.mark.parametrize("lanes", [False, True], ids=["cpu_tier", "lanes"])
def test_sum_of_normal_rows_where_v_is_huge(dbs, lanes):
    """WHERE on huge v, sums of normal w: the port answers on the device
    (the reference replays, its range rule sees v)."""
    sql = ("SELECT k, sum(w), avg(w), count(w) FROM f8 WHERE v < -1e37 "
           "GROUP BY k ORDER BY k")
    with _lanes(lanes):
        rout, rc, pc = _same(sql, dbs)
    assert rout[0] == "rows" and rout[2], rout
    assert pc.get("recheck_chunks", 0) == 0, pc
    assert pc.get("device_chunks", 0) == -(-N // CHUNK), pc
    assert rc.get("cpu_fallback", 0) == -(-N // CHUNK), rc


@pytest.mark.parametrize("sql", [
    "SELECT exp(x) FROM e8",
    "SELECT x * 1e308::float8 FROM e8",
    "SELECT n::float8 FROM e8",
], ids=["exp_1000", "mul_overflow", "numeric_cast_overflow"])
def test_float8_overflow_raises_reference_error(dbs, sql):
    """Float8 overflow keeps PostgreSQL's error: the device defers the row
    and the host replay raises the text.  numeric 1e400 lies outside the
    device's numeric window, so its cast runs on the host in both packages,
    which give Infinity where PostgreSQL raises (a fault of the reference,
    ROADMAP section 3); the port must agree with it."""
    rout, _, _ = _same(sql, dbs)
    if "n::float8" in sql:
        assert rout[2] == ("Infinity", "1.5"), rout
    else:
        assert rout == ("error", "SqlError", "value out of range: overflow")


def test_float8_column_ships_two_planes(dbs):
    rdb, pdb = dbs
    pt, rt = pdb.tables["f8"], rdb.tables["f8"]
    planes = p_planes(pt.columns["v"])
    assert len(planes) == 2
    assert planes[0].dtype == np.float64 and planes[1].dtype == np.bool_
    # the reference ships a third, int64 bits plane for each float8 column
    for name in ("id", "k", "v", "w"):
        p_b = sum(p.dtype.itemsize for p in p_planes(pt.columns[name]))
        r_b = sum(p.dtype.itemsize for p in r_planes(rt.columns[name]))
        assert r_b - p_b == (8 if name in ("v", "w") else 0), name


def test_devcache_holds_two_planes_per_float8_column(dbs):
    _, pdb = dbs
    TCACHE.clear()
    with P.override(device="cpu", debug_force_offload=True,
                    chunk_rows=CHUNK):
        P.execute("SELECT id FROM f8 WHERE v > w", pdb)
    rows = [r for r in TCACHE.info_rows() if r["table_name"] == "f8"]
    assert rows and rows[0]["kind"] == "chunks"
    nchunks = -(-N // CHUNK)
    # id int8, k int4, v and w float8, each with its valid plane: no float8
    # column carries the 8 B a row of a bits plane
    assert rows[0]["nbytes"] == nchunks * CHUNK * (9 + 5 + 9 + 9)


def test_budget_defaults_to_the_device(monkeypatch):
    assert p_config.tcache_size_mb == 0
    with P.override(device="cpu"):
        assert TCACHE.budget_bytes() == CPU_BUDGET_MB << 20 == 8192 << 20
    total = 80 * 10 ** 9 + 12345
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: types.SimpleNamespace(
                            total_memory=total))
    with P.override(device="cuda"):
        got = TCACHE.budget_bytes()
    assert got == (total * 2 // 5) // (1 << 20) * (1 << 20)
    assert got % (1 << 20) == 0 and total * 0.4 - (1 << 20) < got
    with P.override(device="cuda", tcache_size_mb=1234):
        assert TCACHE.budget_bytes() == 1234 << 20
    with P.override(device="cpu", tcache_size_mb=77):
        assert TCACHE.budget_bytes() == 77 << 20
