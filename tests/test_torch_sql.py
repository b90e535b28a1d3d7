"""The slice end to end: SQL through `execute()` in the JAX reference and in
the PyTorch port, on the same state.

The tables are built with the reference (including its regression fixture
`models/fixtures.make_preagg_test`) and carried into the port with
`pg_strom_tpu_torch.datastore.from_reference`.  Both packages force the
device plan; the port runs on `device="cpu"`, i.e. through the plain
PyTorch version of K1.  Rows must be equal as PostgreSQL text at
extra_float_digits=-3, the reference's own rule.  The port's perfmon must
show that the v2 shapes ran on the kernel path (device_chunks, no
unported_host_exact) and that the non-v2 shape ran host-exact, visibly.
The star join and ORDER BY ... LIMIT routes run on the device too."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import (Database as RDatabase, Table as RTable,
                                    column_from_numpy as rnp)
from pg_strom_tpu.models.fixtures import make_preagg_test
from pg_strom_tpu.sql import execute as r_execute
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult


def _flagship_table(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    return RTable.from_columns("t", {
        "key": rnp(R.T.INT4, rng.integers(0, 30, n).astype(np.int32)),
        "k2": rnp(R.T.INT4, rng.integers(0, 3, n).astype(np.int32)),
        "x": rnp(R.T.FLOAT4, rng.random(n).astype(np.float32),
                 rng.random(n) > 0.05),
        "y": rnp(R.T.INT8, rng.integers(0, 1 << 40, n).astype(np.int64),
                 rng.random(n) > 0.05),
    })


@pytest.fixture(scope="module")
def dbs():
    rdb = RDatabase()
    rdb.create(_flagship_table())
    rdb.create(make_preagg_test())
    return rdb, from_reference(rdb)


FLAGSHIP = ("SELECT key, sum(x), count(x), sum(y) FROM t WHERE x > 0.25 "
            "GROUP BY key ORDER BY key")

# name -> (sql, port config overrides)
V2_QUERIES = {
    "flagship": (FLAGSHIP, {}),
    "flagship_multichunk": (FLAGSHIP, {"chunk_rows": 1 << 11}),
    "having_order_by": (
        "SELECT key, count(*), sum(y) FROM t WHERE x > 0.5 GROUP BY key "
        "HAVING count(*) > 90 ORDER BY 3 DESC", {}),
    "avg_stddev_int4": (
        "SELECT key, avg(integer_x), stddev(integer_x), sum(integer_x), "
        "count(integer_x) FROM gpupreagg_test GROUP BY key ORDER BY key",
        {}),
    "fixture_or_isnull_multichunk": (
        "SELECT key, sum(bigint_x), count(*), sum(real_x), avg(integer_x) "
        "FROM gpupreagg_test WHERE real_x > 0.5 OR integer_x IS NULL "
        "GROUP BY key ORDER BY key", {"chunk_rows": 1 << 11}),
}


@contextlib.contextmanager
def _forced(port_overrides):
    with R.override(debug_force_tpupreagg=True), \
            P.override(device="cpu", debug_force_tpupreagg=True,
                       **port_overrides):
        yield


def _port_run(sql, pdb):
    """execute() for a SELECT, keeping the plan's perfmon counters."""
    pq = p_plan_query(p_ast.parse(sql), pdb)
    rows = pq.execute()
    return (PResult(columns=pq.out_names, rows=rows, types=pq.out_types),
            dict(pq.perfmon.counts))


@pytest.mark.parametrize("name", list(V2_QUERIES))
def test_v2_query_matches_reference(dbs, name):
    rdb, pdb = dbs
    sql, ovr = V2_QUERIES[name]
    with _forced(ovr):
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
        via_execute = P.execute(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert via_execute.formatted(-3) == want.formatted(-3)
    assert counts.get("device_chunks", 0) >= 1, counts
    assert counts.get("unported_host_exact", 0) == 0, counts
    assert counts.get("recheck_chunks", 0) == 0, counts


def test_non_v2_shape_runs_host_exact_visibly(dbs):
    """Two GROUP BY keys have no v2 plan: both packages run the salted
    column-sum strategy (K2) and its retry ladder on the device, with the
    same perfmon counters; no chunk is answered by an unported tier and
    the rows match the reference."""
    rdb, pdb = dbs
    sql = ("SELECT key, k2, count(*), sum(y), sum(x) FROM t WHERE x > 0.25 "
           "GROUP BY key, k2 ORDER BY key, k2")
    with _forced({}), R.override(force_fused_preagg_cpu=True):
        rq = r_plan_query(r_ast.parse(sql), rdb)
        want_rows = rq.execute()
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert counts.get("unported_host_exact", 0) == 0, counts
    assert counts.get("device_chunks", 0) + counts.get("recheck_chunks", 0) \
        == 1, counts
    assert counts.get("device_chunks", 0) >= 1, counts
    ladder = ("device_chunks", "recheck_chunks", "salt_retries",
              "sort_fallbacks", "dense_fallbacks")
    assert {c: counts.get(c, 0) for c in ladder} == \
        {c: rq.perfmon.counts.get(c, 0) for c in ladder}
    assert len(want_rows) == len(got.rows)


def test_explain_analyze_shows_the_kernel_path(dbs):
    _, pdb = dbs
    with _forced({}):
        text = "\n".join(r[0] for r in
                         P.execute("EXPLAIN ANALYZE " + FLAGSHIP, pdb).rows)
    assert "TpuPreAgg" in text and "device_chunks: 1" in text, text
    assert "unported_host_exact" not in text, text


HOST_QUERIES = [
    "SELECT 1 + 2, abs(-4), 'a' || 'b'",
    "SELECT count(*), sum(y), avg(x), max(key) FROM t WHERE x > 0.25",
    "SELECT key, sum(y) FROM t GROUP BY key UNION ALL "
    "SELECT key, sum(y) FROM t WHERE x > 0.5 GROUP BY key ORDER BY 1, 2",
    "WITH s AS (SELECT key, count(*) AS c FROM t GROUP BY key) "
    "SELECT count(*), sum(c), min(c) FROM s",
]


@pytest.mark.parametrize("sql", HOST_QUERIES)
def test_copied_host_surface_matches_reference(dbs, sql):
    """Shapes outside the slice still answer in the port — the copied
    host tiers (table-less SELECT, ungrouped aggregates on the host-exact
    tier, set operations, CTEs) — and agree with the reference."""
    rdb, pdb = dbs
    with _forced({}):
        want = r_execute(sql, rdb)
        got = P.execute(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)


def _dist_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items()
            if k.startswith("dist_") and k != "dist_prepare"}


def _ref_run(sql, rdb):
    """The reference's rows as text and its perfmon counters."""
    from pg_strom_tpu.sql.api import Result as RResult
    pq = r_plan_query(r_ast.parse(sql), rdb)
    rows = pq.execute()
    return (RResult(columns=pq.out_names, rows=rows,
                    types=pq.out_types).formatted(-3),
            dict(pq.perfmon.counts))


@pytest.mark.parametrize("sql, cfg", [
    ("SELECT key, sum(y) FROM t GROUP BY key ORDER BY key",
     {"distributed": True}),
    ("COPY t FROM 'absent.csv'", {}),
], ids=["distributed_aggregation", "copy_missing_file"])
def test_formerly_unported_routes_match_reference(dbs, sql, cfg):
    """The routes that raised before the mesh and COPY were ported: the
    distributed aggregation on an 8-shard mesh (the reference's 8 CPU
    devices) gives the reference's rows and dist_* counters, and COPY
    from a missing file the reference's error."""
    rdb, pdb = dbs
    with _forced({"debug_force_offload": True, "mesh_shards": 8,
                  "perfmon": True, **cfg}), \
            R.override(debug_force_offload=True, perfmon=True, **cfg):
        if sql.startswith("COPY"):
            with pytest.raises(FileNotFoundError) as want_err:
                r_execute(sql, rdb)
            with pytest.raises(FileNotFoundError) as got_err:
                P.execute(sql, pdb)
            assert str(got_err.value) == str(want_err.value)
            return
        want, rcounts = _ref_run(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want
    assert _dist_counts(counts) == _dist_counts(rcounts)
    assert counts.get("dist_steps", 0) == 1, counts


# name -> (sql, the port's perfmon counter its device route bumps)
ROUTED_QUERIES = {
    # a 3-way self-join: the fused star node (TpuStarJoinAgg) with both
    # inner relations on the bounded-fanout probe.  It joins on the
    # near-unique y; on `key` (200 rows a value) it would be 240M rows.
    "self_join_3way": (
        "SELECT a.key, count(*), sum(b.x) FROM t a, t b, t c "
        "WHERE a.y = b.y AND a.y = c.y GROUP BY a.key ORDER BY a.key",
        "kernel tpustarjoinagg"),
    "order_by_limit": ("SELECT key FROM t ORDER BY key LIMIT 3",
                       "topk_packed"),
    # the window tier's inner stage scans on the device
    "window_rank": ("SELECT key, rank() OVER (ORDER BY key) FROM t "
                    "WHERE x > 0.25 ORDER BY 2, 1", "device_chunks"),
}


@pytest.mark.parametrize("name", list(ROUTED_QUERIES))
def test_routed_query_matches_reference(dbs, name):
    """Routes that raised before the star join, the top-k and the window
    tier were ported answer on the device and agree with the reference."""
    rdb, pdb = dbs
    sql, counter = ROUTED_QUERIES[name]
    with _forced({"debug_force_offload": True, "perfmon": True}), \
            R.override(debug_force_offload=True):
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert len(got.rows) > 0
    assert counts.get(counter, 0) >= 1, counts
    assert counts.get("unported_host_exact", 0) == 0, counts


# ---------------------------------------------------------------------------
# general grouped aggregation: the star-schema benchmark queries over t0
# (models/testdb.py) and a wide fixture query
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def testdbs():
    from pg_strom_tpu.models.testdb import build_testdb
    rdb = RDatabase()
    build_testdb(rdb, fact_rows=4096, dim_rows=1000, seed=3)
    rdb.create(make_preagg_test(nrows=3000))
    return rdb, from_reference(rdb)


TESTDB_QUERIES = {
    "agg_group": "select cat, count(*), sum(x), avg(y) from t0 group by cat "
                 "order by cat",
    "rollup": "select cat, cid % 8, count(*), sum(x) from t0 "
              "group by rollup(cat, cid % 8) order by 1, 2",
    "filter": "select count(*), sum(x) from t0 where x < 25.0 and y > 10.0",
    "agg_nogrp": "select count(*), sum(x), avg(y) from t0",
    "wide_fixture": (
        "SELECT key, count(*), sum(smlint_x), avg(integer_x), "
        "sum(bigint_x), max(bigint_x), min(real_x), sum(real_x), "
        "avg(float_x), max(float_x), sum(nume_x), min(nume_x), "
        "stddev(integer_x), corr(float_x, real_x) FROM gpupreagg_test "
        "GROUP BY key ORDER BY key"),
}


@pytest.mark.parametrize("name", list(TESTDB_QUERIES))
def test_testdb_query_matches_reference(testdbs, name):
    rdb, pdb = testdbs
    sql = TESTDB_QUERIES[name]
    with _forced({"chunk_rows": 1 << 11}), \
            R.override(force_fused_preagg_cpu=True, chunk_rows=1 << 11):
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert counts.get("unported_host_exact", 0) == 0, counts
    assert counts.get("device_chunks", 0) >= 1, counts


# ---------------------------------------------------------------------------
# joins and device scans: the t0..t5 star schema (models/testdb.py)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _both(ovr):
    """Both packages on the device plan (debug_force_offload), the
    reference's grouped plans on K2 like the port's."""
    with R.override(debug_force_offload=True, force_fused_preagg_cpu=True,
                    **ovr), \
            P.override(device="cpu", debug_force_offload=True, **ovr):
        yield


JOIN_QUERIES = {
    "join_agg": "select count(*), sum(t0.x) from t0 "
                "join t1 on t0.aid = t1.aid where t0.x < 50.0",
    "star_group": "select t1.aid % 40, count(*), sum(t0.x) from t0 "
                  "join t1 on t0.aid = t1.aid group by t1.aid % 40 "
                  "order by t1.aid % 40",
    "pairwise_rows": "select t0.id, t5.eid, t5.a from t0 join t5 "
                     "on t0.eid = t5.eid where t0.x < 3.0 order by t0.id",
    "left_where": "select t0.id, t5.eid, t5.a from t0 left join t5 "
                  "on t0.eid = t5.eid where t5.a > 50.0 or t5.a is null "
                  "order by t0.id",
    "right_where": "select t0.id, t5.eid from t0 right join t5 "
                   "on t0.eid = t5.eid and t0.x < 10.0 "
                   "where t5.b < 30.0 order by t5.eid, t0.id",
    "full_where": "select t0.id, t5.eid from t0 full join t5 "
                  "on t0.eid = t5.eid and t5.a < 20.0 "
                  "where t0.id is null or t0.id % 7 = 0 "
                  "order by t5.eid, t0.id",
    "three_way_rows": "select t0.id, t1.aid, t2.bid from t0 "
                      "join t1 on t0.aid = t1.aid join t2 on t0.bid = t2.bid "
                      "where t0.y < 2.0 order by t0.id",
    "device_scan": "select id, cat, x from t0 where x < 5.0 and y > 50.0 "
                   "order by id",
}


@pytest.mark.parametrize("name", list(JOIN_QUERIES))
def test_join_query_matches_reference(testdbs, name):
    rdb, pdb = testdbs
    sql = JOIN_QUERIES[name]
    with _both({"chunk_rows": 1 << 11}):
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert len(got.rows) > 0
    assert counts.get("unported_host_exact", 0) == 0, counts
    assert counts.get("recheck_chunks", 0) == 0, counts
    assert counts.get("device_chunks", 0) >= 2, counts


@pytest.mark.parametrize("sql", [
    JOIN_QUERIES["join_agg"],
    JOIN_QUERIES["left_where"],
    "select count(*), sum(t0.x), sum(t0.y) from t0, t1, t2, t3 "
    "where t0.aid = t1.aid and t0.bid = t2.bid and t0.cid = t3.cid",
])
def test_join_explain_matches_reference(testdbs, sql):
    rdb, pdb = testdbs
    with _both({}):
        want = r_execute("EXPLAIN " + sql, rdb)
        got = P.execute("EXPLAIN " + sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)


def test_star4way_matches_reference(testdbs):
    """The reference's manual benchmark shape: t0 joined to three serial-PK
    dimensions in one TpuStarJoinAgg pass per fact chunk (identity
    probes), with every chunk on the device."""
    rdb, pdb = testdbs
    from pg_strom_tpu.models.testdb import BENCH_QUERIES
    sql = BENCH_QUERIES["star4way"]
    with _both({"chunk_rows": 1 << 11, "perfmon": True}):
        want = r_execute(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want.formatted(-3)
    assert counts.get("kernel tpustarjoinagg", 0) == 2, counts
    assert counts.get("device_chunks", 0) == 2, counts
    assert counts.get("recheck_chunks", 0) == 0, counts
    assert counts.get("unported_host_exact", 0) == 0, counts


def test_distributed_join_matches_reference(testdbs):
    """join_agg over an 8-shard mesh (the reference's 8 CPU devices): the
    shuffle join+aggregate gives the reference's rows and dist_*
    counters."""
    rdb, pdb = testdbs
    sql = JOIN_QUERIES["join_agg"]
    with _both({"distributed": True, "perfmon": True}), \
            P.override(mesh_shards=8):
        want, rcounts = _ref_run(sql, rdb)
        got, counts = _port_run(sql, pdb)
    assert got.formatted(-3) == want
    assert _dist_counts(counts) == _dist_counts(rcounts)
    assert counts.get("dist_steps", 0) == 1, counts
