"""The N-way fused star join -> aggregate (pg_strom_tpu_torch/ops/starjoin.py,
exec/starjoin_exec.py) against the JAX reference; mirrors
tests/test_starjoin.py case for case.

Each query runs through the planner in both packages on the same tables
(built in the reference, carried over with `from_reference`): the
reference with force_fused_preagg_cpu (so that both take K2 for grouped
plans), the port on device="cpu" under debug_force_offload.  Rows must be
equal as PostgreSQL text at extra_float_digits=-3 and equal to the port's
own host-exact tier; the star executor must engage where the reference's
does, with the same ladder counters (fanout_retries, recheck_chunks, ...), one
device_chunks a fact chunk answered on the device, and no
unported_host_exact.  The distributed star
cases raise NotImplementedError naming "Distributed".  At the op level,
build_star_join_preagg_fn's slices equal the reference's dict for dict.
"""

from __future__ import annotations

from decimal import Decimal

import jax
import numpy as np
import pytest
import torch

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult, explain as r_explain
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query

COUNTERS = ("device_chunks", "fanout_retries", "recheck_chunks",
            "salt_retries", "sort_fallbacks", "dense_fallbacks")
STAR = "kernel tpustarjoinagg"


def _ints(rng, n, lo, hi):
    return [int(v) for v in rng.integers(lo, hi, n)]


def _star_db():
    """tests/test_starjoin.py's fixture: a fact with NULL keys, three
    serial-key dimensions, a 2x fan-out dimension, and the composite-key
    fan-out pair mk / f2."""
    rng = np.random.default_rng(31)
    nf = 8000
    db = R.Database()
    db.create(R.Table.from_columns("t0", {
        "aid": R.column_from_values(R.T.INT4, _ints(rng, nf, 0, 60)),
        "bid": R.column_from_values(
            R.T.INT4, [None if i % 41 == 0 else int(v)
                       for i, v in enumerate(rng.integers(0, 30, nf))]),
        "cid": R.column_from_values(R.T.INT4, _ints(rng, nf, 0, 25)),
        "x": R.column_from_values(R.T.FLOAT8,
                                  [float(v) for v in rng.random(nf)]),
        "q": R.column_from_values(R.T.INT8, _ints(rng, nf, -500, 500)),
    }))
    db.create(R.Table.from_columns("t1", {
        "aid": R.column_from_values(R.T.INT4, list(range(60))),
        "atext": R.column_from_values(R.T.TEXT,
                                      [f"a{i % 9}" for i in range(60)]),
    }))
    db.create(R.Table.from_columns("t2", {
        "bid": R.column_from_values(R.T.INT4, list(range(30))),
        "bval": R.column_from_values(R.T.INT8, [i * 7 for i in range(30)]),
    }))
    db.create(R.Table.from_columns("t3", {
        "cid": R.column_from_values(R.T.INT4, list(range(25))),
        "cw": R.column_from_values(R.T.FLOAT8, [i * 0.25 for i in range(25)]),
    }))
    db.create(R.Table.from_columns("t2dup", {
        "bid": R.column_from_values(R.T.INT4, [i % 30 for i in range(60)]),
        "bval": R.column_from_values(R.T.INT8, list(range(60))),
    }))
    # composite-key inner with up to 5 rows per key pair: the multi-key
    # initial fanout guess is 2, so the join_ovf ladder must double F
    rows_a, rows_b, val = [], [], []
    rng = np.random.default_rng(5)
    for a in range(12):
        for b in range(4):
            for d in range(int(rng.integers(1, 6))):
                rows_a.append(a)
                rows_b.append(b)
                val.append(a * 100 + b * 10 + d)
    db.create(R.Table.from_columns("mk", {
        "ka": R.column_from_values(R.T.INT4, rows_a),
        "kb": R.column_from_values(R.T.INT4, rows_b),
        "v": R.column_from_values(R.T.INT8, val),
    }))
    nf2 = 2000
    db.create(R.Table.from_columns("f2", {
        "a": R.column_from_values(R.T.INT4, _ints(rng, nf2, 0, 14)),
        "b": R.column_from_values(R.T.INT4, _ints(rng, nf2, 0, 5)),
        "c": R.column_from_values(R.T.INT4, _ints(rng, nf2, 0, 25)),
        "x": R.column_from_values(R.T.FLOAT8,
                                  [float(v) for v in rng.random(nf2)]),
    }))
    return db


def _snowflake_db():
    """tests/test_starjoin.py's TestSnowflake fixture."""
    rng = np.random.default_rng(9)
    nf = 4000
    db = R.Database()
    db.create(R.Table.from_columns("sf", {
        "did": R.column_from_values(R.T.INT4, _ints(rng, nf, 0, 40)),
        "x": R.column_from_values(R.T.FLOAT8,
                                  [float(v) for v in rng.random(nf)]),
    }))
    db.create(R.Table.from_columns("sd", {
        "did": R.column_from_values(R.T.INT4, list(range(40))),
        "regid": R.column_from_values(R.T.INT4, [i % 6 for i in range(40)]),
        "w": R.column_from_values(R.T.INT8, [i * 3 for i in range(40)]),
    }))
    db.create(R.Table.from_columns("sr", {
        "regid": R.column_from_values(R.T.INT4, list(range(6))),
        "rw": R.column_from_values(R.T.INT8, [100 * i for i in range(6)]),
    }))
    db.create(R.Table.from_columns("sr2", {
        "regid": R.column_from_values(R.T.INT4, [i % 6 for i in range(12)]),
        "rw": R.column_from_values(R.T.INT8, list(range(12))),
    }))
    return db


def _recheck_db(seed, nf, bad_row, subdim):
    """A snowflake whose fact carries one NUMERIC value outside the device
    window: that chunk replays on the host tier."""
    rng = np.random.default_rng(seed)
    vals = [Decimal(int(v)) for v in rng.integers(0, 100, nf)]
    vals[bad_row] = Decimal("1E+49")
    db = R.Database()
    db.create(R.Table.from_columns("sf", {
        "did": R.column_from_values(R.T.INT4, _ints(rng, nf, 0, 40)),
        "v": R.column_from_values(R.T.NUMERIC, vals),
    }))
    db.create(R.Table.from_columns("sd", {
        "did": R.column_from_values(R.T.INT4, list(range(40))),
        "regid": R.column_from_values(R.T.INT4, [i % 6 for i in range(40)]),
    }))
    if subdim == "sr":
        db.create(R.Table.from_columns("sr", {
            "regid": R.column_from_values(R.T.INT4, list(range(6))),
            "rw": R.column_from_values(R.T.INT8, [100 * i for i in range(6)]),
        }))
    else:
        db.create(R.Table.from_columns("sr2", {
            "regid": R.column_from_values(R.T.INT4,
                                          [i % 6 for i in range(12)]),
            "rw": R.column_from_values(R.T.INT8, list(range(12))),
        }))
    return db


@pytest.fixture(scope="module")
def dbs():
    db = _star_db()
    return db, from_reference(db)


@pytest.fixture(scope="module")
def sdbs():
    db = _snowflake_db()
    return db, from_reference(db)


def _run(ast, plan_query, Result, sql, db):
    pq = plan_query(ast.parse(sql), db)
    rows = pq.execute()
    res = Result(columns=pq.out_names, rows=rows, types=pq.out_types)
    return res.formatted(-3), dict(pq.perfmon.counts)


def both(dbs, sql, star=True, chunk_rows=None, **cfg):
    """(port rows, port counts) after requiring equality with the
    reference's device run and the port's host-exact tier."""
    rdb, pdb = dbs
    chunk = {} if chunk_rows is None else {"chunk_rows": chunk_rows}
    with R.override(debug_force_offload=True, force_fused_preagg_cpu=True,
                    perfmon=True, **chunk, **cfg):
        want, rc = _run(r_ast, r_plan_query, RResult, sql, rdb)
    with P.override(device="cpu", debug_force_offload=True, perfmon=True,
                    **chunk, **cfg):
        got, pc = _run(p_ast, p_plan_query, PResult, sql, pdb)
    with P.override(device="cpu", enabled=False, **chunk, **cfg):
        host, _ = _run(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want, f"port != reference for {sql}\n{got[:4]}\n{want[:4]}"
    assert got == host, f"device != host for {sql}"
    if star is not None:
        assert (pc.get(STAR, 0) >= 1) == (rc.get(STAR, 0) >= 1) == star, \
            (pc, rc)
    assert {c: pc.get(c, 0) for c in COUNTERS[1:]} == \
        {c: rc.get(c, 0) for c in COUNTERS[1:]}, (pc, rc)
    # device_chunks: one per fact chunk answered on the device (the
    # reference also counts each slice a scatter, sort or ungrouped
    # strategy absorbed)
    if star:
        assert pc.get("device_chunks", 0) + pc.get("recheck_chunks", 0) \
            == pc.get(STAR, 0), pc
        assert pc.get("device_chunks", 0) <= rc.get("device_chunks", 0)
    else:
        assert pc.get("device_chunks", 0) == rc.get("device_chunks", 0)
    assert pc.get("unported_host_exact", 0) == 0
    return got, pc


# name -> (sql, star executor engages)
STAR_CASES = {
    "three_dim_star_group_by_dim_text": (
        "select t1.atext, count(*), sum(t0.x), sum(t2.bval), max(t3.cw) "
        "from t0, t1, t2, t3 where t0.aid = t1.aid and t0.bid = t2.bid "
        "and t0.cid = t3.cid group by t1.atext order by t1.atext", True),
    "null_fact_keys_drop": (
        "select count(*), sum(t0.q) from t0, t1, t2 "
        "where t0.aid = t1.aid and t0.bid = t2.bid", True),
    "fact_side_predicate": (
        "select t1.atext, count(*), min(t0.q) from t0, t1, t2 "
        "where t0.aid = t1.aid and t0.bid = t2.bid and t0.x > 0.5 "
        "group by t1.atext order by t1.atext", True),
    "dim_side_predicate": (
        "select count(*), sum(t0.x) from t0, t1, t3 "
        "where t0.aid = t1.aid and t0.cid = t3.cid and t3.cw < 4", True),
    "group_by_fact_column": (
        "select t0.cid, count(*), sum(t2.bval) from t0, t2, t3 "
        "where t0.bid = t2.bid and t0.cid = t3.cid "
        "group by t0.cid order by t0.cid", True),
    "non_unique_dim_stays_on_device": (
        "select count(*), sum(t0.x) from t0, t1, t2dup "
        "where t0.aid = t1.aid and t0.bid = t2dup.bid", True),
    "non_unique_middle_grouped": (
        "select t1.atext, count(*), sum(t2dup.bval), sum(t0.q) "
        "from t0, t1, t2dup where t0.aid = t1.aid and t0.bid = t2dup.bid "
        "group by t1.atext order by t1.atext", True),
    "multi_key_dim_with_fanout_ladder": (
        "select f2.a, count(*), sum(mk.v), sum(f2.x), max(t3.cw) "
        "from f2, mk, t3 where f2.a = mk.ka and f2.b = mk.kb "
        "and f2.c = t3.cid group by f2.a order by f2.a", True),
    "dim_to_dim_join_not_star": (
        "select count(*) from t0, t1, t2 "
        "where t0.aid = t1.aid and t1.aid = t2.bid", True),
    "having_over_star": (
        "select t1.atext, count(*) from t0, t1, t2 "
        "where t0.aid = t1.aid and t0.bid = t2.bid "
        "group by t1.atext having count(*) > 500 order by t1.atext", True),
    "order_limit_over_star": (
        "select t1.atext, sum(t0.x) from t0, t1, t3 "
        "where t0.aid = t1.aid and t0.cid = t3.cid "
        "group by t1.atext order by sum(t0.x) desc limit 3", True),
    "agg_expr_over_mixed_sides": (
        "select count(*), corr(t0.x, t3.cw) from t0, t1, t3 "
        "where t0.aid = t1.aid and t0.cid = t3.cid", True),
    "multichunk_star": (
        "select t1.atext, count(*), sum(t0.x), sum(t2.bval) "
        "from t0, t1, t2, t3 where t0.aid = t1.aid and t0.bid = t2.bid "
        "and t0.cid = t3.cid group by t1.atext order by t1.atext", True),
}


@pytest.mark.parametrize("name", list(STAR_CASES))
def test_star_matches_reference(dbs, name):
    sql, star = STAR_CASES[name]
    chunk_rows = 1 << 11 if name == "multichunk_star" else None
    got, pc = both(dbs, sql, star, chunk_rows=chunk_rows)
    assert len(got) > 0
    if name == "multi_key_dim_with_fanout_ladder":
        assert pc.get("fanout_retries", 0) >= 1, pc
    if name == "multichunk_star":
        assert pc.get("device_chunks", 0) == 4, pc


def test_explain_single_fused_node(dbs):
    rdb, pdb = dbs
    q = ("select t1.atext, count(*) from t0, t1, t2 "
         "where t0.aid = t1.aid and t0.bid = t2.bid group by t1.atext")
    with R.override(debug_force_offload=True):
        want = r_explain(q, rdb)
    with P.override(device="cpu", debug_force_offload=True):
        got = P.explain(q, pdb)
    assert got == want
    assert "TpuStarJoinAgg" in got and "TpuHashJoin" not in got


def test_explain_analyze_shows_the_star_kernel(dbs):
    _, pdb = dbs
    q = ("select count(*), sum(t0.x) from t0, t1, t2, t3 "
         "where t0.aid = t1.aid and t0.bid = t2.bid and t0.cid = t3.cid")
    with P.override(device="cpu", debug_force_offload=True):
        text = "\n".join(r[0] for r in
                         P.execute("EXPLAIN ANALYZE " + q, pdb).rows)
    assert "TpuStarJoinAgg" in text and "kernel tpustarjoinagg" in text
    assert "device_chunks: 1" in text and "recheck_chunks" not in text
    assert "unported_host_exact" not in text


def test_fanout_past_the_slice_cap_answers_pairwise(dbs):
    """With room for one slice only, the 2x fan-out dimension sends the
    query to the pairwise chain, and its rows still match."""
    got, pc = both(dbs, STAR_CASES["non_unique_dim_stays_on_device"][0],
                   star=False, join_star_max_slices=1)
    assert pc.get("fanout_retries", 0) == 0


def test_star_distinct_agg_declines(dbs):
    """agg(DISTINCT x) over a star: the fused node declines (its agg stage
    has no dedup) and the pairwise chain answers exactly."""
    rdb, pdb = dbs
    q = ("select t1.atext, count(distinct t0.cid), count(*) "
         "from t0, t1, t2 where t0.aid = t1.aid and t0.bid = t2.bid "
         "group by t1.atext order by t1.atext")
    with R.override(debug_force_offload=True, force_fused_preagg_cpu=True):
        want, _ = _run(r_ast, r_plan_query, RResult, q, rdb)
    with P.override(device="cpu", debug_force_offload=True, perfmon=True):
        got, pc = _run(p_ast, p_plan_query, PResult, q, pdb)
    assert got == want
    assert pc.get(STAR, 0) == 0, pc


@pytest.mark.parametrize("sql", [
    "select t1.atext, count(*), sum(t0.x), sum(t2.bval) from t0, t1, t2, t3 "
    "where t0.aid = t1.aid and t0.bid = t2.bid and t0.cid = t3.cid "
    "group by t1.atext order by t1.atext",
    "select count(*), sum(t0.x), sum(t2dup.bval) from t0, t1, t2dup "
    "where t0.aid = t1.aid and t0.bid = t2dup.bid",
], ids=["star_distributes", "non_unique_dim_star_distributes"])
def test_distributed_star_matches_reference(dbs, sql):
    """The star over the mesh: the fact shards over the reference's 8 CPU
    devices and the port's 8-shard mesh, the dimensions replicate, each
    shard runs the fused star function; rows and dist_star_steps equal."""
    rdb, pdb = dbs
    # the reference's K2 under shard_map cannot run in interpret mode on
    # the CPU (Pallas wants `vma` on its outputs), so its shards take its
    # plain mxu reduce; the port's take K2's plain version
    with R.override(debug_force_offload=True, perfmon=True,
                    distributed=True):
        want, rc = _run(r_ast, r_plan_query, RResult, sql, rdb)
    with P.override(device="cpu", debug_force_offload=True, perfmon=True,
                    distributed=True, mesh_shards=8):
        got, pc = _run(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want
    assert pc.get("dist_star_steps", 0) == rc.get("dist_star_steps", 0) \
        == 1, (pc, rc)


def test_repeat_star_ships_zero_bytes(dbs):
    """The second run of a star query over unchanged tables finds every
    fact chunk, dimension plane and hash table resident: it uploads
    nothing."""
    _, pdb = dbs
    q = ("select t1.atext, count(*), sum(t0.x) from t0, t1, t3 "
         "where t0.aid = t1.aid and t0.cid = t3.cid "
         "group by t1.atext order by t1.atext")
    with P.override(device="cpu", debug_force_offload=True, perfmon=True):
        first, _ = _run(p_ast, p_plan_query, PResult, q, pdb)
        pq = p_plan_query(p_ast.parse(q), pdb)
        rows = pq.execute()
    assert PResult(columns=pq.out_names, rows=rows,
                   types=pq.out_types).formatted(-3) == first
    assert pq.perfmon.counts.get(STAR, 0) == 1
    assert pq.perfmon.counts.get("tcache_hits", 0) >= 1
    assert pq.perfmon.bytes.get("h2d", 0) == 0, dict(pq.perfmon.bytes)


SNOWFLAKE = {
    "chain_on_device": (
        "select sr.regid, count(*), sum(sf.x), sum(sd.w), sum(sr.rw) "
        "from sf, sd, sr where sf.did = sd.did and sd.regid = sr.regid "
        "group by sr.regid order by sr.regid"),
    "non_unique_subdim": (
        "select count(*), sum(sr2.rw), sum(sf.x) from sf, sd, sr2 "
        "where sf.did = sd.did and sd.regid = sr2.regid"),
    "group_by_subdim_attr": (
        "select sr.rw, count(*) from sf, sd, sr "
        "where sf.did = sd.did and sd.regid = sr.regid "
        "group by sr.rw order by sr.rw"),
}


@pytest.mark.parametrize("name", list(SNOWFLAKE))
def test_snowflake_matches_reference(sdbs, name):
    both(sdbs, SNOWFLAKE[name])
    if name == "chain_on_device":
        rdb, pdb = sdbs
        with R.override(debug_force_offload=True):
            want = r_explain(SNOWFLAKE[name], rdb)
        with P.override(device="cpu", debug_force_offload=True):
            got = P.explain(SNOWFLAKE[name], pdb)
        assert got == want and "TpuStarJoinAgg" in got


@pytest.mark.parametrize("subdim,seed,nf,bad", [("sr", 11, 500, 137),
                                                ("sr2", 12, 400, 7)],
                         ids=["unique_subdim", "nonunique_subdim"])
def test_snowflake_host_replay_recheck(subdim, seed, nf, bad):
    """A fact chunk with an out-of-window NUMERIC value replays on the host
    tier, which resolves the parent-keyed probe keys (and fans a parent
    match out into its sub-matches)."""
    rdb = _recheck_db(seed, nf, bad, subdim)
    if subdim == "sr":
        q = ("select sr.rw, count(*), sum(sf.v) from sf, sd, sr "
             "where sf.did = sd.did and sd.regid = sr.regid "
             "group by sr.rw order by sr.rw")
    else:
        q = ("select count(*), sum(sr2.rw), sum(sf.v) from sf, sd, sr2 "
             "where sf.did = sd.did and sd.regid = sr2.regid")
    # one chunk, replayed before any device call
    _, pc = both((rdb, from_reference(rdb)), q, star=None)
    assert pc.get("cpu_fallback", 0) == 1, pc
    assert pc.get("device_chunks", 0) == 0, pc


# ---------------------------------------------------------------------------
# op level: build_star_join_preagg_fn against the reference's
# ---------------------------------------------------------------------------

def _compare_outputs(ro, po):
    assert set(ro) == set(po), (set(ro), set(po))
    for k in ro:
        if k == "slots":
            for rd, pd in zip(ro[k], po[k]):
                assert set(rd) == set(pd)
                for kk in rd:
                    a, b = np.asarray(rd[kk]), np.asarray(pd[kk])
                    if a.dtype.kind == "f":
                        np.testing.assert_allclose(b, a, rtol=1e-13)
                    else:
                        assert np.array_equal(a, b), kk
        elif k == "keys":
            for rk, pk in zip(ro[k], po[k]):
                for a, b in zip(rk, pk):
                    assert np.array_equal(np.asarray(a), np.asarray(b))
        else:
            assert np.array_equal(np.asarray(ro[k]), np.asarray(po[k])), k


def _op_side(pkg, db, dims, fact, refs, groups, aggs, strategy):
    """One package's star function and its inputs over `db`: dims are
    (table, fact key, dim key, mode, fanout)."""
    import importlib
    name = pkg.__name__
    ir = importlib.import_module(f"{name}.expr.ir")
    hj = importlib.import_module(f"{name}.ops.hashjoin")
    sj = importlib.import_module(f"{name}.ops.starjoin")
    pre = importlib.import_module(f"{name}.ops.preagg")
    if name == "pg_strom_tpu":
        lw = importlib.import_module(f"{name}.expr.lower_jax")
        conv = jax.numpy.asarray
    else:
        lw = importlib.import_module(f"{name}.expr.lower_torch")
        conv = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    T = pkg.T
    ft = db.get(fact)
    pnames = ft.column_names
    pschema = lw.schema_from_chunk_columns(
        pnames, [ft.columns[n] for n in pnames])
    pcols = tuple(tuple(conv(p) for p in lw.planes_of_column(ft.columns[n]))
                  for n in pnames)

    def col(t, nm):
        tb = db.get(t)
        return ir.ColumnRef(type=tb.columns[nm].type, name=nm,
                            index=tb.column_names.index(nm))

    hts, bplanes, specs = [], [], []
    for dt, fk, dk, mode, fan in dims:
        tb = db.get(dt)
        bschema = lw.schema_from_chunk_columns(
            tb.column_names, [tb.columns[n] for n in tb.column_names])
        rb = max(tb.nrows, 1).bit_length()
        planes = tuple(tuple(conv(p) for p in lw.planes_of_column(
            tb.columns[n])) for n in tb.column_names)
        bfn = hj.build_hash_table(bschema, [col(dt, dk)], None, row_bits=rb)
        ht = (jax.jit(bfn)(planes, np.int32(tb.nrows))
              if name == "pg_strom_tpu" else bfn(planes, tb.nrows))
        bcap = tb.nrows
        if mode == "dense":
            ident = bool(ht["dense_ident"])
            mxu = not ident and bool(ht["dense_m_ok"])
            specs.append({"mode": "dense", "probe_keys": [col(fact, fk)],
                          "dense_cap": (hj.mxu_dense_window(bcap) if mxu
                                        else hj.dense_cap_for(bcap)),
                          "use_mxu": mxu, "use_ident": ident,
                          "row_bits": rb})
        else:
            specs.append({"mode": "multi", "probe_keys": [col(fact, fk)],
                          "key_types": (T.INT4,), "max_chain": 8,
                          "fanout": fan})
        hts.append(ht)
        bplanes.append(planes)
    jnames = [c for c in refs]
    jl = {c: i for i, c in enumerate(jnames)}
    jsrc, probe_slots, bmap = [], [], {}
    for j, (t, c) in enumerate(jnames):
        tb = db.get(t)
        jsrc.append(tb.columns[c])
        if t == fact:
            probe_slots.append(tb.column_names.index(c))
        else:
            probe_slots.append(-1)
            di = [d[0] for d in dims].index(t)
            bmap[j] = (di, tb.column_names.index(c))
    jschema = lw.schema_from_chunk_columns([c for _, c in jnames], jsrc)

    def jref(t, c):
        return ir.ColumnRef(type=db.get(t).columns[c].type, name=c,
                            index=jl[(t, c)])
    gs = [jref(*g) for g in groups]
    insts = []
    for an, arg in aggs:
        args = (jref(*arg),) if arg else ()
        d, fam = pre.lookup_agg(an, tuple(a.type for a in args))
        insts.append(pre.AggInstance(aggname=an, family=fam, slots=d.slots,
                                     args=args))
    fn = sj.build_star_join_preagg_fn(pschema, specs, None, jschema,
                                      probe_slots, bmap, gs, insts, 64,
                                      strategy)
    args = (tuple(hts), pcols, tuple(bplanes))
    if name == "pg_strom_tpu":
        return jax.device_get(jax.jit(fn)(*args, np.int32(ft.nrows),
                                          np.uint64(0)))
    from pg_strom_tpu_torch.exec.devcache import fetch_host
    return fetch_host(fn(*args, ft.nrows, 0))


@pytest.mark.parametrize("strategy,groups", [
    ("scatter", [("t0", "cid")]), ("scatter", []),
    ("sort", [("t0", "cid")])])
def test_star_fn_slices_match_reference(dbs, strategy, groups):
    """Identity (t1), K3-or-gather (t3 reversed: unique, not serial) and a
    2x fan-out multi probe (t2dup, two slices): every slice's preagg dict
    equals the reference's, and so does join_ovf."""
    rdb, _ = dbs
    rdb2 = R.Database()
    for nm in ("t0", "t1", "t2dup"):
        rdb2.create(rdb.get(nm))
    rdb2.create(R.Table.from_columns("t3r", {
        "cid": R.column_from_values(R.T.INT4, list(range(24, -1, -1))),
        "cw": R.column_from_values(R.T.FLOAT8,
                                   [i * 0.5 for i in range(25)])}))
    pdb2 = from_reference(rdb2)
    dims = [("t1", "aid", "aid", "dense", 1),
            ("t3r", "cid", "cid", "dense", 1),
            ("t2dup", "bid", "bid", "multi", 2)]
    refs = [("t0", "x"), ("t0", "cid"), ("t2dup", "bval"), ("t3r", "cw")]
    aggs = [("count", None), ("sum", ("t0", "x")), ("sum", ("t2dup", "bval")),
            ("max", ("t3r", "cw"))]
    with R.override(force_fused_preagg_cpu=True):
        ro = _op_side(R, rdb2, dims, "t0", refs, groups, aggs, strategy)
    with P.override(device="cpu"):
        po = _op_side(P, pdb2, dims, "t0", refs, groups, aggs, strategy)
    assert bool(po["join_ovf"]) == bool(ro["join_ovf"]) is False
    assert len(po["slices"]) == len(ro["slices"]) == 2
    for rs, ps in zip(ro["slices"], po["slices"]):
        _compare_outputs(rs, ps)
