"""K5, the one-pass dense join under a scalar aggregate
(pg_strom_tpu_torch/ops/joinagg_scalar.py), through SQL on the CPU.

Each case runs the port's planner three ways on the same tables: with K5
(its plain PyTorch version here), with K5 declined (ops/joinagg.py's dense
branch, the path K5 replaces) and on the port's host-exact tier; and the
JAX reference's planner on its CPU backend.  All four must give the same
rows as PostgreSQL text, or raise the same error.  The
`joinagg_scalar_chunks` counter says whether K5 ran: on every device
chunk for the shapes inside its envelope, never for a GROUP BY, a float
sum, a build-side argument or a non-dense build.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import Database as RDatabase
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.exec import joinagg_exec
from pg_strom_tpu_torch.exec.devcache import TCACHE
from pg_strom_tpu_torch.ops import joinagg_scalar as js
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult

N = 3000
CHUNK = 512          # 3000 rows: five full chunks and one of 440 rows


@pytest.fixture(scope="module")
def dbs():
    """fact: NULLs in the key (and keys no dimension holds), in a
    predicate column and in an int2 argument; `big` is 60000 on the rows
    of tag 1, whose square leaves int4.  dim: the keys 0..49 shuffled (K3's
    table); sdim: 0..49 in order (the identity)."""
    rng = np.random.default_rng(16)
    k = [int(v) if v < 53 else None for v in rng.integers(0, 56, N)]
    tag = [int(v < 0.01) for v in rng.random(N)]
    tag[7], k[7] = 1, 3                  # a tag-1 row that joins
    d = RDatabase()
    d.create(R.Table.from_columns("fact", {
        "k": R.column_from_values(R.T.INT4, k),
        "a": R.column_from_values(R.T.INT4, [
            int(v) if v < 90 else None for v in rng.integers(0, 100, N)]),
        "b": R.column_from_values(R.T.INT4,
                                  [int(v) for v in rng.integers(0, 10, N)]),
        "s": R.column_from_values(R.T.INT2, [
            int(v) if abs(v) < 280 else None
            for v in rng.integers(-300, 301, N)]),
        "s2": R.column_from_values(R.T.INT2,
                                   [int(v) for v in rng.integers(-99, 100, N)]),
        "x": R.column_from_values(R.T.FLOAT4,
                                  [float(v) for v in rng.random(N)]),
        "tag": R.column_from_values(R.T.INT4, tag),
        "big": R.column_from_values(R.T.INT4,
                                    [60000 if t else 5 for t in tag]),
    }))
    keys = rng.permutation(50)
    d.create(R.Table.from_columns("dim", {
        "k": R.column_from_values(R.T.INT4, [int(v) for v in keys]),
        "w": R.column_from_values(R.T.INT4, [int(v) * 3 - 40 for v in keys]),
        "y": R.column_from_values(R.T.INT4,
                                  [1990 + int(v) % 7 for v in keys]),
    }))
    d.create(R.Table.from_columns("sdim", {
        "k": R.column_from_values(R.T.INT4, list(range(50))),
        "w": R.column_from_values(R.T.INT4, [i % 9 for i in range(50)]),
    }))
    return d, from_reference(d)


_JOIN = "from fact join dim on fact.k = dim.k"
# name -> (sql, port config, K5 runs)
CASES = {
    "q1_1_shape": (
        f"select sum(fact.a * fact.b) {_JOIN} where dim.y = 1993 "
        "and fact.b between 2 and 5 and fact.a < 60", {}, True),
    "between": (
        f"select sum(fact.a * fact.b), count(*) {_JOIN} "
        "where fact.b between 2 and 5", {}, True),
    "less_than": (f"select sum(fact.b) {_JOIN} where fact.a < 30", {}, True),
    "or": (f"select count(*), sum(fact.a) {_JOIN} "
           "where fact.a < 10 or fact.b > 7", {}, True),
    "not": (f"select count(*), sum(fact.a + fact.b) {_JOIN} "
            "where not (fact.a < 50)", {}, True),
    "is_null": (f"select count(*), count(fact.s), sum(fact.b) {_JOIN} "
                "where fact.a is null", {}, True),
    "is_not_null_or": (f"select count(*), sum(fact.s) {_JOIN} "
                       "where fact.s is not null or fact.a > 80", {}, True),
    "nulls_in_key_pred_arg": (
        f"select count(*), count(fact.a), count(fact.s), sum(fact.s), "
        f"sum(fact.a - fact.b) {_JOIN} where fact.a > 20", {}, True),
    "counts_and_sums": (
        f"select count(*), count(fact.a), sum(fact.s + fact.s2), "
        f"sum(fact.a - 3 * fact.b), avg(fact.a), sum(fact.s * fact.s2) "
        f"{_JOIN}", {}, True),
    "int2_widened": (f"select sum(fact.s + fact.a), sum(fact.s2) {_JOIN} "
                     "where fact.b <> 4", {}, True),
    "int4_overflow_on_joined_row": (
        f"select sum(fact.big * fact.big) {_JOIN} where fact.tag = 1",
        {}, True),
    "int2_overflow_on_joined_row": (
        f"select sum(fact.s * fact.s) {_JOIN}", {}, True),
    "overflow_only_on_filtered_rows": (
        f"select sum(fact.big * fact.big), count(*) {_JOIN} "
        "where fact.tag = 0", {}, True),
    "ranges_merged_flipped_nullable": (
        f"select count(*), sum(fact.a) {_JOIN} where 2 <= fact.b "
        "and fact.b <= 6 and fact.b < 5 and 40 > fact.a and 7 = dim.y % 9 "
        "and fact.a <> 17", {}, True),
    "ranges_empty_intersection": (
        f"select count(*), sum(fact.b) {_JOIN} where fact.b > 5 "
        "and fact.b < 3", {}, True),
    "no_matches": (f"select sum(fact.a), count(*), count(fact.a) {_JOIN} "
                   "where fact.a > 1000", {}, True),
    "count_star_only": (f"select count(*) {_JOIN}", {}, True),
    "identity_build": (
        "select count(*), sum(fact.a * fact.b) from fact join sdim "
        "on fact.k = sdim.k where fact.b < 8", {}, True),
    "plain_table_build": (
        f"select count(*), sum(fact.a * fact.b) {_JOIN} where dim.w > 0",
        {"join_mxu_lookup": False}, True),
    "empty_filtered_build": (
        f"select sum(fact.a), count(*) {_JOIN} where dim.w > 100000",
        {}, False),
    "group_by_keeps_dense_branch": (
        f"select fact.b, count(*), sum(fact.a) {_JOIN} group by fact.b "
        "order by fact.b", {}, False),
    "float_sum_keeps_dense_branch": (
        f"select count(*), sum(fact.x) {_JOIN}", {}, False),
    "build_arg_keeps_dense_branch": (
        f"select count(*), sum(dim.w) {_JOIN}", {}, False),
}


def _run(ast, plan_query, Result, sql, db):
    """(rows as text, counters), or (the error message, None)."""
    try:
        pq = plan_query(ast.parse(sql), db)
        rows = pq.execute()
    except (R.errors.SqlError, P.errors.SqlError) as e:
        return str(e), None
    res = Result(columns=pq.out_names, rows=rows, types=pq.out_types)
    return res.formatted(-3), dict(pq.perfmon.counts)


@pytest.mark.parametrize("name", list(CASES))
def test_k5_matches_dense_branch_and_reference(dbs, name, monkeypatch):
    sql, cfg, k5 = CASES[name]
    rdb, pdb = dbs
    with R.override(enabled=True, chunk_rows=CHUNK,
                    force_fused_preagg_cpu=True, perfmon=True, **cfg):
        want, _ = _run(r_ast, r_plan_query, RResult, sql, rdb)
    port = dict(device="cpu", debug_force_offload=True, perfmon=True,
                chunk_rows=CHUNK, **cfg)
    with P.override(**port):
        got, pc = _run(p_ast, p_plan_query, PResult, sql, pdb)
    with P.override(device="cpu", enabled=False, chunk_rows=CHUNK, **cfg):
        host, _ = _run(p_ast, p_plan_query, PResult, sql, pdb)
    with monkeypatch.context() as mp:
        mp.setattr(joinagg_exec, "scalar_program", lambda *a, **k: None)
        TCACHE.clear()           # drops the K5 launch plans made above
        with P.override(**port):
            dense, dc = _run(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want, f"port != reference for {sql}\n{got}\n{want}"
    assert got == host and got == dense, (got, host, dense)
    if "overflow_on_joined_row" in name:
        assert pc is None and "out of range" in got, got
        return
    assert pc.get("unported_host_exact", 0) == 0
    assert dc.get("joinagg_scalar_chunks", 0) == 0, dc
    chunks = pc.get("joinagg_scalar_chunks", 0)
    if k5:
        assert chunks == -(-N // CHUNK) == pc.get("device_chunks"), pc
        assert pc.get("recheck_chunks", 0) == 0, pc
    else:
        assert chunks == 0, pc


def test_k5_twin_nrows_and_overflow_lane():
    """The plain version alone: rows at or past nrows never count (their
    keys join and their product overflows), an overflow on a row the
    predicate drops sets no error, one on a joined row sets
    ERR_INT4_OVERFLOW; the output is (err, count(*), count, sum)."""
    from pg_strom_tpu_torch.errors import ERR_INT4_OVERFLOW
    from pg_strom_tpu_torch.expr.ir import ColumnRef, Const, FuncExpr
    from pg_strom_tpu_torch.expr.lower_torch import ColMeta
    from pg_strom_tpu_torch.ops.preagg import AggInstance
    from pg_strom_tpu_torch.sqltypes import T
    schema = [ColMeta("k", T.INT4), ColMeta("v", T.INT4)]
    k, v = ColumnRef(T.INT4, "k", 0), ColumnRef(T.INT4, "v", 1)
    sq = FuncExpr(T.INT4, "*::int4,int4", (v, v))

    def program(op, c):
        return js.scalar_program(
            schema, [k], FuncExpr(T.BOOL, f"{op}::int4,int4",
                                  (v, Const(T.INT4, c))),
            [AggInstance("sum", "i4", ("count", "sum_i"), (sq,))], [0, 1],
            lambda i: False)

    bits = torch.zeros(32, dtype=torch.int32)
    bits[0] = 0b1010                      # build keys 11 and 13 (kmin 10)
    member = {"bits": bits, "kmin": 10, "dcap": 1024}
    kk = torch.tensor([11, 12, 13, 13, 11, 11], dtype=torch.int32)
    vv = torch.tensor([3, 4, 5, 50000, 7, 60000], dtype=torch.int32)
    prog = program("<", 1000)             # drops the row of 50000
    assert prog is not None and prog.n_args == 1
    assert js.joinagg_scalar(prog, [kk, vv], member, 4).tolist() == \
        [0, 2, 2, 9 + 25]
    out = js.joinagg_scalar(program(">", 0), [kk, vv], member, 4)
    assert out[0].item() == ERR_INT4_OVERFLOW and out[1].item() == 3
    assert js.joinagg_scalar(prog, [kk, vv], member, 0).tolist() == [0] * 4


@pytest.mark.parametrize("name", ["q1_1", "q1_1_plain", "qty_identity"])
def test_chip_smoke_q1_1_phase_on_cpu(name):
    """chip_smoke.py's phase 4a at 4196 rows in five chunks: the answer
    against numpy int64, every chunk on K5's plain version and the
    membership table built from the dense variant the phase expects."""
    import chip_smoke as cs
    db, c = cs.q11_db(16, 4096 + 100)
    with P.override(device="cpu", debug_force_offload=True, chunk_rows=1024):
        r = cs.q11_run(db, name, c, 5, 2)
    assert r["variant"] == cs.Q11_CASES[name][2]
    assert r["launches"] == [0, 0] and r["rows"] == cs.q11_expected(name, c)


# ---------------------------------------------------------------------------
# K5's launch plan: one per query shape, reused across constants
# ---------------------------------------------------------------------------

_PLAN_SQL = ("select sum(fact.a * fact.b), count(*) " + _JOIN +
             " where dim.y = {y} and fact.b between {lo} and {hi} "
             "and fact.a < {amax}")
# name -> the constants (d.y, lo, hi, amax) one shape runs with, in turn
PLAN_CONSTS = {
    "probe_ranges": [(1993, 2, 5, 60), (1993, 0, 3, 90), (1993, 4, 9, 25),
                     (1993, 6, 6, 100)],
    "build_constants": [(1990, 2, 5, 60), (1993, 2, 5, 60),
                        (1996, 2, 5, 60), (1991, 2, 5, 60)],
    "both": [(1992, 1, 4, 45), (1995, 3, 8, 70), (1990, 0, 9, 10),
             (1994, 5, 5, 95)],
    # an empty `between` keeps a clause in the predicate program: that
    # query lowers its own program through the executor's first-query
    # code, the next hits the plan again
    "empty_between": [(1993, 2, 5, 60), (1993, 5, 3, 60), (1993, 1, 8, 30)],
}
_PORT = dict(device="cpu", debug_force_offload=True, perfmon=True,
             chunk_rows=CHUNK)
NCHUNKS = -(-N // CHUNK)


def _port(sql, pdb, **cfg):
    with P.override(**_PORT, **cfg):
        return _run(p_ast, p_plan_query, PResult, sql, pdb)


def _host(sql, pdb, **cfg):
    with P.override(device="cpu", enabled=False, chunk_rows=CHUNK, **cfg):
        return _run(p_ast, p_plan_query, PResult, sql, pdb)[0]


def _reference(sql, rdb, **cfg):
    with R.override(enabled=True, chunk_rows=CHUNK,
                    force_fused_preagg_cpu=True, **cfg):
        return _run(r_ast, r_plan_query, RResult, sql, rdb)[0]


@pytest.mark.parametrize("name", list(PLAN_CONSTS))
def test_k5_launch_plan_serves_new_constants(dbs, name, monkeypatch):
    """One shape, new constants each query, two rounds: the first query
    makes the plan (`k5_plan_builds` 1, once in all); every later query
    hits it and lowers no program where its build constants were seen
    before and its ranges lower as the plan's do; every query reads the
    device once (`d2h_reads`); every answer equals the host-exact tier's
    and the JAX reference's."""
    rdb, pdb = dbs
    TCACHE.clear()
    consts = PLAN_CONSTS[name]
    sqls = [_PLAN_SQL.format(y=y, lo=lo, hi=hi, amax=amax)
            for y, lo, hi, amax in consts]
    lowered = []
    real = joinagg_exec.scalar_program
    monkeypatch.setattr(joinagg_exec, "scalar_program",
                        lambda *a: lowered.append(1) or real(*a))
    counts = []
    for rnd in range(2):
        for i, sql in enumerate(sqls):
            del lowered[:]
            got, pc = _port(sql, pdb)
            if pc.get("k5_plan_hits"):
                assert not lowered, sql
            assert pc.get("d2h_reads") == 1, (sql, pc)
            assert got == _host(sql, pdb), sql
            if rnd == 0:
                assert got == _reference(sql, rdb), sql
            assert pc.get("joinagg_scalar_chunks") == NCHUNKS, pc
            assert pc.get("recheck_chunks", 0) == 0, pc
            counts.append(pc)
    assert counts[0].get("k5_plan_builds") == 1
    assert sum(c.get("k5_plan_builds", 0) for c in counts) == 1
    for i, pc in enumerate(counts):
        y, lo, hi, _ = consts[i % len(sqls)]
        seen = i >= len(sqls) or y in {c[0] for c in consts[:i]}
        assert pc.get("k5_plan_hits", 0) == int(seen and lo <= hi), (i, pc)


# (targets, predicate clause) of two queries of one shape but for a
# constant that K5 reads outside a range: in an argument, or in a clause
OTHER_CONSTS = {
    "merged_args": [("sum(fact.a + 1), sum(fact.a + 2)", ""),
                    ("sum(fact.a + 1), sum(fact.a + 1)", "")],
    "pred_clause": [("count(*), sum(fact.b)", " and fact.a <> 17"),
                    ("count(*), sum(fact.b)", " and fact.a <> 40")],
}


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("name", list(OTHER_CONSTS))
def test_k5_launch_plan_keeps_other_constants(dbs, name, first):
    """Two queries that differ only in a constant K5 reads outside a
    range (two arguments that lower to one where their constants are
    equal, or a predicate clause's constant), in either order, twice:
    each makes a plan of its own (`k5_plan_builds` 1) and hits it the
    second time, and every answer equals the host-exact tier's and the
    JAX reference's."""
    rdb, pdb = dbs
    TCACHE.clear()
    sqls = [f"select {t} {_JOIN} where dim.y = 1992{c}"
            for t, c in OTHER_CONSTS[name]]
    if first:
        sqls.reverse()
    for rnd in range(2):
        for sql in sqls:
            want = _host(sql, pdb)
            if rnd == 0:
                assert want == _reference(sql, rdb), sql
            got, pc = _port(sql, pdb)
            assert got == want, (sql, got, want)
            assert pc.get("k5_plan_builds", 0) == 1 - rnd, (sql, pc)
            assert pc.get("k5_plan_hits", 0) == rnd, (sql, pc)
            assert pc.get("joinagg_scalar_chunks") == NCHUNKS, pc
            assert pc.get("d2h_reads") == 1, pc


def _fact_anew(rdb, pdb):
    """pdb with the fact table replaced: the same values, new columns."""
    db = P.Database()
    db.create(pdb.get("dim"))
    db.create(from_reference(rdb.tables["fact"]))
    return db


@pytest.mark.parametrize("event", ["cache_cleared", "budget_eviction",
                                   "table_replaced", "join_mxu_lookup"])
def test_k5_launch_plan_rebuilt_after(dbs, event):
    """After each event the next query makes the plan anew
    (`k5_plan_builds` 1, no hit), the one after hits it, and both answer
    as the host-exact tier."""
    rdb, pdb = dbs
    cfg = {"tcache_size_mb": 1} if event == "budget_eviction" else {}
    TCACHE.clear()
    sql = _PLAN_SQL.format(y=1993, lo=2, hi=5, amax=60)
    want = _host(sql, pdb)
    _port(sql, pdb, **cfg)
    got, pc = _port(sql, pdb, **cfg)
    assert got == want and pc.get("k5_plan_hits") == 1, pc
    db = pdb
    if event == "cache_cleared":
        TCACHE.clear()
    elif event == "budget_eviction":
        # a table of about 0.95 MiB of planes: fits the 1 MiB budget
        # alone, not beside the fact table's chunks
        filler = P.Table.from_columns("filler", {"v": P.column_from_numpy(
            P.T.INT4, np.arange(200_000, dtype=np.int32))})
        evictions = TCACHE.evictions
        db = P.Database()
        for t in ("fact", "dim"):
            db.create(pdb.get(t))
        db.create(filler)
        _port("select count(*), sum(v) from filler where v > 5", db, **cfg)
        assert TCACHE.evictions > evictions
    elif event == "table_replaced":
        db = _fact_anew(rdb, pdb)
    else:
        cfg = {"join_mxu_lookup": False}
    got, pc = _port(sql, db, **cfg)
    assert got == want, (got, want)
    assert pc.get("k5_plan_builds") == 1 and "k5_plan_hits" not in pc, pc
    got, pc = _port(sql, db, **cfg)
    assert got == want and pc.get("k5_plan_hits") == 1, pc
    assert pc.get("d2h_reads") == 1, pc


def _replays(monkeypatch) -> list:
    """The start rows of the chunks the host replays, from now on."""
    starts: list = []
    real = joinagg_exec.JoinPreAggExecutor._host_chunk_agg

    def spy(self, cc, *args):
        starts.append(cc.start)
        return real(self, cc, *args)
    monkeypatch.setattr(joinagg_exec.JoinPreAggExecutor, "_host_chunk_agg",
                        spy)
    return starts


def test_k5_launch_plan_replays_an_err_chunk_alone(dbs, monkeypatch):
    """A row of the shared buffer with its err lane set (here forced on
    the last chunk) replays that chunk alone on the host; the other
    chunks' rows are absorbed from the buffer, and the answer is exact."""
    from pg_strom_tpu_torch.errors import ERR_INT4_OVERFLOW
    rdb, pdb = dbs
    TCACHE.clear()
    sql = _PLAN_SQL.format(y=1994, lo=1, hi=6, amax=70)
    want = _host(sql, pdb)
    _port(sql, pdb)
    real = js.joinagg_scalar_reference
    last = N - (NCHUNKS - 1) * CHUNK

    def err_on_last(prog, planes, member, nrows):
        out = real(prog, planes, member, nrows)
        if nrows == last:
            out[0] = ERR_INT4_OVERFLOW
        return out
    monkeypatch.setattr(js, "joinagg_scalar_reference", err_on_last)
    starts = _replays(monkeypatch)
    got, pc = _port(sql, pdb)
    assert got == want, (got, want)
    assert starts == [(NCHUNKS - 1) * CHUNK], starts
    assert pc.get("k5_plan_hits") == 1 and pc.get("d2h_reads") == 1, pc
    assert pc.get("recheck_chunks") == 1, pc
    assert pc.get("device_chunks") == NCHUNKS - 1, pc


def test_k5_launch_plan_overflow_raises_as_the_host(dbs, monkeypatch):
    """The fixture's int4 overflow (big * big on tag 1) met on a planned
    query: the first chunk whose row sets ERR_INT4_OVERFLOW replays
    alone and raises PostgreSQL's error, as the host tier and the
    reference do."""
    rdb, pdb = dbs
    TCACHE.clear()
    sql = "select sum(fact.big * fact.big) " + _JOIN + " where fact.tag = {}"
    got, pc = _port(sql.format(0), pdb)
    assert pc.get("k5_plan_builds") == 1, pc
    starts = _replays(monkeypatch)
    got, _ = _port(sql.format(1), pdb)
    assert "out of range" in got
    assert got == _host(sql.format(1), pdb) == _reference(sql.format(1), rdb)
    assert starts == [0], starts          # row 7: tag 1, joins key 3


@pytest.fixture(scope="module")
def recheck_dbs(dbs):
    """dbs with a numeric column on the fact table whose one value past
    the device's int64 mantissa (row 2700, in the last chunk) makes that
    chunk replay on the host."""
    from decimal import Decimal
    rdb, _ = dbs
    cols = dict(rdb.tables["fact"].columns)
    cols["n"] = R.column_from_values(R.T.NUMERIC, [
        Decimal("123456789012345678901234567890.5") if i == 2700
        else Decimal(i) for i in range(N)])
    d = RDatabase()
    d.create(R.Table.from_columns("fact", cols))
    d.create(rdb.tables["dim"])
    return d, from_reference(d)


def test_k5_launch_plan_replays_a_recheck_chunk(recheck_dbs, monkeypatch):
    """A chunk that needs the host (recheck_any) is in no parameter block:
    each planned query replays it alone and K5 runs the others."""
    rdb, pdb = recheck_dbs
    TCACHE.clear()
    sql = _PLAN_SQL.format(y=1995, lo=0, hi=7, amax=80)
    want = _host(sql, pdb)
    assert want == _reference(sql, rdb)
    got, pc = _port(sql, pdb)
    assert got == want and pc.get("k5_plan_builds") == 1, pc
    starts = _replays(monkeypatch)
    got, pc = _port(sql, pdb)
    assert got == want, (got, want)
    assert starts == [(NCHUNKS - 1) * CHUNK], starts
    assert pc.get("k5_plan_hits") == 1 and pc.get("d2h_reads") == 1, pc
    assert pc.get("joinagg_scalar_chunks") == NCHUNKS - 1, pc
    assert pc.get("device_chunks") == NCHUNKS - 1, pc


def test_k5_ranges_written_alone_match_a_full_parameter():
    """The parameter block of a plan whose query changed only range
    constants (ranges written alone) is byte for byte the one k5_args
    makes from the new program."""
    import dataclasses
    from pg_strom_tpu_torch.expr.ir import BoolExpr, ColumnRef, Const, FuncExpr
    from pg_strom_tpu_torch.expr.lower_torch import ColMeta
    from pg_strom_tpu_torch.ops.preagg import AggInstance
    from pg_strom_tpu_torch.sqltypes import T
    schema = [ColMeta("k", T.INT4), ColMeta("v", T.INT4)]
    k, v = ColumnRef(T.INT4, "k", 0), ColumnRef(T.INT4, "v", 1)

    def program(lo, hi):
        pred = BoolExpr(T.BOOL, "and", (
            FuncExpr(T.BOOL, ">=::int4,int4", (v, Const(T.INT4, lo))),
            FuncExpr(T.BOOL, "<::int4,int4", (v, Const(T.INT4, hi))),
            FuncExpr(T.BOOL, "<=::int4,int4", (k, Const(T.INT4, 60)))))
        return js.scalar_program(
            schema, [k], pred,
            [AggInstance("sum", "i4", ("count", "sum_i"), (v,))], [0, 1],
            lambda i: False)
    member = {"bits": torch.zeros(32, dtype=torch.int32), "kmin": 10,
              "dcap": 1024}
    p0, p1 = program(-5, 40), program(3, 1 << 30)
    a = js.k5_args(p0, member)
    js._set_ranges(a, dataclasses.replace(p0, ranges=p1.ranges).ranges)
    assert p1.ranges.tolist() != p0.ranges.tolist()
    assert bytes(a) == bytes(js.k5_args(p1, member))


def test_chip_smoke_k5_batch_on_cpu():
    """chip_smoke.py's K5Batch steps on CPU planes (the plain version runs
    each chunk): the steps, their programs and their membership tables."""
    import chip_smoke as cs
    assert cs.k5_batch_compare(np.random.default_rng(13), 4100,
                               torch.device("cpu")) == 4
