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
