"""The fused join->aggregate (pg_strom_tpu_torch/ops/joinagg.py,
exec/joinagg_exec.py) against the JAX reference; mirrors
tests/test_joinagg.py case for case.

Each query runs through the planner in both packages on the same tables
(built in the reference, carried over with `from_reference`), on the
device path: the reference on the CPU backend with
force_fused_preagg_cpu (so that both take K2 for grouped plans — the
reference in Pallas interpret mode, the port through its plain version),
the port on device="cpu".  Rows must be equal as PostgreSQL text at
extra_float_digits=-3, and the perfmon counters of the retry ladder equal
case for case.  The port must also agree with its own host-exact tier.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import pytest

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import Database as RDatabase
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query

COUNTERS = ("device_chunks", "salt_retries", "sort_fallbacks",
            "recheck_chunks", "regrow_retries", "dense_fallbacks")


@pytest.fixture(scope="module")
def dbs():
    """tests/test_joinagg.py's fixture: fact with NULL keys, a unique dim
    with text labels, and an 8x fan-out dimension."""
    rng = np.random.default_rng(42)
    n = 3000
    d = RDatabase()
    d.create(R.Table.from_columns("fact", {
        "k": R.column_from_values(R.T.INT4, [
            int(v) if v < 45 else None for v in rng.integers(0, 50, n)]),
        "g": R.column_from_values(R.T.INT4,
                                  [int(v) for v in rng.integers(0, 6, n)]),
        "x": R.column_from_values(R.T.FLOAT4, [
            float(v) if v > 0.05 else None for v in rng.random(n)]),
        "y": R.column_from_values(R.T.INT8,
                                  [int(v) for v in rng.integers(-20, 20, n)]),
        "num": R.column_from_values(R.T.NUMERIC, [
            None if v < 0.1 else Decimal(f"{v * 10:.2f}")
            for v in rng.random(n)]),
    }))
    d.create(R.Table.from_columns("dim", {
        "k": R.column_from_values(R.T.INT4, list(range(50))),
        "w": R.column_from_values(R.T.INT8, [7 * i - 100 for i in range(50)]),
        "lab": R.column_from_values(R.T.TEXT, [f"lab{i % 4}"
                                               for i in range(50)]),
    }))
    d.create(R.Table.from_columns("fan", {
        "k": R.column_from_values(R.T.INT4, [i % 50 for i in range(400)]),
        "v": R.column_from_values(R.T.INT4, list(range(400))),
    }))
    return d, from_reference(d)


@pytest.fixture(scope="module", autouse=True)
def _leave_reference_memo_as_found():
    """tests/test_joinagg.py tells which path ran from the growth of the
    reference executor's program memo; this module builds the same
    programs on the same tables, so that, run first in one worker, it
    would hide that growth.  It removes the entries it added."""
    from pg_strom_tpu.exec import joinagg_exec as r_joinagg
    before = set(r_joinagg._JIT_CACHE)
    yield
    for key in set(r_joinagg._JIT_CACHE) - before:
        del r_joinagg._JIT_CACHE[key]


def _run(ast, plan_query, Result, sql, db):
    pq = plan_query(ast.parse(sql), db)
    rows = pq.execute()
    res = Result(columns=pq.out_names, rows=rows, types=pq.out_types)
    return res.formatted(-3), dict(pq.perfmon.counts)


def both(dbs, sql, chunk_rows=512, **cfg):
    """(port rows, port counts) after requiring equality with the
    reference's device run and with the port's host-exact tier."""
    rdb, pdb = dbs
    with R.override(enabled=True, chunk_rows=chunk_rows,
                    force_fused_preagg_cpu=True, perfmon=True, **cfg):
        want, rc = _run(r_ast, r_plan_query, RResult, sql, rdb)
    with P.override(device="cpu", debug_force_offload=True, perfmon=True,
                    chunk_rows=chunk_rows, **cfg):
        got, pc = _run(p_ast, p_plan_query, PResult, sql, pdb)
    with P.override(device="cpu", enabled=False, chunk_rows=chunk_rows,
                    **cfg):
        host, _ = _run(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want, f"port != reference for {sql}\n{got[:4]}\n{want[:4]}"
    assert got == host, f"device != host for {sql}"
    assert {c: pc.get(c, 0) for c in COUNTERS} == \
        {c: rc.get(c, 0) for c in COUNTERS}, (pc, rc)
    assert pc.get("unported_host_exact", 0) == 0
    return got, pc


FUSED = "kernel tpujoinagg"
PREGROUPED = "kernel tpujoinagg_pregrouped"

# name -> (sql, config overrides, the device call it must take)
CASES = {
    "fused_path_engages": (
        "select count(*), sum(fact.x) from fact join dim on fact.k = dim.k",
        {}, FUSED),
    "count_star_only": (
        "select count(*) from fact join dim on fact.k = dim.k", {}, FUSED),
    "grouped_by_probe_col": (
        "select fact.g, count(*), sum(fact.y), avg(fact.x), min(dim.w), "
        "max(dim.w) from fact join dim on fact.k = dim.k "
        "group by fact.g order by fact.g", {}, FUSED),
    "grouped_by_build_text": (
        "select dim.lab, count(*), sum(fact.y) from fact "
        "join dim on fact.k = dim.k group by dim.lab order by dim.lab",
        {}, PREGROUPED),
    "preds_both_sides": (
        "select count(*), sum(dim.w) from fact join dim on fact.k = dim.k "
        "where fact.x > 0.4 and dim.w >= 0", {}, FUSED),
    "cross_side_expression_agg": (
        "select fact.g, sum(fact.y + dim.w), stddev(fact.y - dim.w) "
        "from fact join dim on fact.k = dim.k "
        "group by fact.g having count(*) > 5 order by fact.g", {}, FUSED),
    "numeric_agg_through_join": (
        "select fact.g, sum(fact.num), avg(fact.num) from fact "
        "join dim on fact.k = dim.k group by fact.g order by fact.g",
        {}, FUSED),
    "corr_covar_through_join": (
        "select dim.lab, corr(fact.x, fact.y), covar_pop(fact.x, fact.y) "
        "from fact join dim on fact.k = dim.k "
        "group by dim.lab order by dim.lab", {}, PREGROUPED),
    "null_keys_never_match": (
        "select count(*), count(fact.k) from fact join dim on fact.k = dim.k",
        {}, FUSED),
    "output_regrow": (
        "select count(*), sum(fan.v) from fact join fan on fact.k = fan.k "
        "where fact.y > 0", {}, FUSED),
    "group_overflow_host_replay": (
        "select fact.y, count(*), sum(dim.w) from fact "
        "join dim on fact.k = dim.k group by fact.y order by fact.y",
        {"max_groups_device": 16}, FUSED),
    "empty_result": (
        "select count(*), sum(fact.y) from fact join dim on fact.k = dim.k "
        "where fact.x > 99.0", {}, FUSED),
    "limit_offset_after_agg": (
        "select fact.g, count(*) from fact join dim on fact.k = dim.k "
        "group by fact.g order by fact.g limit 3 offset 1", {}, FUSED),
    "pregrouped_path_engages": (
        "select dim.lab, count(*), sum(fact.y), avg(fact.x) from fact "
        "join dim on fact.k = dim.k group by dim.lab order by dim.lab",
        {}, PREGROUPED),
    "pregrouped_group_expr_and_pred": (
        "select dim.w % 3, count(*), sum(fact.y) from fact "
        "join dim on fact.k = dim.k where fact.x > 0.2 and dim.w > -50 "
        "group by dim.w % 3 order by dim.w % 3", {}, PREGROUPED),
    "pregrouped_off_generic_dense": (
        "select dim.lab, count(*), sum(fact.y) from fact "
        "join dim on fact.k = dim.k group by dim.lab order by dim.lab",
        {"join_mxu_lookup": False}, FUSED),
    "pregrouped_many_groups_g_escalation": (
        "select dim.w, count(*) from fact join dim on fact.k = dim.k "
        "group by dim.w order by dim.w", {}, PREGROUPED),
}


@pytest.mark.parametrize("name", list(CASES))
def test_joinagg_matches_reference(dbs, name):
    sql, cfg, path = CASES[name]
    got, pc = both(dbs, sql, **cfg)
    assert pc.get(path, 0) >= 1, (path, pc)
    other = PREGROUPED if path == FUSED else FUSED
    assert pc.get(other, 0) == 0, pc
    if name == "output_regrow":
        assert pc.get("regrow_retries", 0) >= 1, pc
    if name == "group_overflow_host_replay":
        assert pc.get("recheck_chunks", 0) + pc.get("salt_retries", 0) \
            + pc.get("sort_fallbacks", 0) >= 1, pc


def test_pregrouped_equals_generic(dbs):
    a = CASES["pregrouped_path_engages"][0]
    _, pdb = dbs
    with P.override(device="cpu", debug_force_offload=True, chunk_rows=512):
        x = P.execute(a, pdb).formatted(-3)
    with P.override(device="cpu", debug_force_offload=True, chunk_rows=512,
                    join_mxu_lookup=False):
        y = P.execute(a, pdb).formatted(-3)
    assert x == y


def test_null_keys_fixture_has_nulls(dbs):
    got, _ = both(dbs, "select count(*) from fact join dim "
                       "on fact.k = dim.k")
    _, pdb = dbs
    with P.override(device="cpu", enabled=False):
        nn = P.execute("select count(k) from fact", pdb).scalar()
        total = P.execute("select count(*) from fact", pdb).scalar()
    assert nn < total and int(got[0]) <= nn
