"""The port's pre-aggregation strategies (pg_strom_tpu_torch/ops/preagg.py,
ops/preagg_mxu.py, exec/preagg_exec.py) against the JAX reference.

Three levels, each on the same data in both packages:

* column sums (mirrors tests/test_preagg_mxu.py): build_mxu_columns +
  mxu_reduce give bit-equal `mxu_sums` and exponents, the same shadow
  sums, and the same key recovery / collision / overflow decisions;
* strategies (scatter, sort, mxu, mxu_dense, ungrouped) through
  build_preagg_fn on one chunk of `make_preagg_test`: equal outputs;
* the executor (mirrors tests/test_preagg.py): PreAggExecutor rows equal
  as PostgreSQL text at extra_float_digits=-3, and the same perfmon ladder
  counters.  The reference runs with force_fused_preagg_cpu so that both
  packages take K2 (the reference in Pallas interpret mode, the port
  through its plain version) and the same G floor.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr.lower_jax import (DVal as RDVal,
                                         schema_from_chunk_columns as r_schema,
                                         planes_of_column as r_planes)
from pg_strom_tpu.models.fixtures import (make_preagg_test, make_preagg_zero,
                                          make_preagg_overflow)
from pg_strom_tpu.ops import preagg as r_preagg
from pg_strom_tpu.ops import preagg_mxu as r_mxu
from pg_strom_tpu.exec import preagg_exec as r_exec
from pg_strom_tpu.utils.perfmon import Perfmon as RPerfmon
from pg_strom_tpu.datastore import (Chunk as RChunk, Table as RTable,
                                    column_from_values as r_values)
from pg_strom_tpu_torch.datastore import Chunk as PChunk, from_reference
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr.lower_torch import (
    DVal as PDVal, schema_from_chunk_columns as p_schema,
    planes_of_column as p_planes)
from pg_strom_tpu_torch.ops import preagg as p_preagg
from pg_strom_tpu_torch.ops import preagg_mxu as p_mxu
from pg_strom_tpu_torch.exec import preagg_exec as p_exec
from pg_strom_tpu_torch.exec.devcache import fetch_host
from pg_strom_tpu_torch.utils.perfmon import Perfmon as PPerfmon
from pg_strom_tpu_torch.utils.pgformat import row_out

LADDER = ("device_chunks", "recheck_chunks", "salt_retries",
          "sort_fallbacks", "dense_fallbacks")


class _Pkg:
    def __init__(self, T, ir, preagg, mxu, ex, DVal):
        self.T, self.ir, self.preagg, self.mxu = T, ir, preagg, mxu
        self.ex, self.DVal = ex, DVal


RP = _Pkg(R.T, r_ir, r_preagg, r_mxu, r_exec, RDVal)
PP = _Pkg(P.T, p_ir, p_preagg, p_mxu, p_exec, PDVal)


@pytest.fixture(autouse=True)
def _fresh_memos():
    """Both executors keep cross-query memos; every case starts clean."""
    for M in (RP, PP):
        M.ex._GROUP_STATS.clear()
        M.ex._DENSE_FAILED.clear()
        M.ex._LADDER_MEMO.clear()
    yield


# ---------------------------------------------------------------------------
# column sums (tests/test_preagg_mxu.py)
# ---------------------------------------------------------------------------

def _mxu_both(keys, key_types, slots_list, args, arg_types, seg, G, n):
    """(reference out, recipes), (port out, recipes) of build_mxu_columns +
    mxu_reduce over the same lanes; keys/args: (type name, data, valid)."""
    outs = []
    for M, conv in ((RP, jnp.asarray), (PP, torch.from_numpy)):
        kv = [M.DVal(M.T[t], conv(np.ascontiguousarray(d)), conv(v))
              for t, d, v in keys]
        av = [[M.DVal(M.T[t], conv(np.ascontiguousarray(d)), conv(v))
               for t, d, v in a] for a in args]
        insts = [M.preagg.AggInstance(s[0], s[1], s[2], (None,) * len(a))
                 for s, a in zip(slots_list, args)]
        kts = [M.T[t] for t in key_types]
        ats = [tuple(M.T[t] for t in a) for a in arg_types]
        keyr, slotr, S = M.mxu.mxu_recipes(kts, insts, ats)
        mask = conv(np.ones(n, np.bool_))
        V, exps = M.mxu.build_mxu_columns(kv, insts, av, mask, n)
        sums, fsums = M.mxu.mxu_reduce(V, conv(seg), G, n,
                                       fsum_cols=M.mxu.mxu_shadow_cols(slotr))
        out = {"mxu_sums": np.asarray(sums), "mxu_fsums": np.asarray(fsums),
               "mxu_f4exps": np.asarray(exps)}
        outs.append((out, keyr, slotr))
    (ro, rk, rs), (po, pk, ps) = outs
    assert np.array_equal(ro["mxu_sums"], po["mxu_sums"])
    assert np.array_equal(ro["mxu_f4exps"], po["mxu_f4exps"])
    assert np.array_equal(ro["mxu_fsums"], po["mxu_fsums"], equal_nan=True)
    assert r_mxu.mxu_overflow(ro, rs) == p_mxu.mxu_overflow(po, ps, insts)
    if keys:
        rc, rg = r_mxu.mxu_host_groups(ro, rk, [None] * len(keys))
        pc, pg = p_mxu.mxu_host_groups(po, pk, [None] * len(keys))
        assert (rc, rg) == (pc, pg)
    for rd, pd in zip(rs, ps):
        for kind in rd:
            for g in range(G):
                assert (r_mxu.mxu_extract_slot(rd[kind], ro, g)
                        == p_mxu.mxu_extract_slot(pd[kind], po, g))
    return po


_SUM_I = ("sum", "i4", ("count", "sum_i"))


def _mxu_case(name, rng):
    n = 4096
    G = 16
    seg = rng.integers(0, G, n).astype(np.int32)
    ok = rng.random(n) > 0.15
    if name == "count_sum_exact":
        return ([], [], [_SUM_I], [[("INT4", rng.integers(
            -10 ** 9, 10 ** 9, n).astype(np.int32), ok)]], [("INT4",)],
            seg, G, n)
    if name == "sum_i_modular_window":
        return ([], [], [("sum", "i8", ("count", "sum_i"))],
                [[("INT8", rng.integers(-(1 << 52), 1 << 52, n), ok)]],
                [("INT8",)], seg, G, n)
    if name == "sum_i_overflow_shadow_flags":
        return ([], [], [("sum", "i8", ("count", "sum_i"))],
                [[("INT8", np.full(n, (1 << 62) // 16, np.int64),
                   np.ones(n, np.bool_))]], [("INT8",)],
                np.zeros(n, np.int32), 2, n)
    if name == "sumsq_int_exact":
        return ([], [], [("stddev", "i2", ("count", "sum_i", "sumsq_i"))],
                [[("INT2", rng.integers(-32768, 32768, n).astype(np.int16),
                   ok)]], [("INT2",)], seg, G, n)
    if name == "sum_f4_fixed_point_window":
        return ([], [], [("sum", "f4", ("count", "sum_f"))],
                [[("FLOAT4", ((rng.random(n) - 0.5) * 1e6).astype(np.float32),
                   ok)]], [("FLOAT4",)], seg, G, n)
    if name == "multi_segment_reduce":
        n2 = 1 << 17
        return ([], [], [_SUM_I], [[("INT4", rng.integers(
            -1000, 1000, n2).astype(np.int32), np.ones(n2, np.bool_))]],
            [("INT4",)], rng.integers(0, 32, n2).astype(np.int32), 32, n2)
    if name == "sum_f8_double_float":
        return ([], [], [("sum", "f8", ("count", "sum_f"))],
                [[("FLOAT8", (rng.random(n) - 0.5) * 1e9, ok)]],
                [("FLOAT8",)], seg, G, n)
    if name == "pair_agg_covariance_slots":
        return ([], [], [("covar_pop", "f8f8",
                          ("count", "sum_x", "sum_y", "sum_xy", "sumsq_x",
                           "sumsq_y"))],
                [[("FLOAT8", (rng.random(n) - 0.5) * 100.0, ok),
                  ("FLOAT8", (rng.random(n) - 0.3) * 50.0, ok)]],
                [("FLOAT8", "FLOAT8")], seg, G, n)
    if name == "f8_inf_flags_overflow":
        return ([], [], [("sum", "f8", ("count", "sum_f"))],
                [[("FLOAT8", np.full(n, 1e308), np.ones(n, np.bool_))]],
                [("FLOAT8",)], np.zeros(n, np.int32), 2, n)
    # key recovery: one key value per bucket, then every key in bucket 0
    t, base = {"key_recovery": ("INT4", None),
               "key_collision": ("INT4", None),
               "wide_key_int8": ("INT8", np.asarray(
                   [0, -1, 1, 1 << 62, -(1 << 62), 123456789012345678, -42,
                    (1 << 33) + 7], np.int64)),
               "wide_key_timestamp": ("TIMESTAMP", np.asarray(
                   [150, 700, 820, 123, 456], np.int64) * 86400_000_000 * 30),
               "wide_key_collision": ("INT8", np.asarray(
                   [5, 5 + (1 << 40)], np.int64))}[name]
    G = 64
    if base is None:
        keys = rng.integers(-20, 20, n).astype(np.int32)
    else:
        keys = base[rng.integers(0, len(base), n)]
    kvalid = rng.random(n) > 0.05
    if name.endswith("collision"):
        seg = np.zeros(n, np.int32)
    else:
        uniq: dict = {}
        seg = np.empty(n, np.int32)
        for i in range(n):
            kk = int(keys[i]) if kvalid[i] else None
            seg[i] = uniq.setdefault(kk, len(uniq) % G)
    return ([(t, keys, kvalid)], [t], [("count", "star", ("nrows",))], [[]],
            [()], seg, G, n)


MXU_CASES = ["count_sum_exact", "sum_i_modular_window",
             "sum_i_overflow_shadow_flags", "sumsq_int_exact",
             "sum_f4_fixed_point_window", "multi_segment_reduce",
             "sum_f8_double_float", "pair_agg_covariance_slots",
             "f8_inf_flags_overflow", "key_recovery", "key_collision",
             "wide_key_int8", "wide_key_timestamp", "wide_key_collision"]


@pytest.mark.parametrize("name", MXU_CASES)
def test_mxu_columns_and_reduce_match_reference(name, monkeypatch):
    monkeypatch.setattr(r_mxu, "F64_BLOCKS_ON_CPU", True)
    monkeypatch.setattr(p_mxu, "F64_BLOCKS_ON_CPU", True)
    _mxu_both(*_mxu_case(name, np.random.default_rng(3)))


def test_k4_route_equals_plain_reduce():
    """Under use_pallas_reduce, mxu_reduce hands V to K4 (its plain version
    on the CPU): the same integer sums, shadow columns zero in `sums`, the
    same shadow sums."""
    rng = np.random.default_rng(5)
    n, G = 4096, 32
    inst = p_preagg.AggInstance("sum", "f4", ("count", "sum_f"), (None,))
    x = torch.from_numpy(((rng.random(n) - 0.5) * 1e3).astype(np.float32))
    ok = torch.from_numpy(rng.random(n) > 0.1)
    V, _ = p_mxu.build_mxu_columns([], [inst], [[PDVal(P.T.FLOAT4, x, ok)]],
                                   torch.ones(n, dtype=torch.bool), n)
    _, slotr, S = p_mxu.mxu_recipes([], [inst], [(P.T.FLOAT4,)])
    sh = p_mxu.mxu_shadow_cols(slotr)
    seg = torch.from_numpy(rng.integers(0, G + 1, n).astype(np.int32))
    plain = p_mxu.mxu_reduce(V, seg, G, n, fsum_cols=sh)
    with P.override(use_pallas_reduce=True):
        k4 = p_mxu.mxu_reduce(V, seg, G, n, fsum_cols=sh)
    ic = [c for c in range(S) if c not in sh]
    assert torch.equal(plain[0][:, ic], k4[0][:, ic])
    assert not k4[0][:, sh].any()
    torch.testing.assert_close(k4[1], plain[1], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# strategies through build_preagg_fn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_table():
    return make_preagg_test(nrows=1000)


def _strategy_setup(M, t, group_names, agg_specs, pred=None):
    names = t.column_names
    ref = {nm: M.ir.ColumnRef(type=M.T[t.columns[nm].type.name], name=nm,
                              index=names.index(nm)) for nm in names}
    insts = []
    for a, cs in agg_specs:
        args = tuple(ref[c] for c in cs)
        if a in ("corr", "covar_pop"):
            args = tuple(M.ir.explicit_cast(x, M.T.FLOAT8) for x in args)
        d, fam = M.preagg.lookup_agg(a, tuple(x.type for x in args))
        insts.append(M.preagg.AggInstance(a, fam, d.slots, args))
    p = None
    if pred is not None:
        p = M.ir.resolve_function(pred[0], (ref[pred[1]], M.ir.Const(
            type=M.T[pred[2]], value=pred[3])))
    return [ref[g] for g in group_names], insts, p


STRATEGY_AGGS = [("count", ("integer_x",)), ("sum", ("smlint_x",)),
                 ("sum", ("bigint_x",)), ("avg", ("real_x",)),
                 ("sum", ("float_x",)), ("stddev", ("integer_x",)),
                 ("sum", ("nume_x",)), ("max", ("nume_x",)),
                 ("min", ("float_x",)), ("max", ("real_x",)),
                 ("min", ("bigint_x",))]


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
        elif k == "mxu_fsums":
            np.testing.assert_allclose(po[k], np.asarray(ro[k]), rtol=1e-2)
        else:
            assert np.array_equal(np.asarray(ro[k]), np.asarray(po[k])), k


@pytest.mark.parametrize("strategy,groups", [
    ("scatter", ["key"]), ("scatter", ["key", "smlint_x"]),
    ("sort", ["key"]), ("sort", ["real_x"]), ("mxu", ["key", "smlint_x"]),
    ("mxu_dense", ["key"]), ("scatter", [])])
def test_strategy_outputs_match_reference(fixture_table, strategy, groups):
    rt = fixture_table
    pt = from_reference(rt)
    G = 64 if strategy != "sort" else 256
    outs = []
    for M, t, schema_fn, planes_fn, Chunk in (
            (RP, rt, r_schema, r_planes, RChunk),
            (PP, pt, p_schema, p_planes, PChunk)):
        gs, insts, pred = _strategy_setup(M, t, groups, STRATEGY_AGGS,
                                          ("<>", "id", "INT4", 7))
        cols = [t.columns[nm] for nm in t.column_names]
        fn = M.preagg.build_preagg_fn(schema_fn(t.column_names, cols), gs,
                                      insts, pred, G, strategy)
        ch = Chunk.from_table(t, 0, t.nrows, 1024)
        planes = tuple(planes_fn(ch.columns[nm]) for nm in t.column_names)
        if M is RP:
            with R.override(force_fused_preagg_cpu=True):
                outs.append(jax.device_get(jax.jit(fn)(
                    planes, np.int32(t.nrows), np.uint64(5))))
        else:
            with P.override(device="cpu"):
                outs.append(fetch_host(fn(tuple(tuple(torch.from_numpy(p)
                                                      for p in ps)
                                                for ps in planes),
                                          t.nrows, 5)))
    _compare_outputs(*outs)


# ---------------------------------------------------------------------------
# the executor (tests/test_preagg.py)
# ---------------------------------------------------------------------------

TYPE_COLS = [("smlint_x", "INT2"), ("integer_x", "INT4"),
             ("bigint_x", "INT8"), ("real_x", "FLOAT4"),
             ("float_x", "FLOAT8"), ("nume_x", "NUMERIC")]
AGG_NAMES = ["avg", "count", "max", "min", "sum", "stddev", "stddev_pop",
             "variance", "var_samp"]


@contextlib.contextmanager
def _both(**kw):
    with R.override(force_fused_preagg_cpu=True, **kw), \
            P.override(device="cpu", **kw):
        yield


_PORT_TABLES: dict = {}


def _port_table(rt):
    """One port table per reference table, so that both packages' memos
    (keyed by column identity) see one table across runs."""
    if id(rt) not in _PORT_TABLES:
        _PORT_TABLES[id(rt)] = (rt, from_reference(rt))
    return _PORT_TABLES[id(rt)][1]


def _exec_both(rt, group_names, agg_specs, pred=None, **kw):
    """Formatted rows and ladder counters of both executors."""
    pt = _port_table(rt)
    res = []
    for M, t, Pm in ((RP, rt, RPerfmon), (PP, pt, PPerfmon)):
        gs, insts, p = _strategy_setup(M, t, group_names, agg_specs, pred)
        pm = Pm()
        with _both(**kw):
            try:
                rows = M.ex.PreAggExecutor(t, p, gs, insts, perfmon=pm).run()
            except (R.SqlError, P.SqlError) as e:
                res.append((["ERROR: " + e.message], None))
                continue
        types = tuple(g.type for g in gs) + tuple(
            M.preagg.AGG_CATALOG[(i.aggname, i.family)].rettype for i in insts)
        rows.sort(key=lambda r: tuple((v is None, v) for v in r[:len(gs)]))
        res.append(([row_out(r, tuple(P.T[x.name] for x in types), -3)
                     for r in rows],
                    {c: pm.counts.get(c, 0) for c in LADDER}))
    (rrows, rc), (prows, pc) = res
    assert prows == rrows, (prows[:3], rrows[:3])
    assert pc == rc
    return prows, pc


@pytest.fixture(scope="module")
def tbl():
    return make_preagg_test(nrows=2000)


@pytest.mark.parametrize("mode", ["nogrp", "group", "where"])
@pytest.mark.parametrize("colname,coltype", TYPE_COLS,
                         ids=[c for c, _ in TYPE_COLS])
def test_executor_aggs_match_reference(tbl, colname, coltype, mode):
    aggs = [(a, (colname,)) for a in AGG_NAMES]
    if mode == "nogrp":
        aggs += [(a, (colname, colname)) for a in ("corr", "covar_pop")]
    _exec_both(tbl, [] if mode == "nogrp" else ["key"], aggs,
               ("=", "key", "INT4", 1) if mode == "where" else None,
               chunk_rows=1024, max_groups_device=64)


@pytest.mark.parametrize("grouped", [False, True])
def test_executor_zero_rows(grouped):
    rows, _ = _exec_both(make_preagg_zero(), ["key"] if grouped else [],
                         [(a, (c,)) for a in ("sum", "count", "max")
                          for c, _ in TYPE_COLS],
                         chunk_rows=1024, max_groups_device=64)
    assert len(rows) == (0 if grouped else 1)


@pytest.mark.parametrize("colname,coltype", [("bigint_x", "INT8"),
                                             ("nume_x", "NUMERIC"),
                                             ("float_x", "FLOAT8"),
                                             ("real_x", "FLOAT4")])
def test_executor_overflow_recheck(colname, coltype):
    _exec_both(make_preagg_overflow(nrows=800), ["key"],
               [(a, (colname,)) for a in ("sum", "avg", "max", "min",
                                          "count")],
               chunk_rows=512, max_groups_device=64)


def test_null_key_groups_together(tbl):
    rows, _ = _exec_both(tbl, ["key"], [("count", ("id",))],
                         chunk_rows=1024, max_groups_device=64)
    assert len(rows) == 31


def test_many_groups_ladder(tbl):
    """2000 groups over 64 buckets, outside the v2 envelope (max): dense
    failure, salt, escalation, sort — the same rungs in both packages."""
    _, counts = _exec_both(tbl, ["id"], [("max", ("integer_x",))],
                           chunk_rows=1024, max_groups_device=64)
    assert counts["sort_fallbacks"] >= 1


def test_two_key_salted_buckets(tbl):
    _exec_both(tbl, ["key", "smlint_x"], [("count", ("id",)),
                                          ("sum", ("real_x",))],
               chunk_rows=1024, max_groups_device=64)


def _dense_table(keys, vals):
    return RTable.from_columns("t", {
        "key": r_values(R.T.INT4, keys), "x": r_values(R.T.FLOAT8, vals)})


@pytest.mark.parametrize("name", ["dense_keys_zero_retries",
                                  "dense_null_key_group",
                                  "wide_range_falls_back_exact",
                                  "negative_keys_dense"])
def test_dense_bucketing(name):
    rng = np.random.default_rng(9)
    if name == "dense_keys_zero_retries":
        keys = [int(v) for v in rng.integers(100, 150, 4000)]
        vals = [float(v) for v in rng.random(4000)]
        G = 64
    elif name == "dense_null_key_group":
        keys = [1, 2, None, 2, None, 3, 1]
        vals = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
        G = 64
    elif name == "wide_range_falls_back_exact":
        keys = [int(v) * 100003 for v in rng.integers(0, 30, 2000)]
        vals = [float(v) for v in rng.random(2000)]
        G = 64
    else:
        keys = [-5, -3, -5, 0, 7, -3, 7]
        vals = [1.0] * 7
        G = 16
    _, counts = _exec_both(_dense_table(keys, vals), ["key"],
                           [("sum", ("x",))], max_groups_device=G)
    if name != "wide_range_falls_back_exact":
        assert counts["salt_retries"] == 0


def test_group_count_memo_right_sizes_g():
    rng = np.random.default_rng(21)
    t = _dense_table([int(v) for v in rng.integers(0, 10, 3000)],
                     [float(v) for v in rng.random(3000)])
    pt = from_reference(t)
    gs_stats = []
    for M, tt in ((RP, t), (PP, pt)):
        gs, insts, _ = _strategy_setup(M, tt, ["key"], [("sum", ("x",))])
        with _both():
            e1 = M.ex.PreAggExecutor(tt, None, gs, insts)
            r1 = sorted(e1.run())
            e2 = M.ex.PreAggExecutor(tt, None, gs, insts)
            r2 = sorted(e2.run())
        assert r1 == r2
        gs_stats.append((M.ex._GROUP_STATS[e1._gskey], e2._G))
    assert gs_stats[0] == gs_stats[1] == ((10, 9), 16)


def test_wide_key_dense_fail_then_memo():
    rng = np.random.default_rng(33)
    base = [0, -1, 1 << 62, -(1 << 62), 123456789012345678, -42]
    keys = [base[int(i)] if rng.random() > 0.05 else None
            for i in rng.integers(0, len(base), 3000)]
    t = RTable.from_columns("t", {
        "key": r_values(R.T.INT8, keys),
        "x": r_values(R.T.FLOAT8, [float(v) for v in rng.random(3000)])})
    _, c1 = _exec_both(t, ["key"], [("sum", ("x",))])
    assert c1["dense_fallbacks"] > 0
    # the second run starts where the memos say (no dense attempt)
    _, c2 = _exec_both(t, ["key"], [("sum", ("x",))])
    assert c2["dense_fallbacks"] == 0


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_argsort_i32_matches_reference(n):
    """The sort strategy's stable argsort: the reference's packed sort and
    the port's stable torch.argsort give one permutation, ties included."""
    from pg_strom_tpu.ops.sort import argsort_i32 as r_argsort
    from pg_strom_tpu_torch.ops.sort import argsort_i32 as p_argsort
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 50, n).astype(np.int32)
    vals[rng.random(n) < 0.2] = 1 << 30           # the masked-row sentinel
    want = np.asarray(r_argsort(jnp.asarray(vals), n, vbits=31))
    got = p_argsort(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
