"""The port's K1 path (pg_strom_tpu_torch/ops/preagg_fused2.py) against the
JAX reference (pg_strom_tpu/ops/preagg_fused2.py), case by case.

Every case builds its table once with the reference datastore, converts it
with `pg_strom_tpu_torch.datastore.from_reference`, and builds the same
predicate / GROUP BY / aggregates in each package's IR.  Then:

* plan level: `derive_v2_plan` gives equal signatures, recipes and scalar
  arrays in both packages;
* op level: the reference's `build_fused2_fn` (the Pallas kernel in
  interpret mode on the CPU) and the port's (its plain PyTorch version on a
  CPU tensor) give bit-equal `mxu_sums`, `mxu_f4exps`, `dense_kmin` and
  `dense_rng` and the same host-replay decision; `mxu_fsums` agree to rel
  1e-2 (the TPU shadow rounds |x| to bf16, the port sums float32 |x|);
* executor level: PreAggExecutor rows are exactly equal.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import (Table as RTable, Chunk as RChunk,
                                    column_from_values as rvals,
                                    column_from_numpy as rnp)
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr.lower_jax import (
    schema_from_chunk_columns as r_schema, planes_of_column as r_planes)
from pg_strom_tpu.ops import preagg as r_preagg
from pg_strom_tpu.ops import preagg_fused2 as r_f2
from pg_strom_tpu.ops.preagg_mxu import mxu_overflow as r_overflow
from pg_strom_tpu.exec.preagg_exec import PreAggExecutor as RExec
from pg_strom_tpu_torch.datastore import Chunk as PChunk, from_reference
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr.lower_torch import (
    schema_from_chunk_columns as p_schema, planes_of_column as p_planes)
from pg_strom_tpu_torch.ops import preagg as p_preagg
from pg_strom_tpu_torch.ops import preagg_fused2 as p_f2
from pg_strom_tpu_torch.ops.preagg_mxu import mxu_overflow as p_overflow
from pg_strom_tpu_torch.exec.preagg_exec import PreAggExecutor as PExec
from pg_strom_tpu_torch.exec.devcache import fetch_host
from pg_strom_tpu_torch.utils.perfmon import Perfmon


@dataclasses.dataclass(frozen=True)
class _Pkg:
    """One package's IR and aggregate constructors."""
    T: object
    ir: object
    preagg: object


RP = _Pkg(R.T, r_ir, r_preagg)
PP = _Pkg(P.T, p_ir, p_preagg)


def _cols(M, t):
    names = t.column_names
    return {nm: M.ir.ColumnRef(type=M.T[t.columns[nm].type.name], name=nm,
                               index=names.index(nm)) for nm in names}


def _agg(M, name, col):
    d, fam = M.preagg.lookup_agg(name, (col.type,) if col is not None else ())
    return M.preagg.AggInstance(aggname=name, family=fam, slots=d.slots,
                                args=(col,) if col is not None else ())


def _cmp(M, op, col, ctype, value):
    return M.ir.resolve_function(op, (col, M.ir.Const(type=M.T[ctype],
                                                      value=value)))


# ---------------------------------------------------------------------------
# tables (reference datastore) and queries (per package)
# ---------------------------------------------------------------------------

def _mk_table(n=3000, seed=0, with_nulls=True):
    rng = np.random.default_rng(seed)
    kv = rng.integers(5, 21, n).astype(np.int32)           # dense key 5..20
    x = (rng.random(n).astype(np.float32) - 0.3) * 10.0
    y = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    z = rng.integers(-5000, 5000, n).astype(np.int32)
    if with_nulls:
        kvalid = rng.random(n) > 0.1
        xvalid = rng.random(n) > 0.15
        yvalid = rng.random(n) > 0.2
        zvalid = rng.random(n) > 0.05
    else:
        kvalid = xvalid = yvalid = zvalid = np.ones(n, np.bool_)
    return RTable.from_columns("t", {
        "k": rnp(R.T.INT4, kv, kvalid),
        "x": rnp(R.T.FLOAT4, x, xvalid),
        "y": rnp(R.T.INT8, y, yvalid),
        "z": rnp(R.T.INT4, z, zvalid),
    })


def _t_wide_int8():
    return RTable.from_columns("w", {
        "k": rvals(R.T.INT4, [1, 1, 2, 2, 3, 3]),
        "y": rvals(R.T.INT8, [-(1 << 62), (1 << 62) - 7, 0, None, 12345,
                              -987654321]),
    })


def _t_narrow_int8():
    rng = np.random.default_rng(3)
    n = 2000
    return RTable.from_columns("nr", {
        "k": rnp(R.T.INT4, rng.integers(0, 4, n).astype(np.int32)),
        "y": rnp(R.T.INT8, (rng.integers(0, 200, n) + 10**15)
                 .astype(np.int64)),
    })


def _t_f4(vals, keys):
    return RTable.from_columns("f", {
        "k": rvals(R.T.INT4, keys), "x": rvals(R.T.FLOAT4, vals)})


def _t_shrink():
    rng = np.random.default_rng(7)
    n = 4000
    x = (rng.random(n).astype(np.float32) * 7.5 + 0.5).astype(np.float32)
    return RTable.from_columns("w", {
        "k": rnp(R.T.INT4, rng.integers(0, 8, n).astype(np.int32)),
        "x": rnp(R.T.FLOAT4, x),
    })


def _t_text_key():
    return RTable.from_columns("tx", {
        "s": rvals(R.T.TEXT, ["b", "a", "b", None, "c"] * 40),
        "z": rvals(R.T.INT4, list(range(200))),
    })


def _t_nan_nulls():
    t = _mk_table(n=4000, seed=11)
    x = t.columns["x"].data.copy()
    x[np.random.default_rng(12).random(len(x)) < 0.02] = np.float32("nan")
    t.columns["x"] = rnp(R.T.FLOAT4, x, t.columns["x"].valid)
    return t


def _t_wide_g():
    rng = np.random.default_rng(13)
    n = 6000
    return RTable.from_columns("g", {
        "k": rnp(R.T.INT4, rng.integers(-1500, 1500, n).astype(np.int32),
                 rng.random(n) > 0.02),
        "z": rnp(R.T.INT4, rng.integers(-5000, 5000, n).astype(np.int32),
                 rng.random(n) > 0.1),
    })


def _t_bool_sumsq():
    rng = np.random.default_rng(14)
    n = 3000
    return RTable.from_columns("b", {
        "k": rnp(R.T.INT4, rng.integers(0, 12, n).astype(np.int32)),
        "b": rnp(R.T.BOOL, rng.random(n) > 0.4, rng.random(n) > 0.1),
        "x": rnp(R.T.FLOAT4, (rng.standard_normal(n) * 3000)
                 .astype(np.float32), rng.random(n) > 0.1),
        "z": rnp(R.T.INT4, rng.integers(-5000, 5000, n).astype(np.int32)),
        "zb": rnp(R.T.INT4, rng.integers(-(1 << 30), 1 << 30, n)
                  .astype(np.int32), rng.random(n) > 0.05),
    })


def _q_flagship(M, c):
    return (_cmp(M, ">", c["x"], "FLOAT4", 0.25), [c["k"]],
            [_agg(M, "sum", c["x"]), _agg(M, "count", c["x"]),
             _agg(M, "sum", c["y"])])


def _q_all_kinds(M, c):
    return (None, [c["k"]],
            [_agg(M, "sum", c["z"]), _agg(M, "stddev", c["z"]),
             _agg(M, "avg", c["z"]), _agg(M, "count", c["y"]),
             _agg(M, "count", None), _agg(M, "sum", c["x"])])


def _q_sum_count_y(M, c):
    return None, [c["k"]], [_agg(M, "sum", c["y"]), _agg(M, "count", c["y"])]


def _q_sum_y(M, c):
    return None, [c["k"]], [_agg(M, "sum", c["y"])]


def _q_3vl(M, c):
    lt = _cmp(M, "<", c["z"], "INT4", 1000)
    nn = M.ir.NullTest(type=M.T.BOOL, arg=c["y"], isnull=False)
    return (M.ir.BoolExpr(type=M.T.BOOL, op="and", args=(lt, nn)), [c["k"]],
            [_agg(M, "sum", c["z"]), _agg(M, "count", None)])


def _q_sum_x(M, c):
    return None, [c["k"]], [_agg(M, "sum", c["x"])]


def _q_cnt_shared(M, c):
    return (None, [c["k"]], [_agg(M, "sum", c["x"]), _agg(M, "count", c["x"]),
                             _agg(M, "avg", c["x"])])


def _q_flagship_nopred(M, c):
    return (None, [c["k"]], [_agg(M, "sum", c["x"]), _agg(M, "count", c["x"]),
                             _agg(M, "sum", c["y"])])


def _q_text(M, c):
    return None, [c["s"]], [_agg(M, "sum", c["z"])]


def _q_nan_or_not_isnull(M, c):
    """PG NaN order (x >= NaN holds only for NaN), OR, NOT, IS NULL."""
    ge_nan = _cmp(M, ">=", c["x"], "FLOAT4", math.nan)
    not_neg = M.ir.BoolExpr(type=M.T.BOOL, op="not",
                            args=(_cmp(M, "<", c["z"], "INT4", 0),))
    y_null = M.ir.NullTest(type=M.T.BOOL, arg=c["y"], isnull=True)
    pred = M.ir.BoolExpr(type=M.T.BOOL, op="or", args=(
        ge_nan, M.ir.BoolExpr(type=M.T.BOOL, op="and",
                              args=(not_neg, y_null))))
    return (pred, [c["k"]], [_agg(M, "sum", c["x"]), _agg(M, "count", None),
                             _agg(M, "sum", c["z"])])


def _q_in_list(M, c):
    """z IN (40 values): an OR of 40 compares (the kernel folds it left,
    two entries at a time)."""
    eqs = tuple(_cmp(M, "=", c["z"], "INT4", v)
                for v in range(-2000, 2000, 100))
    return (M.ir.BoolExpr(type=M.T.BOOL, op="or", args=eqs), [c["k"]],
            [_agg(M, "sum", c["y"]), _agg(M, "count", None)])


def _q_wide_g(M, c):
    return None, [c["k"]], [_agg(M, "sum", c["z"]), _agg(M, "count", c["z"])]


def _q_bool_sumsq_big(M, c):
    """Bare bool column AND a float compare; stddev over |v| >= 2^16 (the
    three-product sumsq4_big lane)."""
    not_lt = M.ir.BoolExpr(type=M.T.BOOL, op="not",
                           args=(_cmp(M, "<", c["x"], "FLOAT4", -100.0),))
    pred = M.ir.BoolExpr(type=M.T.BOOL, op="and", args=(c["b"], not_lt))
    return (pred, [c["k"]], [_agg(M, "stddev", c["zb"]),
                             _agg(M, "sum", c["zb"]), _agg(M, "count", None)])


# name -> (reference table factory, query, config overrides for both)
CASES = {
    "flagship": (_mk_table, _q_flagship, {}),
    "no_pred_all_kinds": (lambda: _mk_table(seed=1), _q_all_kinds, {}),
    "negative_and_wide_int8": (_t_wide_int8, _q_sum_count_y, {}),
    "int8_narrow_single_limb": (_t_narrow_int8, _q_sum_y, {}),
    "pred_3vl_and_nulltest": (lambda: _mk_table(seed=2), _q_3vl, {}),
    "float_nan_replays": (lambda: _t_f4([1.5, float("nan"), 2.5, 3.0],
                                        [1, 1, 2, 2]), _q_sum_x, {}),
    "stats_elision_nullfree": (lambda: _mk_table(with_nulls=False),
                               _q_flagship_nopred, {}),
    "cnt_column_shared": (_mk_table, _q_cnt_shared, {}),
    "f4_window_shrink": (_t_shrink, _q_sum_x, {}),
    "f4_all_zero": (lambda: _t_f4([0.0, -0.0, 0.0], [1, 1, 2]), _q_sum_x, {}),
    "f4_denormal_clamp": (lambda: _t_f4([1.0e30, 1.0e-40], [1, 1]),
                          _q_sum_x, {}),
    "int8_mode_off": (lambda: _mk_table(seed=8), _q_flagship_nopred,
                      {"use_preagg_int8": False}),
    "text_dict_key": (_t_text_key, _q_text, {}),
    "all_null_key": (lambda: RTable.from_columns("an", {
        "k": rvals(R.T.INT4, [None, None, None]),
        "y": rvals(R.T.INT8, [7, 8, None])}), _q_sum_count_y, {}),
    "nan_or_not_isnull": (_t_nan_nulls, _q_nan_or_not_isnull, {}),
    "wide_g": (_t_wide_g, _q_wide_g, {}),
    "in_list_or_chain": (lambda: _mk_table(seed=15), _q_in_list, {}),
    "bool_column_and_sumsq_big": (_t_bool_sumsq, _q_bool_sumsq_big, {}),
}


@contextlib.contextmanager
def _both(overrides):
    with R.override(**overrides), P.override(**overrides):
        yield


# Cases whose float4 sum column spans more than its digit window (1e30
# beside 1e-40): the reference drops the |v| shadow and, with it, any way
# to see that the window lost rows (a known fault of the reference, ROADMAP
# section 3); the port keeps the shadow for its window check.  There the
# reference is derived with its _f4_stats reporting the shadow needed,
# which is the port's plan.
WINDOW_SHADOW_CASES = ("f4_denormal_clamp",)


@contextlib.contextmanager
def _reference_keeps_window_shadow(name):
    if name not in WINDOW_SHADOW_CASES:
        yield
        return
    real = r_f2._f4_stats

    def needed(ast):
        fs = real(ast)
        return None if fs is None else (fs[0], True)
    r_f2._f4_stats = needed
    try:
        yield
    finally:
        r_f2._f4_stats = real


def _setup(name):
    factory, query, ovr = CASES[name]
    rt = factory()
    pt = from_reference(rt)
    rq = query(RP, _cols(RP, rt))
    pq = query(PP, _cols(PP, pt))
    return rt, pt, rq, pq, ovr


def _derive(mod, schema_fn, t, q):
    pred, groups, aggs = q
    cols = [t.columns[nm] for nm in t.column_names]
    return mod.derive_v2_plan(cols, schema_fn(t.column_names, cols), groups,
                              aggs, pred, 4096)


def _asdict_recipes(recipes):
    return [{k: dataclasses.asdict(r) for k, r in d.items()} for d in recipes]


def _pad_cap(n: int) -> int:
    cap = 1024
    while cap < n:
        cap <<= 1
    return cap


# ---------------------------------------------------------------------------
# plan + op level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_plan_and_op_level_match_reference(name):
    rt, pt, rq, pq, ovr = _setup(name)
    with _both(ovr):
        if name in WINDOW_SHADOW_CASES:
            # the recorded fault: no shadow in the reference's own plan
            assert not _derive(r_f2, r_schema, rt, rq).sig.shadow_map
        with _reference_keeps_window_shadow(name):
            rplan = _derive(r_f2, r_schema, rt, rq)
        pplan = _derive(p_f2, p_schema, pt, pq)
    assert rplan is not None and pplan is not None
    assert bool(pplan.sig.shadow_map) >= (name in WINDOW_SHADOW_CASES)
    assert dataclasses.asdict(rplan.sig) == dataclasses.asdict(pplan.sig)
    assert _asdict_recipes(rplan.recipes) == _asdict_recipes(pplan.recipes)
    for f in ("scal_i", "scal_u", "f4sc", "f4e"):
        a, b = getattr(rplan, f), getattr(pplan, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert rplan.G == pplan.G and rplan.kmin == pplan.kmin

    n = rt.nrows
    cap = _pad_cap(n)
    nrows = max(n - 5, 0) if n > 64 else n      # a live-row tail as well
    rch = RChunk.from_table(rt, 0, n, cap)
    pch = PChunk.from_table(pt, 0, n, cap)
    rcols = tuple(tuple(jax.numpy.asarray(p) for p in
                        r_planes(rch.columns[nm]))
                  for nm in rt.column_names)
    pcols = tuple(tuple(torch.from_numpy(p) for p in
                        p_planes(pch.columns[nm]))
                  for nm in pt.column_names)
    split = {}
    for idx in rplan.split_cols:
        u = rch.columns[rt.column_names[idx]].data.view(np.uint64)
        split[idx] = ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      (u >> np.uint64(32)).astype(np.uint32))
    scal = {"i": rplan.scal_i, "u": rplan.scal_u, "f4sc": rplan.f4sc,
            "f4e": rplan.f4e}
    rpred, rgroups, raggs = rq
    ppred, pgroups, paggs = pq
    with R.override(force_fused_preagg_cpu=True):
        rfn = jax.jit(r_f2.build_fused2_fn(None, rgroups, raggs, rpred,
                                           rplan.G, rplan.sig))
        rout = jax.device_get(rfn(rcols, np.int32(nrows), np.uint64(0),
                                  dict(scal, split=split)))
    pout = fetch_host(p_f2.build_fused2_fn(None, pgroups, paggs, ppred,
                                           pplan.G, pplan.sig)(
        pcols, nrows, 0, dict(scal)))

    assert np.array_equal(np.asarray(rout["mxu_sums"]), pout["mxu_sums"])
    assert np.array_equal(np.asarray(rout["mxu_f4exps"]),
                          pout["mxu_f4exps"])
    assert int(rout["dense_kmin"]) == int(pout["dense_kmin"])
    assert int(rout["dense_rng"]) == int(pout["dense_rng"])
    assert r_overflow(rout, rplan.recipes) == p_overflow(pout, pplan.recipes,
                                                         paggs)
    # the shadow is a replay guard: same decision, values to rel 1e-2.  The
    # TPU's one-hot matmul also spreads a NaN row to every bucket
    # (0 * NaN), the port keeps it in its own bucket: compare where the
    # reference is finite, and require a non-finite port cell to be
    # non-finite in the reference too
    rf, pf = np.asarray(rout["mxu_fsums"]), pout["mxu_fsums"]
    fin = np.isfinite(rf)
    np.testing.assert_allclose(pf[fin], rf[fin], rtol=1e-2)
    assert not np.isfinite(rf[~np.isfinite(pf)]).any()


# ---------------------------------------------------------------------------
# executor level
# ---------------------------------------------------------------------------

def _canon(v):
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return v


def _sorted_rows(rows, ngroups):
    key = lambda r: tuple((v is None, _canon(v) if v is not None else 0)  # noqa
                          for v in r[:ngroups])
    return [tuple(_canon(v) for v in r) for r in sorted(rows, key=key)]


@pytest.mark.parametrize("name", list(CASES))
def test_executor_rows_match_reference(name):
    rt, pt, rq, pq, ovr = _setup(name)
    with _both(ovr), R.override(force_fused_preagg_cpu=True,
                                use_fused_preagg2=True, chunk_rows=1 << 11):
        rex = RExec(rt, *rq)
        rrows = rex.run()
        assert rex._v2 is not None
    pm = Perfmon()
    with _both(ovr), P.override(device="cpu", chunk_rows=1 << 11):
        pex = PExec(pt, *pq, perfmon=pm)
        prows = pex.run()
        assert pex._v2 is not None
    assert pm.counts.get("unported_host_exact", 0) == 0
    assert pm.counts.get("device_chunks", 0) \
        + pm.counts.get("recheck_chunks", 0) == -(-pt.nrows // (1 << 11))
    ng = len(rq[1])
    assert _sorted_rows(prows, ng) == _sorted_rows(rrows, ng)


def _q_computed_arg(M, c):
    plus = M.ir.resolve_function("+", (c["z"], M.ir.Const(type=M.T.INT4,
                                                          value=1)))
    return None, [c["k"]], [_agg(M, "sum", plus)]


def _q_two_keys(M, c):
    return None, [c["k"], c["z"]], [_agg(M, "count", None)]


def _q_text_min(M, c):
    return None, [c["s"]], [_agg(M, "sum", c["z"]), _agg(M, "min", c["z"])]


# shapes outside the v2 envelope: (reference table factory, query)
INELIGIBLE = {
    "computed_arg": (lambda: _mk_table(seed=4), _q_computed_arg),
    "two_keys": (lambda: _mk_table(seed=4), _q_two_keys),
    "sparse_key": (lambda: RTable.from_columns("sp", {
        "k": rvals(R.T.INT4, [0, 10**9, 5]),
        "y": rvals(R.T.INT8, [1, 2, 3])}), _q_sum_y),
    "f4_inf": (lambda: _t_f4([1.0, float("inf"), 2.0, 3.0], [1, 1, 2, 2]),
               _q_sum_x),
    "text_key_min": (_t_text_key, _q_text_min),
}


_LADDER_COUNTERS = ("device_chunks", "recheck_chunks", "salt_retries",
                    "sort_fallbacks", "dense_fallbacks")


@pytest.mark.parametrize("name", list(INELIGIBLE))
def test_ineligible_shape_runs_host_exact_and_is_counted(name):
    """No v2 plan in either package.  Both packages offload the shape to
    the lowering strategies (K2 column sums, scatter, sort): no chunk is
    answered by an unported tier, every chunk is counted as a device chunk
    or a host replay, the ladder counters equal the reference's, and the
    rows agree.  A float4 sum over +Inf replays through the |x| shadow."""
    factory, query = INELIGIBLE[name]
    rt = factory()
    pt = from_reference(rt)
    rq, pq = query(RP, _cols(RP, rt)), query(PP, _cols(PP, pt))
    assert _derive(r_f2, r_schema, rt, rq) is None
    assert _derive(p_f2, p_schema, pt, pq) is None
    rpm = R.utils.perfmon.Perfmon()
    with R.override(chunk_rows=1 << 11, force_fused_preagg_cpu=True):
        rrows = RExec(rt, *rq, perfmon=rpm).run()
    pm = Perfmon()
    with P.override(device="cpu", chunk_rows=1 << 11):
        prows = PExec(pt, *pq, perfmon=pm).run()
    nchunks = -(-pt.nrows // (1 << 11))
    assert pm.counts.get("unported_host_exact", 0) == 0
    assert (pm.counts.get("device_chunks", 0)
            + pm.counts.get("recheck_chunks", 0)) == nchunks
    assert ({c: pm.counts.get(c, 0) for c in _LADDER_COUNTERS}
            == {c: rpm.counts.get(c, 0) for c in _LADDER_COUNTERS})
    if name == "f4_inf":
        assert pm.counts.get("recheck_chunks", 0) >= 1
    else:
        assert pm.counts.get("device_chunks", 0) >= 1
    ng = len(rq[1])
    assert _sorted_rows(prows, ng) == _sorted_rows(rrows, ng)


def test_narrow_exact_casts_only_where_exact():
    """SQL's `x > 0.25` over a real column binds as (x)::float8 > 0.25; the
    kernel sees `x > 0.25` only when the constant is a float32 (or NaN)."""
    t = from_reference(_mk_table(n=10))
    c = _cols(PP, t)
    cast = p_ir.FuncExpr(type=P.T.FLOAT8, fname="cast::float8",
                         args=(c["x"],))
    for value, narrowed in ((0.25, True), (math.nan, True), (0.1, False)):
        e = p_ir.resolve_function(">", (cast, p_ir.Const(type=P.T.FLOAT8,
                                                         value=value)))
        got = p_f2.narrow_exact_casts(e)
        assert (got.args[0] == c["x"]) is narrowed
        assert p_f2._pred_kernel_safe(got, None) is narrowed


def test_cuda_device_without_gpu_raises():
    """config.device = "cuda" on a machine without a GPU must raise, never
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    pt = from_reference(_mk_table(n=100))
    pc = _cols(PP, pt)
    pred, groups, aggs = _q_flagship(PP, pc)
    with P.override(device="cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            PExec(pt, pred, groups, aggs).run()
