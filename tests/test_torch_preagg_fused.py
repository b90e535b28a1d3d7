"""K2 (pg_strom_tpu_torch/ops/preagg_fused.py) and K4
(pg_strom_tpu_torch/ops/preagg_pallas.py) against the JAX reference.

Mirrors tests/test_preagg_fused.py case for case.  Each case runs the SAME
build_preagg_fn program (strategy "mxu") in both packages on the same
planes: the reference's K2 in Pallas interpret mode on the CPU (under
force_fused_preagg_cpu), the port's K2 through its plain PyTorch version
(a CPU tensor).  Required:

* `mxu_sums` bit-equal and `mxu_f4exps` equal;
* the same collision and overflow flags out of mxu_absorb;
* `mxu_fsums` within rel 1e-2 where the reference is finite (the TPU
  quantizes the shadows to bf16; they only decide host replay);
* absorbed states equal under the reference test's rule.

K4 has no interpret mode: its plain version is held against the
reference's CPU mxu_reduce.  The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr.lower_jax import ColMeta as RColMeta, DVal as RDVal
from pg_strom_tpu.ops import preagg as r_preagg
from pg_strom_tpu.ops import preagg_mxu as r_mxu
from pg_strom_tpu.exec.hostexec import canon_group_key as r_canon
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr.lower_torch import (ColMeta as PColMeta,
                                                 DVal as PDVal)
from pg_strom_tpu_torch.ops import preagg as p_preagg
from pg_strom_tpu_torch.ops import preagg_mxu as p_mxu
from pg_strom_tpu_torch.ops import preagg_fused as p_fused
from pg_strom_tpu_torch.ops.preagg_pallas import pallas_reduce_reference
from pg_strom_tpu_torch.exec.devcache import fetch_host
from pg_strom_tpu_torch.exec.hostexec import canon_group_key as p_canon

N = 512
G = 64


class _Pkg:
    def __init__(self, T, ir, preagg, mxu, ColMeta, canon):
        self.T, self.ir, self.preagg, self.mxu = T, ir, preagg, mxu
        self.ColMeta, self.canon = ColMeta, canon


RP = _Pkg(R.T, r_ir, r_preagg, r_mxu, RColMeta, r_canon)
PP = _Pkg(P.T, p_ir, p_preagg, p_mxu, PColMeta, p_canon)


def _insts(M, specs):
    out = []
    for aggname, arg in specs:
        args = arg if isinstance(arg, tuple) else (arg,)
        d, fam = M.preagg.lookup_agg(aggname, tuple(a.type for a in args))
        out.append(M.preagg.AggInstance(aggname=aggname, family=fam,
                                        slots=d.slots, args=args))
    return out


def _case(M, schema_spec, key_names, agg_specs, pred_spec=None):
    """(schema, group exprs, aggs, pred) of one case in package M."""
    schema = [M.ColMeta(nm, M.T[t]) for nm, t in schema_spec]
    ref = {nm: M.ir.ColumnRef(type=M.T[t], name=nm, index=i)
           for i, (nm, t) in enumerate(schema_spec)}
    aggs = _insts(M, [(a, tuple(ref[c] for c in cs) if isinstance(cs, tuple)
                       else ref[cs]) for a, cs in agg_specs])
    pred = None
    if pred_spec is not None:
        op, col, ct, v = pred_spec
        pred = M.ir.resolve_function(op, (ref[col], M.ir.Const(type=M.T[ct],
                                                               value=v)))
    return schema, [ref[k] for k in key_names], aggs, pred


def _absorb(M, out, group_exprs, insts):
    states, displays = {}, {}
    collided, overflow = M.mxu.mxu_absorb(
        out, group_exprs, insts, [None] * len(group_exprs), states,
        displays, M.preagg.merge_partials, M.preagg.extract_partials,
        M.canon)
    return collided, overflow, states


def _canon_states(states):
    return {repr(k): v for k, v in states.items()}


def _run_both(schema_spec, key_names, agg_specs, arrays, pred_spec=None):
    rs, rk, ra, rp = _case(RP, schema_spec, key_names, agg_specs, pred_spec)
    ps, pk, pa, pp = _case(PP, schema_spec, key_names, agg_specs, pred_spec)
    rcols = tuple((jax.device_put(np.asarray(d)),
                   jax.device_put(np.asarray(v, np.bool_))) for d, v in arrays)
    pcols = tuple((torch.from_numpy(np.ascontiguousarray(d)),
                   torch.from_numpy(np.asarray(v, np.bool_)))
                  for d, v in arrays)
    with R.override(use_fused_preagg=True, force_fused_preagg_cpu=True):
        rfn = r_preagg.build_preagg_fn(rs, rk, ra, rp, G, strategy="mxu")
        rout = jax.device_get(rfn(rcols, np.int32(N), np.uint64(0)))
    with P.override(use_fused_preagg=True, device="cpu"):
        pout = fetch_host(p_preagg.build_preagg_fn(ps, pk, pa, pp, G,
                                                   strategy="mxu")(
            pcols, N, 0))
    return (rout, rk, ra), (pout, pk, pa)


def _assert_match(r, p):
    (rout, rk, ra), (pout, pk, pa) = r, p
    assert np.array_equal(np.asarray(rout["mxu_sums"]), pout["mxu_sums"])
    assert np.array_equal(np.asarray(rout["mxu_f4exps"]), pout["mxu_f4exps"])
    rf, pf = np.asarray(rout["mxu_fsums"]), pout["mxu_fsums"]
    assert rf.shape == pf.shape
    fin = np.isfinite(rf)
    np.testing.assert_allclose(pf[fin], rf[fin], rtol=1e-2)
    assert not np.isfinite(rf[~np.isfinite(pf)]).any()
    cr, orr, sr = _absorb(RP, rout, rk, ra)
    cp, op_, sp = _absorb(PP, pout, pk, pa)
    assert (cr, orr) == (cp, op_)
    if cr or orr:
        return cr, orr
    sr, sp = _canon_states(sr), _canon_states(sp)
    assert sorted(sr) == sorted(sp)
    for k in sr:
        for a, b in zip(sr[k], sp[k]):
            assert set(a) == set(b), (k, set(a), set(b))
            for kk in a:
                if isinstance(a[kk], float):
                    assert b[kk] == pytest.approx(a[kk], rel=1e-12,
                                                  abs=1e-300), (k, kk)
                else:
                    assert a[kk] == b[kk], (k, kk, a[kk], b[kk])
    return cr, orr


def _keys_int4(rng, nkeys=5):
    return (rng.integers(0, nkeys, N) * 11 - 17).astype(np.int32)


@pytest.fixture()
def _f64_blocks(monkeypatch):
    """float8 double-float blocks are off on the CPU in both packages;
    force them on so the head/tail lanes are exercised."""
    monkeypatch.setattr(r_mxu, "F64_BLOCKS_ON_CPU", True)
    monkeypatch.setattr(p_mxu, "F64_BLOCKS_ON_CPU", True)
    yield


def test_flagship_mix():
    rng = np.random.default_rng(1)
    arrays = [
        (_keys_int4(rng), np.ones(N, np.bool_)),
        ((rng.random(N).astype(np.float32) - 0.4) * 100, rng.random(N) > 0.1),
        (rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
         rng.random(N) > 0.1)]
    _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT4"), ("y", "INT8")], ["k"],
        [("sum", "x"), ("count", "x"), ("sum", "y"), ("max", "y")], arrays,
        (">", "x", "FLOAT4", 0.0)))


def test_int_sum_sumsq_families():
    rng = np.random.default_rng(2)
    arrays = [
        (_keys_int4(rng, 4), np.ones(N, np.bool_)),
        (rng.integers(-32768, 32767, N).astype(np.int16), rng.random(N) > 0.2),
        (rng.integers(-(1 << 31), (1 << 31) - 1, N).astype(np.int32),
         rng.random(N) > 0.2)]
    _assert_match(*_run_both(
        [("k", "INT4"), ("a", "INT2"), ("b", "INT4")], ["k"],
        [("stddev", "a"), ("variance", "b"), ("sum", "a"), ("avg", "b")],
        arrays))


def test_multi_key_types():
    rng = np.random.default_rng(3)
    arrays = [
        (rng.integers(0, 2, N).astype(np.bool_), np.ones(N, np.bool_)),
        ((rng.integers(0, 3, N) * 9 - 5).astype(np.int16),
         rng.random(N) > 0.1),
        ((rng.integers(0, 2, N) + 7000).astype(np.int32),
         np.ones(N, np.bool_)),
        (rng.random(N).astype(np.float32), rng.random(N) > 0.1)]
    _assert_match(*_run_both(
        [("kb", "BOOL"), ("ks", "INT2"), ("kd", "DATE"), ("x", "FLOAT4")],
        ["kb", "ks", "kd"], [("sum", "x"), ("count", "x")], arrays))


def test_all_null_group_and_extremes():
    rng = np.random.default_rng(4)
    yv = rng.integers(-(1 << 55), 1 << 55, N).astype(np.int64)
    yv[:8] = [np.iinfo(np.int64).max // 2, np.iinfo(np.int64).min // 2,
              0, -1, 1, 255, -256, 1 << 40]
    keys = _keys_int4(rng, 3)
    valid = rng.random(N) > 0.3
    valid[keys == keys.min()] = False          # one group entirely NULL
    _assert_match(*_run_both(
        [("k", "INT4"), ("y", "INT8")], ["k"],
        [("sum", "y"), ("count", "y")],
        [(keys, np.ones(N, np.bool_)), (yv, valid)]))


def test_sum_i_overflow_flags_match():
    """values whose |v| mass exceeds 2^61 must raise overflow both ways."""
    yv = np.full(N, (1 << 61) // 16, np.int64)
    _, overflow = _assert_match(*_run_both(
        [("k", "INT4"), ("y", "INT8")], ["k"], [("sum", "y")],
        [(np.zeros(N, np.int32), np.ones(N, np.bool_)),
         (yv, np.ones(N, np.bool_))]))
    assert overflow


def test_collision_flag_matches():
    """more distinct keys than buckets: both paths must flag collision."""
    rng = np.random.default_rng(6)
    collided, _ = _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT4")], ["k"], [("sum", "x")],
        [(np.arange(N, dtype=np.int32), np.ones(N, np.bool_)),
         (rng.random(N).astype(np.float32), np.ones(N, np.bool_))]))
    assert collided


def test_fused_supported_gating():
    for M, mod in ((RP, None), (PP, p_fused)):
        if mod is None:
            from pg_strom_tpu.ops import preagg_fused as mod
        x4 = M.ir.ColumnRef(type=M.T.FLOAT4, name="x", index=0)
        x8 = M.ir.ColumnRef(type=M.T.FLOAT8, name="y", index=1)
        ok = _insts(M, [("sum", x4), ("count", x4)])
        assert mod.fused_supported([M.T.INT4], ok,
                                   [(M.T.FLOAT4,), (M.T.FLOAT4,)])
        f8 = _insts(M, [("sum", x8), ("stddev", x8)])
        assert mod.fused_supported([M.T.INT4], f8,
                                   [(M.T.FLOAT8,), (M.T.FLOAT8,)])
        assert not mod.fused_supported([], ok, [(M.T.FLOAT4,), (M.T.FLOAT4,)])


def test_f64_families_fused(_f64_blocks):
    rng = np.random.default_rng(41)
    _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT8"), ("y", "FLOAT8")], ["k"],
        [("sum", "x"), ("stddev", "x")],
        [(_keys_int4(rng, 4), np.ones(N, np.bool_)),
         ((rng.random(N) - 0.5) * 1e9, rng.random(N) > 0.1),
         ((rng.random(N) - 0.5) * 1e3, rng.random(N) > 0.1)]))


def test_f64_corr_fused(_f64_blocks):
    """corr(x, y): five f64 blocks — widest fusable plan (114 columns)."""
    rng = np.random.default_rng(42)
    _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT8"), ("y", "FLOAT8")], ["k"],
        [("corr", ("x", "y"))],
        [(_keys_int4(rng, 4), np.ones(N, np.bool_)),
         ((rng.random(N) - 0.5) * 100, rng.random(N) > 0.1),
         ((rng.random(N) - 0.5) * 100, rng.random(N) > 0.1)]))


def test_f4_stddev_fused(_f64_blocks):
    rng = np.random.default_rng(43)
    _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT4")], ["k"],
        [("stddev", "x"), ("sum", "x")],
        [(_keys_int4(rng, 4), np.ones(N, np.bool_)),
         ((rng.random(N).astype(np.float32) - 0.5) * 1e4,
          rng.random(N) > 0.1)]))


def test_wide_int8_key():
    """64-bit group key: two-word limb blocks."""
    rng = np.random.default_rng(31)
    base = np.asarray([0, -1, (1 << 62), -(1 << 62), 123456789012345678,
                       (1 << 33) + 7], dtype=np.int64)
    _assert_match(*_run_both(
        [("k", "INT8"), ("x", "FLOAT4")], ["k"],
        [("sum", "x"), ("count", "x")],
        [(base[rng.integers(0, len(base), N)], rng.random(N) > 0.05),
         ((rng.random(N).astype(np.float32) - 0.4) * 10,
          rng.random(N) > 0.1)]))


def test_wide_timestamp_key():
    rng = np.random.default_rng(32)
    base = (np.asarray([150, 700, 820, 123], dtype=np.int64)
            * 86400_000_000 * 30)
    _assert_match(*_run_both(
        [("k", "TIMESTAMP"), ("y", "INT8")], ["k"],
        [("sum", "y"), ("count", "y")],
        [(base[rng.integers(0, len(base), N)], np.ones(N, np.bool_)),
         (rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
          rng.random(N) > 0.1)]))


def test_f4_nan_inf_shadow_replays():
    """NaN gives zero digits and inf garbage ones; both reach the |x|
    shadow, so both packages replay the chunk."""
    rng = np.random.default_rng(44)
    x = ((rng.random(N) - 0.5) * 10).astype(np.float32)
    x[3], x[77] = np.nan, np.inf
    _, overflow = _assert_match(*_run_both(
        [("k", "INT4"), ("x", "FLOAT4")], ["k"], [("sum", "x")],
        [(_keys_int4(rng, 4), np.ones(N, np.bool_)),
         (x, rng.random(N) > 0.1)]))
    assert overflow


def test_scale_exponent_near_powers_of_two():
    """The float window exponent E: equal to the reference's at and above
    every power of two; a few ulps below one, the reference's XLA f32 log2
    may round the other way, so E may differ by one there — both satisfy
    max|x| * 2^-E < 1 (ROADMAP section 3)."""
    f = np.float32
    at, below = [], []
    for k in range(-120, 127, 7):
        b = f(2.0) ** k
        x = b
        for _ in range(4):
            at.append(x)
            x = np.nextafter(x, f(np.inf))
        at.append(b * f(0.75))
        x = b
        for _ in range(4):
            x = np.nextafter(x, f(0))
            below.append(x)
    at += [f(0.0), f(1e-38), f(3.4e38)]
    rfn = jax.jit(lambda a: r_mxu._f4_scale_exp(a)[1])
    for vals, exact in ((at, True), (below, False)):
        for v in vals:
            lane = np.asarray([v, v / 2], np.float32)
            er = int(rfn(jnp.asarray(lane)))
            sc, ep = p_mxu._f4_scale_exp(torch.from_numpy(lane))
            ep = int(ep)
            if exact:
                assert ep == er, (v, ep, er)
            else:
                assert abs(ep - er) <= 1, (v, ep, er)
            if v < 2.0 ** 126:     # the exponent clips at 127 above
                assert float(v) * float(sc) < 1.0
            assert float(sc) == 2.0 ** -ep


def test_build_mxu_columns_bit_equal(_f64_blocks):
    """The unfused value matrix: the same bf16 bits and exponents."""
    rng = np.random.default_rng(45)
    spec = [("k", "INT8"), ("x", "FLOAT4"), ("y", "FLOAT8"), ("z", "INT4")]
    arrays = [
        (rng.integers(-5, 5, N).astype(np.int64) << 40, rng.random(N) > 0.1),
        ((rng.random(N).astype(np.float32) - 0.5) * 3, rng.random(N) > 0.1),
        ((rng.random(N) - 0.5) * 1e6, rng.random(N) > 0.1),
        (rng.integers(-40000, 40000, N).astype(np.int32),
         rng.random(N) > 0.1)]
    aggs = [("sum", "x"), ("stddev", "y"), ("stddev", "z"), ("count", "z")]
    mask = rng.random(N) > 0.05
    outs = []
    for M, conv in ((RP, jnp.asarray), (PP, torch.from_numpy)):
        _, keys, insts, _ = _case(M, spec, ["k"], aggs)
        D = RDVal if M is RP else PDVal
        vals = [D(M.T[t], conv(np.ascontiguousarray(d)), conv(v))
                for (_, t), (d, v) in zip(spec, arrays)]
        args = [[vals[1]], [vals[2]], [vals[3]], [vals[3]]]
        V, e = M.mxu.build_mxu_columns([vals[0]], insts, args,
                                       conv(mask), N)
        outs.append((np.asarray(V.float() if M is PP else
                                np.asarray(V).astype(np.float32)),
                     np.asarray(e)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_k4_plain_matches_reference_mxu_reduce():
    """K4's plain version (integer columns exact, shadows to rel 1e-2, the
    same replay decision) against the reference's CPU mxu_reduce over the
    reference's own value matrix."""
    rng = np.random.default_rng(46)
    rs, rk, ra, _ = _case(RP, [("k", "INT4"), ("x", "FLOAT4"), ("y", "INT8")],
                          ["k"], [("sum", "x"), ("sum", "y"),
                                  ("count", "y")])
    x = ((rng.random(N) - 0.5) * 50).astype(np.float32)
    vals = [RDVal(R.T.INT4, jnp.asarray(_keys_int4(rng, 6)),
                  jnp.asarray(np.ones(N, np.bool_))),
            RDVal(R.T.FLOAT4, jnp.asarray(x), jnp.asarray(rng.random(N) > .1)),
            RDVal(R.T.INT8, jnp.asarray(rng.integers(-(1 << 50), 1 << 50, N)),
                  jnp.asarray(rng.random(N) > 0.1))]
    mask = jnp.asarray(rng.random(N) > 0.05)
    V, exps = r_mxu.build_mxu_columns(vals[:1], ra, [[vals[1]], [vals[2]],
                                                     [vals[2]]], mask, N)
    _, slotr, S = r_mxu.mxu_recipes([R.T.INT4], ra,
                                    [(R.T.FLOAT4,), (R.T.INT8,), (R.T.INT8,)])
    fcols = r_mxu.mxu_shadow_cols(slotr)
    seg = rng.integers(0, G + 1, N).astype(np.int32)    # G drops the row
    rsums, rfs = jax.jit(lambda v, s: r_mxu.mxu_reduce(
        v, s, G, N, fsum_cols=fcols))(V, jnp.asarray(seg))
    rsums, rfs = np.asarray(rsums), np.asarray(rfs)
    Vt = torch.from_numpy(np.asarray(V).astype(np.float32)).to(torch.bfloat16)
    ints, shadow = pallas_reduce_reference(Vt, torch.from_numpy(seg), G, N,
                                           fcols)
    icols = [c for c in range(S) if c not in fcols]
    assert np.array_equal(ints.numpy()[:, icols], rsums[:, icols])
    assert not ints.numpy()[:, fcols].any()
    pfs = shadow.numpy()[:, fcols].astype(np.float64)
    np.testing.assert_allclose(pfs, rfs, rtol=1e-2)
    exps = np.asarray(exps)
    assert (r_mxu.mxu_overflow({"mxu_fsums": rfs}, slotr)
            == p_mxu.mxu_overflow({"mxu_sums": ints.numpy(), "mxu_fsums": pfs,
                                   "mxu_f4exps": exps}, slotr, ra))
