"""MXU-layout grouped aggregation: the N x S value-matrix contract.

The reference (pg_strom_tpu/ops/preagg_mxu.py) computes every additive
partial of a grouped aggregate as per-bucket column sums of an N x S value
matrix V: 8-bit integer limbs, signed 72-bit float digit windows, key
constancy blocks (n, sum(kb), sum(kb^2): a Cauchy-Schwarz equality check
recovers the key or flags a collision) and |v| shadow columns that guard
the exact window.  The host recovers exact results in python big-int
arithmetic.  On the TPU the column sums are a one-hot matmul; the port
keeps the contract and computes the sums as segmented reductions:

  build_mxu_columns  V (bf16, every integer column in [-255, 255]) and
                     the per-slot float window exponents, in torch;
  mxu_reduce         exact int64 column sums and float64 shadow sums per
                     bucket: an int64 index_add_ over SEG_ROWS row blocks
                     (plain PyTorch, as the reference's XLA code), or K4
                     (ops/preagg_pallas.py) under config.use_pallas_reduce;
  host side          recipes, overflow (host replay) decision, extraction
                     and absorb into the executor's group states.

The fused kernel K2 (ops/preagg_fused.py) builds the same sums without
materializing V; both paths share the recipe walk, so the layout cannot
drift.  Unsigned lanes ride as int64 (two's-complement bits of the u64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..sqltypes import T
from ..utils.perfmon import spanned

# rows per reduction block of the plain mxu_reduce (the reference's
# per-segment f32 exactness bound; here it bounds the int64 copy of V)
SEG_ROWS = 1 << 16

F4_LIMBS = 9
F4_WINDOW = 8 * F4_LIMBS         # 72-bit fixed-point window for float4 sums

_MXU_KINDS = {"nrows", "count", "sum_i", "sum_f", "sumsq_i", "sumsq_f",
              "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"}
_F64_KINDS = {"sumsq_f", "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"}
_KEY_OK_TYPES = {T.BOOL, T.INT2, T.INT4, T.DATE, T.TEXT, T.BPCHAR,
                 T.INT8, T.TIME, T.TIMESTAMP}
# 64-bit key lanes ride as TWO independent 32-bit word blocks: constancy of
# the lo word AND of the hi word within a bucket <=> constancy of the key,
# so each word gets its own sum/sumsq Cauchy-Schwarz check and the host
# reassembles the value from the two word means.
_KEY_WIDE_TYPES = {T.INT8, T.TIME, T.TIMESTAMP}


def mxu_keys_supported(key_types: Sequence[T]) -> bool:
    """Narrow (<=32-bit data lane) key types get exact sum/sumsq checks."""
    return bool(key_types) and all(t in _KEY_OK_TYPES for t in key_types)


def mxu_dense_supported(key_types: Sequence[T]) -> bool:
    """Single int-lane key => the DENSE-key strategy ('mxu_dense'): buckets
    are key - min(key), so the bucket INDEX recovers the key and the ~17
    key-constancy/recovery matmul columns (sum/sumsq limb blocks + nval)
    vanish — collisions are impossible by construction.  A chunk whose key
    range exceeds G-2 sets `dense_fail` and the executor re-dispatches the
    generic 'mxu' strategy."""
    return (len(key_types) == 1 and key_types[0] in _KEY_OK_TYPES)


# A slot whose quantity q rides the double-float lanes (head f32(q) + tail
# f32(q - head): sum of a float8, and the squares and products of stddev,
# variance and covariance) runs on the device only over rows where q is 0
# or 2^-102 <= |q| <= 1e37.  Below, the f32 tail is subnormal and the pair
# holds fewer than 48 bits, down to both halves flushing to zero (the sum
# would silently lose the row); above, q nears the head's f32 range.  The
# lane encoders give such a row an inf head, so the shadow reads inf and
# the chunk replays on the host (mxu_overflow); the IEEE segment sums of
# the other strategies raise ERR_CPU_RECHECK on the same rows, so where a
# chunk runs does not change its answer.  The domain holds the
# [1e-37, 1e37] of every argument that the datastore's float8 range rule
# used to guard; compares, sorts, keys and joins need no rule on IEEE
# hardware.
F64_SUM_MIN = 2.0 ** -102
F64_SUM_MAX = 1e37


def f64_out_of_domain(q: torch.Tensor) -> torch.Tensor:
    """Rows whose double-float quantity q leaves the lanes' domain."""
    a = q.abs()
    return (a > F64_SUM_MAX) | ((a < F64_SUM_MIN) & (a != 0))


# A float slot's digit window keeps each row's bits down to its LSB,
# 2^(E - F4_WINDOW) for the window exponent E the slot publishes in
# mxu_f4exps (the v2 plan publishes an E adjusted for its limb count), so
# bucket g of n_g rows (column 0) loses less than n_g * LSB; a double-float
# slot less than n_g * (LSB_head + LSB_tail).  The window's top follows the
# largest |value| of the chunk (of the column, on the v2 plan), so a group
# whose values lie some 2^48 below another group's loses them all.  The
# host replays the chunk when that bound exceeds 2^-(p + WINDOW_MARGIN_BITS)
# of the bucket's absolute mass A_g (its shadow column: sum |v| or
# sum |head|, which no cancellation shrinks): p is the bits of the answer,
# 24 for sum(float4), whose result is a float4, and 53 for every float8
# answer (avg and the variance family over a float4 accumulate in float8,
# as PostgreSQL's float4_accum does).  The margin keeps the dropped part
# 2^-8 below the answer's last bit and covers a shadow that reads high by
# up to 2^8: bf16 shadow cells in the value matrix (K4, mxu_reduce) are
# within 2^-8 of |v|, and the f32 shadow sums of K1, K2 and K4 drift far
# less.  A_g = 0 means every row was +-0 or NULL: the sum is exact.  t0's
# float8 sums (values in [0, 100), each group's mean near 50) clear the
# check by more than 9 bits; the flagship's v2 plan keeps no shadow.
WINDOW_MARGIN_BITS = 8
# shadow cells hold a nonzero |v| below the smallest normal float32 as
# 2^-126: the card's global float atomics (REDG.ADD.F32.FTZ) flush a
# block's subnormal shadow sum, and bf16 cells drop |v| below 2^-133.  A
# float4 holds no bit below 2^-149, so where the window's LSB is finer a
# subnormal row loses nothing, and where it is coarser n_g * LSB exceeds
# n_g * 2^-126 * 2^-(p + WINDOW_MARGIN_BITS) and the chunk replays.
SHADOW_MIN = 2.0 ** -126


def shadow_cell(x: torch.Tensor) -> torch.Tensor:
    """x as a shadow cell: a nonzero |x| below SHADOW_MIN reads as
    +-SHADOW_MIN (NaN and inf kept; the kernels' onehot::Sink::shadow)."""
    a = x.abs()
    return torch.where((a > 0) & (a < SHADOW_MIN),
                       torch.full_like(x, SHADOW_MIN).copysign(x), x)


def window_lossy(nrows, lsb, mass, bits: int) -> bool:
    """True when some bucket's digit window may have dropped more than
    2^-(bits + WINDOW_MARGIN_BITS) of its absolute mass: nrows and mass per
    bucket, lsb the window's resolution (see WINDOW_MARGIN_BITS)."""
    lost = np.asarray(nrows, np.float64) * lsb
    mass = np.asarray(mass, np.float64)
    return bool(np.any((mass > 0) & (lost > np.ldexp(
        mass, -(bits + WINDOW_MARGIN_BITS)))))


def f64_head_tail(q: torch.Tensor):
    """(head, tail) f32 lanes of quantity q; a row outside the domain gets
    an inf head, which the inf/nan shadow guard turns into a replay."""
    hi = q.to(torch.float32)
    lo = (q - hi.to(torch.float64)).to(torch.float32)
    return hi.masked_fill(f64_out_of_domain(q), float("inf")), lo


# float8 double-float blocks widen a plan by ~19 columns per slot.  On the
# card f64 kinds ride the column sums (K2), as on the TPU; on the CPU (the
# tests) they take the scatter side path, as the reference does on its CPU
# backend.  Tests force them on explicitly in both packages.
F64_BLOCKS_ON_CPU = False


def _f64_blocks_enabled() -> bool:
    from ..config import config
    return config.device != "cpu" or F64_BLOCKS_ON_CPU


def _kind_mxu_ok(kind: str, argtype: Optional[T]) -> bool:
    if kind not in _MXU_KINDS:
        return False
    if kind == "sum_f":
        if argtype is T.FLOAT4:
            return True
        return argtype is T.FLOAT8 and _f64_blocks_enabled()
    if kind in _F64_KINDS:
        return _f64_blocks_enabled()
    if kind == "sumsq_i":
        return argtype in (T.INT2, T.INT4)
    return True


# ---------------------------------------------------------------------------
# static column recipes — the device builder and the host extractor both
# derive the layout from this single walk, so they cannot drift
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SlotRecipe:
    kind: str
    # signed-digit limb columns, low first: column j sums digit_j(|v|)*sign(v)
    limbs: list[int] = dataclasses.field(default_factory=list)
    okcnt: int = -1
    shadow: int = -1
    bias_bits: int = 0
    f4_slot_no: int = -1         # index into the kernel's f4_exps vector
    # f64 (double-float) variant: limbs hold the f32 HEAD, these hold the
    # residual TAIL (q - f32(q)), each with its own exponent slot
    lo_limbs: list[int] = dataclasses.field(default_factory=list)
    lo_slot_no: int = -1
    # v2 (stats-driven) integer sums: the device encodes v - bias_value and
    # extraction adds bias_value * okcnt back in exact host big-int
    # arithmetic — no modular wrap, no overflow shadow (preagg_fused2.py)
    bias_value: int | None = None
    # digit width per limb column (v2 i8 mode ships 7-bit float4 digits)
    limb_bits: int = 8


@dataclasses.dataclass
class _KeyRecipe:
    sum_limbs: list[int]
    sumsq_limbs: list[int]
    nval: int
    bias: int
    t: T
    # 64-bit keys: the hi-word block (sum_limbs/sumsq_limbs hold the lo word)
    sum_limbs_hi: list[int] = dataclasses.field(default_factory=list)
    sumsq_limbs_hi: list[int] = dataclasses.field(default_factory=list)


def mxu_recipes(key_types: Sequence[T], aggs, arg_types: Sequence[tuple],
                dense_key: bool = False):
    """(key_recipes, per-agg {kind: _SlotRecipe}, ncols).

    Column 0 is always the bucket row count (mask).  aggs[i].slots with
    arg types arg_types[i] drive the slot walk.  dense_key (the
    'mxu_dense' strategy): buckets ARE biased key values, so no key
    recovery/constancy columns are emitted at all."""
    c = 1                                    # col 0: rows-per-bucket
    keyr: list[_KeyRecipe] = []
    for t in [] if dense_key else key_types:
        if t in _KEY_WIDE_TYPES:
            s_lo = list(range(c, c + 4)); c += 4
            q_lo = list(range(c, c + 8)); c += 8
            s_hi = list(range(c, c + 4)); c += 4
            q_hi = list(range(c, c + 8)); c += 8
            nv = c; c += 1
            keyr.append(_KeyRecipe(s_lo, q_lo, nv, 1 << 63, t,
                                   sum_limbs_hi=s_hi, sumsq_limbs_hi=q_hi))
        else:
            s = list(range(c, c + 5)); c += 5
            q = list(range(c, c + 8)); c += 8
            nv = c; c += 1
            keyr.append(_KeyRecipe(s, q, nv, 1 << 31, t))
    slotr: list[dict[str, _SlotRecipe]] = []
    nf4 = 0
    for inst, at in zip(aggs, arg_types):
        a_t = at[0] if at else None
        d: dict[str, _SlotRecipe] = {}
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a_t):
                continue
            if kind in ("nrows", "count"):
                d[kind] = _SlotRecipe(kind, [c]); c += 1
            elif kind == "sum_i":
                d[kind] = _SlotRecipe(kind, list(range(c, c + 8)),
                                      okcnt=c + 8, shadow=c + 9,
                                      bias_bits=63)
                c += 10
            elif kind == "sumsq_i":
                d[kind] = _SlotRecipe(kind, list(range(c, c + 8)))
                c += 8
            elif kind == "sum_f" and a_t is T.FLOAT4:
                d[kind] = _SlotRecipe(kind, list(range(c, c + F4_LIMBS)),
                                      shadow=c + F4_LIMBS,
                                      f4_slot_no=nf4)
                nf4 += 1
                c += F4_LIMBS + 1
            else:
                # f64 additive quantity: signed-digit double-float fixed
                # point (head + residual tail, each its own 72-bit window)
                L = F4_LIMBS
                d[kind] = _SlotRecipe(
                    kind,
                    limbs=list(range(c, c + L)),
                    lo_limbs=list(range(c + L, c + 2 * L)),
                    shadow=c + 2 * L,
                    f4_slot_no=nf4, lo_slot_no=nf4 + 1)
                nf4 += 2
                c += 2 * L + 1
        slotr.append(d)
    return keyr, slotr, c


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_BIAS63 = -(1 << 63)             # + 2^63 on u64 lanes held as int64


def _mask0(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, torch.zeros_like(x))


def _u64_limbs(u: torch.Tensor, nlimbs: int) -> list[torch.Tensor]:
    """8-bit limbs, low first, of u64 lanes held as int64 bits."""
    return [(u >> (8 * j)) & 0xFF for j in range(nlimbs)]


def _exact_pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Bit-exact 2^e (float32) for int e in [-126, 127]."""
    bits = ((e.to(torch.int64).clamp(-126, 127) + 127) << 23).to(torch.int32)
    return bits.view(torch.float32)


def _f4_scale_exp(absx: torch.Tensor):
    """(scale, E): scale = 2^-E exact power of two with max|v| * scale < 1.

    E = floor(log2(max|v|)) + 1, with the float32 log2 taken as the
    correctly rounded value of the float64 log2; the bump guards a log2
    that rounds up to the next power of two.  The reference's XLA f32 log2
    agrees at and above every power of two; a few ulps below one it may
    round the other way, giving an E one apart (both windows are valid)."""
    m = absx.max() if absx.numel() else torch.zeros((), dtype=torch.float32,
                                                      device=absx.device)
    m = m.to(torch.float32)
    tiny = torch.tensor(1e-38, dtype=torch.float32, device=m.device)
    lg = torch.floor(torch.log2(torch.maximum(m, tiny).to(torch.float64))
                     .to(torch.float32)).to(torch.float64)
    # float -> int32 saturates (inf -> INT32_MAX) and the +1 wraps in
    # int32, as in the reference's XLA arithmetic
    e = lg.clamp(-(1 << 31), (1 << 31) - 1).to(torch.int64) + 1
    e = ((e + (1 << 31)) & _M32) - (1 << 31)
    e = e.clamp(-125, 126)
    sc = _exact_pow2_f32(-e)
    bump = (m * sc) >= 1.0                      # guard log2 rounding
    e = torch.where(bump, e + 1, e)
    sc = torch.where(bump, sc * 0.5, sc)
    return sc, e.to(torch.int32)


def _f4_limb_cols(x: torch.Tensor, sc: torch.Tensor) -> list[torch.Tensor]:
    """SIGNED 72-bit fixed-point limbs of one f32 lane, low limb FIRST:
    column j is digit_j(|x|) * sign(x) in [-255, 255].  NaN lanes
    contribute 0 digits (the |x| shadow column carries the NaN to the
    host-replay guard)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    pos = torch.where(x > 0, x, zero)
    neg = torch.where(x < 0, -x, zero)          # NaN compares false
    sgn = torch.where(x < 0, -1.0, 1.0).to(torch.float32)
    v = (pos + neg) * sc
    high_first = []
    for _ in range(F4_LIMBS):
        v = v * 256.0
        d = torch.floor(v)
        v = v - d
        high_first.append(d * sgn)
    return list(reversed(high_first))


def build_mxu_columns(key_vals, aggs, arg_vals, mask: torch.Tensor, n: int,
                      dense_key: bool = False):
    """(V bf16 [n, S], per-window exponents int32) in recipe order.

    V is filled column by column in place (an N x S float32 staging matrix
    would be twice its size)."""
    cols: list = [mask]                                        # col 0
    f4_exps: list[torch.Tensor] = []

    for k in [] if dense_key else key_vals:
        okk = mask & k.valid
        if k.t in _KEY_WIDE_TYPES:
            # 64-bit key: biased word pair, one sum/sumsq block per word
            u = _mask0(k.data.to(torch.int64) ^ _BIAS63, okk)
            for w in (u & _M32, (u >> 32) & _M32):
                cols.extend(_u64_limbs(w, 4))
                cols.extend(_u64_limbs(w * w, 8))
            cols.append(okk)
            continue
        kb = _mask0(k.data.to(torch.int64) + (1 << 31), okk)
        cols.extend(_u64_limbs(kb, 5))
        cols.extend(_u64_limbs(kb * kb, 8))
        cols.append(okk)

    def _f32_signed_block(x32: torch.Tensor):
        """(signed limbs, exp) of a masked f32 lane."""
        absx = torch.where(torch.isnan(x32), torch.zeros_like(x32),
                           x32.abs())
        sc, e = _f4_scale_exp(absx)
        return _f4_limb_cols(x32, sc), e

    for inst, vals in zip(aggs, arg_vals):
        a = vals[0] if vals else None
        ok = mask if a is None else (mask & a.valid)
        if len(vals) == 2:
            ok = mask & vals[0].valid & vals[1].valid
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a.t if a is not None else None):
                continue
            if kind == "nrows":
                cols.append(mask)
            elif kind == "count":
                cols.append(ok)
            elif kind == "sum_i":
                v = _mask0(a.data.to(torch.int64), ok)
                cols.extend(_u64_limbs(_mask0(v + _BIAS63, ok), 8))
                cols.append(ok)
                cols.append(_mask0(a.data.to(torch.float32).abs(), ok))
            elif kind == "sumsq_i":
                v = _mask0(a.data.to(torch.int64), ok)
                cols.extend(_u64_limbs(v * v, 8))
            elif kind == "sum_f" and a.t is T.FLOAT4:
                x = _mask0(a.data.to(torch.float32), ok)
                absx = torch.where(torch.isnan(x), torch.zeros_like(x),
                                   x.abs())
                sc, e = _f4_scale_exp(absx)
                f4_exps.append(e)
                cols.extend(_f4_limb_cols(x, sc))
                cols.append(shadow_cell(_mask0(a.data.to(torch.float32).abs(),
                                               ok)))
            else:
                # f64 additive quantity q -> head f32(q) + tail f32(q - head)
                hi, lo = f64_head_tail(_f64_quantity(kind, vals, ok))
                hp, he = _f32_signed_block(hi)
                lp, le = _f32_signed_block(lo)
                f4_exps.append(he)
                f4_exps.append(le)
                cols.extend(hp)
                cols.extend(lp)
                cols.append(hi.abs())              # shadow: inf/nan guard
    # bf16 column matrix: every integer column is in [-255, 255] (exact in
    # bf16's 8-bit significand); shadow columns are threshold guards with a
    # 4x band, so bf16 quantization is safe
    V = torch.empty((n, len(cols)), dtype=torch.bfloat16, device=mask.device)
    for j, c in enumerate(cols):
        V[:, j] = c.expand(n)
    exps = (torch.stack(f4_exps) if f4_exps
            else torch.zeros(0, dtype=torch.int32, device=mask.device))
    return V, exps


def _f64_quantity(kind: str, vals, ok: torch.Tensor) -> torch.Tensor:
    """The per-row f64 value each additive f64 slot kind sums."""
    x = _mask0(vals[0].data.to(torch.float64), ok)
    if kind in ("sum_f", "sum_x"):
        return x
    if kind in ("sumsq_f", "sumsq_x"):
        return x * x
    y = _mask0(vals[1].data.to(torch.float64), ok)
    if kind == "sum_y":
        return y
    if kind == "sumsq_y":
        return y * y
    if kind == "sum_xy":
        return x * y
    raise ValueError(kind)


def sat_int64(x: torch.Tensor) -> torch.Tensor:
    """Value-matrix cells to int64 the way XLA and CUDA convert: toward
    zero, saturating at the int64 range, NaN -> 0.  Only the columns of a
    chunk that host replay discards ever hold a non-finite cell."""
    f = x.to(torch.float32)
    i = torch.where(torch.isfinite(f), f, torch.zeros_like(f)).to(torch.int64)
    i = torch.where(f == float("inf"), torch.full_like(i, (1 << 63) - 1), i)
    return torch.where(f == float("-inf"), torch.full_like(i, -(1 << 63)), i)


def mxu_reduce(V: torch.Tensor, seg_id: torch.Tensor, G: int, n: int,
               fsum_cols=None):
    """Segmented column sums: (sums int64[G, S] exact ints, fsums
    float64[G, len(fsum_cols)] for the shadow columns).  seg_id == G drops
    the row.

    The plain path (both devices) is an int64 index_add_ over SEG_ROWS row
    blocks, so no int64 copy of the whole V is ever made.  Under
    config.use_pallas_reduce, with G <= MAX_G and a shape K4 plans
    (k4_fits), K4 computes it (ops/preagg_pallas.py); a shape it cannot
    plan takes the plain path and counts `k4_shape_routed`."""
    S = V.shape[1]
    explicit_shadow = fsum_cols is not None
    if fsum_cols is None:
        fsum_cols = list(range(S))
    from ..config import config as _cfg
    from .preagg_pallas import pallas_reduce, k4_fits, MAX_G
    if _cfg.use_pallas_reduce and explicit_shadow and G <= MAX_G:
        if k4_fits(G, S, len(fsum_cols)):
            return pallas_reduce(V, seg_id, G, n, list(fsum_cols))
        from ..utils.perfmon import bump_active
        bump_active("k4_shape_routed")
    dev = V.device
    seg = seg_id.to(torch.int64).clamp(0, G)
    fsel = torch.as_tensor(list(fsum_cols), dtype=torch.int64, device=dev)
    sums = torch.zeros((G + 1, S), dtype=torch.int64, device=dev)
    fsums = torch.zeros((G + 1, len(fsum_cols)), dtype=torch.float64,
                        device=dev)
    for s in range(0, n, SEG_ROWS):
        blk = V[s:s + SEG_ROWS]
        sg = seg[s:s + SEG_ROWS]
        sums.index_add_(0, sg, sat_int64(blk))
        if len(fsum_cols):
            fsums.index_add_(0, sg, blk[:, fsel].to(torch.float64))
    return sums[:G], fsums[:G]


def mxu_shadow_cols(slotr) -> list[int]:
    """Global column indexes needing the f64 shadow reduction (sorted)."""
    return sorted(r.shadow for d in slotr for r in d.values()
                  if r.shadow >= 0)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def _limb_int(sums: np.ndarray, g: int, idxs: Sequence[int],
              bits: int = 8) -> int:
    v = 0
    for j, ci in enumerate(idxs):
        v += int(sums[g, ci]) << (bits * j)
    return v


def mxu_host_groups(out, key_recipes, key_metas):
    """Exact key-constancy check + key recovery over nonempty buckets.

    Returns (collision, [(g, keyvals tuple)]); collision True triggers the
    executor's salt-retry / sort-fallback, same as the scatter contract."""
    sums = np.asarray(out["mxu_sums"])
    nrows_b = sums[:, 0]
    groups = []
    for g in np.flatnonzero(nrows_b > 0):
        g = int(g)
        nb = int(nrows_b[g])
        kv = []
        for kr, meta in zip(key_recipes, key_metas):
            nval = int(sums[g, kr.nval])
            if nval not in (0, nb):
                return True, []              # NULL/value mix in one bucket
            if nval == 0:
                kv.append(None)
                continue
            s1 = _limb_int(sums, g, kr.sum_limbs)
            s2 = _limb_int(sums, g, kr.sumsq_limbs)
            if nval * s2 != s1 * s1:
                return True, []              # two distinct keys share bucket
            if kr.sum_limbs_hi:
                # 64-bit key: hi word must be constant too
                h1 = _limb_int(sums, g, kr.sum_limbs_hi)
                h2 = _limb_int(sums, g, kr.sumsq_limbs_hi)
                if nval * h2 != h1 * h1:
                    return True, []
                raw = ((h1 // nval) << 32 | (s1 // nval)) - kr.bias
                kv.append(_decode_key(kr.t, raw, meta))
            else:
                kv.append(_decode_key(kr.t, s1 // nval - kr.bias, meta))
        groups.append((g, tuple(kv)))
    return False, groups


def _decode_key(t: T, raw: int, meta):
    if t in (T.TEXT, T.BPCHAR):
        return meta.dictionary[raw] if meta and meta.dictionary else None
    if t is T.BOOL:
        return bool(raw)
    return int(raw)


def mxu_overflow(out, slot_recipes, aggs) -> bool:
    """Any additive slot outside its exact window => host replay.

    mxu_fsums carries ONLY the shadow columns (mxu_shadow_cols order);
    aggs[i] owns slot_recipes[i] (its aggname sets a float sum's bits)."""
    sums = np.asarray(out["mxu_sums"])
    fsums = np.asarray(out["mxu_fsums"])
    exps = np.asarray(out["mxu_f4exps"])
    spos = {c: i for i, c in enumerate(mxu_shadow_cols(slot_recipes))}

    def lsb(slot_no: int) -> float:
        return 2.0 ** (int(exps[slot_no]) - F4_WINDOW)

    for inst, d in zip(aggs, slot_recipes):
        for kind, r in d.items():
            if kind == "sum_i" and r.shadow >= 0 and np.any(
                    fsums[:, spos[r.shadow]] > float(1 << 61)):
                return True
            if kind == "sum_f" and not r.lo_limbs:
                if r.shadow < 0:
                    # v2 stats-elided shadow: column proven all-finite with
                    # nrows*max|v| far below f32-max and every row's bits
                    # inside the window — neither garbage digits, dropped
                    # bits nor PG stepwise overflow is possible
                    continue
                sh = fsums[:, spos[r.shadow]]
                # PG sums float4 stepwise in f32: if the absolute mass could
                # reach f32-inf territory the host must replay sequentially
                # to reproduce PostgreSQL's mid-sum overflow error (the same
                # guard the scatter path applies on-device)
                if (np.any(np.isinf(sh)) or np.any(np.isnan(sh))
                        or np.any(sh > 3.0e38)):
                    return True
                if window_lossy(sums[:, 0], lsb(r.f4_slot_no), sh,
                                24 if inst.aggname == "sum" else 53):
                    return True
            elif r.lo_limbs:
                # f64 double-float block: inf/nan head (a quantity outside
                # the lanes' domain, which f64_head_tail marks inf, or a
                # nan input) => host replay
                sh = fsums[:, spos[r.shadow]]
                if np.any(np.isinf(sh)) or np.any(np.isnan(sh)):
                    return True
                if window_lossy(sums[:, 0], lsb(r.f4_slot_no)
                                + lsb(r.lo_slot_no), sh, 53):
                    return True
    return False


def mxu_extract_slot(r: _SlotRecipe, out, g: int) -> dict:
    """Host-exact partial(s) for one MXU slot kind at bucket g."""
    sums = np.asarray(out["mxu_sums"])
    if r.kind in ("nrows", "count"):
        return {r.kind: int(sums[g, r.limbs[0]])}
    if r.kind == "sum_i":
        okcnt = int(sums[g, r.okcnt])
        if r.bias_value is not None:
            # v2 min-biased encode: the limb sums reconstruct sum(v - min)
            # with no truncation, so the true sum is exact — no modular
            # wrap, no shadow guard needed (preagg_fused2.py)
            return {"sum_i": _limb_int(sums, g, r.limbs)
                    + okcnt * r.bias_value}
        total = _limb_int(sums, g, r.limbs) - (okcnt << r.bias_bits)
        total &= (1 << 64) - 1               # modular-int64 contract
        if total >= (1 << 63):
            total -= 1 << 64
        return {"sum_i": total}
    if r.kind == "sumsq_i":
        return {"sumsq_i": _limb_int(sums, g, r.limbs)}
    if r.kind == "sum_f" and not r.lo_limbs:
        E = int(np.asarray(out["mxu_f4exps"])[r.f4_slot_no])
        m = _limb_int(sums, g, r.limbs, r.limb_bits)  # signed digit sums
        return {"sum_f": float(m) * 2.0 ** (E - F4_WINDOW)}
    if r.lo_limbs:
        exps = np.asarray(out["mxu_f4exps"])
        Eh = int(exps[r.f4_slot_no])
        El = int(exps[r.lo_slot_no])
        mh = _limb_int(sums, g, r.limbs)
        ml = _limb_int(sums, g, r.lo_limbs)
        # both terms are dyadic rationals: combine exactly in big ints and
        # round ONCE — the correctly-rounded true sum (within the per-row
        # 2^(E-72) truncation window)
        emin = min(Eh, El) - F4_WINDOW
        M = (mh << (Eh - F4_WINDOW - emin)) + (ml << (El - F4_WINDOW - emin))
        return {r.kind: _dyadic_float(M, emin)}
    raise ValueError(r.kind)


def _dyadic_float(M: int, e: int) -> float:
    """Correctly rounded float of M * 2^e for arbitrary-width int M.

    Python's int / int rounds once, to nearest even.  The reference keeps
    the top 63 bits of M and lets float() round those: where the bits it
    drops are not all zero and the kept ones sit exactly halfway between
    two floats, it rounds to even where the true value lies above the
    halfway point (tests/test_torch_sum_window.py)."""
    if e >= 0:
        return float(M << e)
    return M / (1 << -e)


# ---------------------------------------------------------------------------
# executor glue: one call consumes a fetched MXU-strategy chunk output
# ---------------------------------------------------------------------------

def mxu_dense_groups(out, key_type: T, meta):
    """Populated buckets of a dense-key ('mxu_dense') chunk: bucket index
    IS key - kmin; bucket rng+1 is the NULL-key group."""
    sums = np.asarray(out["mxu_sums"])
    kmin = int(np.asarray(out["dense_kmin"]))
    rng = int(np.asarray(out["dense_rng"]))
    groups = []
    for g in np.flatnonzero(sums[:, 0] > 0):
        g = int(g)
        kv = None if g == rng + 1 else _decode_key(key_type, kmin + g, meta)
        groups.append((g, (kv,)))
    return groups


@spanned("absorb")
def mxu_absorb(out_host, group_exprs, aggs, key_metas, states, displays,
               merge_partials, extract_partials, canon_group_key,
               dense_key: bool = False, recipes=None):
    """Merge one fetched MXU-strategy output into (states, displays).

    Returns (collision, overflow): collision => executor re-salts / falls
    back to the sort strategy; overflow => host replays the chunk (the
    CpuReCheck contract).  Either way states are untouched on failure.
    dense_key must match the strategy that produced out_host ('mxu_dense').
    recipes overrides the layout walk (the v2 stats-driven kernel derives
    its own slot recipes — preagg_fused2.derive_v2_plan)."""
    key_types = [g.type for g in group_exprs]
    arg_types = [tuple(a.type for a in inst.args) for inst in aggs]
    if recipes is not None:
        keyr, slotr = [], recipes
    else:
        keyr, slotr, _ = mxu_recipes(key_types, aggs, arg_types,
                                     dense_key=dense_key)
    if dense_key:
        groups = mxu_dense_groups(out_host, key_types[0], key_metas[0])
    else:
        collision, groups = mxu_host_groups(out_host, keyr, key_metas)
        if collision:
            return True, False
    if mxu_overflow(out_host, slotr, aggs):
        return False, True
    slots = [{k: np.asarray(v) for k, v in d.items()}
             for d in out_host["slots"]]
    for g, kvals in groups:
        ck = tuple(canon_group_key(v) for v in kvals)
        parts = []
        for inst, rd, arrs in zip(aggs, slotr, slots):
            p = extract_partials(inst, arrs, g, skip=tuple(rd.keys()))
            for kind, r in rd.items():
                p.update(mxu_extract_slot(r, out_host, g))
            parts.append(p)
        if ck not in states:
            states[ck] = parts
            displays[ck] = kvals
        else:
            st = states[ck]
            states[ck] = [merge_partials(inst, a, b)
                          for inst, a, b in zip(aggs, st, parts)]
    return False, False
