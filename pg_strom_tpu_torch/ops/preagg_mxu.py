"""MXU-layout grouped aggregation: the host half.

The reference's ops/preagg_mxu.py computes every additive partial with one
one-hot matmul over an N x S value matrix (8-bit integer limbs, signed
float4 digit windows, |v| shadow columns) and recovers exact results on
the host in python big-int arithmetic.  The v2 kernel (ops/preagg_fused2.py)
emits the same output contract, so this slice of the PyTorch port carries
the host side: the slot recipes, the overflow (host replay) decision, the
exact extraction and the absorb into the executor's group states.  The
device-side column build and reduce (build_mxu_columns, mxu_reduce) are
ROADMAP queue 1, "Pre-aggregation XLA strategies".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..sqltypes import T

F4_LIMBS = 9
F4_WINDOW = 8 * F4_LIMBS         # 72-bit fixed-point window for float4 sums

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


def mxu_overflow(out, slot_recipes) -> bool:
    """Any additive slot outside its exact window => host replay.

    mxu_fsums carries ONLY the shadow columns (mxu_shadow_cols order)."""
    fsums = np.asarray(out["mxu_fsums"])
    spos = {c: i for i, c in enumerate(mxu_shadow_cols(slot_recipes))}
    for d in slot_recipes:
        for kind, r in d.items():
            if kind == "sum_i" and r.shadow >= 0 and np.any(
                    fsums[:, spos[r.shadow]] > float(1 << 61)):
                return True
            if kind == "sum_f" and not r.lo_limbs:
                if r.shadow < 0:
                    # v2 stats-elided shadow: column proven all-finite with
                    # nrows*max|v| far below f32-max — neither garbage
                    # digits nor PG stepwise overflow is possible
                    continue
                sh = fsums[:, spos[r.shadow]]
                # PG sums float4 stepwise in f32: if the absolute mass could
                # reach f32-inf territory the host must replay sequentially
                # to reproduce PostgreSQL's mid-sum overflow error (the same
                # guard the scatter path applies on-device)
                if (np.any(np.isinf(sh)) or np.any(np.isnan(sh))
                        or np.any(sh > 3.0e38)):
                    return True
            elif r.lo_limbs:
                # f64 double-float block: inf/nan head (value beyond the f32
                # head range, or inf/nan input/square) => host replay — the
                # same domain as the TPU-emulated-f64 recheck
                sh = fsums[:, spos[r.shadow]]
                if np.any(np.isinf(sh)) or np.any(np.isnan(sh)):
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
    """Correctly rounded float of M * 2^e for arbitrary-width int M."""
    if M == 0:
        return 0.0
    if e >= 0:
        f = float(M)                      # one rounding
        return f * (2.0 ** e) if e < 1024 else float(M << e)
    # M / 2^-e: keep 54+ significant bits, let float division round once
    shift = max(M.bit_length() - 63, 0)
    if shift <= -e:
        return float(M >> shift) / float(1 << (-e - shift)) if -e - shift < 1024 \
            else float(M >> shift) * (2.0 ** (e + shift))
    return float(M) * (2.0 ** e)


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
    if recipes is None:
        raise NotImplementedError(
            "mxu absorb without v2 recipes: not ported yet (ROADMAP queue "
            "1: Pre-aggregation XLA strategies)")
    keyr, slotr = [], recipes
    if dense_key:
        groups = mxu_dense_groups(out_host, key_types[0], key_metas[0])
    else:
        collision, groups = mxu_host_groups(out_host, keyr, key_metas)
        if collision:
            return True, False
    if mxu_overflow(out_host, slotr):
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
