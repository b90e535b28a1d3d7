"""Fused pre-aggregation kernel v2 (K1): raw column planes in, per-bucket
partial sums out.

The reference (pg_strom_tpu/ops/preagg_fused2.py) reads the columns' raw
storage planes and derives mask, bucket ids, limbs and digits inside one
Pallas kernel, then contracts a one-hot bucket matrix with the value
matrix on the TPU's MXU.  This module ports it to PyTorch/CUDA:

* **Plan derivation is copied** (`V2Sig`, `V2Plan`,
  `derive_v2_plan`, `_pred_kernel_safe`, `_f4_stats`): numpy over exact
  column statistics (datastore.column_stats).  Integer sums encode
  v - min in 8-bit limbs, float4 sums a signed digit window anchored at
  the column max, and a NULL-free column ships no validity plane.  The
  plan keeps the reference's TPU-only fields (`bool_inputs`, `i8`,
  `biased_cols`, the int64 "lo"/"hi" inputs) so the two packages derive
  equal plans; the port maps both int64 inputs onto the raw int64 plane
  and emits unbiased sums.  One difference: a float4 sum column whose
  range does not fit its digit window keeps its |v| shadow, so the host's
  window check can replay a chunk where the window dropped a group's
  rows (`_f4_stats`; the reference drops the shadow and sums them to 0).
* **One fixed kernel, driven by tables** (ops/cuda/preagg_fused2.cu, a
  row decoder on the accumulation core ops/cuda/onehot_accum.cuh,
  launched as ops/launch_plan.py plans).
  `lower_program` turns `sig.ops` into an int32 op table and the
  kernel-safe predicate into an int32 postfix program over a (data,
  valid) stack — PostgreSQL float order (NaN equals NaN and sorts above
  everything), Kleene AND/OR/NOT, IS [NOT] NULL, bare bool columns.  No
  source is generated per plan.
* **The contract is the output dict**, not the TPU internals: the kernel
  emits `ints int64[G, K]` (the exact per-bucket sum of each physical
  column) and `shadow float32[G, K]` (per-bucket sum of |x| for the
  `fabs` columns); `build_fused2_fn`'s torch epilogue applies `int_map`
  and `shadow_map` into `{mxu_sums, mxu_fsums, mxu_f4exps, dense_kmin,
  dense_rng, dense_fail}` exactly like the reference's.  P=8 row packing,
  the diagonal epilogue, bf16/int8 digits, the 2^16-row flush and the
  int8 digit-128 bias have no counterpart.
* **Plain PyTorch version** (`fused2_reference`): the same tables
  interpreted with tensor ops, per-row values as int64 [N, K] then
  `index_add_` into [G+1, K] with masked rows in bucket G.  The CPU path
  and the tests use it; on a CUDA tensor `build_fused2_fn` launches the
  kernel (`fused2_cuda`) or raises.

Reference parity: gpupreagg preparation+reduction in one pass
(opencl_gpupreagg.h:380-615) with the qual evaluated in the same kernel
(gpupreagg_qual_eval, gpupreagg.c:1181-1943).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef, Const, FuncExpr, BoolExpr, NullTest
from .preagg_mxu import _SlotRecipe, F4_LIMBS, shadow_cell
from ..utils.perfmon import span

LANES = 128
F4_WINDOW_BITS = 72   # == preagg_mxu.F4_WINDOW (host divides by 2^72)

_KEY_TYPES = (T.INT4, T.DATE, T.TEXT, T.BPCHAR, T.BOOL)
# i8 mode's float4 digits: 11 limbs of 7 bits (a 77-bit window)
_I8_DBITS = 7
_I8_CAP = 11


# ---------------------------------------------------------------------------
# plan derivation (executor side; consumes column statistics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class V2Sig:
    """Static kernel signature — hashable, part of the plan cache key.
    Carries structure only (op shapes / limb counts), never data values
    (mins/scales ride as runtime scalars so programs survive data
    versions)."""
    ops: tuple                   # kernel ops, see _build_kernel
    inputs: tuple                # (schema_idx, plane) plane in data/valid/lo/hi
    ni: int                      # i32 scalar count (after nrows at [0])
    nu: int                      # u32 scalar count
    nf4: int
    ncols: int                   # physical kernel columns
    S: int                       # recipe (mxu_sums) width
    int_map: tuple               # (recipe_col, phys_col, mult)
    shadow_map: tuple            # (recipe_shadow_col, phys_col)
    rng: int                     # dense key range; G buckets >= rng + 2
    has_pred: bool
    # input positions delivered as 2-D bool blocks (pallas converts i1
    # memrefs to i32 — cheaper than in-kernel i8 widen+reshape chains)
    bool_inputs: tuple = ()
    # int8 MXU mode: V digits + one-hot in i8, i32 accumulator.  Integer
    # limbs ride as digit-128 (the epilogue adds 128*bucket_rows back per
    # biased phys col — biased_cols); float4 digits are 7-bit signed.
    # Engages only when no shadow column exists (the fabs mirror needs the
    # f32 accumulator).
    i8: bool = False
    biased_cols: tuple = ()


@dataclasses.dataclass
class V2Plan:
    sig: V2Sig
    G: int
    kmin: int
    recipes: list                # per-agg {kind: _SlotRecipe}
    scal_i: np.ndarray           # (1, ni) int32  [0]=placeholder for nrows
    scal_u: np.ndarray           # (1, max(nu,1)) uint32
    f4sc: np.ndarray             # (2, max(nf4,1)) float32 two-step scales
    f4e: np.ndarray              # (max(nf4,1),) int32 window exponents
    split_cols: tuple            # schema idxs needing i64 (lo[,hi]) planes
    pred: Optional[Expr]


def _bits(x: int) -> int:
    return max(int(x).bit_length(), 1)


def _wrap_i32(v: int) -> int:
    """Two's-complement wrap of a python int into the int32 value range
    (the kernel subtracts in i32 where wraparound is the point)."""
    return ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


_CMP_TAGS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le",
             ">": "gt", ">=": "ge"}
_PRED_OK_TYPES = (T.INT4, T.DATE, T.FLOAT4, T.BOOL)


def _pred_kernel_safe(e: Optional[Expr], schema) -> bool:
    """True when the predicate lowers to Mosaic-legal elementwise ops on
    32-bit lanes: comparisons (col vs const / col vs col, matching lane
    families), AND/OR/NOT, IS [NOT] NULL, bare bool columns/consts."""
    if e is None:
        return True

    def leaf_ok(a: Expr) -> bool:
        if isinstance(a, ColumnRef):
            return a.type in _PRED_OK_TYPES
        if isinstance(a, Const):
            return a.type in (T.INT4, T.INT2, T.INT8, T.DATE, T.FLOAT4,
                              T.FLOAT8, T.BOOL) and a.value is not None
        return False

    def ok(x: Expr) -> bool:
        if isinstance(x, BoolExpr):
            return all(ok(a) for a in x.args)
        if isinstance(x, NullTest):
            return isinstance(x.arg, ColumnRef)
        if isinstance(x, ColumnRef):
            return x.type is T.BOOL
        if isinstance(x, Const):
            return x.type is T.BOOL
        if isinstance(x, FuncExpr):
            op = x.fname.split("::", 1)[0]
            if op not in _CMP_TAGS or len(x.args) != 2:
                return False
            a, b = x.args
            if not (leaf_ok(a) and leaf_ok(b)):
                return False
            ts = {s.type for s in (a, b) if isinstance(s, ColumnRef)}
            if not ts:
                return False               # const-vs-const: let v1 fold it
            # int consts against float columns (and vice versa) are fine —
            # the const is materialized in the column's compare domain at
            # trace time; int8 consts must fit the i32/f32 compare exactly
            for s in (a, b):
                if isinstance(s, Const) and s.type in (T.INT8, T.INT2,
                                                       T.INT4, T.DATE):
                    v = int(s.value)
                    if T.FLOAT4 in ts:
                        if float(np.float32(v)) != v:
                            return False
                    elif not (-(1 << 31) <= v < (1 << 31)):
                        return False
                if isinstance(s, Const) and s.type in (T.FLOAT4, T.FLOAT8):
                    if T.FLOAT4 in ts and s.type is T.FLOAT8:
                        # f8 const vs f4 column: PG compares in f8; only a
                        # const exactly representable in f32 keeps the f32
                        # compare faithful
                        if not (math.isnan(float(s.value))
                                or float(np.float32(s.value))
                                == float(s.value)):
                            return False
                    if ts - {T.FLOAT4} and T.FLOAT4 not in ts:
                        return False       # float const vs int column
            return True
        return False

    return ok(e)


def _f4_stats(ast, window_bits: int):
    """(mx, shadow_needed) for a float4 sum column whose digit window holds
    window_bits bits; None => v2-ineligible (+-Inf makes the max-anchored
    window meaningless and a chunk WITHOUT the Inf row could emit garbage
    digits under a finite shadow)."""
    if (ast.min_val is not None
            and not (math.isfinite(ast.min_val)
                     and math.isfinite(ast.max_val))):
        return None
    mx = float(ast.max_val) if ast.min_val is not None else 0.0
    mx = max(mx, abs(float(ast.min_val or 0.0)))
    # the |v| shadow guards three hazards: non-finite inputs (NaN rows
    # contribute no digits and must force host replay), PostgreSQL's
    # stepwise-f32 overflow error, and rows whose bits fall below the
    # window, which the host's window check (preagg_mxu.window_lossy) reads
    # from the shadow.  Statistics prove all three away for most columns:
    # all-finite data with nrows*max|v| far below f32-max, and a range
    # from the largest |v| down to the last mantissa bit of the smallest
    # nonzero |v| that fits the window (a value in [2^(e-1), 2^e) has no
    # bit below 2^(e-24)).  No minabs proves no range.
    out_of_window = mx > 0.0 and (
        ast.minabs is None
        or (math.frexp(mx)[1] - math.frexp(ast.minabs)[1] + 24
            > window_bits))
    need_shadow = (ast.has_nan
                   or (ast.n_valid > 0 and ast.min_val is None)
                   or ast.nrows * mx >= 1e38
                   or out_of_window)
    return mx, need_shadow


def narrow_exact_casts(e: Optional[Expr]) -> Optional[Expr]:
    """`(float4_col)::float8 <op> c` -> `float4_col <op> c` wherever that is
    exact: c (float8) equal to its float32 rounding, or NaN.  The float4 ->
    float8 cast is exact and order-preserving (NaN stays NaN and keeps
    PostgreSQL's NaN-greatest order), so both forms select the same rows.
    The binder writes SQL's `x > 0.25` over a real column in the cast form,
    which _pred_kernel_safe rejects; the narrowed form is kernel-safe.  Only
    the kernel sees the narrowed predicate — host replay evaluates the
    bound original."""
    if isinstance(e, BoolExpr):
        return dataclasses.replace(
            e, args=tuple(narrow_exact_casts(a) for a in e.args))
    if not (isinstance(e, FuncExpr) and len(e.args) == 2
            and e.fname.split("::", 1)[0] in _CMP_TAGS):
        return e

    def narrowed(s):
        if (isinstance(s, FuncExpr) and s.fname == "cast::float8"
                and len(s.args) == 1 and isinstance(s.args[0], ColumnRef)
                and s.args[0].type is T.FLOAT4):
            return s.args[0]
        return None

    a, b = e.args
    for cast_side, other in ((0, b), (1, a)):
        col = narrowed(e.args[cast_side])
        if (col is not None and isinstance(other, Const)
                and other.type is T.FLOAT8 and other.value is not None):
            v = float(other.value)
            if math.isnan(v) or float(np.float32(v)) == v:
                args = list(e.args)
                args[cast_side] = col
                return dataclasses.replace(e, args=tuple(args))
    return e


def v2_supported_kinds(inst, a_t) -> bool:
    for kind in inst.slots:
        if kind in ("nrows", "count"):
            continue
        if kind == "sum_i" and a_t in (T.INT4, T.INT8):
            continue
        if kind == "sumsq_i" and a_t is T.INT4:
            continue
        if kind == "sum_f" and a_t is T.FLOAT4:
            continue
        return False
    return True


def derive_v2_plan(columns: Sequence, schema, group_exprs, aggs,
                   pred: Optional[Expr], max_g: int) -> Optional[V2Plan]:
    """Build the v2 plan from real column statistics, or None when the
    query shape is outside v2's envelope (caller then uses the v1 path).

    columns: datastore.Column per schema position (stats source)."""
    from ..datastore import column_stats

    if len(group_exprs) != 1 or not isinstance(group_exprs[0], ColumnRef):
        return None
    key = group_exprs[0]
    if key.type not in _KEY_TYPES or key.type is T.BOOL:
        return None
    kcol = columns[key.index]
    if kcol.data.dtype != np.int32:
        return None
    kst = column_stats(kcol)
    if kst.n_valid == 0:
        kmin, rng = 0, 0
    else:
        kmin, rng = int(kst.min_val), int(kst.max_val) - int(kst.min_val)
    if rng + 2 > max_g:
        return None                        # sparse key: v1 ladder handles it
    if not _pred_kernel_safe(pred, schema):
        return None

    # int8 MXU mode pre-decision: possible iff NO column will need a |v|
    # shadow (the fabs mirror rides the f32 accumulator).  Shadows only
    # arise from float4 sums, so scan those args up front — the f4 digit
    # WIDTH (7-bit in i8 mode) depends on this choice.
    from ..config import config as _cfg
    want_i8 = bool(_cfg.use_preagg_int8)
    if want_i8:
        for inst in aggs:
            a = inst.args[0] if inst.args else None
            if (a is not None and isinstance(a, ColumnRef)
                    and "sum_f" in inst.slots and a.type is T.FLOAT4):
                fs = _f4_stats(column_stats(columns[a.index]),
                               _I8_CAP * _I8_DBITS)
                if fs is None or fs[1]:
                    want_i8 = False
                    break

    ops: list = []
    biased: list = []                      # phys cols carrying digit-128
    inputs: list = []
    in_ix: dict = {}
    # i32 scalar vector layout AT THE KERNEL: [nrows, kmin, user...].
    # scal_i here holds [kmin, user...]; the wrapper prepends nrows.
    scal_i: list = [_wrap_i32(kmin)]
    scal_u: list = []
    f4sc: list = []
    f4e: list = []
    split_cols: list = []
    int_map: list = []
    shadow_map: list = []
    col = 0
    recipes: list = []
    S = 1                                  # recipe col 0 = bucket row count
    # contributing-row count columns shared ACROSS agg instances: count(x)
    # and sum(x)'s okcnt read the same physical and recipe column
    cnt_phys_by_col: dict = {}
    cnt_rcol_by_col: dict = {}

    def get_in(idx: int, plane: str) -> int:
        k = (idx, plane)
        if k not in in_ix:
            in_ix[k] = len(inputs)
            inputs.append(k)
        return in_ix[k]

    def get_valid(idx: int) -> int:
        # statistics-driven elision: a column with zero NULLs never ships
        # its validity plane — the kernel treats -1 as constant-true
        if column_stats(columns[idx]).null_count == 0:
            return -1
        return get_in(idx, "valid")

    def emit(op, width) -> int:
        nonlocal col
        ops.append(op)
        c = col
        col += width
        return c

    # register key + predicate column planes as kernel inputs (the ops walk
    # below only registers agg-arg planes)
    get_in(key.index, "data")
    key_vin = get_valid(key.index)
    for node in ([pred] if pred is not None else []):
        stack = [node]
        while stack:
            x = stack.pop()
            if isinstance(x, ColumnRef):
                get_in(x.index, "data")
                get_valid(x.index)
            for ch in getattr(x, "children", lambda: ())():
                stack.append(ch)

    # physical col 0: the mask column (recipe col 0 and every nrows slot)
    int_map.append((0, emit(("mask",), 1), 1))

    for inst in aggs:
        a = inst.args[0] if inst.args else None
        if a is not None and not isinstance(a, ColumnRef):
            return None
        a_t = a.type if a is not None else None
        if not v2_supported_kinds(inst, a_t):
            return None
        acol = columns[a.index] if a is not None else None
        ast = column_stats(acol) if acol is not None else None
        d: dict = {}
        # statistics-driven dead-column elision: a NULL-free arg column's
        # contributing-row count IS the bucket row count (recipe col 0) —
        # no cnt column is built and no recipe slot allocated
        a_nullfree = ast is not None and ast.null_count == 0

        def cnt_phys() -> int:
            if a.index not in cnt_phys_by_col:
                vin = get_valid(a.index)
                cnt_phys_by_col[a.index] = emit(("cnt", vin), 1)
            return cnt_phys_by_col[a.index]

        def cnt_rcol() -> int:
            """Recipe column summing contributing rows of a.index (shared
            across instances; 0 when statistics elide it entirely)."""
            nonlocal S
            if a_nullfree:
                return 0
            if a.index not in cnt_rcol_by_col:
                int_map.append((S, cnt_phys(), 1))
                cnt_rcol_by_col[a.index] = S
                S += 1
            return cnt_rcol_by_col[a.index]

        for kind in inst.slots:
            if kind == "nrows":
                d[kind] = _SlotRecipe(kind, [0])   # maps onto recipe col 0
            elif kind == "count":
                d[kind] = _SlotRecipe(kind, [cnt_rcol()])
            elif kind == "sum_i":
                if ast.n_valid == 0:
                    amin, arng = 0, 0
                else:
                    amin = int(ast.min_val)
                    arng = int(ast.max_val) - amin
                nl = max(-(-_bits(arng) // 8), 1) if arng else 1
                if a_t is T.INT4:
                    din = get_in(a.index, "data")
                    si = len(scal_i)
                    scal_i.append(_wrap_i32(amin))
                    c = emit(("sum_i4", din, get_valid(a.index),
                              nl, si), nl)
                else:                      # INT8 via u32 pair planes
                    lin = get_in(a.index, "lo")
                    hin = get_in(a.index, "hi") if nl > 4 else -1
                    if a.index not in split_cols:
                        split_cols.append(a.index)
                    su = len(scal_u)
                    um = amin & ((1 << 64) - 1)
                    scal_u += [np.uint32(um & 0xFFFFFFFF),
                               np.uint32(um >> 32)]
                    c = emit(("sum_i8", lin, hin,
                              get_valid(a.index), nl, su), nl)
                if want_i8:
                    biased.extend(range(c, c + nl))
                r = _SlotRecipe(kind, list(range(S, S + nl)),
                                okcnt=-2, bias_value=amin)
                S += nl
                for j in range(nl):
                    int_map.append((r.limbs[j], c + j, 1))
                r.okcnt = cnt_rcol()       # shared contributing-row count
                d[kind] = r
            elif kind == "sumsq_i":
                maxabs = max(abs(int(ast.min_val or 0)),
                             abs(int(ast.max_val or 0)))
                din = get_in(a.index, "data")
                if maxabs < (1 << 16):
                    nl = max(-(-(2 * _bits(maxabs)) // 8), 1)
                    c = emit(("sumsq4", din, get_valid(a.index), nl),
                             nl)
                    if want_i8:
                        biased.extend(range(c, c + nl))
                    r = _SlotRecipe(kind, list(range(S, S + nl)))
                    S += nl
                    for j in range(nl):
                        int_map.append((r.limbs[j], c + j, 1))
                else:
                    # |v| = a*2^16 + b: v^2 = a^2*2^32 + ab*2^17 + b^2
                    c = emit(("sumsq4_big", din,
                              get_valid(a.index)), 12)
                    if want_i8:
                        biased.extend(range(c, c + 12))
                    r = _SlotRecipe(kind, list(range(S, S + 8)))
                    S += 8
                    for j in range(4):
                        int_map.append((r.limbs[j], c + j, 1))
                    for j in range(4):
                        int_map.append((r.limbs[j + 2], c + 4 + j, 2))
                    for j in range(4):
                        int_map.append((r.limbs[j + 4], c + 8 + j, 1))
                d[kind] = r
            else:                          # sum_f on FLOAT4
                din = get_in(a.index, "data")
                vin = get_valid(a.index)
                nf = len(f4sc)
                # i8 mode: 7-bit signed digits (fit int8 with the sign
                # folded in); cap 11 limbs keeps >= the 72-bit window.
                dbits = _I8_DBITS if want_i8 else 8
                cap = _I8_CAP if want_i8 else F4_LIMBS
                fs = _f4_stats(ast, cap * dbits)
                if fs is None:
                    return None            # +-Inf column: v1 owns it
                mx, need_shadow = fs
                if mx > 0.0 and math.isfinite(mx):
                    _, E = math.frexp(mx)  # mx * 2^-E in [0.5, 1)
                else:
                    E = 0
                # stats-driven digit-window shrink: every |v| >= 2^(Emin-1)
                # (Emin = frexp exponent of the column's smallest nonzero
                # |v|) has no mantissa bit below 2^(Emin-1-23); a window
                # whose floor E-dbits*nl reaches it captures EVERY row's
                # full f32 mantissa, so fewer limb columns lose nothing.
                nl = cap
                if mx == 0.0:
                    nl = 1                 # only zeros (or nothing) to sum
                elif ast.minabs is not None:
                    _, emn = math.frexp(ast.minabs)
                    nl = max(1, min(cap, -(-(E - emn + 24) // dbits)))
                e1 = E - E // 2
                f4sc.append((np.float32(2.0 ** (-e1)),
                             np.float32(2.0 ** (-(E - e1)))))
                # host extract divides by 2^F4_WINDOW always; an nl-limb
                # digit sum m represents m * 2^(E - dbits*nl), so publish
                # the window-adjusted exponent
                f4e.append(np.int32(E + (F4_WINDOW_BITS - dbits * nl)))
                # a NaN-free column (== no shadow) also lets the kernel
                # take |v| with one abs op instead of the NaN-zeroing
                # pos/neg split (op flag)
                c = emit(("f4s", din, vin, nf, nl,
                          bool(not need_shadow)), nl)
                r = _SlotRecipe(kind, list(range(S, S + nl)),
                                f4_slot_no=nf, limb_bits=dbits)
                S += nl
                for j in range(nl):
                    int_map.append((r.limbs[j], c + j, 1))
                if need_shadow:
                    r.shadow = S
                    S += 1
                    shadow_map.append((r.shadow, emit(("fabs", din, vin),
                                                      1)))
                d[kind] = r
        recipes.append(d)

    if col > LANES:
        return None
    shadow_map.sort(key=lambda p: p[0])
    bool_in = tuple(
        i for i, (idx, which) in enumerate(inputs)
        if which == "valid" or (which == "data"
                                and columns[idx].data.dtype == np.bool_))
    assert not (want_i8 and shadow_map)
    sig = V2Sig(ops=tuple(ops), inputs=tuple(inputs),
                ni=len(scal_i) + 1,       # +1: nrows prepended per call
                nu=max(len(scal_u), 1), nf4=len(f4sc), ncols=col, S=S,
                int_map=tuple(int_map), shadow_map=tuple(shadow_map),
                rng=rng, has_pred=pred is not None, bool_inputs=bool_in,
                i8=want_i8, biased_cols=tuple(biased))
    G = max(_pow2(rng + 2), 8)
    return V2Plan(
        sig=sig, G=G, kmin=kmin, recipes=recipes,
        scal_i=np.asarray([scal_i], np.int32),
        scal_u=np.asarray([scal_u or [0]], np.uint32),
        f4sc=np.asarray(list(zip(*f4sc)) if f4sc else [[0.0], [0.0]],
                        np.float32),
        f4e=np.asarray(f4e or [0], np.int32),
        split_cols=tuple(split_cols), pred=pred)

def _in_index(sig: V2Sig, schema_idx: int, plane: str) -> int:
    return sig.inputs.index((schema_idx, plane))


def _in_index_opt(sig: V2Sig, schema_idx: int, plane: str) -> int:
    """Input position of a plane, or -1 when the plan elided it (a
    NULL-free column ships no validity plane)."""
    try:
        return _in_index(sig, schema_idx, plane)
    except ValueError:
        return -1


# ---------------------------------------------------------------------------
# lowering: sig.ops + predicate -> the int32 tables the kernel interprets
# (layouts shared with ops/cuda/preagg_fused2.cu; the predicate's also with
# ops/cuda/pred_program.cuh and K5)
# ---------------------------------------------------------------------------

# op table rows: (tag, col, din, vin, nl, x, flag, 0); x is the scal_i
# slot (sum_i4), the scal_u pair (sum_i8) or the f4 scale slot (f4s);
# flag is use_abs (f4s)
OP_W = 8
(OP_MASK, OP_CNT, OP_SUM_I4, OP_SUM_I8, OP_SUMSQ4, OP_SUMSQ4_BIG, OP_F4S,
 OP_FABS) = range(8)
# predicate program rows (postfix): (opcode, a1, ..., a8)
#   P_CMP      (tag, is_float, a_kind, a_val, a_vin, b_kind, b_val, b_vin);
#              kind 0 = column (val = data input), 1 = constant (val =
#              int32 value, or float32 bits when is_float)
#   P_NULLTEST (isnull, vin)   P_BOOLCOL (din, vin)   P_CONST (value)
#   P_AND / P_OR (binary: an n-ary node folds left, as the reference's
#   _kpred does, so the stack grows with nesting depth, not width)
#   P_NOT
PRED_W = 9
P_CMP, P_NULLTEST, P_BOOLCOL, P_CONST, P_AND, P_OR, P_NOT = range(1, 8)
_CMP_CODE = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}
# the kernel keeps the (data, valid) stack in two 32-bit registers
MAX_PRED_DEPTH = 31
# plane element types the kernels read (ops/cuda/pred_program.cuh); K1
# reads no int16 plane, K5 (ops/joinagg_scalar.py) does
DT_I32, DT_F32, DT_I64, DT_BOOL, DT_I16 = range(5)
_DT_CODE = {torch.int32: DT_I32, torch.float32: DT_F32,
            torch.int64: DT_I64, torch.bool: DT_BOOL}


@dataclasses.dataclass(frozen=True)
class K1Program:
    """The lowered kernel tables of one (V2Sig, predicate)."""
    ops: np.ndarray          # int32 [n_ops, OP_W]
    pred: np.ndarray         # int32 [n_prog, PRED_W]
    key_d: int               # input position of the key's data plane
    key_v: int               # ... of its validity plane; -1 = never NULL
    ncols: int               # physical columns K
    has_shadow: bool         # any fabs column


def _lower_pred(e: Optional[Expr], sig: V2Sig) -> tuple[list, int]:
    """Postfix program of a kernel-safe predicate (see _pred_kernel_safe)
    and the stack depth it needs.  Mirrors the reference's _kpred."""
    prog: list = []
    depth = 0
    sp = 0

    def emit(row: tuple, pops: int) -> None:
        nonlocal sp, depth
        sp = sp - pops + 1
        depth = max(depth, sp)
        prog.append(tuple(row) + (0,) * (PRED_W - len(row)))

    def walk(x: Expr) -> None:
        if isinstance(x, BoolExpr):
            walk(x.args[0])
            if x.op == "not":
                emit((P_NOT,), 1)
            for a in x.args[1:]:
                walk(a)
                emit((P_AND if x.op == "and" else P_OR,), 2)
            return
        if isinstance(x, NullTest):
            emit((P_NULLTEST, int(x.isnull),
                  _in_index_opt(sig, x.arg.index, "valid")), 0)
            return
        if isinstance(x, ColumnRef):                  # bare bool column
            emit((P_BOOLCOL, _in_index(sig, x.index, "data"),
                  _in_index_opt(sig, x.index, "valid")), 0)
            return
        if isinstance(x, Const):                      # bool constant
            emit((P_CONST, int(bool(x.value))), 0)
            return
        tag = _CMP_TAGS[x.fname.split("::", 1)[0]]
        a, b = x.args
        is_float = any(isinstance(s, ColumnRef) and s.type is T.FLOAT4
                       for s in (a, b))

        def side(s) -> tuple:
            if isinstance(s, ColumnRef):
                return (0, _in_index(sig, s.index, "data"),
                        _in_index_opt(sig, s.index, "valid"))
            if is_float:
                bits = np.float32(float(s.value)).view(np.int32)
                return (1, int(bits), -1)
            return (1, int(np.int32(int(s.value))), -1)

        emit((P_CMP, _CMP_CODE[tag], int(is_float)) + side(a) + side(b), 0)

    if e is not None:
        walk(e)
    return prog, depth


def pred_stack_depth(sig: V2Sig, pred: Optional[Expr]) -> int:
    """Stack depth the kernel needs for `pred` (<= MAX_PRED_DEPTH fits)."""
    return _lower_pred(pred, sig)[1]


@functools.lru_cache(maxsize=128)
def lower_program(sig: V2Sig, pred: Optional[Expr]) -> K1Program:
    rows: list = []
    col = 0
    for op in sig.ops:
        tag = op[0]
        if tag == "mask":
            r, w = (OP_MASK, col, -1, -1, 1, 0, 0), 1
        elif tag == "cnt":
            r, w = (OP_CNT, col, -1, op[1], 1, 0, 0), 1
        elif tag == "sum_i4":
            _, din, vin, nl, si = op
            r, w = (OP_SUM_I4, col, din, vin, nl, si, 0), nl
        elif tag == "sum_i8":
            # the reference's u32 (lo, hi) inputs: the kernel reads the raw
            # int64 plane at the "lo" position and subtracts the 64-bit min
            _, lin, _hin, vin, nl, su = op
            r, w = (OP_SUM_I8, col, lin, vin, nl, su, 0), nl
        elif tag == "sumsq4":
            _, din, vin, nl = op
            r, w = (OP_SUMSQ4, col, din, vin, nl, 0, 0), nl
        elif tag == "sumsq4_big":
            _, din, vin = op
            r, w = (OP_SUMSQ4_BIG, col, din, vin, 12, 0, 0), 12
        elif tag == "f4s":
            din, vin, nf, nl = op[1:5]
            use_abs = op[5] if len(op) > 5 else False
            r, w = (OP_F4S, col, din, vin, nl, nf, int(bool(use_abs))), nl
        elif tag == "fabs":
            _, din, vin = op
            r, w = (OP_FABS, col, din, vin, 1, 0, 0), 1
        else:                                         # pragma: no cover
            raise AssertionError(tag)
        rows.append(r + (0,))
        col += w
    if col != sig.ncols:
        raise AssertionError((col, sig.ncols))
    key_idx, which = sig.inputs[0]        # derive_v2_plan registers it first
    if which != "data":
        raise AssertionError(sig.inputs[0])
    prog, depth = _lower_pred(pred, sig)
    if depth > MAX_PRED_DEPTH:
        raise ValueError(f"predicate needs a stack of {depth} "
                         f"(> {MAX_PRED_DEPTH})")
    return K1Program(
        ops=np.asarray(rows, np.int32).reshape(-1, OP_W),
        pred=np.asarray(prog, np.int32).reshape(-1, PRED_W),
        key_d=0, key_v=_in_index_opt(sig, key_idx, "valid"),
        ncols=sig.ncols,
        has_shadow=any(op[0] == "fabs" for op in sig.ops))


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _limb_block(u: torch.Tensor, nl: int, bits: int = 8) -> torch.Tensor:
    """[n, nl] limbs of a non-negative int64 lane, low limb first.  Torch
    has no uint32 shifts on the CPU, so unsigned lanes ride as int64."""
    m = (1 << bits) - 1
    return torch.stack([(u >> (bits * j)) & m for j in range(nl)], dim=1)


def _pred_mask(prog: K1Program, planes, n: int) -> torch.Tensor:
    dev = planes[0].device
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def valid(vin: int):
        return None if vin < 0 else planes[vin][:n]

    stack: list = []
    for row in prog.pred.tolist():
        op = row[0]
        if op == P_CMP:
            tag, is_float = row[1], bool(row[2])

            def side(kind, val, vin):
                if kind == 0:
                    d = planes[val][:n]
                    d = d.to(torch.float32) if is_float else d.to(torch.int32)
                    return d, valid(vin)
                if is_float:
                    c = np.int32(val).view(np.float32)
                    return torch.tensor(c, dtype=torch.float32,
                                        device=dev), None
                return torch.tensor(val, dtype=torch.int32, device=dev), None

            (x, xv), (y, yv) = side(*row[3:6]), side(*row[6:9])
            if is_float:
                # PG float order: NaN == NaN, NaN > everything
                xn, yn = torch.isnan(x), torch.isnan(y)
                nn = xn | yn
                lt = (nn & ~xn & yn) | (~nn & (x < y))
                eq = (nn & xn & yn) | (~nn & (x == y))
                d = (eq, ~eq, lt, lt | eq, ~(lt | eq), ~lt)[tag]
            else:
                d = (x == y, x != y, x < y, x <= y, x > y, x >= y)[tag]
            v = ones
            for s in (xv, yv):
                if s is not None:
                    v = v & s
            stack.append((d.expand(n), v))
        elif op == P_NULLTEST:
            cv = valid(row[2])
            cv = ones if cv is None else cv
            stack.append((~cv if row[1] else cv, ones))
        elif op == P_BOOLCOL:
            cv = valid(row[2])
            stack.append((planes[row[1]][:n].to(torch.bool),
                          ones if cv is None else cv))
        elif op == P_CONST:
            stack.append((ones if row[1] else ~ones, ones))
        elif op == P_NOT:
            d, v = stack.pop()
            stack.append((~d, v))
        else:                                         # P_AND / P_OR
            d2, v2 = stack.pop()
            d, v = stack.pop()
            # Kleene 3-valued logic over (data, valid) pairs
            if op == P_AND:
                nv = (v & v2) | (v & ~d) | (v2 & ~d2)
                d = d & d2
            else:
                nv = (v & v2) | (v & d) | (v2 & d2)
                d = d | d2
            stack.append((d, nv))
    if not stack:
        return ones
    d, v = stack[-1]
    return d & v


def fused2_reference(sig: V2Sig, planes: Sequence[torch.Tensor], nrows: int,
                     scal: dict, G: int, pred: Optional[Expr] = None):
    """Plain PyTorch K1: (ints int64[G, K], shadow float32[G, K]).

    planes: one 1-D tensor per sig.inputs position (int64 columns give their
    raw plane at both "lo" and "hi").  scal: the V2Plan's "i", "u" and
    "f4sc" arrays.  Rows at or past nrows, and rows the predicate rejects,
    land in bucket G, which is dropped."""
    prog = lower_program(sig, pred)
    dev = planes[0].device
    K = prog.ncols
    n = max(0, min(int(nrows), planes[0].shape[0]))
    ints = torch.zeros((G + 1, K), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G + 1, K), dtype=torch.float32, device=dev)
    if n == 0:
        return ints[:G], shadow[:G]
    scal_i = np.asarray(scal["i"], np.int32).reshape(-1)
    scal_u = np.asarray(scal["u"], np.uint32).reshape(-1)
    f4sc = np.asarray(scal["f4sc"], np.float32).reshape(2, -1)
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def valid(vin: int) -> torch.Tensor:
        return ones if vin < 0 else planes[vin][:n]

    mask = _pred_mask(prog, planes, n)
    # dense bucket: int32 key - kmin (two's-complement wrap, as the
    # kernel's i32 subtraction); NULL key -> rng + 1; masked row -> G
    key = planes[prog.key_d][:n].to(torch.int64)
    seg = ((key - int(scal_i[0]) + (1 << 31)) & _M32) - (1 << 31)
    if prog.key_v >= 0:
        seg = torch.where(valid(prog.key_v), seg,
                          torch.full_like(seg, sig.rng + 1))
    seg = torch.where(mask & (seg >= 0) & (seg < G), seg,
                      torch.full_like(seg, G))

    V = torch.zeros((n, K), dtype=torch.int64, device=dev)
    S = (torch.zeros((n, K), dtype=torch.float32, device=dev)
         if prog.has_shadow else None)
    zero64 = torch.zeros((), dtype=torch.int64, device=dev)
    zero32f = torch.zeros((), dtype=torch.float32, device=dev)
    for tag, col, din, vin, nl, x, flag, _ in prog.ops.tolist():
        ok = valid(vin)
        if tag == OP_MASK:
            V[:, col] = 1
        elif tag == OP_CNT:
            V[:, col] = ok.to(torch.int64)
        elif tag == OP_SUM_I4:
            d = planes[din][:n].to(torch.int64)
            u = torch.where(ok, (d - int(scal_i[x])) & _M32, zero64)
            V[:, col:col + nl] = _limb_block(u, nl)
        elif tag == OP_SUM_I8:
            # (uint64)(v - min) as two u32 words with an explicit borrow:
            # no int64 overflow, bit-identical to the kernel's u64 subtract
            d = planes[din][:n]
            amin = int(scal_u[x]) | (int(scal_u[x + 1]) << 32)
            lo = (d & _M32) - (amin & _M32)
            borrow = (lo < 0).to(torch.int64)
            lo = lo & _M32
            hi = (((d >> 32) & _M32) - (amin >> 32) - borrow) & _M32
            lo = torch.where(ok, lo, zero64)
            hi = torch.where(ok, hi, zero64)
            V[:, col:col + min(nl, 4)] = _limb_block(lo, min(nl, 4))
            if nl > 4:
                V[:, col + 4:col + nl] = _limb_block(hi, nl - 4)
        elif tag in (OP_SUMSQ4, OP_SUMSQ4_BIG):
            u = planes[din][:n].to(torch.int64).abs()      # |v| as u32
            u = torch.where(ok, u, zero64)
            if tag == OP_SUMSQ4:
                V[:, col:col + nl] = _limb_block((u * u) & _M32, nl)
            else:
                # |v| = a*2^16 + b: limbs of b*b, a*b, a*a (u32 products)
                a, b = u >> 16, u & 0xFFFF
                for k, sq in enumerate((b * b, a * b, a * a)):
                    V[:, col + 4 * k:col + 4 * k + 4] = \
                        _limb_block(sq & _M32, 4)
        elif tag == OP_F4S:
            xv = torch.where(ok, planes[din][:n], zero32f)
            neg = xv < 0
            if flag:
                av = xv.abs()
            else:
                # NaN compares false both ways: its digits are zero (the
                # fabs shadow carries it to the host-replay decision)
                av = (torch.where(xv > 0, xv, zero32f)
                      + torch.where(xv < 0, -xv, zero32f))
            sc0 = torch.tensor(f4sc[0, x], dtype=torch.float32, device=dev)
            sc1 = torch.tensor(f4sc[1, x], dtype=torch.float32, device=dev)
            v = (av * sc0) * sc1
            # the TOP nl digits of the window: ceil(nl/3) base-2^(3*DB)
            # ints, the lowest `drop` digits of the last one dropped
            DB = 7 if sig.i8 else 8
            iters = -(-nl // 3)
            drop = 3 * iters - nl
            pb = torch.tensor(float(1 << (3 * DB)), dtype=torch.float32,
                              device=dev)
            words = []
            for _ in range(iters):
                w = v * pb
                i_ = torch.floor(w)
                v = w - i_
                words.append(i_.to(torch.int64))
            for j in range(nl):
                t = j + drop
                dg = (words[iters - 1 - t // 3] >> ((t % 3) * DB)) \
                    & ((1 << DB) - 1)
                V[:, col + j] = torch.where(neg, -dg, dg)
        elif tag == OP_FABS:
            S[:, col] = shadow_cell(
                torch.where(ok, planes[din][:n], zero32f).abs())
        else:                                         # pragma: no cover
            raise AssertionError(tag)
    ints.index_add_(0, seg, V)
    if S is not None:
        shadow.index_add_(0, seg, S)
    return ints[:G], shadow[:G]


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _descriptor(prog: K1Program, planes, scal: dict) -> tuple[np.ndarray,
                                                              int, int, int]:
    """One int32 launch descriptor: plane addresses (lo, hi words), plane
    types, op table, predicate program, scal_i, scal_u, f4 scales, then the
    shadow (fabs) columns in op order."""
    ptrs = np.asarray([p.data_ptr() for p in planes], np.uint64)
    scal_i = np.asarray(scal["i"], np.int32).reshape(-1)
    scal_u = np.asarray(scal["u"], np.uint32).reshape(-1)
    f4sc = np.asarray(scal["f4sc"], np.float32).reshape(2, -1)
    desc = np.concatenate([
        ptrs.view(np.int32),
        np.asarray([_DT_CODE[p.dtype] for p in planes], np.int32),
        prog.ops.reshape(-1), prog.pred.reshape(-1),
        scal_i, scal_u.view(np.int32), f4sc.reshape(-1).view(np.int32),
        _shadow_cols(prog)])
    return desc, len(scal_i), len(scal_u), f4sc.shape[1]


def _shadow_cols(prog: K1Program) -> np.ndarray:
    return np.asarray([r[1] for r in prog.ops if r[0] == OP_FABS], np.int32)


def fused2_cuda(sig: V2Sig, planes: Sequence[torch.Tensor], nrows: int,
                scal: dict, G: int, pred: Optional[Expr] = None, *,
                grid: int | None = None):
    """Launch K1 (ops/cuda/preagg_fused2.cu) on the planes' CUDA device:
    (ints int64[G, K], shadow float32[G, K]), same contract as
    fused2_reference.  Raises on a build or launch failure.

    ops/launch_plan.py picks the block and the column tiles (every v2
    plan, G <= 4096, fits shared memory); `grid` fixes the blocks per
    column tile (tests; the default fills the card)."""
    import ctypes
    from .cuda import library, cuda_error_text
    from .launch_plan import plan_launch
    prog = lower_program(sig, pred)
    dev = planes[0].device
    N = planes[0].shape[0]
    for p in planes:
        if (p.device != dev or p.dim() != 1 or p.shape[0] != N
                or not p.is_contiguous() or p.dtype not in _DT_CODE):
            raise ValueError(f"K1 plane {p.dtype} {tuple(p.shape)} on "
                             f"{p.device}: need contiguous 1-D "
                             f"int32/float32/int64/bool planes of length {N} "
                             f"on {dev}")
    lib = library()
    n = max(0, min(int(nrows), N))
    K = prog.ncols
    desc_np, ni, nu, nf4 = _descriptor(prog, planes, scal)
    desc = torch.from_numpy(desc_np).to(dev)
    ints = torch.zeros((G, K), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G, K), dtype=torch.float32, device=dev)
    lp = plan_launch(G, K, int(_shadow_cols(prog).shape[0]),
                     8 * len(planes) + 4 * (len(desc_np) - 2 * len(planes)))
    geo = (ctypes.c_int * len(lp.geo()))(*lp.geo())
    with torch.cuda.device(dev), span("K1"):   # on the planes' device
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pgstrom_k1_launch(
            ctypes.c_void_p(desc.data_ptr()), len(desc_np), len(planes),
            len(prog.ops), len(prog.pred), ni, nu, nf4,
            ctypes.c_longlong(n), prog.key_d, prog.key_v, int(sig.rng),
            7 if sig.i8 else 8, geo, ctypes.c_void_p(ints.data_ptr()),
            ctypes.c_void_p(shadow.data_ptr()), grid or 0,
            ctypes.c_size_t(lp.smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed ({lp.ntiles} column tile(s), "
                           f"{lp.smem} B shared memory): "
                           f"{cuda_error_text(rc)}")
    fused2_cuda.launches += 1
    return ints, shadow


fused2_cuda.launches = 0      # main-path launch count (chip_smoke.py reads it)


# ---------------------------------------------------------------------------
# executor-facing wrapper (plane gather + epilogue into the mxu layout)
# ---------------------------------------------------------------------------

def _kernel_planes(sig: V2Sig, cols) -> tuple:
    """One tensor per sig.inputs position; int64 columns give their raw
    plane at both the reference's "lo" and "hi" positions."""
    return tuple(cols[idx][1] if which == "valid" else cols[idx][0]
                 for idx, which in sig.inputs)


def build_fused2_fn(schema, group_exprs, aggs, pred, G: int, sig: V2Sig):
    """f(cols, nrows, salt, scal) -> mxu-layout output dict.

    cols: per schema position the chunk's plane tensors (data, valid, ...);
    scal: the V2Plan's {"i", "u", "f4sc", "f4e"} arrays.  A CUDA chunk
    launches the kernel; a CPU chunk runs the plain version."""
    by_mult: dict = {}
    for rc, pc, m in sig.int_map:
        by_mult.setdefault(m, []).append((rc, pc))
    shadow_pcs = [pc for _, pc in sig.shadow_map]

    def f(cols, nrows, salt, scal):
        planes = _kernel_planes(sig, cols)
        dev = planes[0].device
        with span("reduce"):
            if dev.type == "cuda":
                ints, shadow = fused2_cuda(sig, planes, nrows, scal, G, pred)
            elif dev.type == "cpu":
                ints, shadow = fused2_reference(sig, planes, nrows, scal, G,
                                                pred)
            else:
                raise RuntimeError(f"K1 has no kernel for device {dev}")
        sums = torch.zeros((G, sig.S), dtype=torch.int64, device=dev)
        for m, pairs in by_mult.items():
            rcs = torch.tensor([p[0] for p in pairs], device=dev)
            pcs = torch.tensor([p[1] for p in pairs], device=dev)
            sums.index_add_(1, rcs, ints[:, pcs] * m)
        if shadow_pcs:
            fsums = shadow[:, shadow_pcs].to(torch.float64)
        else:
            fsums = torch.zeros((G, 0), dtype=torch.float64, device=dev)
        return {
            "err": 0,
            "mxu_sums": sums,
            "mxu_fsums": fsums,
            "mxu_f4exps": np.asarray(scal["f4e"], np.int32),
            "slots": tuple({} for _ in aggs),
            "dense_kmin": int(np.asarray(scal["i"])[0, 0]),
            "dense_rng": int(sig.rng),
            # exact column statistics make out-of-range keys impossible
            "dense_fail": False,
        }

    return f
