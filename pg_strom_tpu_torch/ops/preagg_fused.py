"""Fused grouped-aggregation kernel K2: per-bucket column sums built from a
few encoded lanes, without materializing the N x S value matrix.

The reference (pg_strom_tpu/ops/preagg_fused.py) encodes per-slot lanes in
XLA (biased u32 key words, u32 limb words, signed f32 value lanes, bool ok
lanes), then one Pallas kernel builds each V tile in VMEM (limbs, key
squares, signed float digits, |x| shadows) and contracts a one-hot bucket
tile with it on the MXU.  The port:

* copies the plan (`_Plan`, `_build_plan`, `_plan_cached`,
  `fused_supported`): the same ops, physical columns, `int_map` and
  `shadow_map`, so both packages agree on the layout;
* ports the lane encoding of `fused_mxu_reduce` to torch (it stays outside
  the kernel, as it stays in XLA in the reference);
* runs the ops in one fixed CUDA kernel driven by an int32 op table
  (ops/cuda/preagg_fused.cu, a row decoder on the accumulation core
  ops/cuda/onehot_accum.cuh, launched as ops/launch_plan.py plans):
  exact int64 sums per physical column and float32 sums of the shadow
  columns, per bucket (`fused_cuda`), with the plain PyTorch version
  beside it (`fused_reference`, over row blocks);
* applies the reference's epilogue (`int_map` multipliers 1 and 2,
  `shadow_map`) in torch.

The MXU-only parts have no counterpart: FLUSH_ROWS, the tile and pack
pickers, the P=8 block packing and the strided-diagonal epilogue.  The
envelope gates stay: G <= 2048 (ops/preagg.py) and at most 128 physical
columns; outside it the route takes build_mxu_columns + mxu_reduce, as the
reference's does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..sqltypes import T
from .preagg_mxu import (F4_LIMBS, _kind_mxu_ok, _f4_scale_exp,
                         _f64_quantity, _f64_blocks_enabled, f64_head_tail,
                         mxu_recipes, shadow_cell,
                         mxu_shadow_cols, _KEY_WIDE_TYPES, _F64_KINDS)
from ..utils.perfmon import span

MAX_G = 1 << 11
LANES = 128                    # widest plan (physical columns)

_FUSED_KINDS = ({"nrows", "count", "sum_i", "sumsq_i", "sum_f"}
                | _F64_KINDS)


def fused_supported(key_types: Sequence[T], aggs, arg_types) -> bool:
    """True when every MXU-eligible slot kind of the plan is fusable.

    Kinds outside the MXU set (min/max/numeric) run their scatter side-path
    either way; an MXU-eligible kind we can't fuse means the whole chunk
    should use build_mxu_columns + mxu_reduce so the recipe layout stays
    consistent."""
    if not key_types:
        return False
    for inst, at in zip(aggs, arg_types):
        a_t = at[0] if at else None
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a_t):
                continue                       # scatter side-path, fine
            if kind not in _FUSED_KINDS:
                return False
    return True


# ---------------------------------------------------------------------------
# plan: static description of kernel inputs + physical columns + epilogue map
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Plan:
    # ops: tuple of (opcode, input_index[, f4_slot_no])
    #   "mask"   -> 1 col   (seg != G)
    #   "bool"   -> 1 col   (bool lane & mask)
    #   "limbs4" -> 4 cols  (u32 lane, already masked/encoded)
    #   "ksq12"  -> 12 cols (b^2, a*b, a^2 limb blocks derived in the kernel
    #                        from the biased key word kb = a*2^16 + b)
    #   "f4s"    -> F4_LIMBS cols (signed digit block digit(|x|)*sign(x)
    #                        derived in the kernel from one signed f32 lane)
    #   "fabs"   -> 1 col   (|lane| shadow, derived in the kernel)
    #   "f32"    -> 1 col   (f32 lane shadow)
    ops: tuple
    n_inputs: int
    n_f4: int
    ncols: int                 # physical columns (<= LANES)
    # epilogue: (recipe_col, phys_col, int multiplier) for integer sums
    int_map: tuple
    # (recipe_shadow_col, phys_col) pairs, recipe order = mxu_shadow_cols
    shadow_map: tuple


_WIDTH = {"mask": 1, "bool": 1, "limbs4": 4, "ksq12": 12, "f4s": F4_LIMBS,
          "fabs": 1, "f32": 1}


def _build_plan(key_types: Sequence[T], aggs, arg_types,
                dense_key: bool = False):
    keyr, slotr, S = mxu_recipes(key_types, aggs, arg_types,
                                 dense_key=dense_key)
    ops: list = []
    int_map: list = []
    shadow_map: list = []
    n_in = 0
    n_f4 = 0
    col = 0

    def new_in() -> int:
        nonlocal n_in
        n_in += 1
        return n_in - 1

    def emit(op) -> int:
        nonlocal col
        ops.append(op)
        c = col
        col += _WIDTH[op[0]]
        return c

    # col 0: bucket row count (mask) — recipe col 0
    int_map.append((0, emit(("mask",)), 1))

    def emit_key_word(kb: int, sum_limbs, sumsq_limbs) -> None:
        c = emit(("limbs4", kb))
        for j in range(4):
            int_map.append((sum_limbs[j], c + j, 1))
        # kb^2 = a^2*2^32 + ab*2^17 + b^2   (2^17 = 2 * 2^16 -> limb 2, x2);
        # the b^2 / a*b / a^2 limb blocks are derived in the kernel from kb
        c = emit(("ksq12", kb))
        for j in range(4):
            int_map.append((sumsq_limbs[j], c + j, 1))
        for j in range(4):
            int_map.append((sumsq_limbs[j + 2], c + 4 + j, 2))
        for j in range(4):
            int_map.append((sumsq_limbs[j + 4], c + 8 + j, 1))

    for kr in keyr:
        emit_key_word(new_in(), kr.sum_limbs, kr.sumsq_limbs)
        if kr.sum_limbs_hi:        # 64-bit key: hi-word block
            emit_key_word(new_in(), kr.sum_limbs_hi, kr.sumsq_limbs_hi)
        int_map.append((kr.nval, emit(("bool", new_in())), 1))

    for inst, at, rd in zip(aggs, arg_types, slotr):
        for kind, r in rd.items():
            if kind in ("nrows", "count"):
                i = new_in()       # bool ok lane (mask applied already)
                int_map.append((r.limbs[0], emit(("bool", i)), 1))
            elif kind == "sum_i":
                lo, hi = new_in(), new_in()
                c = emit(("limbs4", lo))
                for j in range(4):
                    int_map.append((r.limbs[j], c + j, 1))
                c = emit(("limbs4", hi))
                for j in range(4):
                    int_map.append((r.limbs[j + 4], c + j, 1))
                okc = new_in()
                int_map.append((r.okcnt, emit(("bool", okc)), 1))
                sh = new_in()      # |v| f32, masked
                shadow_map.append((r.shadow, emit(("f32", sh))))
            elif kind == "sumsq_i":
                lo, hi = new_in(), new_in()
                c = emit(("limbs4", lo))
                for j in range(4):
                    int_map.append((r.limbs[j], c + j, 1))
                c = emit(("limbs4", hi))
                for j in range(4):
                    int_map.append((r.limbs[j + 4], c + j, 1))
            elif kind == "sum_f" and not r.lo_limbs:
                v = new_in()       # ONE signed masked f32 lane; the kernel
                c = emit(("f4s", v, n_f4))   # derives the signed digit block
                for j in range(F4_LIMBS):
                    int_map.append((r.limbs[j], c + j, 1))
                shadow_map.append((r.shadow, emit(("fabs", v))))
                n_f4 += 1
            elif r.lo_limbs:
                # f64 double-float: head + tail signed f32 lanes, one signed
                # digit block each; shadow = |head| (inf/nan replay guard)
                hi_, lo_ = new_in(), new_in()
                c = emit(("f4s", hi_, n_f4))
                for j in range(F4_LIMBS):
                    int_map.append((r.limbs[j], c + j, 1))
                c = emit(("f4s", lo_, n_f4 + 1))
                for j in range(F4_LIMBS):
                    int_map.append((r.lo_limbs[j], c + j, 1))
                shadow_map.append((r.shadow, emit(("fabs", hi_))))
                n_f4 += 2
            else:                  # pragma: no cover — fused_supported gates
                raise ValueError(kind)

    if col > LANES:
        return None, S
    shadow_map.sort(key=lambda p: p[0])
    return _Plan(ops=tuple(ops), n_inputs=n_in, n_f4=n_f4, ncols=col,
                 int_map=tuple(int_map), shadow_map=tuple(shadow_map)), S


@functools.lru_cache(maxsize=256)
def _plan_cached(key_types: tuple, slots_sig: tuple, arg_types: tuple,
                 f64on: bool, dense_key: bool = False):
    # f64on keys the cache only: _kind_mxu_ok consults the live setting,
    # so a plan built under one f64-blocks state must not be reused by the
    # other (the recipe layouts differ)
    class _Inst:                      # minimal view for mxu_recipes
        def __init__(self, slots):
            self.slots = slots
    aggs = [_Inst(list(s)) for s in slots_sig]
    return _build_plan(list(key_types), aggs, list(arg_types),
                       dense_key=dense_key)


def _recipes_slotr(key_types, aggs, arg_types, dense_key: bool = False):
    _, slotr, _ = mxu_recipes(list(key_types), aggs, list(arg_types),
                              dense_key=dense_key)
    return slotr


# ---------------------------------------------------------------------------
# the op table (layout shared with ops/cuda/preagg_fused.cu)
# ---------------------------------------------------------------------------

OP_W = 4                         # (tag, col, input, f4 slot)
OPS = ("mask", "bool", "limbs4", "ksq12", "f4s", "fabs", "f32")
_OPCODE = {name: i for i, name in enumerate(OPS)}
# the lane dtype each op reads (u32 lanes ride in int32 storage)
_OP_DTYPE = {"bool": torch.bool, "limbs4": torch.int32, "ksq12": torch.int32,
             "f4s": torch.float32, "fabs": torch.float32, "f32": torch.float32}


@functools.lru_cache(maxsize=256)
def op_table(plan: _Plan) -> np.ndarray:
    """int32 [n_ops, OP_W] rows (opcode, first column, input, f4 slot)."""
    rows, col = [], 0
    for op in plan.ops:
        rows.append((_OPCODE[op[0]], col, op[1] if len(op) > 1 else -1,
                     op[2] if len(op) > 2 else 0))
        col += _WIDTH[op[0]]
    return np.asarray(rows, np.int32).reshape(-1, OP_W)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

_REF_ROWS = 1 << 20             # rows per block of the plain version


def _limbs(u: torch.Tensor, nl: int) -> torch.Tensor:
    return torch.stack([(u >> (8 * j)) & 0xFF for j in range(nl)], dim=1)


def _sat_i32(w: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as the kernel converts: toward zero, saturating,
    NaN -> 0 (int64 result)."""
    w = w.to(torch.float64).nan_to_num(nan=0.0, posinf=2.0 ** 31 - 1,
                                       neginf=-2.0 ** 31)
    return w.clamp(-2.0 ** 31, 2.0 ** 31 - 1).trunc().to(torch.int64)


def _f4s_digits(x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """[n, 9] signed digit block of one f32 lane (see the kernel)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    pos = torch.where(x > 0, x, zero)
    neg = torch.where(x < 0, -x, zero)          # NaN compares false
    v = (pos + neg) * sc
    p24 = torch.tensor(float(1 << 24), dtype=torch.float32, device=x.device)
    ints = []
    for _ in range(3):
        w = v * p24
        i_ = torch.floor(w)
        v = w - i_
        ints.append(_sat_i32(i_))
    # low level first; within a level digit shifts 0/8/16
    d = torch.stack([(ints[2 - j // 3] >> (8 * (j % 3))) & 0xFF
                     for j in range(9)], dim=1)
    return torch.where((x < 0)[:, None], -d, d)


def fused_reference(plan: _Plan, seg: torch.Tensor, inputs,
                    scales: torch.Tensor, G: int, n: int):
    """Plain K2: (ints int64[G, K], shadow float32[G, K]) over rows < n
    (seg >= G drops a row), in row blocks so the per-row int64 [rows, K]
    matrix stays small.  scales: float32 [n_f4] on the lanes' device."""
    dev = seg.device
    K = plan.ncols
    ints = torch.zeros((G + 1, K), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G + 1, K), dtype=torch.float32, device=dev)
    sc = scales
    table = op_table(plan).tolist()
    has_shadow = any(op[0] in ("fabs", "f32") for op in plan.ops)
    for s in range(0, n, _REF_ROWS):
        e = min(s + _REF_ROWS, n)
        sg = seg[s:e].to(torch.int64)
        keep = (sg >= 0) & (sg < G)
        sg = torch.where(keep, sg, torch.full_like(sg, G))
        m = e - s
        V = torch.zeros((m, K), dtype=torch.int64, device=dev)
        Sh = (torch.zeros((m, K), dtype=torch.float32, device=dev)
              if has_shadow else None)
        for tag, col, i, slot in table:
            name = OPS[tag]
            lane = inputs[i][s:e] if i >= 0 else None
            if name == "mask":
                V[:, col] = 1
            elif name == "bool":
                V[:, col] = lane.to(torch.int64)
            elif name == "limbs4":
                V[:, col:col + 4] = _limbs(lane.to(torch.int64) & 0xFFFFFFFF,
                                           4)
            elif name == "ksq12":
                u = lane.to(torch.int64) & 0xFFFFFFFF
                a, b = u >> 16, u & 0xFFFF
                for k, sq in enumerate((b * b, a * b, a * a)):
                    V[:, col + 4 * k:col + 4 * k + 4] = _limbs(sq, 4)
            elif name == "f4s":
                V[:, col:col + F4_LIMBS] = _f4s_digits(lane, sc[slot])
            elif name == "fabs":
                Sh[:, col] = shadow_cell(lane.abs())
            else:                                   # "f32"
                Sh[:, col] = shadow_cell(lane)
        ints.index_add_(0, sg, V)
        if Sh is not None:
            shadow.index_add_(0, sg, Sh)
    return ints[:G], shadow[:G]


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def fused_cuda(plan: _Plan, seg: torch.Tensor, inputs, scales, G: int,
               n: int, *, grid: int | None = None):
    """Launch K2 (ops/cuda/preagg_fused.cu): the same (ints, shadow) as
    fused_reference.  Raises on a bad input, a build or a launch failure.

    ops/launch_plan.py picks the block and the column tiles; `grid` fixes
    the blocks per column tile (tests; the default fills the card)."""
    import ctypes
    from .cuda import library, cuda_error_text
    from .launch_plan import plan_launch
    dev = seg.device
    if (seg.dtype != torch.int32 or not seg.is_contiguous()
            or seg.shape[0] < n or G > MAX_G):
        raise ValueError(f"K2 needs contiguous int32 bucket ids and "
                         f"G <= {MAX_G}; got {seg.dtype}, G={G}")
    for p in inputs:
        if (p.device != dev or p.dim() != 1 or p.shape[0] < n
                or not p.is_contiguous()):
            raise ValueError(f"K2 lane {p.dtype} {tuple(p.shape)} on "
                             f"{p.device}: need contiguous 1-D lanes of "
                             f">= {n} rows on {dev}")
    for op in plan.ops:
        if op[0] in _OP_DTYPE and inputs[op[1]].dtype != _OP_DTYPE[op[0]]:
            raise ValueError(f"K2 op {op[0]} reads a {_OP_DTYPE[op[0]]} "
                             f"lane; got {inputs[op[1]].dtype}")
    if (scales.device != dev or scales.dtype != torch.float32
            or not scales.is_contiguous()):
        raise ValueError("K2 scales must be contiguous float32 on the "
                         "lanes' device")
    K = plan.ncols
    table = op_table(plan)
    # descriptor: lane addresses (the inputs, then the bucket ids), the op
    # table, the shadow columns in op order (the kernel's compact shadow
    # table maps back through them)
    shcol = np.asarray([r[1] for r in table if OPS[r[0]] in ("fabs", "f32")],
                       np.int32)
    ptrs = np.asarray([p.data_ptr() for p in (*inputs, seg)], np.uint64)
    desc_np = np.concatenate([ptrs.view(np.int32), table.reshape(-1),
                              shcol]).astype(np.int32)
    desc = torch.from_numpy(desc_np).to(dev)
    nl = len(inputs) + 1
    lp = plan_launch(G, K, len(shcol), 8 * nl + 4 * (len(desc_np) - 2 * nl))
    geo = (ctypes.c_int * len(lp.geo()))(*lp.geo())
    ints = torch.zeros((G, K), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G, K), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev), span("K2"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pgstrom_k2_launch(
            ctypes.c_void_p(desc.data_ptr()), len(desc_np), len(inputs),
            len(table), ctypes.c_void_p(scales.data_ptr()),
            ctypes.c_longlong(n), geo,
            ctypes.c_void_p(ints.data_ptr()),
            ctypes.c_void_p(shadow.data_ptr()), grid or 0,
            ctypes.c_size_t(lp.smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K2 launch failed ({lp.ntiles} column tile(s), "
                           f"{lp.smem} B shared memory): "
                           f"{cuda_error_text(rc)}")
    fused_cuda.launches += 1
    return ints, shadow


fused_cuda.launches = 0      # main-path launch count (chip_smoke.py reads it)


def fused_reduce(plan: _Plan, seg: torch.Tensor, inputs, scales, G: int,
                 n: int):
    """K2 on the lanes' device: the kernel on CUDA, the plain version on
    the CPU."""
    if seg.device.type == "cuda":
        return fused_cuda(plan, seg, inputs, scales, G, n)
    if seg.device.type == "cpu":
        return fused_reference(plan, seg, inputs, scales, G, n)
    raise RuntimeError(f"K2 has no kernel for device {seg.device}")


# ---------------------------------------------------------------------------
# lane encoding + kernel call + epilogue into the mxu layout
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held as int64 -> int32 storage (same bits)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000).sub(0x80000000).to(torch.int32)


def encode_lanes(key_vals, aggs, arg_vals, mask: torch.Tensor, plan: _Plan,
                 dense_key: bool = False):
    """(inputs, scales, f4 exps): the kernel's lanes in plan order."""
    inputs: list = []
    f4_exps: list = []
    scales: list = []
    zero32 = torch.zeros((), dtype=torch.float32, device=mask.device)

    for k in [] if dense_key else key_vals:
        okk = mask & k.valid
        if k.t in _KEY_WIDE_TYPES:
            # 64-bit key: biased word pair, squares derived in the kernel
            u = torch.where(okk, k.data.to(torch.int64) ^ -(1 << 63),
                            torch.zeros((), dtype=torch.int64,
                                        device=mask.device))
            inputs += [_u32(u), _u32(u >> 32), okk]
            continue
        kb = (k.data.to(torch.int64) ^ 0x80000000) & 0xFFFFFFFF
        kb = torch.where(okk, kb, torch.zeros_like(kb))
        inputs += [_u32(kb), okk]   # a^2/ab/b^2 limb blocks in the kernel

    for inst, vals in zip(aggs, arg_vals):
        a_ = vals[0] if vals else None
        ok = mask if a_ is None else (mask & a_.valid)
        if len(vals) == 2:
            ok = mask & vals[0].valid & vals[1].valid
        for kind in inst.slots:
            if not _kind_mxu_ok(kind, a_.t if a_ is not None else None):
                continue
            if kind in ("nrows", "count"):
                inputs.append((mask if kind == "nrows" else ok).expand(
                    mask.shape[0]))
            elif kind == "sum_i":
                v = torch.where(ok, a_.data.to(torch.int64),
                                torch.zeros((), dtype=torch.int64,
                                            device=mask.device))
                b = torch.where(ok, v + -(1 << 63), torch.zeros_like(v))
                inputs += [_u32(b), _u32(b >> 32), ok,
                           torch.where(ok, a_.data.to(torch.float32).abs(),
                                       zero32)]
            elif kind == "sumsq_i":
                v = torch.where(ok, a_.data.to(torch.int64),
                                torch.zeros((), dtype=torch.int64,
                                            device=mask.device))
                q = v * v
                inputs += [_u32(q), _u32(q >> 32)]
            elif kind == "sum_f" and a_.t is T.FLOAT4:
                absx = torch.where(ok, a_.data.to(torch.float32).abs(), zero32)
                absx = torch.where(torch.isnan(absx), zero32, absx)
                sc, e = _f4_scale_exp(absx)
                f4_exps.append(e)
                scales.append(sc)
                # ONE signed masked lane; the kernel derives the signed
                # digit block and the |.| shadow from it
                inputs.append(torch.where(ok, a_.data.to(torch.float32),
                                          zero32))
            else:
                # f64 double-float: encode head/tail f32 lanes in torch (the
                # only f64 math), digits in the kernel
                for lane in f64_head_tail(_f64_quantity(kind, vals, ok)):
                    absx = torch.where(torch.isnan(lane), zero32, lane.abs())
                    sc, e = _f4_scale_exp(absx)
                    f4_exps.append(e)
                    scales.append(sc)
                    inputs.append(lane)
    if len(inputs) != plan.n_inputs:
        raise AssertionError((len(inputs), plan.n_inputs))
    return ([p.contiguous() for p in inputs], scales, f4_exps)


def fused_mxu_reduce(key_vals, aggs, arg_vals, mask: torch.Tensor,
                     seg_id: torch.Tensor, G: int, n: int,
                     key_types, arg_types, dense_key: bool = False):
    """Drop-in for build_mxu_columns + mxu_reduce: (sums int64[G, S],
    fsums f64[G, n_shadow], f4exps) with the preagg_mxu output contract,
    or None when the plan can't fuse."""
    plan, S = _plan_cached(tuple(key_types),
                           tuple(tuple(i.slots) for i in aggs),
                           tuple(arg_types), _f64_blocks_enabled(),
                           dense_key)
    if plan is None:
        return None
    dev = mask.device
    inputs, scales, f4_exps = encode_lanes(key_vals, aggs, arg_vals, mask,
                                           plan, dense_key)
    sc = (torch.stack(scales).to(torch.float32) if scales
          else torch.zeros(1, dtype=torch.float32, device=dev))
    ints, shadow = fused_reduce(plan, seg_id.to(torch.int32).contiguous(),
                                inputs, sc, G, n)

    sums = torch.zeros((G, S), dtype=torch.int64, device=dev)
    # group epilogue adds by (recipe column, multiplier)
    by_mult: dict = {}
    for rc, pc, m in plan.int_map:
        by_mult.setdefault(m, []).append((rc, pc))
    for m, pairs in by_mult.items():
        rcs = torch.tensor([p[0] for p in pairs], device=dev)
        pcs = torch.tensor([p[1] for p in pairs], device=dev)
        sums.index_add_(1, rcs, ints[:, pcs] * m)

    sh_cols = mxu_shadow_cols(_recipes_slotr(key_types, aggs, arg_types,
                                             dense_key))
    if plan.shadow_map:
        assert [rc for rc, _ in plan.shadow_map] == sh_cols
        pcs = torch.tensor([pc for _, pc in plan.shadow_map], device=dev)
        fsums = shadow[:, pcs].to(torch.float64)
    else:
        fsums = torch.zeros((G, 0), dtype=torch.float64, device=dev)
    exps = (torch.stack(f4_exps) if f4_exps
            else torch.zeros(0, dtype=torch.int32, device=dev))
    return sums, fsums, exps
