"""ORDER BY: multi-key device sort and ORDER BY ... LIMIT top-k.

The reference (pg_strom_tpu/ops/sort.py) packs every sort into one int64
word per row, key bits above the row position, so that each sort has a
single operand and the row id in the low bits makes it stable:

  wide = (unsigned-comparable key bits << rbits) | row_id
  perm = sort(wide) & (2^rbits - 1)

Key sets wider than one word run LSD passes (`packed_argsort`), or first
try a runtime range-reduced single word (`_argsort_adaptive`) or two words
(`_argsort_adaptive2`).  `lax.sort`, `lax.top_k` and the gathers are
XLA-lowered in the reference, not Pallas kernels, so here they are
`torch.sort`, `torch.topk` and indexing; this module has no hand-written
kernel.  The packed words are distinct, so sorting their values gives the
reference's permutation element for element.

Per-key encoding to unsigned-comparable bit chunks (as the reference):
  ints/date/time  biased two's complement within the type's width
  floats          exact IEEE total-order keys (NaN greatest: PG btree order)
  numeric         (magnitude class, normalized mantissa) lanes: exact
  DESC            chunk bits inverted within their width
  NULLS           one leading bit per key (first/last by ORDER BY spec)
  padding rows    one global leading dead bit: always sort last

Unsigned lanes: the reference's uint64 words ride as int64 bit patterns
(torch has no uint64 `>>`, `-` or `<` on the CPU).  Unsigned order is the
signed order of the word with its sign bit flipped (`_u`), right shifts of
a full 64-bit pattern are masked after the arithmetic shift (`_lshr`), and
differences wrap modulo 2^64 as the reference's do.

`argsort_i32` stays the stable argsort the pre-aggregation sort strategy
and the hash-join build use.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..sqltypes import T
from ..expr.ir import Expr
from ..expr.lower_torch import (Lowerer, DVal, ColMeta, _f64_orderkey,
                                f64_bits, _live, pred_mask, err_max)
from ..utils.perfmon import bump_active, span

_SIGN = -(1 << 63)              # the uint64 top bit as an int64 pattern


@dataclasses.dataclass(frozen=True)
class SortSpec:
    expr: Expr
    descending: bool = False
    nulls_first: Optional[bool] = None   # None = PG default (last if ASC)

    def nulls_go_first(self) -> bool:
        return self.descending if self.nulls_first is None else self.nulls_first


def argsort_i32(vals: torch.Tensor) -> torch.Tensor:
    """Stable argsort (int64 positions, for indexing) of a non-negative
    int lane."""
    return torch.argsort(vals.to(torch.int64), stable=True)


def _rbits(n: int) -> int:
    b = 1
    while (1 << b) < max(n, 2):
        b += 1
    return b


def _u(x: torch.Tensor) -> torch.Tensor:
    """A uint64 pattern -> the int64 whose signed order is its unsigned
    order (an involution)."""
    return x ^ _SIGN


def _lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _lshr_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a 0-d tensor amount in [1, 63]."""
    return (x >> s) & ~(torch.full_like(s, -1) << (64 - s))


def _umin(x: torch.Tensor) -> torch.Tensor:
    return _u(_u(x).min())


def _umax(x: torch.Tensor) -> torch.Tensor:
    return _u(_u(x).max())


def _f32_orderkey(data: torch.Tensor) -> torch.Tensor:
    """float4 -> int64 key with PG float ordering (-0 == +0, NaN greatest)."""
    b32 = data.to(torch.float32).contiguous().view(torch.int32)
    b32 = torch.where(b32 == -(1 << 31), torch.zeros_like(b32), b32)
    expm = 0x7F800000
    isn = ((b32 & expm) == expm) & ((b32 & 0x007FFFFF) != 0)
    b32 = torch.where(isn, torch.full_like(b32, 0x7FC00000), b32)
    key = torch.where(b32 < 0, -1 - (b32 & 0x7FFFFFFF), b32)
    return key.to(torch.int64)


_INT_WIDTH = {T.BOOL: 1, T.INT2: 16, T.INT4: 32, T.DATE: 32, T.TIME: 64,
              T.TIMESTAMP: 64, T.INT8: 64}


def _order_lanes(v: DVal) -> list[tuple[torch.Tensor, int]]:
    """(int64 lane, bit width) pairs; lexicographic ascending order of the
    biased chunks == SQL ascending order of the value."""
    if v.t is T.NUMERIC:
        from .preagg import _num_sort_keys
        p, s = _num_sort_keys(v.data, v.exp)
        return _bias_chunks(p, 10) + _bias_chunks(s, 62)
    if v.t is T.FLOAT8:
        return _bias_chunks(_f64_orderkey(f64_bits(v.data)), 64)
    if v.t is T.FLOAT4:
        return _bias_chunks(_f32_orderkey(v.data), 32)
    return _bias_chunks(v.data.to(torch.int64), _INT_WIDTH.get(v.t, 64))


def _bias_unsigned(lane: torch.Tensor, width: int) -> torch.Tensor:
    """Signed int64 lane of `width` significant bits -> the whole
    unsigned-comparable uint64 value (as an int64 pattern)."""
    u = lane.to(torch.int64) ^ (_SIGN if width >= 64 else 1 << (width - 1))
    if width < 64:
        u = u & ((1 << width) - 1)
    return u


def _bias_chunks(lane: torch.Tensor,
                 width: int) -> list[tuple[torch.Tensor, int]]:
    """Signed int64 lane of `width` significant bits -> non-negative
    unsigned-comparable chunks of <= 33 bits each (so chunk+rowid packs)."""
    if width <= 1:
        return [(lane.to(torch.int64) & 1, 1)]
    u = _bias_unsigned(lane, width)
    if width <= 33:
        return [(u, width)]
    hi_w = width - 31
    hi = _lshr(u, 31)
    lo = u & ((1 << 31) - 1)
    out = []
    if hi_w > 33:                      # width 64: hi is 33 bits after this
        out.extend(_chunks_from_unsigned(hi, hi_w))
    else:
        out.append((hi, hi_w))
    out.append((lo, 31))
    return out


def _chunks_from_unsigned(u: torch.Tensor,
                          width: int) -> list[tuple[torch.Tensor, int]]:
    out = []
    while width > 33:
        out.append((_lshr(u, width - 31) & ((1 << 31) - 1), 31))
        width -= 31
    out.append((u & ((1 << width) - 1), width))
    return out


def _key_lanes(v: DVal, sp: SortSpec) -> list[tuple[torch.Tensor, int]]:
    """Null bit + encoded value chunks for one ORDER BY key."""
    isnull = (~v.valid).to(torch.int64)
    null_bit = isnull if not sp.nulls_go_first() else (1 - isnull)
    lanes = [(null_bit, 1)]
    for chunk, w in _order_lanes(v):
        c = torch.where(v.valid, chunk, torch.zeros_like(chunk))
        if sp.descending:
            c = ((1 << w) - 1) - c
        lanes.append((c, w))
    return lanes


def _full_specs(v: DVal, sp: SortSpec) -> tuple:
    """Adaptive-pack spec for one key: (null_bit, [whole encoded lanes as
    uint64 patterns], descending, valid).  Keeping each encoded value WHOLE
    lets the runtime min-reduction shrink it to its true bit width."""
    isnull = (~v.valid).to(torch.int64)
    null_bit = isnull if not sp.nulls_go_first() else (1 - isnull)
    if v.t is T.NUMERIC:
        from .preagg import _num_sort_keys
        p, s = _num_sort_keys(v.data, v.exp)
        fulls = [_bias_unsigned(p, 10), _bias_unsigned(s, 62)]
    elif v.t is T.FLOAT8:
        fulls = [_bias_unsigned(_f64_orderkey(f64_bits(v.data)), 64)]
    elif v.t is T.FLOAT4:
        fulls = [_bias_unsigned(_f32_orderkey(v.data), 32)]
    else:
        width = _INT_WIDTH.get(v.t, 64)
        fulls = [_bias_unsigned(v.data.to(torch.int64), max(width, 2))]
    return (null_bit, fulls, sp.descending, v.valid)


def _bit_width_u64(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2(x+1)) of a 0-d uint64 pattern (a range >= 2^63 reports
    64: the comparison is unsigned)."""
    pw = torch.tensor([1 << k for k in range(63)] + [_SIGN],
                      dtype=torch.int64, device=x.device)
    return (_u(x) >= _u(pw)).sum()


def _reduced(lane, desc, valid):
    """(lane - min, its unsigned range) over the valid rows; DESC flips the
    reduced value within the range."""
    any_ok = valid.any()
    zero = torch.zeros((), dtype=torch.int64, device=lane.device)
    m = torch.where(any_ok, _umin(torch.where(valid, lane,
                                              torch.full_like(lane, -1))),
                    zero)
    red = torch.where(valid, lane - m, torch.zeros_like(lane))
    rmax = torch.where(any_ok, _umax(red), zero)
    if desc:
        red = torch.where(valid, rmax - red, torch.zeros_like(red))
    return red, rmax


def _argsort_adaptive(dead_bit: torch.Tensor,
                      key_specs: Sequence[tuple], n: int):
    """Adaptive single-pass stable multi-key argsort: (perm, fits).

    Per key, reduce the whole encoded value by its runtime min and measure
    its true bit width; when the dead bit + null bits + reduced widths +
    row-id bits fit one 64-bit word, ONE sort of the packed words is the
    exact stable answer.  fits=False => perm is meaningless and the caller
    re-dispatches the static LSD program (packed_argsort)."""
    rb = _rbits(n)
    dev = dead_bit.device
    wide = torch.arange(n, dtype=torch.int64, device=dev)
    shift = torch.tensor(rb, dtype=torch.int64, device=dev)
    for null_bit, fulls, desc, valid in reversed(list(key_specs)):
        for lane in reversed(fulls):
            red, rmax = _reduced(lane, desc, valid)
            wide = wide | (red << shift.clamp(max=63))
            shift = shift + _bit_width_u64(rmax)
        wide = wide | (null_bit.to(torch.int64) << shift.clamp(max=63))
        shift = shift + 1
    # dead/qual bit (the most significant) on top
    wide = wide | (dead_bit.to(torch.int64) << shift.clamp(max=63))
    fits = (shift + 1) <= 64
    s = torch.sort(_u(wide)).values      # the top bit is the dead bit
    perm = (s & ((1 << rb) - 1)).to(torch.int32)
    return perm, fits


def _argsort_adaptive2(dead_bit: torch.Tensor,
                       key_specs: Sequence[tuple], n: int):
    """Two-word adaptive stable multi-key argsort: (perm, fits).

    Same runtime range reduction as _argsort_adaptive, but the reduced keys
    pack into TWO 64-bit words sorted lexicographically: a stable sort by
    the low word, then a stable sort by the high word composed with it.
    fits=False => caller takes the static path."""
    rb = _rbits(n)
    dev = dead_bit.device
    lo = torch.arange(n, dtype=torch.int64, device=dev)
    hi = torch.zeros(n, dtype=torch.int64, device=dev)
    shift = torch.tensor(rb, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def put(bits, width):
        nonlocal lo, hi, shift
        off = shift
        lo_part = torch.where(off < 64, bits << off.clamp(max=63), zero)
        straddle = torch.where((off > 0) & (off < 64),
                               _lshr_t(bits, (64 - off).clamp(1, 63)), zero)
        hi_part = torch.where(off >= 64, bits << (off - 64).clamp(0, 63),
                              zero)
        lo = lo | lo_part
        hi = hi | straddle | hi_part
        shift = shift + width

    for null_bit, fulls, desc, valid in reversed(list(key_specs)):
        for lane in reversed(fulls):
            red, rmax = _reduced(lane, desc, valid)
            put(red, _bit_width_u64(rmax))
        put(null_bit.to(torch.int64), 1)
    put(dead_bit.to(torch.int64), 1)
    fits = shift <= 128
    o1 = torch.sort(_u(lo), stable=True).indices
    o2 = torch.sort(_u(hi[o1]), stable=True).indices
    ls = lo[o1[o2]]
    perm = (ls & ((1 << rb) - 1)).to(torch.int32)
    return perm, fits


def packed_argsort(lanes: Sequence[tuple[torch.Tensor, int]],
                   n: int) -> torch.Tensor:
    """Stable ascending argsort over lexicographic (lane, width) chunks,
    most-significant first.  Every sort has one operand; key sets wider
    than 63-rbits bits run LSD passes with permutation composition."""
    rb = _rbits(n)
    budget = 63 - rb
    # group lanes from the LEAST significant end; each group <= budget bits
    groups: list[list[tuple[torch.Tensor, int]]] = []
    cur: list[tuple[torch.Tensor, int]] = []
    used = 0
    for lane, w in reversed(list(lanes)):
        if w > budget:
            raise ValueError(f"lane width {w} exceeds pack budget {budget}")
        if used + w > budget:
            groups.append(cur)
            cur, used = [], 0
        cur.append((lane, w))          # within group: LSB-first
        used += w
    if cur:
        groups.append(cur)

    dev = lanes[0][0].device if lanes else torch.device("cpu")
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    # pack every group's word before any permutation: an LSD pass then
    # costs one gather (wide[perm]) and one composition gather (perm[idx])
    packed: list[torch.Tensor] = []
    for g in groups:                   # least-significant group first (LSD)
        wide = torch.zeros(n, dtype=torch.int64, device=dev)
        shift = rb
        for lane, w in g:              # g is LSB-first: shift upward
            wide = wide | (lane << shift)
            shift += w
        packed.append(wide)
    perm = None
    for wide in packed:
        w = wide if perm is None else wide[perm]
        s = torch.sort(w | iota).values  # low bits = current position
        idx = s & ((1 << rb) - 1)
        perm = idx if perm is None else perm[idx]
    return (perm if perm is not None else iota).to(torch.int32)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def build_sort_topk_fn(schema: Sequence[ColMeta], specs: Sequence[SortSpec],
                       pred: Optional[Expr], k: int,
                       exact: bool = False) -> Callable:
    """ORDER BY ... LIMIT k: f(cols, nrows) ->
       (top int32[k], key_lanes tuple of int64[k], nqual, err, ovf).

    Returns the k first row indexes in sort order among rows passing `pred`
    (rows failing the qual carry a leading dead bit and sort last), plus the
    encoded key-lane values at those rows, so that the host merges
    candidates across chunks with a lexicographic compare of exactly the
    bits the device sorted on.

    Routes, chosen from the shapes (each call counts `topk_<route>` on the
    executing query's Perfmon):
      * packed: every key lane + the row id fit one 63-bit word, so one
        top-k over the negated packed keys is the exact stable top-k;
      * threshold: wider keys; a top-k over a 63-bit key PREFIX finds the
        k-th smallest prefix t, the candidates {prefix <= t} are compacted
        by a second top-k over (is_cand, row id) words (a static-shape
        compaction, which is what makes `ovf` mean "more ties than the
        buffer holds") and finished by an exact packed argsort;
      * adaptive (k > 8192 or k >= n/4): the range-reduced single-word
        sort; `ovf` when the key set does not fit one word;
      * exact=True: the full static packed argsort.
    On `ovf` the caller re-runs the chunk with exact=True."""
    specs = list(specs)

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        with span("lower"):
            live = _live(cols, nrows)
            dev = live.device
            lw = Lowerer(schema, cols, live)
            qual = pred_mask(lw, pred, live)
            lanes: list[tuple[torch.Tensor, int]] = [
                ((~qual).to(torch.int64), 1)]       # non-matches last
            for sp in specs:
                v = lw.lower(sp.expr, qual)
                lanes.extend(_key_lanes(v, sp))
            nqual = qual.to(torch.int64).sum()
            err = err_max(lw, live)
        no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        kk = min(k, n) if n else 0
        if kk == 0:
            top = torch.zeros(0, dtype=torch.int32, device=dev)
            return top, tuple(lane[:0] for lane, _ in lanes), nqual, err, \
                no_ovf

        rb = _rbits(n)
        total = sum(w for _, w in lanes)

        if exact or kk > 8192 or kk * 4 >= n:
            if exact:
                bump_active("topk_exact")
                perm = packed_argsort(lanes, n)
                ovf = no_ovf
            else:
                bump_active("topk_adaptive")
                fs = [_full_specs(lw.lower(sp.expr, qual), sp)
                      for sp in specs]
                perm, fits = _argsort_adaptive(lanes[0][0], fs, n)
                ovf = ~fits
            top = perm[:kk]
            ti = top.to(torch.int64)
            return (top, tuple(lane[ti] for lane, _ in lanes), nqual, err,
                    ovf)

        if total + rb <= 63:
            bump_active("topk_packed")
            wide = torch.arange(n, dtype=torch.int64, device=dev)
            shift = rb
            for lane, w in reversed(lanes):    # lanes are MSB-first
                wide = wide | (lane << shift)
                shift += w
            maxv = (1 << shift) - 1
            desc = torch.topk(maxv - wide, kk).values
            top = ((maxv - desc) & ((1 << rb) - 1)).to(torch.int32)
            ti = top.to(torch.int64)
            return (top, tuple(lane[ti] for lane, _ in lanes), nqual, err,
                    no_ovf)

        bump_active("topk_threshold")
        prefix = torch.zeros(n, dtype=torch.int64, device=dev)
        used = 0
        for lane, w in lanes:
            if used >= 63:
                break
            take = min(w, 63 - used)
            prefix = (prefix << take) | (lane >> (w - take))
            used += take
        maxp = (1 << used) - 1
        desc = torch.topk(maxp - prefix, kk).values
        thresh = maxp - desc[kk - 1]           # k-th smallest prefix
        # every true top-k row has prefix <= thresh; qual-failing rows can
        # never win, so an under-full chunk cannot flood the buffer
        cand = (prefix <= thresh) & qual
        C = min(n, max(512, 2 * _next_pow2(kk)))
        ovf = cand.to(torch.int64).sum() > C
        iota = torch.arange(n, dtype=torch.int64, device=dev)
        w2 = ((~cand).to(torch.int64) << rb) | iota
        max2 = (1 << (rb + 1)) - 1
        cdesc = torch.topk(max2 - w2, C).values
        cw = max2 - cdesc                      # candidates first, rowid asc
        is_cand = (cw >> rb) == 0
        idx = cw & ((1 << rb) - 1)
        glanes: list[tuple[torch.Tensor, int]] = []
        for li, (lane, w) in enumerate(lanes):
            g = lane[idx]
            if li == 0:                        # non-candidates sort last
                g = torch.where(is_cand, g, torch.ones_like(g))
            glanes.append((g, w))
        perm_c = packed_argsort(glanes, C).to(torch.int64)
        sel = perm_c[:kk]
        top = idx[sel].to(torch.int32)
        return (top, tuple(g[sel] for g, _ in glanes), nqual, err, ovf)

    return f


def build_sort_fn(schema: Sequence[ColMeta], specs: Sequence[SortSpec],
                  adaptive: bool | int = True) -> Callable:
    """f(cols, nrows) -> (perm int32[n], err, fits bool).

    perm[:nrows] orders the live rows per the sort specs; dead (padding)
    rows sort last.  Tiers: adaptive in (True, 1) = single-word
    range-reduced sort; adaptive == 2 = two-word lexicographic sort;
    adaptive in (False, 0) = static LSD passes (always valid, fits=True).
    fits=False means the runtime key widths did not fit the tier's word
    budget and perm is meaningless: the caller re-dispatches the next tier
    down."""
    specs = list(specs)
    tier = 1 if adaptive is True else (0 if adaptive is False
                                       else int(adaptive))

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        with span("lower"):
            live = _live(cols, nrows)
            lw = Lowerer(schema, cols, live)
            lanes: list[tuple[torch.Tensor, int]] = [
                ((~live).to(torch.int64), 1)]           # dead rows last
            fs = []
            for sp in specs:
                v = lw.lower(sp.expr, live)
                lanes.extend(_key_lanes(v, sp))
                fs.append(_full_specs(v, sp))
            err = err_max(lw, live)
        if tier == 1:
            perm, fits = _argsort_adaptive(lanes[0][0], fs, n)
        elif tier == 2:
            perm, fits = _argsort_adaptive2(lanes[0][0], fs, n)
        else:
            perm = packed_argsort(lanes, n)
            fits = torch.tensor(True, device=live.device)
        return perm, err, fits

    return f
