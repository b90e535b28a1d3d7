"""Equi hash join: device build + streamed probe.

The GpuHashJoin/MultiHash analog as the reference writes it
(pg_strom_tpu/ops/hashjoin.py), evaluated eagerly with torch ops:

  * build: sort build rows by bucket id (a stable argsort), bucket offsets
    by searchsorted — no chains, no atomics; plus a direct-address `dense`
    table for a single integer key (key - kmin -> build row), its identity
    flag for serial keys, and the K3 lookup table `dense_M`;
  * probe: two-phase count -> prefix sum -> write with a bounded chain
    walk (build_probe_fn), a row-aligned bounded-fanout walk
    (build_probe_multi_fn), or the one-lookup dense probe
    (build_probe_dense_fn: identity, K3 or a plain gather).

Chains longer than `max_chain` flag CPU_RECHECK and the chunk falls back to
the exact host join.  The hash table is a dict of tensors with the
reference's keys, so the tests compare the two entry by entry; `dense_M`
is the raw padded lookup table (ops/mxu_lookup.py), not the digit matrix.

Unsigned lanes follow ops/hashing.py: the u32 bucket hash rides as int64
in [0, 2^32).  A jnp scatter with mode="drop" becomes a write into a
tensor one slot longer, whose last slot takes the dropped lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..sqltypes import T
from ..errors import ERR_CPU_RECHECK
from ..expr.ir import Expr
from ..expr.lower_torch import Lowerer, DVal, ColMeta, _live, pred_mask, \
    err_max
from .hashing import hash_column32, combine_hashes32
from .sort import argsort_i32
from .mxu_lookup import MAX_D as MXU_MAX_D, _HPAD as _MXU_HPAD_MIN, LANE, \
    encode_table_torch, lookup_digits, mxu_lookup
from ..utils.perfmon import span


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class HashTable:
    """Device-resident sorted-bucket hash table over the build side."""
    nbuckets: int
    bucket_start: torch.Tensor     # int32[nbuckets+1]
    order: torch.Tensor            # int32[cap]: sorted position -> build row
    key_planes: tuple              # sorted key DVal planes per key expr
    key_types: tuple[T, ...]
    nbuild: int                    # live build rows


# single-int-key PK joins (the dim-join shape) get a direct-address table:
# the probe costs one lookup instead of a bounded chain walk.  Types with
# an integer data lane whose value IS the join identity:
_DENSE_KEY_TYPES = {T.INT2, T.INT4, T.INT8, T.DATE, T.TIME, T.TIMESTAMP,
                    T.BOOL}


def dense_cap_for(build_cap: int) -> int:
    """Static direct-address table size for a build capacity (4x slack lets
    serial PKs with gaps still qualify)."""
    return _next_pow2(max(4 * build_cap, 1024))


def mxu_dense_window(build_cap: int) -> int:
    """Window of the K3 lookup table (tighter than dense_cap_for when that
    exceeds the kernel's MAX_D; ht['dense_m_ok'] certifies at run time that
    live keys fit it)."""
    return min(dense_cap_for(build_cap), MXU_MAX_D)


def _buckets(keys: list[DVal], allvalid: torch.Tensor, nbuckets: int,
             null_bucket: int) -> torch.Tensor:
    hs = [hash_column32(k.t, k.data, k.valid,
                        k.exp if k.t is T.NUMERIC else None)
          for k in keys]
    bucket = (combine_hashes32(hs) & (nbuckets - 1)).to(torch.int32)
    return torch.where(allvalid, bucket, torch.full_like(bucket, null_bucket))


def build_hash_table(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                     pred: Optional[Expr] = None,
                     row_bits: Optional[int] = None) -> Callable:
    """Build-side function: f(cols, nrows) -> dict of table tensors.

    Rows with NULL in any join key never match (SQL equi-join semantics), so
    they are excluded from buckets entirely.

    Besides the sorted-bucket table, emits a direct-address `dense` lookup
    (key - kmin -> build row, -1 empty) with `dense_ok` true when the build
    side has ONE integer key whose live values fit the static window with no
    duplicates — the executor then probes with one lookup.

    row_bits: bit width of live build-row ids (the executor passes
    bit_length(build.nrows)), which sets K3's digit count K and its
    sentinel; it must match the probe's."""
    key_exprs = list(key_exprs)

    def f(cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = _live(cols, nrows)
        dev = live.device
        nbuckets = _next_pow2(max(2 * n, 16))
        lw = Lowerer(schema, cols, live)
        mask = pred_mask(lw, pred, live)
        keys = [lw.lower(k, mask) for k in key_exprs]
        allvalid = mask
        for k in keys:
            allvalid = allvalid & k.valid
        bucket = _buckets(keys, allvalid, nbuckets, nbuckets)
        order = argsort_i32(bucket)
        bsorted = bucket[order]
        edges = torch.arange(nbuckets + 1, dtype=torch.int32, device=dev)
        bucket_start = torch.searchsorted(bsorted, edges).to(torch.int32)
        key_planes = []
        for k in keys:
            planes = [k.data[order], k.valid[order]]
            if k.t is T.NUMERIC:
                planes.append(k.exp[order])
            key_planes.append(tuple(planes))

        if len(keys) == 1 and keys[0].t in _DENSE_KEY_TYPES:
            rows = torch.arange(n, dtype=torch.int32, device=dev)
            dcap = dense_cap_for(n)
            kd = keys[0].data.to(torch.int64)
            kmin = torch.where(allvalid, kd,
                               torch.full_like(kd, 1 << 62)).min()
            off = kd - kmin
            in_r = allvalid & (off >= 0) & (off < dcap)
            # every live key in window + kmin far from int64 extremes (so a
            # probe-side `key - kmin` can never wrap INTO the window)
            fits = ((in_r == allvalid).all() & allvalid.any()
                    & (kmin.abs() < (1 << 62)))
            tgt = torch.where(in_r, off, torch.full_like(off, dcap))
            # slot dcap takes the dropped lanes; duplicate targets write in
            # no defined order, which only matters where dense_ok is false
            dense = torch.full((dcap + 1,), -1, dtype=torch.int32, device=dev)
            dense[tgt] = rows
            dense = dense[:dcap]
            cnt = torch.zeros(dcap + 1, dtype=torch.int32, device=dev)
            cnt.index_add_(0, tgt, torch.ones_like(rows))
            dense_ok = fits & (cnt[:dcap] <= 1).all()
            # identity: build key of row i is exactly kmin + i for EVERY
            # build row (the serial-PK dimension shape): the probe needs
            # no table access at all
            dense_ident = (dense_ok & (allvalid == live).all()
                           & torch.where(live, off == rows.to(torch.int64),
                                         torch.ones_like(live)).all())
            # the K3 table covers the tighter window D_m <= MXU_MAX_D;
            # dense_m_ok certifies at run time that every live key fits it
            D_m = min(dcap, MXU_MAX_D)
            if D_m == dcap:
                dense_m_ok = dense_ok
            else:
                dense_m_ok = dense_ok & torch.where(
                    allvalid, off < D_m, torch.ones_like(allvalid)).all()
            rb = row_bits if row_bits is not None else max(n, 1).bit_length()
            sent = (1 << rb) - 1        # > any live row id by construction
            vals = torch.where(dense[:D_m] >= 0, dense[:D_m],
                               torch.full_like(dense[:D_m], sent))
            dense_M = encode_table_torch(vals, D_m, lookup_digits(rb),
                                         pad_value=sent)
        else:
            dense = torch.full((1,), -1, dtype=torch.int32, device=dev)
            kmin = torch.tensor(0, dtype=torch.int64, device=dev)
            false = torch.tensor(False, device=dev)
            dense_ok = dense_m_ok = dense_ident = false
            dense_M = torch.zeros(_MXU_HPAD_MIN * LANE, dtype=torch.int32,
                                  device=dev)
        return {"bucket_start": bucket_start,
                "order": order.to(torch.int32),
                "key_planes": tuple(key_planes),
                "dense": dense, "kmin": kmin, "dense_ok": dense_ok,
                "dense_M": dense_M, "dense_m_ok": dense_m_ok,
                "dense_ident": dense_ident,
                "nbuild": allvalid.to(torch.int32).sum().to(torch.int32),
                "err": err_max(lw, live)}

    return f


def build_probe_dense_fn(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                         dense_cap: int, pred: Optional[Expr] = None,
                         use_mxu: bool = False,
                         row_bits: Optional[int] = None,
                         use_ident: bool = False) -> Callable:
    """One-lookup probe against a direct-address build table:
       f(ht, cols, nrows) -> (matched bool[n], build_row int32[n], nout, err).

    Output stays ROW-ALIGNED (no compaction pass): at most one match per
    probe row by construction (dense_ok => unique build keys), so the
    executor materializes pairs with a host flatnonzero.

    use_ident (ht['dense_ident']): the slot is the build row, no table
    access.  use_mxu (ht['dense_m_ok']): dense_cap is the tighter
    mxu_dense_window and the slot lookup is K3.  Otherwise a plain gather
    into ht['dense']."""
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        with span("lower"):
            live = _live(cols, nrows)
            lw = Lowerer(schema, cols, live)
            mask = pred_mask(lw, pred, live)
            k = lw.lower(key_exprs[0], mask)
        off = k.data.to(torch.int64) - ht["kmin"]
        in_r = mask & k.valid & (off >= 0) & (off < dense_cap)
        slot = off.clamp(0, dense_cap - 1).to(torch.int32)
        if use_ident:
            br = slot
            matched = in_r & (off < ht["nbuild"].to(torch.int64))
        elif use_mxu:
            nb = ht["order"].shape[0]
            rb = row_bits if row_bits is not None \
                else max(nb, 1).bit_length()
            sent = (1 << rb) - 1       # must match build_hash_table's
            br = mxu_lookup(slot, ht["dense_M"], dense_cap,
                            lookup_digits(rb), n, sentinel=sent)
            matched = in_r & (br != sent)
        else:
            br = ht["dense"][slot.to(torch.int64)]
            matched = in_r & (br >= 0)
        return (matched, torch.where(matched, br, torch.zeros_like(br)),
                matched.to(torch.int64).sum(), err_max(lw, live))

    return f


def _keys_match(probe_keys: list[DVal], ht_key_planes: tuple,
                key_types: tuple, j: torch.Tensor) -> torch.Tensor:
    """probe row lanes vs build rows at sorted positions j (lane-wise)."""
    ok = None
    for pk, planes, t in zip(probe_keys, ht_key_planes, key_types):
        bdata = planes[0][j]
        bvalid = planes[1][j]
        pd = pk.data
        if t in (T.FLOAT4, T.FLOAT8):
            # PostgreSQL float equality is float8_cmp_internal == 0:
            # -0 = +0 AND NaN = NaN (the btree semantics the host tier's
            # cmp_values implements) — plain IEEE == would drop NaN pairs
            pd0 = torch.where(pd == 0, torch.zeros_like(pd), pd)
            bd0 = torch.where(bdata == 0, torch.zeros_like(bdata), bdata)
            same = (pd0 == bd0) | (torch.isnan(pd) & torch.isnan(bdata))
        else:
            same = pd == bdata
        if t is T.NUMERIC:
            same = same & (pk.exp == planes[2][j])
        e = pk.valid & bvalid & same
        ok = e if ok is None else (ok & e)
    return ok


def _probe_keys(lw: Lowerer, key_exprs, mask, ht):
    """(keys, allvalid, start, blen) of the bounded chain walk."""
    keys = [lw.lower(k, mask) for k in key_exprs]
    allvalid = mask
    for k in keys:
        allvalid = allvalid & k.valid
    nbuckets = ht["bucket_start"].shape[0] - 1
    bucket = _buckets(keys, allvalid, nbuckets, nbuckets - 1).to(torch.int64)
    start = ht["bucket_start"][bucket]
    end = ht["bucket_start"][bucket + 1]
    blen = torch.where(allvalid, end - start, torch.zeros_like(start))
    return keys, allvalid, start, blen


def build_probe_multi_fn(schema: Sequence[ColMeta],
                         key_exprs: Sequence[Expr], key_types: tuple,
                         max_chain: int, fanout: int,
                         pred: Optional[Expr] = None) -> Callable:
    """ROW-ALIGNED bounded-fanout probe: f(ht, cols, nrows) ->
       (brs int32[fanout, n], counts int32[n], ovf bool, err).

    brs[f, i] = build row of probe row i's f-th match (first-seen order);
    counts[i] = total matches; ovf = some row had more than `fanout`
    matches OR a bucket chain exceeded max_chain — the caller raises the
    fanout/chain ladder or falls back to the pairwise compacting probe."""
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        with span("lower"):
            live = _live(cols, nrows)
            lw = Lowerer(schema, cols, live)
            mask = pred_mask(lw, pred, live)
            keys, allvalid, start, blen = _probe_keys(lw, key_exprs, mask,
                                                      ht)
        too_long = (blen > max_chain).any()
        err = err_max(lw, live)
        bs_max = ht["order"].shape[0]
        order = ht["order"]
        brs = [torch.full((n,), bs_max, dtype=torch.int32, device=live.device)
               for _ in range(fanout)]
        cnt = torch.zeros(n, dtype=torch.int32, device=live.device)
        for k in range(max_chain):
            j = (start + k).clamp(0, max(bs_max - 1, 0)).to(torch.int64)
            m = (allvalid & (k < blen)
                 & _keys_match(keys, ht["key_planes"], key_types, j))
            row = order[j]
            for fx in range(fanout):
                brs[fx] = torch.where(m & (cnt == fx), row, brs[fx])
            cnt = cnt + m.to(torch.int32)
        ovf = too_long | (cnt > fanout).any()
        return torch.stack(brs), cnt, ovf, err

    return f


def build_probe_fn(schema: Sequence[ColMeta], key_exprs: Sequence[Expr],
                   key_types: tuple, nbuckets: int, max_chain: int,
                   out_cap: int, pred: Optional[Expr] = None) -> Callable:
    """Probe function: f(ht, cols, nrows) ->
       (probe_idx int32[out_cap], build_row int32[out_cap], nout, err).

    Two-phase count-then-write with a bounded per-bucket scan; chains longer
    than max_chain or nout > out_cap are flagged (executor grows/falls back).
    """
    key_exprs = list(key_exprs)

    def f(ht: dict, cols: tuple, nrows):
        n = cols[0][0].shape[0] if cols else 0
        live = _live(cols, nrows)
        dev = live.device
        with span("lower"):
            lw = Lowerer(schema, cols, live)
            mask = pred_mask(lw, pred, live)
            keys, allvalid, start, blen = _probe_keys(lw, key_exprs, mask,
                                                      ht)
        # chains longer than the bounded scan: defer chunk to host
        too_long = (blen > max_chain).any()
        err = torch.maximum(err_max(lw, live), torch.where(
            too_long, torch.tensor(ERR_CPU_RECHECK, dtype=torch.uint8,
                                   device=dev),
            torch.tensor(0, dtype=torch.uint8, device=dev)))
        bs_max = ht["order"].shape[0]
        order = ht["order"]

        def match_at(k: int):
            j = (start + k).clamp(0, max(bs_max - 1, 0)).to(torch.int64)
            return (allvalid & (k < blen)
                    & _keys_match(keys, ht["key_planes"], key_types, j)), j

        # phase 1: count
        counts = torch.zeros(n, dtype=torch.int64, device=dev)
        for k in range(max_chain):
            m, _ = match_at(k)
            counts = counts + m.to(torch.int64)
        pos = torch.cumsum(counts, 0) - counts      # exclusive prefix
        nout = counts.sum()

        # phase 2: write pairs (slot out_cap takes the dropped lanes)
        probe_idx = torch.full((out_cap + 1,), n, dtype=torch.int32,
                               device=dev)
        build_row = torch.full((out_cap + 1,), bs_max, dtype=torch.int32,
                               device=dev)
        written = torch.zeros(n, dtype=torch.int64, device=dev)
        src = torch.arange(n, dtype=torch.int32, device=dev)
        for k in range(max_chain):
            m, j = match_at(k)
            w = pos + written
            tgt = torch.where(m & (w < out_cap), w,
                              torch.full_like(w, out_cap))
            probe_idx[tgt] = src
            build_row[tgt] = order[j]
            written = written + m.to(torch.int64)
        return probe_idx[:out_cap], build_row[:out_cap], nout, err

    return f
