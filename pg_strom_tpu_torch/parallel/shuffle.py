"""SPMD shuffle hash-join + grouped aggregation over a device mesh.

The reference (pg_strom_tpu/parallel/shuffle.py) runs one jitted
`shard_map` step; here the same dataflow runs as host-driven phases over
the mesh's shards (parallel/mesh.py), each shard's work on its device:

  per shard: local probe shard, local build shard
    1. partition: bucket rows by hash(key) mod ndev (stable sort + bucket
       starts, the same sorted-bucket machinery as the local hash join)
    2. exchange:  all_to_all both sides -> every key now lives on exactly
       one shard
    3. local join: sorted-bucket build + bounded-chain probe
    4. local partial aggregate: segment reductions by group key
    5. re-aggregate: a second (tiny) all_to_all shuffles the group
       partials by hash(group) so each group's total lands on one shard

Fixed-capacity partition buckets keep shapes static; overflowing a bucket
sets the shard's `ovf` flag (the executor repartitions with a larger
factor — the distributed analog of the DataStoreNoSpace regrow).

The hashes are the reference's splitmix64 on int64 bit patterns
(ops/hashing._mix64) and `h mod ndev` is the unsigned remainder (`_umod`),
so every row goes to the shard the reference sends it to, and every
bucket overflows exactly when the reference's does.

This layer works on pre-projected key/payload lanes (int64 keys).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.hashing import _mix64, _shr64
from .mesh import (Mesh, all_gather, all_to_all, per_shard,  # noqa: F401
                   get_mesh)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of uint64 lanes held as int64 bit patterns by a
    small positive m (torch has no uint64 `%` on the CPU):
    x = 2*(x >>> 1) + (x & 1)."""
    hi = _shr64(x, 1) % m
    return (hi * 2 + (x & 1)) % m


def _i32(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def _starts(sorted_ids: torch.Tensor, nb: int) -> torch.Tensor:
    """Left insertion points of 0..nb in an ascending int lane."""
    edges = torch.arange(nb + 1, dtype=sorted_ids.dtype,
                         device=sorted_ids.device)
    return torch.searchsorted(sorted_ids.contiguous(), edges,
                              side="left").to(torch.int32)


def _partition_lanes(lanes: tuple, key: torch.Tensor, valid: torch.Tensor,
                     ndev: int, bucket_cap: int, part=None):
    """Sort local rows into ndev fixed-capacity buckets by hash(key)%ndev
    (or by a caller-supplied partition lane — the skew router uses this).

    Returns (bucketed lanes each [ndev, bucket_cap], valid [ndev,
    bucket_cap], counts [ndev], ovf)."""
    n = key.shape[0]
    dev = key.device
    if part is None:
        part = _umod(_mix64(key), ndev).to(torch.int32)
    part = torch.where(valid, part.to(torch.int32), _i32(ndev, key))
    order = torch.argsort(part, stable=True)
    psorted = part[order]
    starts = _starts(psorted, ndev)
    counts = starts[1:] - starts[:-1]
    ovf = (counts > bucket_cap).any()
    pos = (torch.arange(n, dtype=torch.int32, device=dev)
           - starts[psorted.clamp(0, ndev - 1).long()])
    dest = torch.where((psorted < ndev) & (pos < bucket_cap),
                       psorted * bucket_cap + pos,
                       _i32(ndev * bucket_cap, key)).long()
    size = ndev * bucket_cap

    def scatter(src):
        buf = torch.zeros(size + 1, dtype=src.dtype, device=dev)
        buf[dest] = src            # distinct slots; dropped rows hit `size`
        return buf[:size].reshape(ndev, bucket_cap)

    out = tuple(scatter(lane[order]) for lane in lanes)
    vb = scatter(valid[order])
    return out, vb, counts, ovf


def _local_hash_join(pkey, pval, pvalid, bkey, bpay, bvalid, nbuckets: int,
                     max_chain: int):
    """Sorted-bucket join on local shards.  Returns per-probe-row fan-out
    lanes: (matched mask [n, max_chain], build payload [n, max_chain],
    ovf) — join output = all (probe, build) matched pairs."""
    nb = bkey.shape[0]
    bucket = _umod(_mix64(bkey), nbuckets).to(torch.int32)
    bucket = torch.where(bvalid, bucket, _i32(nbuckets, bkey))
    order = torch.argsort(bucket, stable=True)
    bsorted = bucket[order]
    bkey_s = bkey[order]
    bpay_s = bpay[order]
    starts = _starts(bsorted, nbuckets)

    pb = _umod(_mix64(pkey), nbuckets).to(torch.int32)
    pb = torch.where(pvalid, pb, _i32(nbuckets - 1, pkey)).long()
    s = starts[pb]
    e = starts[pb + 1]
    blen = torch.where(pvalid, e - s, torch.zeros_like(s))
    ovf = (blen > max_chain).any()

    ms, pays = [], []
    for k in range(max_chain):
        j = (s + k).clamp(0, max(nb - 1, 0)).long()
        ms.append(pvalid & (k < blen) & (pkey == bkey_s[j]))
        pays.append(bpay_s[j])
    return torch.stack(ms, dim=1), torch.stack(pays, dim=1), ovf


def segment_sum(x: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """jax.ops.segment_sum with ids in [0, G)."""
    out = torch.zeros(G, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg.long(), x)


def segment_min(x: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """jax.ops.segment_min with ids in [0, G): an empty segment holds the
    dtype's maximum."""
    out = torch.full((G,), torch.iinfo(x.dtype).max, dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce_(0, seg.long(), x, "amin", include_self=True)


def _local_group_partials(gkey, vals, valid, G: int):
    """Segment partial aggregation by key into G slots: ONE sort per call
    carries any number of value lanes (count + each lane's sum).

    Returns (keys[G], kvalid[G], count[G] int64-exact, [sum[G] per value
    lane], ovf).  `vals` may be a single lane or a list/tuple of lanes."""
    from ..ops.sort import packed_argsort, _chunks_from_unsigned
    single = not isinstance(vals, (list, tuple))
    vlanes = [vals] if single else list(vals)
    n = gkey.shape[0]
    dev = gkey.device
    hk = _mix64(gkey) & ((1 << 62) - 1)
    hk = torch.where(valid, hk, torch.full_like(hk, 1 << 62))
    order = packed_argsort(_chunks_from_unsigned(hk, 63), n).long()
    ks = gkey[order]
    ok = valid[order]
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same = torch.cat([false1, (ks[1:] == ks[:-1]) & ok[1:] & ok[:-1]])
    new_seg = ok & ~same
    seg = (torch.cumsum(new_seg.to(torch.int32), 0) - 1).clamp(0, G - 1)
    ngroups = new_seg.to(torch.int32).sum()
    ovf = ngroups > G
    cnt = segment_sum(ok.to(torch.int64), seg, G)
    sums = []
    for v in vlanes:
        vs = v[order]
        sums.append(segment_sum(torch.where(ok, vs, torch.zeros_like(vs)),
                                seg, G))
    pos = torch.where(new_seg, torch.arange(n, dtype=torch.int64, device=dev),
                      torch.full((n,), 1 << 62, dtype=torch.int64,
                                 device=dev))
    first = segment_min(pos, seg, G).clamp(0, max(n - 1, 0))
    gkeys = ks[first]
    gvalid = torch.arange(G, dtype=torch.int32, device=dev) < ngroups
    if single:
        return gkeys, gvalid, cnt, sums[0], ovf
    return gkeys, gvalid, cnt, sums, ovf


_HEAVY_SENTINEL = -(1 << 63)


def detect_heavy_keys(keys, valid, k_heavy: int,
                      sample_rows: int | None = None,
                      threshold: float | None = None) -> np.ndarray:
    """Host-side heavy-hitter detection (skew sampling).

    Samples up to `sample_rows` valid keys and returns the <= k_heavy keys
    whose sample frequency exceeds `threshold`, padded with _HEAVY_SENTINEL
    to a fixed int64[k_heavy].  Misclassification in either direction is
    correctness-preserving — heaviness only changes ROUTING (spread+broadcast
    vs hash partition), never join/agg semantics.  Defaults come from config
    (skew_sample_rows / skew_heavy_threshold)."""
    from ..config import config
    if sample_rows is None:
        sample_rows = config.skew_sample_rows
    if threshold is None:
        threshold = config.skew_heavy_threshold
    keys = np.asarray(keys)
    valid = np.asarray(valid, dtype=bool)
    kv = keys[valid]
    out = np.full(k_heavy, _HEAVY_SENTINEL, dtype=np.int64)
    if k_heavy == 0 or kv.size == 0:
        return out
    if kv.size > sample_rows:
        step = kv.size // sample_rows
        kv = kv[::step][:sample_rows]
    uniq, cnt = np.unique(kv, return_counts=True)
    frac = cnt / kv.size
    order = np.argsort(-cnt)
    picked = [int(uniq[i]) for i in order[:k_heavy] if frac[i] > threshold]
    out[:len(picked)] = picked
    return out


def build_shuffle_join_agg_step(mesh: Mesh, axis: str = "dp",
                                bucket_cap: int = 1024,
                                nbuckets: int = 4096,
                                max_chain: int = 8,
                                G: int = 512,
                                k_heavy: int = 0,
                                heavy_cap: int | None = None) -> Callable:
    """Distributed step over `mesh`:

      f(probe_key, probe_val, probe_valid, build_key, build_pay,
        build_valid[, heavy_keys[k_heavy]])
        -> per shard (group_keys [G], group_valid, count, sum, ovf [1])

    Each input is a list of per-shard tensors (`mesh.shard_host`); the
    heavy-key list is one tensor, replicated.  Every shard's outputs are
    its disjoint group partials after the re-aggregation shuffle (each
    group's total lives on exactly one shard).

    Skew-aware repartitioning (k_heavy > 0): rows whose key is in
    `heavy_keys` bypass hash partitioning — probe rows are spread
    round-robin over all shards and the matching build rows are broadcast
    (all_gather) to every shard.  Exactness is unaffected: the second-phase
    partial re-aggregation already merges per-shard partials of a group."""
    ndev = mesh.shape[axis]
    if heavy_cap is None:
        heavy_cap = bucket_cap

    def step(pkey, pval, pvalid, bkey, bpay, bvalid, *rest):
        heavy = rest[0] if k_heavy else None

        # ---- phase 0: skew routing lanes ---------------------------------
        def route(s, pk, pval_, pv, bk, bp, bv):
            hovf = torch.zeros((), dtype=torch.bool, device=pk.device)
            bv_hash, ppart, hb = bv, None, None
            if k_heavy:
                hv = heavy.to(pk.device)
                p_heavy = torch.zeros_like(pv)
                b_heavy = torch.zeros_like(bv)
                for j in range(k_heavy):
                    p_heavy = p_heavy | (pk == hv[j])
                    b_heavy = b_heavy | (bk == hv[j])
                p_heavy = p_heavy & pv
                b_heavy = b_heavy & bv
                base = _umod(_mix64(pk), ndev).to(torch.int32)
                rr = (torch.cumsum(p_heavy.to(torch.int32), 0) - 1) % ndev
                ppart = torch.where(p_heavy, rr.to(torch.int32), base)
                bv_hash = bv & ~b_heavy
                (hbk, hbp), hbv, _, hovf = _partition_lanes(
                    (bk, bp), bk, b_heavy, 1, heavy_cap)
                hb = (hbk[0], hbp[0], hbv[0])
            (pk_b, pv_b), pva_b, _, povf = _partition_lanes(
                (pk, pval_), pk, pv, ndev, bucket_cap, part=ppart)
            (bk_b, bp_b), bva_b, _, bovf = _partition_lanes(
                (bk, bp), bk, bv_hash, ndev, bucket_cap)
            return (pk_b, pv_b, pva_b, bk_b, bp_b, bva_b, hb,
                    povf | bovf | hovf)

        r = per_shard(mesh, route, pkey, pval, pvalid, bkey, bpay, bvalid)

        # ---- phase 1+2: exchange both sides -------------------------------
        def a2a(k):
            return [x.reshape(-1) for x in
                    all_to_all([t[k] for t in r], mesh, axis)]
        pk_l, pv_l, pva_l, bk_l, bp_l, bva_l = (a2a(k) for k in range(6))
        if k_heavy:
            hb_g = [all_gather([t[6][k] for t in r], mesh, axis)
                    for k in range(3)]
            bk_l = [torch.cat([a, g.reshape(-1)])
                    for a, g in zip(bk_l, hb_g[0])]
            bp_l = [torch.cat([a, g.reshape(-1)])
                    for a, g in zip(bp_l, hb_g[1])]
            bva_l = [torch.cat([a, g.reshape(-1)])
                     for a, g in zip(bva_l, hb_g[2])]

        # ---- phase 3+4: local join, local partial aggregate ---------------
        def join_agg(s, pk, pv, pva, bk, bp, bva):
            matched, pay_m, jovf = _local_hash_join(
                pk, pv, pva, bk, bp, bva, nbuckets, max_chain)
            n, mc = matched.shape
            jkey = pk[:, None].expand(n, mc).reshape(-1)
            jval = (pv[:, None].expand(n, mc)
                    * pay_m.to(torch.float64)).reshape(-1)
            gk, gv, cnt, sm, govf = _local_group_partials(
                jkey, jval, matched.reshape(-1), G)
            (gk_b, cnt_b, sm_b), gvb, _, rovf = _partition_lanes(
                (gk, cnt, sm), gk, gv, ndev, G)
            return gk_b, cnt_b, sm_b, gvb, jovf | govf | rovf

        j = per_shard(mesh, join_agg, pk_l, pv_l, pva_l, bk_l, bp_l, bva_l)

        # ---- phase 5: re-aggregate partials across shards -----------------
        gk_x, cnt_x, sm_x, gv_x = (
            [x.reshape(-1) for x in all_to_all([t[k] for t in j], mesh,
                                               axis)]
            for k in range(4))

        def final(s, gk, cnt, sm, gv):
            fk, fv, _fn, (fcnt, fsum), fovf = _local_group_partials(
                gk, [cnt, sm], gv, G)
            ovf = r[s][7] | j[s][4] | fovf
            return fk, fv, fcnt, fsum, ovf.reshape(1)

        return per_shard(mesh, final, gk_x, cnt_x, sm_x, gv_x)

    return step


def pad_shards(arr: np.ndarray, ndev: int, fill=0) -> np.ndarray:
    """Pad the leading axis to a multiple of ndev (an even shard split)."""
    n = arr.shape[0]
    m = (-n) % ndev
    if m == 0:
        return arr
    pad = np.full((m,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_host(arr: np.ndarray, mesh: Mesh) -> list[torch.Tensor]:
    """Split a host array (leading axis a multiple of the shard count)
    into equal contiguous blocks, block s on the mesh's device s — the
    reference's NamedSharding over every mesh axis jointly."""
    a = np.ascontiguousarray(arr)
    blocks = np.split(a, mesh.ndev)
    return [torch.from_numpy(np.ascontiguousarray(b)).to(d)
            for b, d in zip(blocks, mesh.devices)]


def gather_host(outs: list):
    """Per-shard output trees -> one host tree whose leaves concatenate the
    shards' leaves on axis 0 (0-d leaves become one element a shard): the
    reference's out_specs=P(axis) layout."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return np.concatenate([np.asarray(o.cpu()).reshape(-1)
                               if o.dim() == 0 else np.asarray(o.cpu())
                               for o in outs])
    if isinstance(first, dict):
        return {k: gather_host([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(gather_host([o[i] for o in outs])
                           for i in range(len(first)))
    return first


def run_shuffle_join_agg(step, mesh: Mesh, pkey, pval, pvalid,
                         bkey, bpay, bvalid):
    """Pad inputs to shard-count multiples (padding rows valid=False),
    shard them over the mesh and run; per-shard outputs."""
    ndev = mesh.ndev
    return step(shard_host(pad_shards(np.asarray(pkey), ndev), mesh),
                shard_host(pad_shards(np.asarray(pval, dtype=np.float64),
                                      ndev), mesh),
                shard_host(pad_shards(np.asarray(pvalid, dtype=bool), ndev,
                                      fill=False), mesh),
                shard_host(pad_shards(np.asarray(bkey), ndev), mesh),
                shard_host(pad_shards(np.asarray(bpay), ndev), mesh),
                shard_host(pad_shards(np.asarray(bvalid, dtype=bool), ndev,
                                      fill=False), mesh))


def host_merge_group_partials(fk, fv, fcnt, fsum):
    """Collect the per-shard disjoint partials into {key: (count, sum)}."""
    fk = np.asarray(fk)
    fv = np.asarray(fv)
    fcnt = np.asarray(fcnt)
    fsum = np.asarray(fsum)
    out: dict[int, tuple[int, float]] = {}
    for k, v, c, s in zip(fk, fv, fcnt, fsum):
        if not v or c == 0:
            continue
        kk = int(k)
        if kk in out:  # only if a group straddled shards (shouldn't happen)
            c0, s0 = out[kk]
            out[kk] = (c0 + int(c), s0 + float(s))
        else:
            out[kk] = (int(c), float(s))
    return out
