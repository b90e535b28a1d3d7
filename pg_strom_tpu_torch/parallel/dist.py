"""Generalized SPMD distributed join + grouped aggregation.

The engine-integrated distributed layer, as pg_strom_tpu/parallel/dist.py
has it, on the port's single-controller mesh (parallel/mesh.py): one
process runs each step's phases over every shard, each shard's work on
its device, and moves rows between shards with `all_to_all` /
`all_gather`.  It routes real SQL through the mesh:

  - multi-lane join keys (any int-lane SQL type; floats via exact order-key
    encoding, so NaN = NaN and -0 = +0 follow PostgreSQL equality)
  - multi-lane group keys from either join side (ints, date/time, text via
    dictionary codes, floats via order keys) decoded exactly on the host
  - every partial slot kind of ops/preagg.AGG_CATALOG in DIST_SLOT_KINDS —
    the per-shard partial aggregation calls ops/preagg._slot_compute, so
    shard partials and host finalization share one exactness contract
  - fixed-capacity phases with per-shard overflow flags; the executor
    (exec/dist_exec.py) owns the overflow -> repartition retry loop

One step per (plan signature, capacities, mesh shape): per shard —

  1. partition probe/build rows into ndev buckets by hash(join key lanes)
  2. all_to_all both sides over the mesh axis (two stages on a 2D mesh)
  3. local sorted-bucket hash join, ALL key lanes compared per chain step
  4. local partial aggregation of the joined pairs by group-key lanes
     (sort by group hash, segment boundaries by exact lane equality)

Outputs are per-shard group partials; a group may appear on several shards
(and, on a group-hash collision, twice on one) — benign: the host merge
folds duplicates through ops/preagg.merge_partials.  Which shard owns a
row, and which buckets overflow, are the reference's bit for bit
(`_umod` over the reference's splitmix64).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..sqltypes import T
from ..ops.hashing import _mix64
from .mesh import (Mesh, all_gather, all_to_all, per_shard,  # noqa: F401
                   get_mesh)
from .shuffle import (_partition_lanes, _starts, _umod, _i32,  # noqa: F401
                      pad_shards, segment_min)

# build-time telemetry: how many distributed steps were BUILT (not served
# from a step cache) per exchange topology — toggling dist_mesh_hosts must
# build the other topology, not serve the cached one
BUILD_COUNTS = {"exchange_flat": 0, "exchange_2stage": 0}


# int-lane types whose canonical encoding is the value itself
_INT_LANE = {T.BOOL, T.INT2, T.INT4, T.INT8, T.DATE, T.TIME, T.TIMESTAMP}
JOIN_KEY_OK = _INT_LANE | {T.FLOAT4, T.FLOAT8}
GROUP_KEY_OK = JOIN_KEY_OK | {T.TEXT, T.BPCHAR}
AGG_ARG_OK = _INT_LANE | {T.FLOAT4, T.FLOAT8, T.NUMERIC}
# slot kinds _slot_compute handles over the mesh; a NUMERIC arg ships as
# THREE int64 lanes (mantissa, exponent, display scale)
DIST_SLOT_KINDS = {"nrows", "count", "sum_i", "sumsq_i", "sum_f", "sumsq_f",
                   "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y",
                   "min", "max", "sum_num", "sumsq_num", "maxdscale"}

_EXP_F64 = 0x7FF0000000000000
_MAN_F64 = 0x000FFFFFFFFFFFFF
_QNAN_F64 = 0x7FF8000000000000


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One shipped lane: which join side it comes from and its SQL type.

    Wire encodings (fixed-width):
      int-lane types -> int64 value; text -> int64 dictionary code (host
      decodes per column); float4 agg arg -> float32 data; float8 agg arg
      -> int64 IEEE bits (f64 data derived in-step); float KEYS -> int64
      order key (exact PG equality incl. NaN and -0).
    """
    side: str          # 'probe' | 'build'
    t: T
    role: str          # 'gkey' | 'arg'

    def wire_dtype(self):
        return np.float32 if (self.role == "arg" and self.t is T.FLOAT4) \
            else np.int64


@dataclasses.dataclass(frozen=True)
class DistPlanSig:
    """Static signature of a distributed join+agg program."""
    n_probe_jkeys: int
    n_build_jkeys: int
    gkeys: tuple            # tuple[LaneSpec]
    aggs: tuple             # per agg: (tuple[LaneSpec], tuple[slot kinds])
    ungrouped: bool


class _ErrShim:
    """Stand-in for the Lowerer's error lane that _slot_compute maxes
    CpuReCheck conditions into (expr/lower_torch.Lowerer.err)."""

    def __init__(self, dev: torch.device):
        self.err = torch.zeros((), dtype=torch.uint8, device=dev)


def _combine_hash(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    h = _mix64(lanes[0].to(torch.int64))
    for lane in lanes[1:]:
        h = _mix64(h ^ _mix64(lane.to(torch.int64)))
    return h


def host_combine_hash(lanes: Sequence[np.ndarray]) -> np.ndarray:
    """Numpy mirror of _combine_hash over host int64 lanes — the skew
    detector classifies keys by the SAME hash the step routes by."""
    def mix(x):
        x = x.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))
    with np.errstate(over="ignore"):
        h = mix(np.asarray(lanes[0]).astype(np.int64)).astype(np.int64)
        for lane in lanes[1:]:
            h = mix(h ^ mix(np.asarray(lane).astype(np.int64))
                    .astype(np.int64)).astype(np.int64)
    return h


def _local_hash_join_multi(pkeys, pvalid, bkeys, bvalid, nbuckets: int,
                           max_chain: int):
    """Sorted-bucket equi-join comparing ALL key lanes per chain step.

    Returns (matched [n, mc], j [n, mc] gather index into the SORTED build
    order, order [nb] build sort permutation, ovf)."""
    nb = bkeys[0].shape[0]
    bucket = _umod(_combine_hash(bkeys), nbuckets).to(torch.int32)
    bucket = torch.where(bvalid, bucket, _i32(nbuckets, bucket))
    order = torch.argsort(bucket, stable=True)
    bsorted = bucket[order]
    bkeys_s = [k[order] for k in bkeys]
    starts = _starts(bsorted, nbuckets)

    pb = _umod(_combine_hash(pkeys), nbuckets).to(torch.int32)
    pb = torch.where(pvalid, pb, _i32(nbuckets - 1, pb)).long()
    s = starts[pb]
    e = starts[pb + 1]
    blen = torch.where(pvalid, e - s, torch.zeros_like(s))
    ovf = (blen > max_chain).any()

    ms, js = [], []
    for k in range(max_chain):
        j = (s + k).clamp(0, max(nb - 1, 0)).long()
        m = pvalid & (k < blen)
        for pk, bks in zip(pkeys, bkeys_s):
            m = m & (pk == bks[j])
        ms.append(m)
        js.append(j)
    return torch.stack(ms, dim=1), torch.stack(js, dim=1), order, ovf


def _arg_dval(sp: LaneSpec, data_lane, valid_lane):
    """DVal for an agg-arg lane (ops/preagg._slot_compute input)."""
    from ..expr.lower_torch import DVal, storage_dtype
    t = sp.t
    if t is T.FLOAT8:     # rides the exchange as its IEEE bits (int64)
        return DVal(t=t, data=data_lane.contiguous().view(torch.float64),
                    valid=valid_lane)
    if t is T.FLOAT4:
        return DVal(t=t, data=data_lane, valid=valid_lane)
    return DVal(t=t, data=data_lane.to(storage_dtype(t)), valid=valid_lane)


def _a2a_lanes(lanes_sh: list, mesh: Mesh, axis: str) -> list:
    """all_to_all of each lane (and flatten): lanes_sh[s] is shard s's list
    of [peers, cap] blocks; returns each shard's list of received lanes."""
    nl = len(lanes_sh[0])
    moved = [[x.reshape(-1) for x in
              all_to_all([ls[k] for ls in lanes_sh], mesh, axis)]
             for k in range(nl)]
    return [[moved[k][s] for k in range(nl)] for s in range(mesh.ndev)]


def _make_exchange(mesh: Mesh, bucket_cap: int):
    """Row exchange factory shared by the join step and the distinct-dedup
    phase: route every row to the shard owning hash(keys) % ndev (or a
    caller-supplied part lane — the skew router overrides parts for
    heavy-key rows).

    1D mesh: one all_to_all.  2D mesh: stage 1 sends each row to its
    TARGET CHIP within the source host (all_to_all over "chips"); stage 2
    sends to the target host along the now-aligned chip column
    (all_to_all over "hosts").  Shard (h, c) ends up with exactly the rows
    whose part id is h*C + c.  The part lane RIDES stage 1 (recomputing it
    from key hashes would undo skew-routing overrides).

    exchange(lanes_sh, njk, valid_sh, part_sh=None) -> (lanes, valid, ovf)
    per shard."""
    axes = mesh.axis_names
    ndev = mesh.ndev

    def _part(lanes, njk, part):
        if part is None:
            part = _umod(_combine_hash(lanes[:njk]), ndev).to(torch.int32)
        return part

    def _exchange(lanes_sh, njk, valid_sh, part_sh=None):
        parts = part_sh if part_sh is not None else [None] * ndev
        if len(axes) == 1:
            def stage(s, lanes, valid, part):
                lb, vb, _, ovf = _partition_lanes(
                    tuple(lanes), lanes[0], valid, ndev, bucket_cap,
                    part=_part(lanes, njk, part))
                return list(lb) + [vb], ovf
            r = per_shard(mesh, stage, lanes_sh, valid_sh, parts)
            x = _a2a_lanes([t[0] for t in r], mesh, axes[0])
            return ([xs[:-1] for xs in x], [xs[-1] for xs in x],
                    [t[1] for t in r])
        H, C = mesh.dims
        cap1 = bucket_cap * H
        cap2 = max(2 * C * cap1 // max(H, 1), 64)

        def stage1(s, lanes, valid, part):
            part = _part(lanes, njk, part)
            lanes_p = tuple(lanes) + (part.to(torch.int64),)
            lb, vb, _, ovf1 = _partition_lanes(
                lanes_p, lanes[0], valid, C, cap1, part=part % C)
            return list(lb) + [vb], ovf1
        r1 = per_shard(mesh, stage1, lanes_sh, valid_sh, parts)
        mid = _a2a_lanes([t[0] for t in r1], mesh, axes[1])

        def stage2(s, m):
            lanes, part, vmid = m[:-2], m[-2], m[-1]
            lb2, vb2, _, ovf2 = _partition_lanes(
                tuple(lanes), lanes[0], vmid, H, cap2,
                part=torch.div(part, C, rounding_mode="floor")
                .to(torch.int32))
            return list(lb2) + [vb2], ovf2 | r1[s][1]
        r2 = per_shard(mesh, stage2, mid)
        x = _a2a_lanes([t[0] for t in r2], mesh, axes[0])
        return ([xs[:-1] for xs in x], [xs[-1] for xs in x],
                [t[1] for t in r2])
    return _exchange


def _count_build(mesh: Mesh) -> None:
    BUILD_COUNTS["exchange_flat" if len(mesh.axis_names) == 1
                 else "exchange_2stage"] += 1


def build_dist_join_agg_step(mesh: Mesh, sig: DistPlanSig,
                             axis: str = "dp",
                             bucket_cap: int = 4096,
                             nbuckets: int = 4096,
                             max_chain: int = 8,
                             G: int = 1024,
                             k_heavy: int = 0,
                             heavy_cap: int = 64,
                             distinct_idxs: tuple = (),
                             dedup_cap: int = 4096):
    """Distributed step over `mesh`.

    f(probe_jkeys..., probe_valid, probe_lanes..., probe_lane_valids...,
      build_jkeys..., build_valid, build_lanes..., build_lane_valids...
      [, heavy hash list])
      -> per shard (gkeys [G]..., gkey_valids..., gvalid [G], slots
         (per-agg dict of [G]), err [1], ovf [1][, distinct phases...])

    Each argument is a list of per-shard tensors (rows sharded on the
    leading axis); the heavy hash list is one tensor, replicated.  Value
    lanes are packed probe-side first in (group keys, then agg args)
    signature order, build-side likewise.  `probe_valid`/`build_valid`
    mark live rows (padding dead); per-lane valids carry SQL NULLs.
    """
    axes = mesh.axis_names
    ndev = mesh.ndev
    _count_build(mesh)
    pspecs = [sp for sp in sig.gkeys if sp.side == "probe"] + \
             [sp for ag in sig.aggs for sp in ag[0] if sp.side == "probe"]
    bspecs = [sp for sp in sig.gkeys if sp.side == "build"] + \
             [sp for ag in sig.aggs for sp in ag[0] if sp.side == "build"]
    npj, nbj = sig.n_probe_jkeys, sig.n_build_jkeys
    npr, nbr = len(pspecs), len(bspecs)
    _exchange = _make_exchange(mesh, bucket_cap)
    dexch = _make_exchange(mesh, dedup_cap)

    def step(*flat):
        it = iter(flat)

        def take(k):
            return [next(it) for _ in range(k)]

        pjk, (pvalid,), plv, plvv = take(npj), take(1), take(npr), take(npr)
        bjk, (bvalid,), blv, blvv = take(nbj), take(1), take(nbr), take(nbr)
        heavy = take(1)[0] if k_heavy else None
        shards = range(ndev)

        # ---- 0: skew routing.  Rows whose combined key hash is in the
        # replicated heavy list bypass hash partitioning: probe rows SPREAD
        # round-robin over all shards, matching build rows BROADCAST
        # (compact + all_gather) to every shard.  Exact under any
        # misclassification: both sides classify by the same hash and each
        # (probe, build) pair meets once, on the probe row's shard.
        def route(s):
            pv, bv = pvalid[s], bvalid[s]
            if not k_heavy:
                return None, None, bv, None
            hv = heavy.to(pv.device)
            ph = _combine_hash([k[s] for k in pjk])
            bh = _combine_hash([k[s] for k in bjk])
            ish_p = torch.zeros_like(pv)
            ish_b = torch.zeros_like(bv)
            for j in range(k_heavy):
                ish_p = ish_p | (ph == hv[j])
                ish_b = ish_b | (bh == hv[j])
            ish_p = ish_p & pv
            b_heavy = ish_b & bv
            spread = (torch.arange(pv.shape[0], dtype=torch.int32,
                                   device=pv.device) % ndev)
            ppart = torch.where(ish_p, spread,
                                _umod(ph, ndev).to(torch.int32))
            bpart = _umod(bh, ndev).to(torch.int32)
            return ppart, bpart, bv & ~ish_b, b_heavy
        rt = per_shard(mesh, lambda s: route(s))

        # ---- 1+2: partition by hash(join keys), exchange
        plan = [[x[s] for x in pjk + plv + plvv] for s in shards]
        blan = [[x[s] for x in bjk + blv + blvv] for s in shards]
        p_all, pva, povf = _exchange(plan, npj, pvalid,
                                     [t[0] for t in rt] if k_heavy else None)
        b_all, bva, bovf = _exchange(blan, nbj, [t[2] for t in rt],
                                     [t[1] for t in rt] if k_heavy else None)
        if k_heavy:
            def compact(s, lanes):
                hb_l, hb_v, _, hovf = _partition_lanes(
                    tuple(lanes), lanes[0], rt[s][3], 1, heavy_cap,
                    part=torch.zeros(lanes[0].shape[0], dtype=torch.int32,
                                     device=lanes[0].device))
                return [x.reshape(-1) for x in hb_l] + [hb_v.reshape(-1)], \
                    hovf
            hb = per_shard(mesh, compact, blan)
            gathered = []
            for k in range(len(hb[0][0])):
                y = [t[0][k] for t in hb]
                for ax in reversed(axes):          # chips first
                    y = all_gather(y, mesh, ax, tiled=True)
                gathered.append(y)
            b_all = [[torch.cat([a, gathered[k][s]])
                      for k, a in enumerate(b_all[s])] for s in shards]
            bva = [torch.cat([bva[s], gathered[-1][s]]) for s in shards]
            bovf = [bovf[s] | hb[s][1] for s in shards]

        # ---- 3+4: local join, group + partials --------------------------
        def local(s):
            pjk_l, plv_l = p_all[s][:npj], p_all[s][npj:]
            bjk_l, blv_l = b_all[s][:nbj], b_all[s][nbj:]
            matched, jidx, border, jovf = _local_hash_join_multi(
                pjk_l, pva[s], bjk_l, bva[s], nbuckets, max_chain)
            n, mc = matched.shape
            jvalid = matched.reshape(-1)

            def probe_expand(lane):
                return lane[:, None].expand(n, mc).reshape(-1)

            def build_gather(lane):
                return lane[border][jidx].reshape(-1)

            pi = bi = 0

            def joined_lane(sp: LaneSpec):
                nonlocal pi, bi
                if sp.side == "probe":
                    d = probe_expand(plv_l[pi])
                    v = probe_expand(plv_l[npr + pi]).to(torch.bool)
                    pi += 1
                else:
                    d = build_gather(blv_l[bi])
                    v = build_gather(blv_l[nbr + bi]).to(torch.bool)
                    bi += 1
                return d, v

            glanes, gvalids = [], []
            for sp in sig.gkeys:
                d, v = joined_lane(sp)
                glanes.append(d)
                gvalids.append(v)
            arg_lanes = [[joined_lane(sp) for sp in argspecs]
                         for argspecs, _k in sig.aggs]
            res = _partials_phase(sig, glanes, gvalids, arg_lanes, jvalid, G)
            ovf = povf[s] | bovf[s] | jovf | res[4]
            # the joined rows outlive this shard's phase only when a
            # DISTINCT phase reads them
            rows = (glanes, gvalids, arg_lanes, jvalid) \
                if distinct_idxs else None
            return res, ovf, rows
        loc = per_shard(mesh, lambda s: local(s))

        # distinct aggs over JOINED rows: one dedup exchange each, fed by
        # the join output lanes
        extra = _distinct_phases(mesh, sig, distinct_idxs, G, dexch,
                                 [t[2] for t in loc])
        outs = []
        for s in shards:
            (gk, gkv, gvalid, slots, _govf, err), ovf, _ = loc[s]
            ex = []
            for d in extra:
                gkB, gkvB, gvB, slotB, ovfB, errB = d[s]
                ex += [gkB, gkvB, gvB, slotB]
                err = err | errB
                ovf = ovf | ovfB
            outs.append(tuple([gk, gkv, gvalid, slots, err.reshape(1),
                               ovf.reshape(1)] + ex))
        return outs

    return step


def _partials_phase(sig: DistPlanSig, glanes, gvalids, arg_lanes, live,
                    G: int):
    """Per-shard grouping + partial-slot computation over row-aligned
    lanes: sort by group hash, segment boundaries by exact lane equality,
    ops/preagg._slot_compute per agg.  Shared by the shuffle-join step and
    the no-join (single-table data-parallel) step.

    Returns (gk_out, gkv_out, gvalid, slot_out, govf, err)."""
    from ..ops.preagg import _slot_compute
    from ..ops.sort import packed_argsort, _chunks_from_unsigned
    from ..expr.lower_torch import DVal
    dev = live.device
    nj = live.shape[0]
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    if sig.ungrouped:
        seg = torch.where(live, _i32(0, live), _i32(G, live))
        order2 = None
        govf = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        # NULL-safe encodings: zero the data lane of NULL keys and fold
        # the validity pattern into the hash so (0, NULL) != (0, 0)
        enc = [torch.where(gv, gl, torch.zeros_like(gl))
               for gl, gv in zip(glanes, gvalids)]
        vbits = sum(gv.to(torch.int64) << k for k, gv in enumerate(gvalids))
        gh = _combine_hash(enc + [vbits])
        gh = torch.where(live, gh & ((1 << 62) - 1),
                         torch.full_like(gh, 1 << 62))
        order2 = packed_argsort(_chunks_from_unsigned(gh, 63), nj).long()
        jvs = live[order2]
        lanes_s = [lane[order2] for lane in enc]
        gvs = [v[order2] for v in gvalids]
        same = torch.cat([false1, jvs[1:] & jvs[:-1]])
        for ls, vs in zip(lanes_s, gvs):
            same = same & torch.cat(
                [false1, (ls[1:] == ls[:-1]) & (vs[1:] == vs[:-1])])
        new_seg = jvs & ~same
        seg_sorted = (torch.cumsum(new_seg.to(torch.int32), 0) - 1) \
            .clamp(0, G - 1)
        ngroups = new_seg.to(torch.int32).sum()
        seg = torch.where(jvs, seg_sorted, _i32(G, live))
        govf = ngroups > G

    shim = _ErrShim(dev)
    row_idx = torch.arange(nj, dtype=torch.int64, device=dev)
    jv_sorted = live if order2 is None else live[order2]
    slot_out = []
    for (argspecs, kinds), lanes in zip(sig.aggs, arg_lanes):
        dvals = []
        li = 0
        while li < len(argspecs):
            sp = argspecs[li]
            d, v = lanes[li]
            if order2 is not None:
                d = d[order2]
                v = v[order2]
            if sp.t is T.NUMERIC and sp.role == "arg":
                # numeric arg = 3 wire lanes: mantissa, exponent, dscale
                de, _ = lanes[li + 1]
                dd, _ = lanes[li + 2]
                if order2 is not None:
                    de = de[order2]
                    dd = dd[order2]
                dvals.append(DVal(t=T.NUMERIC, data=d, valid=v,
                                  exp=de.to(torch.int32),
                                  dscale_lane=dd.to(torch.int32)))
                li += 3
            else:
                dvals.append(_arg_dval(sp, d, v))
                li += 1
        d_out = {}
        for kind in kinds:
            d_out.update(_slot_compute(kind, dvals, jv_sorted, seg, G,
                                       shim, row_idx))
        slot_out.append(d_out)

    # group key values at segment-first positions
    if sig.ungrouped:
        gk_out = tuple(torch.zeros(G, dtype=torch.int64, device=dev)
                       for _ in sig.gkeys)
        gkv_out = tuple(torch.zeros(G, dtype=torch.bool, device=dev)
                        for _ in sig.gkeys)
        gvalid = torch.zeros(G, dtype=torch.bool, device=dev)
        gvalid[0] = True
    else:
        pos = torch.where(new_seg, row_idx,
                          torch.full_like(row_idx, 1 << 62))
        first = segment_min(pos, seg_sorted, G).clamp(0, max(nj - 1, 0))
        gvalid = torch.arange(G, dtype=torch.int32, device=dev) < \
            torch.clamp(ngroups, max=G)
        gk_out = tuple(ls[first] for ls in lanes_s)
        gkv_out = tuple(vs[first] for vs in gvs)
    return gk_out, gkv_out, gvalid, tuple(slot_out), govf, shim.err


def _canon(ad, sp: LaneSpec):
    """PG-equality canonicalization of a distinct arg lane: -0.0 and +0.0
    are ONE value and every NaN payload is ONE value.  Float8 rides as
    IEEE-bit int64 (canonicalize the bits); float4 rides as an f32 lane —
    canonicalize to +0 / one quiet NaN so its BIT view is a faithful
    equality proxy."""
    if sp.t is T.FLOAT8:
        ad = torch.where(ad == -(1 << 63), torch.zeros_like(ad), ad)
        isnan = ((ad & _EXP_F64) == _EXP_F64) & ((ad & _MAN_F64) != 0)
        return torch.where(isnan, torch.full_like(ad, _QNAN_F64), ad)
    if sp.t is T.FLOAT4:
        ad = torch.where(ad == 0.0, torch.zeros_like(ad), ad)
        return torch.where(torch.isnan(ad), torch.full_like(ad, float("nan")),
                           ad)
    return ad


def _bitproxy(ad, sp: LaneSpec):
    """Integer view for hashing / sorting / equality: after
    canonicalization, bit equality == PG value equality."""
    if sp.t is T.FLOAT4:
        return ad.contiguous().view(torch.int32).to(torch.int64)
    return ad


def _proxies(lanes_, dspecs):
    """Equality-proxy lanes per spec.  A NUMERIC arg spans three wire lanes
    (mantissa, exponent, dscale): PG numeric equality is on the VALUE
    mant*10^exp and ignores display scale, so the proxy is the canonical
    (mant, exp) pair with trailing zeros stripped and dscale excluded."""
    out = []
    li = 0
    while li < len(dspecs):
        sp = dspecs[li]
        if sp.t is T.NUMERIC and sp.role == "arg":
            mant = lanes_[li]
            exp = lanes_[li + 1]
            for _ in range(18):       # |mant| < 10^18: bounded strip
                more = (mant != 0) & (mant % 10 == 0)
                mant = torch.where(
                    more, torch.div(mant, 10, rounding_mode="floor"), mant)
                exp = torch.where(more, exp + 1, exp)
            exp = torch.where(mant == 0, torch.zeros_like(exp), exp)
            out += [mant, exp]
            li += 3
        else:
            out.append(_bitproxy(lanes_[li], sp))
            li += 1
    return out


def _vbits(gvalids, like: torch.Tensor) -> torch.Tensor:
    if not gvalids:
        return torch.zeros(like.shape[0], dtype=torch.int64,
                           device=like.device)
    return sum(gv.to(torch.int64) << k for k, gv in enumerate(gvalids))


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort: the LAST key is primary; equal rows keep their order
    (stable LSD passes)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in keys:
        kk = k[perm]
        if kk.dtype == torch.bool:
            kk = kk.to(torch.int8)
        perm = perm[torch.argsort(kk, stable=True)]
    return perm


def _distinct_phases(mesh: Mesh, sig: DistPlanSig, distinct_idxs, G: int,
                     exchange, rows_sh) -> list:
    """agg(DISTINCT x) partials, one phase per listed agg: exchange the
    (group, arg) pairs by their combined hash so every distinct pair lands
    on exactly ONE shard, dedup there via a LEXICOGRAPHIC sort + adjacent
    equality (lex order makes equal rows provably adjacent), and run the
    normal partial phase over the unique rows.  Per-shard partials of the
    same group then merge on the host with no double count.

    rows_sh[s] = (glanes, gvalids, arg_lanes, live) of shard s.  Returns
    one list per agg of per-shard (gkB, gkvB, gvB, slotB, ovfB, errB)."""
    ndev = mesh.ndev
    out = []
    for di in distinct_idxs:
        dspecs = sig.aggs[di][0]

        def pre(s, rows):
            glanes, gvalids, arg_lanes, live = rows
            dargs = arg_lanes[di]
            live_d = live
            for _ad, av in dargs:
                live_d = live_d & av           # strict agg: NULL args drop
            enc_g = [torch.where(gv, gl, torch.zeros_like(gl))
                     for gl, gv in zip(glanes, gvalids)]
            enc_a = [torch.where(av, _canon(ad, sp), torch.zeros_like(ad))
                     for (ad, av), sp in zip(dargs, dspecs)]
            h = _combine_hash(enc_g + _proxies(enc_a, dspecs)
                              + [_vbits(gvalids, live)])
            part = _umod(h, ndev).to(torch.int32)
            ship = list(enc_g) + list(gvalids) + list(enc_a)
            return ship, live_d, part
        pr = per_shard(mesh, pre, rows_sh)
        lx, vx, dovf = exchange([t[0] for t in pr], 1,
                                [t[1] for t in pr], [t[2] for t in pr])

        def post(s, lx_s, vx_s):
            ng = len(sig.gkeys)
            gl_x = lx_s[:ng]
            gv_x = [lane.to(torch.bool) for lane in lx_s[ng:2 * ng]]
            ad_x = lx_s[2 * ng:]
            vb_x = _vbits(gv_x, vx_s)
            adb_x = _proxies(ad_x, dspecs)
            order = _lexsort(list(adb_x) + [vb_x] + list(gl_x) + [~vx_s])
            vx_o = vx_s[order]
            gl_s = [lane[order] for lane in gl_x]
            gv_s = [v[order] for v in gv_x]
            ad_s = [a[order] for a in ad_x]
            false1 = torch.zeros(1, dtype=torch.bool, device=vx_s.device)
            prev_eq = torch.cat([false1, vx_o[1:] & vx_o[:-1]])
            for lane in gl_s + [b[order] for b in adb_x] + [vb_x[order]]:
                prev_eq = prev_eq & torch.cat([false1,
                                               lane[1:] == lane[:-1]])
            unique = vx_o & ~prev_eq
            sigB = DistPlanSig(n_probe_jkeys=0, n_build_jkeys=0,
                               gkeys=sig.gkeys, aggs=(sig.aggs[di],),
                               ungrouped=sig.ungrouped)
            argB = [[(a, torch.ones_like(unique)) for a in ad_s]]
            gkB, gkvB, gvB, slotB, govfB, errB = _partials_phase(
                sigB, gl_s, gv_s, argB, unique, G)
            return gkB, gkvB, gvB, slotB, dovf[s] | govfB, errB
        out.append(per_shard(mesh, post, lx, vx))
    return out


def build_dist_preagg_step(mesh: Mesh, sig: DistPlanSig, axis: str = "dp",
                           G: int = 1024, distinct_idxs: tuple = (),
                           dedup_cap: int = 4096):
    """Single-table data-parallel distributed aggregation: rows shard on
    the leading axis, each shard computes group partials for ITS rows (no
    collective — groups overlap across shards; the host merge folds
    duplicates).

    f(valid, lanes..., lane_valids...) -> per shard (gkeys...,
    gkey_valids..., gvalid, slots, err [1], ovf [1]), each argument a list
    of per-shard tensors.

    distinct_idxs: each listed agg's partials come from an EXTRA phase
    appended to the outputs (one dedup exchange per distinct agg; see
    _distinct_phases).  Output gains (gkB..., gkvB..., gvalidB, slotB) per
    listed agg."""
    specs = list(sig.gkeys) + [sp for ag in sig.aggs for sp in ag[0]]
    dexch = _make_exchange(mesh, dedup_cap)

    def step(valid, *flat):
        lanes_all = flat[:len(specs)]
        lvalids_all = flat[len(specs):]

        def local(s):
            v = valid[s]
            lanes = [x[s] for x in lanes_all]
            lvalids = [x[s] for x in lvalids_all]
            i = 0
            glanes, gvalids = [], []
            for _sp in sig.gkeys:
                glanes.append(lanes[i])
                gvalids.append(lvalids[i].to(torch.bool) & v)
                i += 1
            arg_lanes = []
            for argspecs, _k in sig.aggs:
                al = []
                for _sp in argspecs:
                    al.append((lanes[i], lvalids[i].to(torch.bool)))
                    i += 1
                arg_lanes.append(al)
            res = _partials_phase(sig, glanes, gvalids, arg_lanes, v, G)
            return res, (glanes, gvalids, arg_lanes, v)
        loc = per_shard(mesh, lambda s: local(s))
        extra = _distinct_phases(mesh, sig, distinct_idxs, G, dexch,
                                 [t[1] for t in loc])
        outs = []
        for s in range(mesh.ndev):
            gk, gkv, gvalid, slots, govf, err = loc[s][0]
            ex = []
            for d in extra:
                gkB, gkvB, gvB, slotB, ovfB, errB = d[s]
                ex += [gkB, gkvB, gvB, slotB]
                err = err | errB
                govf = govf | ovfB
            outs.append(tuple([gk, gkv, gvalid, slots, err.reshape(1),
                               govf.reshape(1)] + ex))
        return outs

    return step
