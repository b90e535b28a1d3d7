"""Fused hash-join -> grouped partial aggregation over one probe chunk.

The bulk-load analog as the reference writes it (pg_strom_tpu/ops/
joinagg.py): the probe chunk is device-resident, the hash table is
device-resident, and the probe, the projection gathers and the partial
aggregation (ops/preagg.build_preagg_fn: K2 for a grouped plan) run on
the device; only the G-slot partials come back.  The joined rows never
exist on the host.

Error/retry contracts compose:
  nout > out_cap   -> executor regrows and re-dispatches (DataStoreNoSpace)
  err lane nonzero -> host replays the probe chunk (CpuReCheck)
  bucket collision -> salt retry / sort-strategy fallback (preagg contract)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..expr.lower_torch import ColMeta, Lowerer, _live, pred_mask, err_max
from .hashjoin import build_probe_fn, build_probe_dense_fn
from .mxu_lookup import mxu_lookup
from .preagg import AggInstance, build_preagg_fn
from ..utils.perfmon import span


def build_join_preagg_fn(pschema: Sequence[ColMeta],
                         probe_keys: Sequence[Expr],
                         key_types: tuple,
                         nbuckets: int, max_chain: int, out_cap: int,
                         probe_pred: Optional[Expr],
                         jschema: Sequence[ColMeta],
                         probe_slots: Sequence[int],
                         build_slots: Sequence[tuple[int, int]],
                         group_exprs: Sequence[Expr],
                         aggs: Sequence[AggInstance],
                         G: int, strategy: str = "scatter",
                         dense: bool = False, dense_cap: int = 0,
                         dense_mxu: bool = False,
                         dense_row_bits: Optional[int] = None) -> Callable:
    """Build f(ht, pcols, bcols, nrows, salt) -> preagg dict + 'nout'.

    jschema describes the joined (projected) layout the group/agg exprs are
    bound to; each jschema slot is filled by gathering either a probe column
    (probe_slots[i] = probe layout index, or -1) or a build column
    (build_slots entries are (jslot, bcol_index)).

    dense=True (direct-address unique build, hashjoin.build_probe_dense_fn):
    joined lanes stay ROW-ALIGNED with the probe chunk — probe columns pass
    through untouched, build columns gather once at build_row (K3 finds it
    when dense_mxu), and the match mask feeds the aggregation as a
    synthetic bool filter column.  No pair materialization, no output
    capacity, no regrow."""
    probe_slots = list(probe_slots)
    build_map = dict(build_slots)

    if dense:
        dprobe_fn = build_probe_dense_fn(pschema, list(probe_keys),
                                         dense_cap, probe_pred,
                                         use_mxu=dense_mxu,
                                         row_bits=dense_row_bits)
        jschema_eff = list(jschema) + [ColMeta("__match__", T.BOOL)]
        match_pred = ColumnRef(type=T.BOOL, name="__match__",
                               index=len(jschema))
        pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs),
                                 match_pred, G, strategy)

        def f_dense(ht: dict, pcols: tuple, bcols: tuple, nrows, salt):
            with span("probe"):
                matched, build_row, nout, jerr = dprobe_fn(ht, pcols, nrows)
            with span("gather"):
                br = build_row.to(torch.int64)
                jcols = []
                for jslot in range(len(jschema)):
                    if probe_slots[jslot] >= 0:
                        g = list(pcols[probe_slots[jslot]])
                    else:
                        g = [p[br] for p in bcols[build_map[jslot]]]
                    g[1] = g[1] & matched
                    jcols.append(tuple(g))
                # the __match__ lane
                jcols.append((matched, torch.ones_like(matched)))
            out = pre_fn(tuple(jcols), nrows, salt)
            out["err"] = torch.maximum(out["err"], jerr)
            out["nout"] = torch.tensor(0, dtype=torch.int32)  # row-aligned
            return out

        return f_dense

    probe_fn = build_probe_fn(pschema, list(probe_keys), key_types, nbuckets,
                              max_chain, out_cap, probe_pred)
    # count(*)-only queries reference no columns; the preagg still needs a
    # lane to carry the joined-row mask, so inject a synthetic bool column
    jschema_eff = list(jschema) or [ColMeta("__rows__", T.BOOL)]
    pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs), None,
                             G, strategy)

    def f(ht: dict, pcols: tuple, bcols: tuple, nrows, salt):
        with span("probe"):
            probe_idx, build_row, nout, jerr = probe_fn(ht, pcols, nrows)
        with span("gather"):
            n = pcols[0][0].shape[0] if pcols else 0
            bs_max = bcols[0][0].shape[0] if bcols else 0
            nlive = int(torch.clamp(nout, max=out_cap))
            dev = probe_idx.device
            live_out = (torch.arange(out_cap, dtype=torch.int32, device=dev)
                        < nlive)
            pi = probe_idx.to(torch.int64).clamp(0, max(n - 1, 0))
            br = build_row.to(torch.int64).clamp(0, max(bs_max - 1, 0))
            jcols = []
            for jslot in range(len(jschema)):
                if probe_slots[jslot] >= 0:
                    planes, idx = pcols[probe_slots[jslot]], pi
                else:
                    planes, idx = bcols[build_map[jslot]], br
                g = [p[idx] for p in planes]
                g[1] = g[1] & live_out          # validity plane
                jcols.append(tuple(g))
            if not jcols:                        # synthetic row-mask lane
                jcols.append((live_out, live_out))
        out = pre_fn(tuple(jcols), nlive, salt)
        out["err"] = torch.maximum(out["err"], jerr)
        out["nout"] = nout
        return out

    return f


def build_join_preagg_pregrouped_fn(
        pschema: Sequence[ColMeta], probe_keys: Sequence[Expr],
        dense_cap: int, probe_pred: Optional[Expr],
        jschema: Sequence[ColMeta], probe_slots: Sequence[int],
        aggs: Sequence[AggInstance], G: int, seg_K: int,
        strategy: str = "mxu") -> Callable:
    """Star-schema fused join->aggregate with PRE-ASSIGNED group ids.

    When every GROUP BY expression reads only build-side (dimension) columns
    and every aggregate reads only probe-side (fact) columns, the executor
    enumerates the distinct group-key tuples over the small build side ONCE
    (host, exact) and builds a slot -> group-id lookup table
    (`ht['seg_M']`, sentinel G for empty slots).  The per-chunk work is
    then ONE K3 lookup (probe key -> group id) feeding the grouped preagg —
    no build-row gather, no build-column gathers, no salt ladder.

    f(ht, pcols, nrows, salt) -> preagg dict (+'nout'=0); group keys in the
    output are the int seg ids, which the executor maps back to the
    enumerated display tuples."""
    probe_keys = list(probe_keys)
    probe_slots = list(probe_slots)
    jschema_eff = (list(jschema)
                   + [ColMeta("__seg__", T.INT4), ColMeta("__match__", T.BOOL)])
    seg_ref = ColumnRef(type=T.INT4, name="__seg__", index=len(jschema))
    match_pred = ColumnRef(type=T.BOOL, name="__match__",
                           index=len(jschema) + 1)
    pre_fn = build_preagg_fn(jschema_eff, [seg_ref], list(aggs), match_pred,
                             G, strategy)

    def f(ht: dict, pcols: tuple, nrows, salt):
        n = pcols[0][0].shape[0] if pcols else 0
        with span("probe"):
            with span("lower"):
                live = _live(pcols, nrows)
                lw = Lowerer(pschema, pcols, live)
                mask = pred_mask(lw, probe_pred, live)
                k = lw.lower(probe_keys[0], mask)
            off = k.data.to(torch.int64) - ht["kmin"]
            in_r = mask & k.valid & (off >= 0) & (off < dense_cap)
            slot = off.clamp(0, dense_cap - 1).to(torch.int32)
            seg = mxu_lookup(slot, ht["seg_M"], dense_cap, seg_K, n,
                             sentinel=G)
            matched = in_r & (seg < G)
            seg = torch.where(matched, seg, torch.zeros_like(seg))
        jcols = []
        for jslot in range(len(jschema)):
            g = list(pcols[probe_slots[jslot]])
            g[1] = g[1] & matched
            jcols.append(tuple(g))
        ones = torch.ones_like(matched)
        jcols.append((seg, ones))                  # __seg__ group lane
        jcols.append((matched, ones))              # __match__ filter lane
        out = pre_fn(tuple(jcols), nrows, salt)
        out["err"] = torch.maximum(out["err"], err_max(lw, live))
        out["nout"] = torch.tensor(0, dtype=torch.int32)
        return out

    return f
