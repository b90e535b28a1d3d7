"""N-way fused device join chain -> grouped partial aggregation.

The reference (pg_strom_tpu/ops/starjoin.py; gpuhashjoin's multi-rel path
merge, gpuhashjoin.c:789-835, and its probe recursion, :1184-1318): every
inner relation is probed ROW-ALIGNED with the fact chunk, so the joined
row set never materializes:

  * unique single-int-key inners ("dense"): one identity / K3 /
    direct-address probe per inner (ops/hashjoin.build_probe_dense_fn):
    a match mask and one build-row lane;
  * non-unique or multi-key inners ("multi"): the bounded-fanout probe
    (ops/hashjoin.build_probe_multi_fn) returns up to F build rows per
    probe row, still row-aligned.  The cartesian product of fanout
    indices across multi inners enumerates SLICES: slice s fixes one match
    choice per multi inner, its mask is the AND of all inner matches, and
    the grouped partial aggregation (ops/preagg.build_preagg_fn) runs once
    per slice over the same fact lanes.  Summing partial states over
    slices is exactly the fan-out join.

A probe row with more than F matches of an inner (or a bucket chain past
the bounded walk) raises `join_ovf`; the executor doubles F and re-runs
the chunk, and past its slice cap answers on the pairwise chain.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import torch

from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..expr.lower_torch import ColMeta
from .hashjoin import build_probe_dense_fn, build_probe_multi_fn
from ..utils.perfmon import span
from .preagg import AggInstance, build_preagg_fn


def build_star_join_preagg_fn(pschema: Sequence[ColMeta],
                              dim_specs: Sequence[dict],
                              probe_pred: Optional[Expr],
                              jschema: Sequence[ColMeta],
                              probe_slots: Sequence[int],
                              build_slot_map: dict,
                              group_exprs: Sequence[Expr],
                              aggs: Sequence[AggInstance],
                              G: int, strategy: str = "scatter") -> Callable:
    """f(hts tuple, pcols, bcols_list tuple, nrows, salt) -> outputs.

    dim_specs[i] (dense): {"mode": "dense", "probe_keys": [Expr],
      "dense_cap": int, "use_mxu": bool, "use_ident": bool, "row_bits": int}
    dim_specs[i] (multi): {"mode": "multi", "probe_keys": [Expr...],
      "key_types": tuple, "max_chain": int, "fanout": int}
    Either may carry "key_source": "probe" (keyed by the fact) or the
    index of an earlier dense dimension (a snowflake chain), with
    "src_schema" that dimension's schema.

    jschema slots fill from the probe chunk (probe_slots[j] >= 0) or from
    dimension d's column b (build_slot_map[j] = (d, b)) gathered at that
    dimension's matched row for the current slice.  Output: {"slices":
    tuple of per-slice preagg dicts, "join_ovf": bool tensor}; the
    executor absorbs each slice like a chunk and merges partial states."""
    probe_slots = list(probe_slots)
    dfns = []
    for i, d in enumerate(dim_specs):
        src = d.get("key_source", "probe")
        schema_i = pschema if src == "probe" else d["src_schema"]
        pred_i = probe_pred if (i == 0 and src == "probe") else None
        if d.get("mode", "dense") == "multi":
            dfns.append(("multi", src, build_probe_multi_fn(
                schema_i, list(d["probe_keys"]), tuple(d["key_types"]),
                d["max_chain"], d["fanout"], pred_i)))
        else:
            dfns.append(("dense", src, build_probe_dense_fn(
                schema_i, list(d["probe_keys"]), d["dense_cap"], pred_i,
                use_mxu=d["use_mxu"], row_bits=d["row_bits"],
                use_ident=d.get("use_ident", False))))
    jschema_eff = list(jschema) + [ColMeta("__match__", T.BOOL)]
    match_pred = ColumnRef(type=T.BOOL, name="__match__", index=len(jschema))
    pre_fn = build_preagg_fn(jschema_eff, list(group_exprs), list(aggs),
                             match_pred, G, strategy)
    fan_ranges = [range(d["fanout"]) if d.get("mode") == "multi" else (0,)
                  for d in dim_specs]

    def f(hts: tuple, pcols: tuple, bcols_list: tuple, nrows, salt):
        dev = pcols[0][0].device
        jerr = torch.tensor(0, dtype=torch.uint8, device=dev)
        ovf = torch.tensor(False, device=dev)
        dim_res = []
        with span("probe"):
            for (mode, src, dfn), ht in zip(dfns, hts):
                if src == "probe":
                    cols_in = pcols
                else:
                    # snowflake: probe with the PARENT dimension's columns
                    # gathered at its matched rows (row-aligned with the fact;
                    # values on parent-unmatched rows are killed by the AND
                    # over all dims' masks below).  The parent is dense, so
                    # its match is slice-independent.
                    pbr = dim_res[src][2].to(torch.int64)
                    cols_in = tuple(tuple(pl[pbr] for pl in colp)
                                    for colp in bcols_list[src])
                if mode == "dense":
                    m, br, _, e = dfn(ht, cols_in, nrows)
                    if src != "probe":
                        m = m & dim_res[src][1]
                    dim_res.append(("dense", m, br))
                else:
                    brs, cnt, o, e = dfn(ht, cols_in, nrows)
                    if src != "probe":
                        cnt = torch.where(dim_res[src][1], cnt,
                                          torch.zeros_like(cnt))
                    dim_res.append(("multi", brs, cnt))
                    ovf = ovf | o
                jerr = torch.maximum(jerr, e)

        outs = []
        for combo in itertools.product(*fan_ranges):
            matched = None
            brs_eff = []
            for res, fx in zip(dim_res, combo):
                if res[0] == "dense":
                    m, br = res[1], res[2]
                else:
                    m = res[2] > fx
                    br = res[1][fx]
                matched = m if matched is None else (matched & m)
                brs_eff.append(br.to(torch.int64))
            with span("gather"):
                jcols = []
                for jslot in range(len(jschema)):
                    if probe_slots[jslot] >= 0:
                        g = list(pcols[probe_slots[jslot]])
                    else:
                        di, bci = build_slot_map[jslot]
                        bcol = bcols_list[di][bci]
                        # a multi probe's "no match" row id is the table's
                        # capacity: clamp the gather, the mask kills the row
                        idx = brs_eff[di].clamp(0, bcol[0].shape[0] - 1)
                        g = [p[idx] for p in bcol]
                    g[1] = g[1] & matched
                    jcols.append(tuple(g))
                jcols.append((matched, torch.ones_like(matched)))  # __match__
            out = pre_fn(tuple(jcols), nrows, salt)
            out["err"] = torch.maximum(out["err"], jerr)
            out["nout"] = torch.tensor(0, dtype=torch.int32)  # row-aligned
            outs.append(out)
        return {"slices": tuple(outs), "join_ovf": ovf}

    return f
