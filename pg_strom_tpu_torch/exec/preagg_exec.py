"""Streaming pre-aggregation executor.

The end-to-end GpuPreAgg pipeline (reference call stack §3.5): stream
device-resident chunks, launch the partial-aggregation kernel per chunk,
read every result back in one transfer, merge partials on the host and
finalize exactly.  Chunks whose sums leave the exact window (the float4
|v| shadow guard) or carry unrepresentable rows are replayed host-exactly
(the CpuReCheck tier).

Port status: a grouped shape with a v2 plan (ops/preagg_fused2.
derive_v2_plan: one dense 32-bit key, plain-column count/sum/avg/stddev
arguments, a kernel-safe predicate) runs the CUDA kernel K1.  Every other
shape the reference would offload runs the host-exact tier here and bumps
the perfmon counter `unported_host_exact`, so it shows in EXPLAIN ANALYZE
and never passes for a device run (ROADMAP queue 1: "Pre-aggregation XLA
strategies").  The reference's i64 split planes and AOT shape arguments
exist only for Mosaic and XLA and have no counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..config import config
from ..datastore import Table, Chunk
from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef
from ..expr.catalog import device_expression_supported
from ..expr.lower_torch import ColMeta, schema_from_chunk_columns
from ..ops.preagg import (
    AggInstance, build_preagg_fn, extract_partials, merge_partials,
)
from ..ops.preagg_mxu import mxu_dense_supported, mxu_absorb
from .devcache import (TCACHE, CachedChunk, chunk_capacity, device,
                       fetch_host)
from .hostexec import replay_chunk_preagg, canon_group_key, new_state
from ..utils.perfmon import Perfmon
from ..utils.devprog import tiered_capacity

def _device_supported(pred, group_exprs, aggs) -> bool:
    for e in ([] if pred is None else [pred]) + list(group_exprs):
        if not device_expression_supported(e):
            return False
    for inst in aggs:
        if inst.distinct:
            return False      # agg(DISTINCT x) runs on the host-exact tier
        for a in inst.args:
            if not device_expression_supported(a):
                return False
            # numeric agg args must be plain columns so the display-scale
            # lane is available; computed numerics go host-exact
            if a.type is T.NUMERIC and not isinstance(a, ColumnRef):
                return False
            # text agg args aggregate dict codes: plain columns only (a
            # computed text expr has no single dictionary to decode)
            if a.type in (T.TEXT, T.BPCHAR) and not isinstance(a, ColumnRef):
                return False
    return True


class PreAggExecutor:
    """Aggregate `table` with optional filter and GROUP BY.

    pred / group_exprs / agg args are exprs bound to table.column_names."""

    def __init__(self, table: Table, pred: Optional[Expr],
                 group_exprs: Sequence[Expr], aggs: Sequence[AggInstance],
                 perfmon: Perfmon | None = None, offload: bool = True):
        self.table = table
        self.pred = pred
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.layout_names = table.column_names
        self.perfmon = perfmon or Perfmon()
        # cost-model verdict (plan/cost.py cost_tpupreagg vs cost_hostagg;
        # debug_force_tpupreagg overrides it upstream)
        self.offload = offload
        self._v2 = None

    def run(self) -> list[tuple]:
        """Returns rows: (key_values..., agg_values...) in no defined order."""
        states, displays = self.run_states()
        return finalize_agg_states(self.group_exprs, self.aggs, states,
                                   displays)

    def run_states(self) -> tuple[dict, dict]:
        """Pre-finalize accumulators: states[canon_key] = per-agg state
        dicts, displays[canon_key] = first-seen key values (GROUPING SETS
        roll coarser sets up from one finest-grain pass)."""
        states: dict[tuple, list[dict]] = {}
        displays: dict[tuple, tuple] = {}
        use_device = (config.enabled and config.enable_tpupreagg
                      and self.offload
                      and _device_supported(self.pred, self.group_exprs,
                                            self.aggs))
        pm = self.perfmon
        if self.table.nrows == 0:
            return states, displays
        if use_device:
            self._v2 = self._derive_v2()
        if self._v2 is None:
            for chunk in self.table.chunks():
                if use_device:
                    # the reference offloads this shape; its strategy is not
                    # ported yet, so the host-exact tier answers — visibly
                    pm.bump("unported_host_exact")
                with pm.timer("cpu_fallback"):
                    self._replay(chunk, states, displays)
            return states, displays

        plan = self._v2
        cap = tiered_capacity(chunk_capacity(self.table.nrows), device(),
                              pm=pm)
        fn = build_preagg_fn(self._schema, self.group_exprs, self.aggs,
                             self._kpred, plan.G, "mxu_dense",
                             v2sig=plan.sig)
        scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
                "f4e": plan.f4e}
        key_metas = self._key_metas()
        # launch every chunk, then read all results back in one transfer
        pending: list = []
        for cc in TCACHE.chunks_for(self.table, self.layout_names, cap, pm):
            if cc.recheck_any:
                with pm.timer("cpu_fallback"):
                    self._replay(cc.host_chunk(self.table), states, displays)
                continue
            with pm.timer("dispatch"):
                out = pm.device_call("tpupreagg", fn, cc.planes, cc.nrows,
                                     0, scal)
            pending.append((cc, out))
        if pending:
            with pm.timer("device_wait"):
                outs_host = fetch_host([o for _, o in pending])
            for (cc, _), oh in zip(pending, outs_host):
                self._consume(cc, oh, states, displays, key_metas)
        return states, displays

    # ------------------------------------------------------------------

    def _derive_v2(self):
        """The v2 plan of this query, or None (host-exact tier)."""
        if not (config.use_fused_preagg and config.use_fused_preagg2
                and mxu_dense_supported([g.type for g in self.group_exprs])):
            return None
        from ..ops.preagg_fused2 import (
            derive_v2_plan, narrow_exact_casts, pred_stack_depth,
            MAX_PRED_DEPTH)
        self._schema = schema_from_chunk_columns(
            self.layout_names,
            [self.table.columns[nm] for nm in self.layout_names])
        # the kernel's predicate; host replay keeps evaluating self.pred
        self._kpred = narrow_exact_casts(self.pred)
        plan = derive_v2_plan(
            [self.table.columns[nm] for nm in self.layout_names],
            self._schema, self.group_exprs, self.aggs, self._kpred,
            max_g=config.max_groups_cap)
        if plan is not None and \
                pred_stack_depth(plan.sig, self._kpred) > MAX_PRED_DEPTH:
            return None
        return plan

    def _key_metas(self) -> list[ColMeta | None]:
        metas = []
        for g in self.group_exprs:
            m = None
            if isinstance(g, ColumnRef) and g.type in (T.TEXT, T.BPCHAR):
                c = self.table.columns.get(g.name)
                if c is not None:
                    m = ColMeta(name=g.name, type=g.type,
                                dictionary=tuple(c.dictionary or ()),
                                dict_id=id(c.dictionary))
            metas.append(m)
        return metas

    def _replay(self, chunk: Chunk, states, displays) -> None:
        replay_chunk_preagg(chunk, self.layout_names, self.pred,
                            self.group_exprs, self.aggs, states, displays)

    def _consume(self, cc: CachedChunk, out, states, displays,
                 key_metas) -> None:
        """Absorb one chunk's kernel output; a chunk outside the exact
        window (overflow) replays on the host."""
        pm = self.perfmon
        with pm.timer("materialize"):
            _, overflow = mxu_absorb(
                out, self.group_exprs, self.aggs, key_metas, states,
                displays, merge_partials,
                extract_with_dicts(self.aggs,
                                   agg_text_dicts(self.aggs,
                                                  self.table.columns.get)),
                canon_group_key, dense_key=True, recipes=self._v2.recipes)
        if not overflow:
            pm.bump("device_chunks")
            return
        pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            self._replay(cc.host_chunk(self.table), states, displays)


def agg_text_dicts(aggs, resolve) -> list[tuple | None] | None:
    """Per-agg sorted dictionary for min/max over a TEXT/BPCHAR column
    (the device aggregates dict codes; extraction decodes them so device
    partials merge with host-replay partials).  None when no agg needs
    decoding."""
    out: list[tuple | None] = []
    any_ = False
    for inst in aggs:
        d = None
        if inst.aggname in ("min", "max") and inst.args and \
                inst.args[0].type in (T.TEXT, T.BPCHAR) and \
                isinstance(inst.args[0], ColumnRef):
            c = resolve(inst.args[0].name)
            if c is not None and c.dictionary is not None:
                d = tuple(c.dictionary)
                any_ = True
        out.append(d)
    return out if any_ else None


def extract_with_dicts(aggs, agg_dicts):
    """extract_partials bound to per-instance text dictionaries."""
    if not agg_dicts:
        return extract_partials
    by_id = {id(i): d for i, d in zip(aggs, agg_dicts)}

    def ex(inst, arrays, g, skip=()):
        return extract_partials(inst, arrays, g, skip,
                                text_dict=by_id.get(id(inst)))
    return ex


def finalize_agg_states(group_exprs, aggs, states, displays) -> list[tuple]:
    # ungrouped aggregate over zero rows still yields one all-NULL row
    if not group_exprs and not states:
        states[()] = [new_state(inst) for inst in aggs]
        displays[()] = ()
    from ..ops.preagg import AGG_CATALOG
    rows = []
    for ck, st in states.items():
        kvals = displays[ck]
        avals = tuple(AGG_CATALOG[(inst.aggname, inst.family)].final(s)
                      for inst, s in zip(aggs, st))
        rows.append(kvals + avals)
    return rows
