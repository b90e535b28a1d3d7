"""Streaming pre-aggregation executor.

The end-to-end GpuPreAgg pipeline (reference call stack §3.5): stream
device-resident chunks, launch the partial-aggregation program per chunk,
read the results back in one transfer, merge partials on the host and
finalize exactly.  Chunks the device flags (err != 0), or whose sums leave
the exact window, are replayed host-exactly (the CpuReCheck tier).

The reference's executor (pg_strom_tpu/exec/preagg_exec.py), minus what
exists only for XLA (the jit cache, the i64 split planes, the AOT shape
arguments and the compile tiering):

* strategy choice — the v2 raw-plane kernel K1 when the shape fits its
  statistics-driven envelope, else `mxu_dense` (one int-lane key), `mxu`
  (narrow key types, K2), `scatter`, or the ungrouped reductions;
* the bucket count G from the cross-query memos `_GROUP_STATS`,
  `_DENSE_FAILED` and `_LADDER_MEMO`;
* the per-chunk retry ladder in `_consume`: dense_fail re-dispatch, a new
  salt, 4x G escalation, the exact sort strategy, then host replay; the
  perfmon counters `dense_fallbacks`, `salt_retries`, `sort_fallbacks`,
  `device_chunks` and `recheck_chunks` count each rung.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import config
from ..datastore import Table, Chunk
from ..sqltypes import T, numeric_to_decimal
from ..expr.ir import Expr, ColumnRef, referenced_columns
from ..expr.catalog import device_expression_supported
from ..expr.lower_torch import ColMeta, schema_from_chunk_columns
from ..ops.preagg import (
    AggInstance, build_preagg_fn, extract_partials, merge_partials,
)
from ..ops.preagg_mxu import (mxu_keys_supported, mxu_dense_supported,
                              mxu_absorb)
from .devcache import CachedChunk, chunk_capacity, device, fetch_host, \
    launch_chunks
from .hostexec import replay_chunk_preagg, canon_group_key, new_state
from ..utils.perfmon import Perfmon, spanned
from ..utils.devprog import tiered_capacity

# Cross-query group-count memo: (key column uids, group expr reprs) ->
# (observed number of groups, observed dense key range | None).  Column
# sums cost scales with the bucket count G, so repeated GROUP BYs over
# unchanged data start at a right-sized G instead of
# config.max_groups_device; column uids pin the data version.  The
# salt/escalation ladder (and dense_fail re-dispatch) keeps correctness if
# the memo underestimates.
_GROUP_STATS: dict[tuple, tuple] = {}
_GROUP_STATS_CAP = 4096
# GROUP BYs whose key RANGE exceeded the dense window (sparse keys): skip
# the mxu_dense attempt on later queries instead of re-dispatching per chunk
_DENSE_FAILED: set[tuple] = set()

# winning retry-ladder rung per plan (strategy, G, salt): a collision-prone
# key set otherwise re-runs the salted-bucket ladder on every execution
_LADDER_MEMO: dict[tuple, tuple] = {}
_LADDER_MEMO_CAP = 4096


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


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


def _key_value_from_planes(t: T, planes, g: int, meta: ColMeta | None):
    data, valid = planes[0], planes[1]
    if not bool(valid[g]):
        return None
    if t is T.NUMERIC:
        return numeric_to_decimal(int(data[g]), int(planes[2][g]),
                                  int(planes[3][g]))
    if t in (T.TEXT, T.BPCHAR):
        return meta.dictionary[int(data[g])] if meta and meta.dictionary else None
    if t in (T.FLOAT4, T.FLOAT8):
        return float(data[g])
    if t is T.BOOL:
        return bool(data[g])
    return int(data[g])


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
        self._gskey: tuple | None = None
        self._v2 = None
        self._obs_rng: int | None = None
        self._memo_key = None
        self._memo_used = False
        self._agg_dicts = None

    def run(self) -> list[tuple]:
        """Returns rows: (key_values..., agg_values...) in no defined order."""
        states, displays = self.run_states()
        return self._finalize(states, displays)

    def run_states(self) -> tuple[dict, dict]:
        """Pre-finalize accumulators: states[canon_key] = per-agg state
        dicts, displays[canon_key] = first-seen key values (GROUPING SETS
        roll coarser sets up from one finest-grain device pass)."""
        states: dict[tuple, list[dict]] = {}
        displays: dict[tuple, tuple] = {}
        use_device = (config.enabled and config.enable_tpupreagg
                      and self.offload
                      and _device_supported(self.pred, self.group_exprs,
                                            self.aggs))
        pm = self.perfmon
        if self.table.nrows == 0:
            return states, displays
        if not use_device:
            for chunk in self.table.chunks():
                with pm.timer("cpu_fallback"):
                    self._replay(chunk, states, displays)
            return states, displays

        with pm.timer("prepare"):
            key_metas, cap, fn = self._prepare()

        def dispatch(cc):
            if self._v2 is not None:
                return pm.device_call("tpupreagg", fn, cc.planes, cc.nrows,
                                      0, self._v2_scal())
            return pm.device_call("tpupreagg", fn, cc.planes, cc.nrows,
                                  self._salt0)

        for cc, out in launch_chunks(self.table, self.layout_names, cap, pm,
                                     dispatch):
            self._consume(cc, out, states, displays, key_metas)
        return states, displays

    def _prepare(self):
        """Everything before the first launch: strategy, G, the chunk
        capacity and the device function; (key metas, capacity, fn)."""
        pm = self.perfmon
        self._gskey = self._gstats_key()
        key_metas = self._key_metas()
        self._agg_dicts = agg_text_dicts(self.aggs, self.table.columns.get)
        kts = [g.type for g in self.group_exprs]
        # dense-key column sums (one int-lane key): the bucket index IS the
        # key, no key-recovery columns, no collisions; chunks whose key
        # range exceeds G-2 re-dispatch the generic 'mxu'
        self._strategy = ("mxu_dense" if mxu_dense_supported(kts)
                          and self._gskey not in _DENSE_FAILED
                          else "mxu" if mxu_keys_supported(kts)
                          else "scatter")
        G = config.max_groups_device
        # K2 (and its plain version on the CPU) makes small G cheap; the
        # reference keeps a 128 floor only when its fused kernel is off
        floor = 8 if config.use_fused_preagg else 128
        if self._gskey is not None:
            st = _GROUP_STATS.get(self._gskey)
            if st is not None:
                obs, rng_obs = st
                if self._strategy == "mxu_dense" and rng_obs is not None:
                    # dense buckets need exactly range+2 slots (NULL group
                    # at rng+1); dense_fail re-dispatches on data drift
                    G = min(max(floor, _pow2_at_least(rng_obs + 2)),
                            config.max_groups_device)
                else:
                    # 2x headroom over the observed count for hash buckets
                    G = min(max(floor, _pow2_at_least(2 * max(obs, 1))),
                            config.max_groups_device)
        # start at the remembered winning rung for this plan; the memo key
        # includes the predicate (group stats under another filter can
        # describe another group population)
        self._salt0 = 0
        self._memo_key = ((self._gskey, repr(self.pred))
                          if self._gskey is not None else None)
        memo = (_LADDER_MEMO.get(self._memo_key)
                if self._memo_key is not None else None)
        self._memo_used = memo is not None
        if memo is not None:
            self._strategy, G, self._salt0 = memo
            if self._strategy == "sort":
                # the final ladder rung ran at max_groups_cap; right-size
                # from the observed group count (ngroups > G raises
                # CPU_RECHECK, so an undersized clamp degrades exactly)
                st = _GROUP_STATS.get(self._gskey)
                if st is not None:
                    G = min(G, max(128, _pow2_at_least(2 * max(st[0], 1))))
        self._schema = schema_from_chunk_columns(
            self.layout_names,
            [self.table.columns[nm] for nm in self.layout_names])
        # v2 raw-plane kernel K1 (ops/preagg_fused2.py): dense single-key
        # plans whose shape fits the stats-driven envelope skip the lowering
        # and encode entirely
        self._v2 = None
        if (self._strategy == "mxu_dense" and config.use_fused_preagg
                and config.use_fused_preagg2):
            self._v2 = self._derive_v2()
            if self._v2 is not None:
                G = self._v2.G
        self._G = G
        cap = tiered_capacity(chunk_capacity(self.table.nrows), device(),
                              pm=pm)
        self._cap = cap
        fn = self._fn(G, self._strategy)
        return key_metas, cap, fn

    # ------------------------------------------------------------------

    def _fn(self, G: int, strategy: str, v2: bool = True):
        if v2 and self._v2 is not None:
            return build_preagg_fn(self._schema, self.group_exprs, self.aggs,
                                   self._kpred, G, strategy,
                                   v2sig=self._v2.sig)
        return build_preagg_fn(self._schema, self.group_exprs, self.aggs,
                               self.pred, G, strategy)

    def _derive_v2(self):
        """The v2 plan of this query, or None."""
        from ..ops.preagg_fused2 import (
            derive_v2_plan, narrow_exact_casts, pred_stack_depth,
            MAX_PRED_DEPTH)
        # the kernel's predicate; every other path evaluates self.pred
        self._kpred = narrow_exact_casts(self.pred)
        plan = derive_v2_plan(
            [self.table.columns[nm] for nm in self.layout_names],
            self._schema, self.group_exprs, self.aggs, self._kpred,
            max_g=config.max_groups_cap)
        if plan is not None and \
                pred_stack_depth(plan.sig, self._kpred) > MAX_PRED_DEPTH:
            return None
        return plan

    def _v2_scal(self) -> dict:
        """Runtime scalars of the v2 kernel (int64 columns are read raw:
        the reference's u32 split planes have no counterpart)."""
        p = self._v2
        return {"i": p.scal_i, "u": p.scal_u, "f4sc": p.f4sc, "f4e": p.f4e}

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
        """Retry ladder per chunk: salted buckets at G, 4x G escalation,
        the exact sort strategy, then host replay (at once: out None)."""
        pm = self.perfmon
        if out is None:
            with pm.timer("cpu_fallback"):
                self._replay(cc.host_chunk(self.table), states, displays)
            return
        # (G, salt) ladder: re-salt once, escalate bucket count (column-sum
        # cost scales with G, so start small), then sort-exact
        ladder = [(self._G, 0x9E3779B97F4A7C15)]
        G2 = min(4 * self._G, config.max_groups_cap)
        if G2 > self._G:
            ladder += [(G2, 0), (G2, 0xC2B2AE3D27D4EB4F)]
        attempt = 0
        overflow = False
        cur_strategy = self._strategy
        cur_g, cur_salt = self._G, int(self._salt0)

        def remember():
            if attempt > 0 and self._memo_key is not None:
                if len(_LADDER_MEMO) >= _LADDER_MEMO_CAP:
                    _LADDER_MEMO.clear()
                _LADDER_MEMO[self._memo_key] = (cur_strategy, cur_g,
                                                cur_salt)

        def rerun(G: int, strategy: str, salt: int):
            # the v2 plan is bound to mxu_dense at its own G; every later
            # rung lowers the expression tree
            return fetch_host(self._fn(G, strategy, v2=False)(
                cc.planes, cc.nrows, salt))

        while True:
            err = int(out["err"])
            if err != 0 or overflow:
                break                                 # -> host replay
            if "mxu_sums" in out:
                dense_fail = bool(np.asarray(out.get("dense_fail", False)))
                if "dense_rng" in out and not dense_fail:
                    r = int(np.asarray(out["dense_rng"]))
                    self._obs_rng = max(self._obs_rng or 0, r)
                if dense_fail:
                    # key range exceeded the dense window: one-time
                    # re-dispatch with the generic mxu strategy
                    pm.bump("dense_fallbacks")
                    if self._gskey is not None:
                        _DENSE_FAILED.add(self._gskey)
                    cur_strategy = "mxu"
                    out = rerun(self._G, "mxu", 0)
                    continue
                collided, overflow = mxu_absorb(
                    out, self.group_exprs, self.aggs, key_metas, states,
                    displays, merge_partials,
                    extract_with_dicts(self.aggs, self._agg_dicts),
                    canon_group_key, dense_key=cur_strategy == "mxu_dense",
                    recipes=(self._v2.recipes
                             if self._v2 is not None
                             and cur_strategy == "mxu_dense"
                             and attempt == 0 else None))
                if overflow:
                    continue
                if not collided:
                    pm.bump("device_chunks")
                    remember()
                    return
            else:
                collided = (bool(np.asarray(out.get("collision", False)))
                            if self.group_exprs else False)
                if not collided:
                    absorb_preagg_out(out, self.group_exprs, self.aggs,
                                      key_metas, states, displays, pm,
                                      self._agg_dicts)
                    remember()
                    return
            if attempt < len(ladder):
                pm.bump("salt_retries")
                g, salt = ladder[attempt]
                cur_g, cur_salt = g, salt
                out = rerun(g, cur_strategy, salt)
            elif attempt == len(ladder):
                # distinct keys genuinely share every salted bucket (or
                # more groups than buckets): sort is exact for any key
                # distribution up to max_groups_cap groups
                pm.bump("sort_fallbacks")
                cur_strategy = "sort"
                cur_g, cur_salt = config.max_groups_cap, 0
                out = rerun(config.max_groups_cap, "sort", 0)
            else:
                break
            attempt += 1
        pm.bump("recheck_chunks")
        if self._memo_used and self._memo_key is not None:
            # a remembered rung that ends in host replay is stale (data or
            # stats drift): drop it so the next run retries the full ladder
            _LADDER_MEMO.pop(self._memo_key, None)
        with pm.timer("cpu_fallback"):
            self._replay(cc.host_chunk(self.table), states, displays)

    def _gstats_key(self) -> tuple | None:
        if not self.group_exprs:
            return None
        uids = []
        for g in self.group_exprs:
            for nm in referenced_columns(g):
                c = self.table.columns.get(nm)
                if c is None:
                    return None
                uids.append(c.uid)
        return (tuple(uids), tuple(repr(g) for g in self.group_exprs))

    def _finalize(self, states, displays) -> list[tuple]:
        if self._gskey is not None:
            if len(_GROUP_STATS) >= _GROUP_STATS_CAP:
                _GROUP_STATS.pop(next(iter(_GROUP_STATS)))
            _GROUP_STATS[self._gskey] = (len(states), self._obs_rng)
        return finalize_agg_states(self.group_exprs, self.aggs, states,
                                   displays)


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


@spanned("absorb")
def absorb_preagg_out(out, group_exprs, aggs, key_metas, states, displays,
                      pm, agg_dicts: list | None = None,
                      whole_chunk: bool = True) -> None:
    """Merge one fetched preagg output (scatter / sort / ungrouped) into
    the host (states, displays) accumulators.  `whole_chunk`: the output
    answers its chunk, which counts as a device chunk (a star join's
    slice is a part of one; its executor counts the chunk)."""
    with pm.timer("materialize"):
        gmask = np.asarray(out["gmask"])
        keys = [tuple(np.asarray(p) for p in kp) for kp in out["keys"]]
        slots = [{k: np.asarray(v) for k, v in d.items()}
                 for d in out["slots"]]
    if whole_chunk:
        pm.bump("device_chunks")
    pm.add_bytes("d2h", sum(a.nbytes for d in slots for a in d.values()))
    groups = np.flatnonzero(gmask) if group_exprs else np.array([0])
    for g in groups:
        g = int(g)
        kvals = tuple(
            _key_value_from_planes(ge.type, kp, g, meta)
            for ge, kp, meta in zip(group_exprs, keys, key_metas))
        ck = tuple(canon_group_key(v) for v in kvals)
        parts = [extract_partials(
                     inst, d, g,
                     text_dict=agg_dicts[i] if agg_dicts else None)
                 for i, (inst, d) in enumerate(zip(aggs, slots))]
        if ck not in states:
            states[ck] = parts
            displays[ck] = kvals
        else:
            st = states[ck]
            states[ck] = [merge_partials(inst, a, b)
                          for inst, a, b in zip(aggs, st, parts)]


@spanned("finalize")
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
