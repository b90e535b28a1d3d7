"""Fused join->aggregate executor: joined rows never touch the host.

The execution-pipeline analog of the reference's bulk-load chain
(gpuscan_exec_multi -> gpuhashjoin -> gpupreagg via pgstrom_bulkslot,
pg_strom.h:317-329), as pg_strom_tpu/exec/joinagg_exec.py runs it: the
probe chunk is device-resident (tcache), the hash table is
device-resident, and one device pass per chunk probes, projects and
partially aggregates (ops/joinagg.py).  Only G-slot partials come back per
chunk.  Every degradation contract of the component executors is kept:
capacity regrow, dense_fail re-dispatch, salt retry, sort-strategy
fallback, and an exact host replay tier that joins + aggregates the
flagged chunk row-wise — with the reference's perfmon counters.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..datastore import Table, Chunk, column_stats
from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef, referenced_columns, bind_columns
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..expr.lower_torch import ColMeta, schema_from_chunk_columns
from ..ops.hashjoin import build_hash_table, dense_cap_for, \
    mxu_dense_window, _next_pow2
from ..ops.joinagg import build_join_preagg_fn, build_join_preagg_pregrouped_fn
from ..ops.joinagg_scalar import K5Batch, ScalarProgram, conjuncts, \
    member_table, range_clause, scalar_program, split_ranges
from ..ops.mxu_lookup import encode_table, lookup_digits
from ..ops.preagg import AggInstance, merge_partials
from ..ops.preagg_mxu import mxu_keys_supported, mxu_dense_supported, \
    mxu_absorb
from .devcache import TCACHE, chunk_capacity, device, fetch_host, \
    launch_chunks
from .hostexec import canon_group_key, new_state, update_state
from .preagg_exec import (absorb_preagg_out, finalize_agg_states,
                          agg_text_dicts, extract_with_dicts)
from ..utils.devprog import tiered_capacity
from ..utils.perfmon import Perfmon


class JoinPreAggExecutor:
    """SELECT <aggs> FROM probe JOIN build ON keys [WHERE preds] GROUP BY ...

    group_exprs / agg args are bound by run() to the *joined* layout
    (probe column names + build column names, pre-qualified by the planner);
    probe/build keys and side preds are bound to their side's layout."""

    def __init__(self, probe: Table, build: Table,
                 probe_keys: Sequence[Expr], build_keys: Sequence[Expr],
                 group_exprs: Sequence[Expr], aggs: Sequence[AggInstance],
                 probe_pred: Optional[Expr] = None,
                 build_pred: Optional[Expr] = None,
                 perfmon: Perfmon | None = None, offload: bool = True):
        self.probe = probe
        self.build = build
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.group_exprs = list(group_exprs)   # bound to joined names (no idx)
        self.aggs = list(aggs)
        self.probe_pred = probe_pred
        self.build_pred = build_pred
        self.perfmon = perfmon or Perfmon()
        # cost-model verdict (plan/cost.py): join AND agg must both win
        self.offload = offload
        self._host_ht_cache: dict | None = None

    # -- eligibility -----------------------------------------------------------

    def device_ok(self) -> bool:
        if any(inst.distinct for inst in self.aggs):
            return False      # agg(DISTINCT x): host-exact tier only
        exprs = (self.probe_keys + self.build_keys + self.group_exprs
                 + [a for inst in self.aggs for a in inst.args])
        if self.probe_pred is not None:
            exprs.append(self.probe_pred)
        if self.build_pred is not None:
            exprs.append(self.build_pred)
        if any(not device_expression_supported(e) for e in exprs):
            return False
        if any(k.type in (T.TEXT, T.BPCHAR)
               for k in self.probe_keys + self.build_keys):
            return False
        for inst in self.aggs:
            for a in inst.args:
                # numeric agg args need the display-scale plane: plain columns
                if a.type is T.NUMERIC and not isinstance(a, ColumnRef):
                    return False
                # text agg args aggregate dict codes: plain columns only
                if a.type in (T.TEXT, T.BPCHAR) \
                        and not isinstance(a, ColumnRef):
                    return False
        return (config.enabled and config.enable_tpuhashjoin
                and config.enable_tpupreagg and self.offload
                and self.build.nrows > 0
                and self.probe.nrows > 0)

    # -- run -------------------------------------------------------------------

    def run(self) -> list[tuple]:
        with self.perfmon.timer("prepare"):
            launch = self._planned() or self._prepare()
        return launch()

    def _prepare(self):
        """Everything before the first launch: the joined layout, the
        build side's hash table, the device function.  Returns the rest of
        the run, a call that takes no arguments."""
        states: dict[tuple, list[dict]] = {}
        displays: dict[tuple, tuple] = {}
        pm = self.perfmon
        dev = device()

        # ---- joined layout: referenced columns only -------------------------
        pnames = list(self.probe.column_names)
        bnames = list(self.build.column_names)
        refd: list[str] = []
        for e in self.group_exprs + [a for i_ in self.aggs for a in i_.args]:
            for c in referenced_columns(e):
                if c not in refd:
                    refd.append(c)
        jnames = [c for c in refd if c in self.probe.columns] + \
                 [c for c in refd if c not in self.probe.columns]
        jlayout = {c: i for i, c in enumerate(jnames)}
        jcols_src = [self.probe.columns.get(c) or self.build.columns[c]
                     for c in jnames]
        jschema = schema_from_chunk_columns(jnames, jcols_src)
        bound_groups = [bind_columns(g, jlayout) for g in self.group_exprs]
        bound_aggs = [
            AggInstance(aggname=i_.aggname, family=i_.family, slots=i_.slots,
                        args=tuple(bind_columns(a, jlayout) for a in i_.args))
            for i_ in self.aggs]
        self._agg_dicts_join = agg_text_dicts(
            bound_aggs,
            lambda n: self.probe.columns.get(n) or self.build.columns.get(n))
        host_args = (states, displays, jnames, bound_groups, bound_aggs)

        # ---- build side: device-resident hash table + planes ----------------
        bcols_all = [self.build.columns[n] for n in bnames]
        bcap = _next_pow2(max(self.build.nrows, 16))
        blayout = {n: i for i, n in enumerate(bnames)}
        bkeys = [bind_columns(k, blayout) for k in self.build_keys]
        bpred = bind_columns(self.build_pred, blayout) \
            if self.build_pred is not None else None
        row_bits = max(self.build.nrows, 1).bit_length()
        ht_key = ("join_ht", tuple(c.uid for c in bcols_all), str(dev),
                  tuple(bkeys), bpred, bcap, row_bits)
        ht = TCACHE.get_aux(ht_key, pm)
        bcc = None
        for c in TCACHE.chunks_for(self.build, bnames, bcap, pm):
            bcc = c
        if bcc is None or bcc.recheck_any:
            return lambda: self._host_all(*host_args)
        if ht is None:
            bschema = schema_from_chunk_columns(bnames, bcols_all)
            build_fn = build_hash_table(bschema, bkeys, bpred,
                                        row_bits=row_bits)
            with pm.timer("build_hash"):
                ht = build_fn(bcc.planes, bcc.nrows)
            if int(ht["err"]) != 0:
                return lambda: self._host_all(*host_args)
            TCACHE.put_aux(ht_key, ht, self.build.name, bcols_all)
        nbuckets = int(ht["bucket_start"].shape[0]) - 1
        key_types = tuple(k.type for k in self.build_keys)

        # map joined slots to (probe layout idx) or (build layout idx)
        playout = {n: i for i, n in enumerate(pnames)}
        probe_slots = [playout.get(c, -1) for c in jnames]
        build_slots = [(j, blayout[c]) for j, c in enumerate(jnames)
                       if probe_slots[j] < 0]

        pkeys = [bind_columns(k, playout) for k in self.probe_keys]
        ppred = bind_columns(self.probe_pred, playout) \
            if self.probe_pred is not None else None
        pschema = schema_from_chunk_columns(
            pnames, [self.probe.columns[n] for n in pnames])
        pcap = tiered_capacity(chunk_capacity(self.probe.nrows), dev, pm)
        self._G = config.max_groups_device
        max_chain = config.join_max_bucket_probe
        out_cap0 = max(2 * pcap, 1024)
        key_metas = self._key_metas()

        # column-sum grouping (K2) when key types allow exact host recovery
        kts = [g.type for g in bound_groups]
        self._strategy = ("mxu_dense" if mxu_dense_supported(kts)
                          else "mxu" if mxu_keys_supported(kts)
                          else "scatter")
        # direct-address probe (one lookup, row-aligned, no regrow) when the
        # build side is a unique single-int-key table — the dim-join shape
        use_dense = bool(ht["dense_ok"])
        use_mxu = config.join_mxu_lookup and bool(ht["dense_m_ok"])
        dcap = mxu_dense_window(bcap) if use_mxu else dense_cap_for(bcap)

        # star-schema fast path: dimension-only GROUP BY keys + fact-only
        # aggregate args => pre-assign group ids on the build side and probe
        # with ONE slot->group K3 lookup (no build gathers, no salt ladder)
        if use_dense and use_mxu and bound_groups:
            pg = self._compose_pregroup(ht, ht_key, bnames, bpred, dcap, pm)
            if pg is not None:
                return self._prepare_pregrouped(pg, ht, pnames, refd, pcap,
                                                host_args)

        # ungrouped over a dense build, inside K5's envelope: the probe and
        # the aggregate in one kernel pass (ops/joinagg_scalar.py), through
        # a launch plan where the probe chunks stay resident
        if use_dense and not bound_groups:
            prog = scalar_program(
                pschema, pkeys, ppred, bound_aggs, probe_slots,
                lambda i: column_stats(
                    self.probe.columns[pnames[i]]).null_count > 0)
            if prog is not None:
                member_key = ("joinagg_member", ht_key, dcap, use_mxu)
                member = self._member_table(ht, member_key, bnames, dcap,
                                            use_mxu, row_bits, pm)
                chunks = TCACHE.cached_chunks(self.probe, pnames, pcap, pm)
                if chunks and not all(c.recheck_any for c in chunks):
                    plan = self._k5_plan(prog, member, member_key, chunks,
                                         jlayout, bound_aggs, pnames, pcap)
                    return lambda: self._run_planned(plan)
                return lambda: self._run_k5(prog, member, pnames, pcap,
                                            host_args)

        def fused(out_cap, strategy=self._strategy, G=None):
            return build_join_preagg_fn(
                pschema, pkeys, key_types, nbuckets, max_chain, out_cap,
                ppred, jschema, probe_slots, build_slots, bound_groups,
                bound_aggs, G if G is not None else self._G, strategy,
                dense=use_dense, dense_cap=dcap, dense_mxu=use_mxu,
                dense_row_bits=row_bits)

        fn0 = fused(out_cap0)

        def launch() -> list[tuple]:
            consume_args = (key_metas, bound_groups, bound_aggs, host_args)
            for cc, out in launch_chunks(
                    self.probe, pnames, pcap, pm,
                    lambda cc: pm.device_call("tpujoinagg", fn0, ht,
                                              cc.planes, bcc.planes,
                                              cc.nrows, 0)):
                self._consume(cc, out, out_cap0, ht, bcc, fused,
                              *consume_args)
            return finalize_agg_states(bound_groups, bound_aggs, states,
                                       displays)
        return launch

    # -- consume one chunk -------------------------------------------------------

    def _consume(self, cc, out, out_cap, ht, bcc, fused, key_metas,
                 bound_groups, bound_aggs, host_args) -> None:
        """Retry ladder: regrow (DataStoreNoSpace analog) -> dense_fail
        re-dispatch -> salted buckets at G -> 4x G escalation -> exact sort
        strategy -> host replay (at once: out None)."""
        pm = self.perfmon
        if out is None:
            with pm.timer("cpu_fallback"):
                self._host_chunk_agg(cc, *host_args)
            return
        states, displays = host_args[0], host_args[1]
        lstrat = "mxu" if self._strategy == "mxu_dense" else self._strategy
        ladder = [(self._G, 0x9E3779B97F4A7C15, lstrat)]
        G2 = min(4 * self._G, config.max_groups_cap)
        if G2 > self._G:
            ladder += [(G2, 0, lstrat),
                       (G2, 0xC2B2AE3D27D4EB4F, lstrat)]
        ladder.append((config.max_groups_cap, 0, "sort"))
        attempt = 0
        overflow = False
        cur = (self._G, 0, self._strategy)

        def redispatch():
            g, salt, strategy = cur
            return fetch_host(fused(out_cap, strategy, g)(
                ht, cc.planes, bcc.planes, cc.nrows, salt))

        while True:
            err = int(out["err"])
            nout = int(out["nout"])
            if err != 0 or overflow:
                break                                 # -> host replay
            if nout > out_cap:
                # DataStoreNoSpace analog: regrow fused output, re-dispatch
                pm.bump("regrow_retries")
                out_cap = _next_pow2(nout)
                out = redispatch()
                continue
            if bound_groups and "mxu_sums" in out:
                if bool(np.asarray(out.get("dense_fail", False))):
                    # sparse key range: one-time generic-mxu re-dispatch
                    pm.bump("dense_fallbacks")
                    cur = (cur[0], cur[1], "mxu")
                    out = redispatch()
                    continue
                collided, overflow = mxu_absorb(
                    out, bound_groups, bound_aggs, key_metas, states,
                    displays, merge_partials,
                    extract_with_dicts(bound_aggs, self._agg_dicts_join),
                    canon_group_key, dense_key=cur[2] == "mxu_dense")
                if overflow:
                    continue
                if not collided:
                    pm.bump("device_chunks")
                    return
            else:
                collided = (bool(np.asarray(out.get("collision", False)))
                            if bound_groups else False)
                if not collided:
                    absorb_preagg_out(out, bound_groups, bound_aggs,
                                      key_metas, states, displays, pm,
                                      self._agg_dicts_join)
                    return
            if attempt >= len(ladder):
                break
            cur = ladder[attempt]
            pm.bump("sort_fallbacks" if cur[2] == "sort" else "salt_retries")
            out = redispatch()
            attempt += 1
        pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            self._host_chunk_agg(cc, *host_args)

    def _member_table(self, ht, aux_key, bnames, dcap, use_mxu, row_bits,
                      pm) -> dict:
        """K5's bitmap of the build keys, cached beside the hash table
        under aux_key."""
        member = TCACHE.get_aux(aux_key, pm)
        if member is None:
            member = member_table(ht, dcap, use_mxu, row_bits)
            TCACHE.put_aux(aux_key, member, self.build.name,
                           [self.build.columns[n] for n in bnames])
        return member

    # -- K5's launch plan ------------------------------------------------------

    def _k5_keys(self) -> tuple:
        """(plan key, build key) of this query.  The plan key is its shape:
        the probe keys, the aggregates and the probe predicate's
        conjuncts, each whole but for the constant of a `column op
        constant` conjunct, which K5 reads as a range (the columns and the
        device are in the key of the chunk entry the plan is filed on).
        The build key names the build side's columns, keys and predicate,
        whose membership table the plan finds in `members`."""
        conjs = tuple((r[0], r[1], r[2].type) if r is not None else c
                      for c, r in ((c, range_clause(c))
                                   for c in conjuncts(self.probe_pred)))
        return (("k5_plan", config.join_mxu_lookup, tuple(self.probe_keys),
                 conjs, tuple(self.aggs)),
                (tuple(c.uid for c in self.build.columns.values()),
                 tuple(self.build_keys), self.build_pred))

    def _planned(self):
        """The run of a query whose shape has a launch plan (K5 over the
        resident probe chunks, nothing read from the device before the
        launch and one read after), or None: the query then runs through
        _prepare, which makes the plan where K5 takes the query."""
        if self.group_exprs:
            return None                  # K5 takes no GROUP BY
        keys = self._k5_keys()
        pm = self.perfmon
        # _prepare's capacity; the kernel library its plan needs is loaded
        plan = TCACHE.get_plan(self.probe, self.probe.column_names,
                               chunk_capacity(self.probe.nrows), keys[0])
        if plan is None:
            return None
        member_key = plan.members.get(keys[1])
        member = (TCACHE.get_aux(member_key, pm)
                  if member_key is not None else None)
        ranges = plan.ranges(self.probe_pred) if member is not None else None
        if ranges is None or not plan.lock.acquire(blocking=False):
            return None
        plan.batch.set_member(member)
        plan.batch.set_ranges(ranges)
        pm.bump("k5_plan_hits")
        return lambda: self._run_planned(plan)

    def _k5_plan(self, prog, member, member_key, chunks, jlayout, bound_aggs,
                 pnames, pcap) -> "_K5Plan":
        """A launch plan of prog over the resident probe chunks, locked for
        this query.  Filed on the chunks' cache entry (`k5_plan_builds`)
        where the entry holds none for the query's shape and the plan
        serves every range constant; the membership table is filed under
        the build side in the plan the entry holds."""
        dev_chunks = [c for c in chunks if not c.recheck_any]
        plan = _K5Plan(
            batch=_k5_batch(prog, member, dev_chunks),
            device_chunks=dev_chunks,
            host_chunks=[c for c in chunks if c.recheck_any],
            aggs=bound_aggs, jlayout=jlayout,
            agg_dicts=self._agg_dicts_join, prog0=prog)
        plan.lock.acquire()
        keys = self._k5_keys()
        filed = TCACHE.get_plan(self.probe, pnames, pcap, keys[0])
        if filed is None and np.array_equal(
                plan.ranges(self.probe_pred), prog.ranges) and \
                TCACHE.put_plan(self.probe, pnames, pcap, keys[0], plan):
            self.perfmon.bump("k5_plan_builds")
            filed = plan
        if filed is not None:
            if len(filed.members) >= _MAX_MEMBERS:
                filed.members.clear()
            filed.members[keys[1]] = member_key
        return plan

    def _run_planned(self, plan: "_K5Plan") -> list[tuple]:
        """Launch the plan's batch, read it back once, release the plan,
        then absorb each chunk's row (_absorb_k5); the chunks that need
        the host (recheck_any) replay first."""
        pm = self.perfmon
        try:
            with pm.timer("dispatch"):
                pm.device_call("tpujoinagg", plan.batch.launch)
            with pm.timer("device_wait"):
                rows = plan.batch.fetch()
        finally:
            plan.lock.release()
        states: dict[tuple, list[dict]] = {}
        displays: dict[tuple, tuple] = {}
        host_args = (states, displays, list(plan.jlayout), [], plan.aggs)
        for cc in plan.host_chunks:
            self._absorb_k5(cc, None, plan.batch.prog, plan.agg_dicts,
                            host_args)
        for cc, row in zip(plan.device_chunks, rows):
            self._absorb_k5(cc, row, plan.batch.prog, plan.agg_dicts,
                            host_args)
        return finalize_agg_states([], plan.aggs, states, displays)

    def _run_k5(self, prog, member, pnames, pcap, host_args) -> list[tuple]:
        """K5 over probe chunks that are not all resident: a one-chunk
        K5Batch a chunk in the chunk pipeline, each row absorbed by
        _absorb_k5."""
        pm = self.perfmon
        for cc, out in launch_chunks(
                self.probe, pnames, pcap, pm,
                lambda cc: pm.device_call(
                    "tpujoinagg", _k5_batch(prog, member, [cc]).launch)):
            self._absorb_k5(cc, None if out is None else out[0], prog,
                            self._agg_dicts_join, host_args)
        states, displays, _, _, aggs = host_args
        return finalize_agg_states([], aggs, states, displays)

    def _absorb_k5(self, cc, row, prog: ScalarProgram, agg_dicts,
                   host_args) -> None:
        """Absorb one chunk's K5 row (err, count(*), per argument count
        and sum); a row with its err lane set replays the chunk alone on
        the host, as does a chunk that needs the host (row None)."""
        pm = self.perfmon
        if row is not None and row[0] == 0:
            states, displays, _, _, aggs = host_args
            absorb_preagg_out(
                {"gmask": _ONE, "keys": (),
                 "slots": tuple({kind: row[i:i + 1] for kind, i in s_}
                                for s_ in prog.slots)},
                [], aggs, [], states, displays, pm, agg_dicts)
            return
        if row is not None:
            pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            self._host_chunk_agg(cc, *host_args)

    # -- star-schema pregrouped path ------------------------------------------

    def _compose_pregroup(self, ht, ht_key, bnames, bpred, dcap, pm):
        """Enumerate dimension group ids on the host and build the
        slot -> seg lookup table.  Returns None when the plan shape doesn't
        qualify (group keys not build-only / agg args not probe-only /
        non-column join key / too many groups) — the caller falls through
        to the generic fused path.  The loop over the build rows is the
        reference's, cold cost included."""
        if len(self.build_keys) != 1 or \
                not isinstance(self.build_keys[0], ColumnRef):
            return None
        for g in self.group_exprs:
            cols = list(referenced_columns(g))
            if not cols or any(c not in self.build.columns
                               or c in self.probe.columns for c in cols):
                return None
        for inst in self.aggs:
            for a in inst.args:
                if any(c not in self.probe.columns
                       for c in referenced_columns(a)):
                    return None
        aux_key = ("joinagg_pregroup", ht_key, tuple(self.group_exprs), dcap)
        cached = TCACHE.get_aux(aux_key, pm)
        if cached is not None:
            return cached

        bl = list(bnames)
        blayout0 = {n: i for i, n in enumerate(bl)}
        bound_groups_b = [bind_columns(g, blayout0) for g in self.group_exprs]
        bkey_col = self.build.columns[self.build_keys[0].name]
        kmin = int(ht["kmin"])
        groups_by_ck: dict[tuple, int] = {}
        seg_displays: list[tuple] = []
        entries: list[tuple[int, int]] = []
        try:
            with pm.timer("pregroup_compose"):
                for i in range(self.build.nrows):
                    if not bool(bkey_col.valid[i]):
                        continue
                    row = lambda s: self.build.columns[bl[s]].get(i)
                    if bpred is not None and \
                            eval_expr_cpu(bpred, row) is not True:
                        continue
                    slotv = int(bkey_col.data[i]) - kmin
                    if not (0 <= slotv < dcap):
                        return None          # contradicts dense_m_ok; bail
                    kvals = tuple(eval_expr_cpu(g, row)
                                  for g in bound_groups_b)
                    ck = tuple(canon_group_key(v) for v in kvals)
                    seg = groups_by_ck.get(ck)
                    if seg is None:
                        seg = len(seg_displays)
                        groups_by_ck[ck] = seg
                        seg_displays.append(kvals)
                    entries.append((slotv, seg))
        except Exception:
            return None                      # group expr not host-evaluable
        ngroups = len(seg_displays)
        if ngroups == 0:
            return None                      # empty join: generic path
        G_pre = max(128, _next_pow2(ngroups + 2))
        if G_pre > config.max_groups_cap:
            return None
        seg_K = lookup_digits(G_pre.bit_length())
        segslot = np.full(dcap, G_pre, np.uint32)
        for slotv, seg in entries:
            segslot[slotv] = seg
        table = encode_table(segslot, dcap, seg_K)
        # the padding slots read as "no group" too
        table[dcap:] = G_pre
        pg = {"M_seg": torch.from_numpy(table).to(device()),
              "seg_displays": seg_displays,
              "G_pre": G_pre, "seg_K": seg_K, "dcap": dcap}
        TCACHE.put_aux(aux_key, pg, self.build.name,
                       [self.build.columns[n] for n in bl])
        return pg

    def _prepare_pregrouped(self, pg, ht, pnames, refd, pcap, host_args):
        """The pregrouped path's device function; returns its run."""
        pm = self.perfmon
        states, displays, _, bound_groups, bound_aggs = host_args
        playout = {n: i for i, n in enumerate(pnames)}
        pkeys = [bind_columns(k, playout) for k in self.probe_keys]
        ppred = bind_columns(self.probe_pred, playout) \
            if self.probe_pred is not None else None
        pschema = schema_from_chunk_columns(
            pnames, [self.probe.columns[n] for n in pnames])
        jnames_pre = [c for c in refd if c in self.probe.columns]
        jlayout_pre = {c: i for i, c in enumerate(jnames_pre)}
        jschema_pre = schema_from_chunk_columns(
            jnames_pre, [self.probe.columns[c] for c in jnames_pre])
        probe_slots_pre = [playout[c] for c in jnames_pre]
        aggs_pre = [
            AggInstance(aggname=i_.aggname, family=i_.family, slots=i_.slots,
                        args=tuple(bind_columns(a, jlayout_pre)
                                   for a in i_.args))
            for i_ in self.aggs]
        G_pre, seg_K = pg["G_pre"], pg["seg_K"]
        seg_ref = ColumnRef(type=T.INT4, name="__seg__",
                            index=len(jschema_pre))
        fn = build_join_preagg_pregrouped_fn(
            pschema, pkeys, pg["dcap"], ppred, jschema_pre, probe_slots_pre,
            aggs_pre, G_pre, seg_K, "mxu_dense")
        ht2 = dict(ht)
        ht2["seg_M"] = pg["M_seg"]
        extract = extract_with_dicts(
            aggs_pre, agg_text_dicts(aggs_pre, self.probe.columns.get))

        seg_states: dict[tuple, list[dict]] = {}
        seg_disp: dict[tuple, tuple] = {}

        def consume(cc, out):
            if out is not None and int(out["err"]) == 0 and \
                    not bool(np.asarray(out.get("dense_fail", False))):
                collided, overflow = mxu_absorb(
                    out, [seg_ref], aggs_pre, [None], seg_states, seg_disp,
                    merge_partials, extract, canon_group_key, dense_key=True)
                if not (collided or overflow):
                    pm.bump("device_chunks")
                    return
            # a chunk that needs the host (out None), a device error, or
            # (impossible by construction with dense seg ids) a collision:
            # replay the chunk host-exactly
            if out is not None:
                pm.bump("recheck_chunks")
            with pm.timer("cpu_fallback"):
                self._host_chunk_agg(cc, *host_args)

        def launch() -> list[tuple]:
            for cc, out in launch_chunks(
                    self.probe, pnames, pcap, pm,
                    lambda cc: pm.device_call("tpujoinagg_pregrouped", fn,
                                              ht2, cc.planes, cc.nrows, 0)):
                consume(cc, out)

            # translate seg ids -> enumerated dimension key tuples, then merge
            # with any host-replayed groups (keyed by the real values)
            for ck_seg, st in seg_states.items():
                seg = int(seg_disp[ck_seg][0])
                kvals = pg["seg_displays"][seg]
                ck = tuple(canon_group_key(v) for v in kvals)
                if ck not in states:
                    states[ck] = st
                    displays[ck] = kvals
                else:
                    states[ck] = [merge_partials(inst, a, b) for inst, a, b
                                  in zip(bound_aggs, states[ck], st)]
            return finalize_agg_states(bound_groups, bound_aggs, states,
                                       displays)
        return launch

    def _key_metas(self) -> list[ColMeta | None]:
        metas = []
        for g in self.group_exprs:
            m = None
            if isinstance(g, ColumnRef) and g.type in (T.TEXT, T.BPCHAR):
                c = self.probe.columns.get(g.name) or self.build.columns.get(g.name)
                if c is not None:
                    m = ColMeta(name=g.name, type=g.type,
                                dictionary=tuple(c.dictionary or ()),
                                dict_id=id(c.dictionary))
            metas.append(m)
        return metas

    # -- host-exact tier -----------------------------------------------------

    def _host_hash_table(self) -> dict:
        if self._host_ht_cache is not None:
            return self._host_ht_cache
        ht: dict = {}
        bl = self.build.column_names
        blayout = {n: i for i, n in enumerate(bl)}
        bkeys = [bind_columns(k, blayout) for k in self.build_keys]
        bpred = bind_columns(self.build_pred, blayout) \
            if self.build_pred is not None else None
        for i in range(self.build.nrows):
            row = lambda s: self.build.columns[bl[s]].get(i)
            if bpred is not None and eval_expr_cpu(bpred, row) is not True:
                continue
            kv = tuple(eval_expr_cpu(k, row) for k in bkeys)
            if any(v is None for v in kv):
                continue
            ht.setdefault(tuple(canon_group_key(v) for v in kv), []).append(i)
        self._host_ht_cache = ht
        return ht

    def _host_chunk_agg(self, cc, states, displays, jnames, bound_groups,
                        bound_aggs) -> None:
        """Join + aggregate one probe chunk row-by-row, host-exactly."""
        ht = self._host_hash_table()
        chunk = cc.host_chunk(self.probe)
        pl = self.probe.column_names
        playout = {n: i for i, n in enumerate(pl)}
        pkeys = [bind_columns(k, playout) for k in self.probe_keys]
        ppred = bind_columns(self.probe_pred, playout) \
            if self.probe_pred is not None else None
        probe_side = [c in self.probe.columns for c in jnames]

        for i in range(chunk.nrows):
            prow = lambda s: chunk.columns[pl[s]].get(i)
            if ppred is not None and eval_expr_cpu(ppred, prow) is not True:
                continue
            kv = tuple(eval_expr_cpu(k, prow) for k in pkeys)
            if any(v is None for v in kv):
                continue
            for bi in ht.get(tuple(canon_group_key(v) for v in kv), ()):
                def jrow(s):
                    c = jnames[s]
                    if probe_side[s]:
                        return chunk.columns[c].get(i)
                    return self.build.columns[c].get(bi)
                kvals = tuple(eval_expr_cpu(g, jrow) for g in bound_groups)
                ck = tuple(canon_group_key(v) for v in kvals)
                if ck not in states:
                    states[ck] = [new_state(inst) for inst in bound_aggs]
                    displays[ck] = kvals
                st = states[ck]
                for inst, s in zip(bound_aggs, st):
                    update_state(inst, s,
                                 [eval_expr_cpu(a, jrow) for a in inst.args])

    def _host_all(self, states, displays, jnames, bound_groups,
                  bound_aggs) -> list[tuple]:
        pcap = chunk_capacity(self.probe.nrows)
        for start in range(0, self.probe.nrows, pcap):
            stop = min(start + pcap, self.probe.nrows)
            with self.perfmon.timer("cpu_fallback"):
                self._host_chunk_agg(_HostCC(start, stop - start, pcap),
                                     states, displays, jnames, bound_groups,
                                     bound_aggs)
        return finalize_agg_states(bound_groups, bound_aggs, states, displays)


_ONE = np.ones(1, dtype=bool)
_MAX_MEMBERS = 256       # build sides a launch plan keeps membership keys of


def _k5_batch(prog: ScalarProgram, member: dict, chunks) -> K5Batch:
    """K5 over the chunks, each one's planes in prog.inputs order."""
    return K5Batch(prog, member,
                   [[c.planes[i][0 if plane == "data" else 1]
                     for i, plane in prog.inputs] for c in chunks],
                   [c.nrows for c in chunks])


@dataclasses.dataclass(eq=False)
class _K5Plan:
    """K5 over a probe table's resident chunks for one query shape
    (JoinPreAggExecutor._k5_keys): the batch (parameter blocks, result
    buffer, pinned twin) and what _prepare derives that no range constant
    changes.  Filed on the chunks' cache entry, it leaves the cache with
    them.  `members` maps a build side to the cache key of its membership
    table; `lock` keeps the batch to one query at a time."""
    batch: K5Batch
    device_chunks: list          # the chunks K5 runs, in the batch's order
    host_chunks: list            # recheck_any chunks: the host replays them
    aggs: list                   # the aggregates, bound to jlayout
    jlayout: dict                # joined column name -> slot
    agg_dicts: list
    prog0: ScalarProgram         # the lowering the plan was made of
    members: dict = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def ranges(self, pred: Optional[Expr]) -> Optional[np.ndarray]:
        """prog0's range rows with the bounds of pred's range conjuncts, or
        None where one of them lowers to no range (no value meets it, or
        its column's range would be empty): that query lowers its own
        program through _prepare."""
        ranges, rest = split_ranges(conjuncts(pred))
        if any(range_clause(c) is not None for c in rest):
            return None
        out = self.prog0.ranges.copy()
        if ranges:
            out[:, 2:] = list(ranges.values())
        return out


class _HostCC:
    """A chunk position with no device planes (the host-exact tier)."""

    def __init__(self, start, nrows, capacity):
        self.start, self.nrows, self.capacity = start, nrows, capacity
        self.recheck_any = True

    def host_chunk(self, table):
        return Chunk.from_table(table, self.start, self.start + self.nrows,
                                self.capacity)
