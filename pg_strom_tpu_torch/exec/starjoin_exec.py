"""N-way fused star join -> aggregate executor.

The multi-relation device join chain as pg_strom_tpu/exec/starjoin_exec.py
runs it (gpuhashjoin.c:789-835 multi-rel path merge, :1184-1318 probe
recursion, bulkslot hand-off pg_strom.h:317-329): a fact table joined to 2+
dimension tables feeding aggregation runs as ONE device pass per fact
chunk (ops/starjoin.py), with no intermediate host Table per join hop.

Per dimension: a unique single integer key takes the dense probe (the
identity for a serial key, else K3 under config.join_mxu_lookup when the
keys span its window, else a plain gather); anything else the
bounded-fanout multi probe, whose fan-out F starts at the key's duplicate
maximum and doubles on `join_ovf` up to config.join_star_max_slices
slices.  A shape the chain cannot run raises StarFallback and the planner
runs the pairwise HashJoin chain.

The retry ladder per chunk mirrors the two-relation executor
(exec/joinagg_exec.py): dense-group fail -> generic mxu -> salt retry ->
G escalation -> exact sort strategy -> host replay (a row-wise N-way join
and aggregate, exact).

`device_chunks` counts fact chunks answered on the device, once each.
The reference also counts every slice a scatter, sort or ungrouped
strategy absorbed, so its count runs ahead of the port's there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..datastore import Table
from ..sqltypes import T
from ..expr.ir import Expr, ColumnRef, referenced_columns, bind_columns
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..expr.lower_torch import ColMeta, schema_from_chunk_columns
from ..ops.hashjoin import build_hash_table, dense_cap_for, \
    mxu_dense_window, _next_pow2
from ..ops.starjoin import build_star_join_preagg_fn
from ..ops.preagg import AggInstance, merge_partials
from ..ops.preagg_mxu import mxu_keys_supported, mxu_dense_supported, \
    mxu_absorb
from .devcache import TCACHE, chunk_capacity, device, fetch_host, \
    launch_chunks
from .hostexec import canon_group_key, new_state, update_state
from .preagg_exec import absorb_preagg_out, finalize_agg_states, \
    agg_text_dicts, extract_with_dicts
from ..utils.devprog import tiered_capacity
from ..utils.perfmon import Perfmon


def _canon_spec_val(v):
    """Hashable canonical form of a dim-spec value (ColMeta lists etc.)."""
    if isinstance(v, ColMeta):
        return ("__colmeta__", v.name, v.type, v.dict_id)
    if isinstance(v, (list, tuple)):
        return tuple(_canon_spec_val(x) for x in v)
    return v


def _spec_sig(specs) -> tuple:
    return tuple(tuple(sorted((k, _canon_spec_val(v))
                              for k, v in s.items())) for s in specs)


class StarFallback(Exception):
    """Signal: run the pairwise join chain instead."""


@dataclasses.dataclass
class DimSpec:
    table: Table
    probe_keys: list          # exprs over the SOURCE rel (fact or parent dim)
    build_keys: list          # exprs over this dimension table
    build_pred: Optional[Expr]
    # snowflake chains: None = keyed by the fact; an int = keyed by the
    # columns of dims[src] (a parent dimension resolved earlier)
    src: Optional[int] = None


class StarJoinAggExecutor:
    """SELECT <aggs> FROM fact, d1, d2, ... WHERE fact.k1 = d1.pk AND ...
    GROUP BY ... — all joins + aggregation fused into one device pass."""

    def __init__(self, probe: Table, dims: Sequence[DimSpec],
                 group_exprs: Sequence[Expr], aggs: Sequence[AggInstance],
                 probe_pred: Optional[Expr] = None,
                 perfmon: Perfmon | None = None):
        self.probe = probe
        self.dims = list(dims)
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.probe_pred = probe_pred
        self.perfmon = perfmon or Perfmon()
        self._host_hts: list | None = None
        self._fns: dict = {}          # built star functions by signature

    # -- eligibility ---------------------------------------------------------

    def device_ok(self) -> bool:
        if not (config.enabled and config.enable_tpuhashjoin
                and config.enable_tpupreagg):
            return False
        if self.probe.nrows == 0 or any(d.table.nrows == 0
                                        for d in self.dims):
            return False
        if any(inst.distinct for inst in self.aggs):
            return False
        exprs = list(self.group_exprs) + \
            [a for i_ in self.aggs for a in i_.args]
        if self.probe_pred is not None:
            exprs.append(self.probe_pred)
        for d in self.dims:
            exprs += d.probe_keys + d.build_keys
            if d.build_pred is not None:
                exprs.append(d.build_pred)
            # text join keys compare via per-table dictionaries: no shared
            # code space on the device (the pairwise executor's gate)
            if any(k.type in (T.TEXT, T.BPCHAR)
                   for k in d.probe_keys + d.build_keys):
                return False
        if any(not device_expression_supported(e) for e in exprs):
            return False
        for inst in self.aggs:
            for a in inst.args:
                if a.type is T.NUMERIC and not isinstance(a, ColumnRef):
                    return False
                # text agg args aggregate dict codes: plain columns only
                if a.type in (T.TEXT, T.BPCHAR) \
                        and not isinstance(a, ColumnRef):
                    return False
        return True

    # -- run -----------------------------------------------------------------

    def run(self) -> list[tuple]:
        if not self.device_ok():
            raise StarFallback("shape not device-eligible")
        with self.perfmon.timer("prepare"):
            launch = self._prepare()
        return launch()

    def _prepare(self):
        """Everything before the first launch: the joined layout, each
        dimension's hash table, the probe specs.  Returns the rest of the
        run, a call that takes no arguments."""
        pm = self.perfmon
        dev = device()
        states: dict[tuple, list[dict]] = {}
        displays: dict[tuple, tuple] = {}

        pnames = list(self.probe.column_names)
        playout = {n: i for i, n in enumerate(pnames)}

        # joined layout: referenced columns only, fact side first
        refd: list[str] = []
        for e in self.group_exprs + [a for i_ in self.aggs for a in i_.args]:
            for c in referenced_columns(e):
                if c not in refd:
                    refd.append(c)
        col_dim = {}                      # joined col -> (dim idx, col idx)
        for di, d in enumerate(self.dims):
            for ci, c in enumerate(d.table.column_names):
                col_dim.setdefault(c, (di, ci))
        jnames = [c for c in refd if c in self.probe.columns] + \
                 [c for c in refd if c not in self.probe.columns]
        for c in jnames:
            if c not in self.probe.columns and c not in col_dim:
                raise StarFallback(f"unresolvable joined column {c}")
        jlayout = {c: i for i, c in enumerate(jnames)}
        jcols_src = [self.probe.columns.get(c)
                     or self.dims[col_dim[c][0]].table.columns[c]
                     for c in jnames]
        jschema = schema_from_chunk_columns(jnames, jcols_src)
        probe_slots = [playout.get(c, -1) for c in jnames]
        build_slot_map = {j: col_dim[c] for j, c in enumerate(jnames)
                          if probe_slots[j] < 0}
        bound_groups = [bind_columns(g, jlayout) for g in self.group_exprs]
        bound_aggs = [
            AggInstance(aggname=i_.aggname, family=i_.family, slots=i_.slots,
                        args=tuple(bind_columns(a, jlayout) for a in i_.args))
            for i_ in self.aggs]

        def _rescol(n):
            c = self.probe.columns.get(n)
            if c is None and n in col_dim:
                c = self.dims[col_dim[n][0]].table.columns.get(n)
            return c
        self._agg_dicts_star = agg_text_dicts(bound_aggs, _rescol)

        # ---- per-dimension device hash tables -----------------------------
        hts, bccs, dim_specs, bschemas = [], [], [], []
        for d in self.dims:
            bnames = list(d.table.column_names)
            bcols_all = [d.table.columns[n] for n in bnames]
            bcap = _next_pow2(max(d.table.nrows, 16))
            blayout0 = {n: i for i, n in enumerate(bnames)}
            bkeys = [bind_columns(k, blayout0) for k in d.build_keys]
            bpred = bind_columns(d.build_pred, blayout0) \
                if d.build_pred is not None else None
            row_bits = max(d.table.nrows, 1).bit_length()
            ht_key = ("join_ht", tuple(c.uid for c in bcols_all), str(dev),
                      tuple(bkeys), bpred, bcap, row_bits)
            ht = TCACHE.get_aux(ht_key, pm)
            bcc = None
            for c in TCACHE.chunks_for(d.table, bnames, bcap, pm):
                bcc = c
            if bcc is None or bcc.recheck_any:
                raise StarFallback("build side needs host recheck")
            bschema = schema_from_chunk_columns(bnames, bcols_all)
            if ht is None:
                build_fn = build_hash_table(bschema, bkeys, bpred,
                                            row_bits=row_bits)
                with pm.timer("build_hash"):
                    ht = build_fn(bcc.planes, bcc.nrows)
                if int(ht["err"]) != 0:
                    raise StarFallback("build-side device error")
                TCACHE.put_aux(ht_key, ht, d.table.name, bcols_all)
            # snowflake chains: this inner's keys reference a PARENT
            # dimension's columns (d.src); bind them over the parent's
            # layout and probe against lanes gathered at the parent's
            # matched rows.  The parent must resolve dense (unique) so its
            # match is slice-independent.
            if d.src is None:
                pkeys = [bind_columns(k, playout) for k in d.probe_keys]
                src = "probe"
                src_schema = None
            else:
                if (d.src >= len(dim_specs)
                        or dim_specs[d.src].get("mode") != "dense"):
                    raise StarFallback(
                        "snowflake parent not unique-dense")
                pt = self.dims[d.src].table
                slay = {n: i for i, n in enumerate(pt.column_names)}
                pkeys = [bind_columns(k, slay) for k in d.probe_keys]
                src = d.src
                src_schema = bschemas[d.src]
            hts.append(ht)
            bccs.append(bcc)
            bschemas.append(bschema)
            if (bool(ht["dense_ok"]) and len(d.build_keys) == 1
                    and d.build_keys[0].type not in (T.NUMERIC, T.FLOAT4,
                                                     T.FLOAT8)):
                # serial key: identity; else K3 when the keys span its
                # window; else a plain gather (exec/join_exec.py's order)
                use_ident = bool(ht["dense_ident"])
                use_mxu = (not use_ident and config.join_mxu_lookup
                           and bool(ht["dense_m_ok"]))
                dcap = (mxu_dense_window(bcap) if use_mxu
                        else dense_cap_for(bcap))
                dim_specs.append({"mode": "dense", "probe_keys": pkeys,
                                  "dense_cap": dcap, "use_mxu": use_mxu,
                                  "use_ident": use_ident,
                                  "row_bits": row_bits,
                                  "key_source": src,
                                  "src_schema": src_schema})
            else:
                # non-unique / multi-key / float inner: bounded-fanout
                # row-aligned probe; F starts at the exact duplicate
                # maximum when cheaply computable, else 2 (the join_ovf
                # ladder doubles it)
                dim_specs.append({"mode": "multi", "probe_keys": pkeys,
                                  "key_types": tuple(k.type
                                                     for k in d.build_keys),
                                  "max_chain": 0,   # filled by _spec_tune
                                  "fanout": self._initial_fanout(d),
                                  "key_source": src,
                                  "src_schema": src_schema})

        ppred = bind_columns(self.probe_pred, playout) \
            if self.probe_pred is not None else None
        pschema = schema_from_chunk_columns(
            pnames, [self.probe.columns[n] for n in pnames])
        kts = [g.type for g in bound_groups]
        self._strategy = ("mxu_dense" if mxu_dense_supported(kts)
                          else "mxu" if mxu_keys_supported(kts)
                          else "scatter")
        self._G = config.max_groups_device
        key_metas = self._key_metas()

        self._dim_specs = dim_specs
        self._spec_tune()

        def fused(strategy=None, G=None):
            strategy = strategy or self._strategy
            G = G if G is not None else self._G
            specs = [dict(s) for s in self._dim_specs]
            key = (_spec_sig(specs), G, strategy)
            fn = self._fns.get(key)
            if fn is None:
                fn = build_star_join_preagg_fn(
                    pschema, specs, ppred, jschema, probe_slots,
                    build_slot_map, bound_groups, bound_aggs, G, strategy)
                self._fns[key] = fn
            return fn

        bplanes = tuple(bcc.planes for bcc in bccs)
        hts_t = tuple(hts)
        pcap = tiered_capacity(chunk_capacity(self.probe.nrows), dev, pm)

        def launch() -> list[tuple]:
            # 3+-relation star over the device mesh: the fact shards
            # data-parallel across the mesh, every dimension table and
            # hash table REPLICATES (dims are small by the star shape),
            # each shard runs the same fused star-join+agg function over
            # its rows, and the host merges partials like chunks.  Any
            # per-shard anomaly falls back to the single-device chunked
            # flow below.
            if config.distributed:
                from ..parallel.mesh import mesh_size
                if mesh_size() >= 2:
                    rows = self._run_distributed(
                        pnames, pschema, ppred, jschema, probe_slots,
                        build_slot_map, bound_groups, bound_aggs, hts_t,
                        bplanes, states, displays, key_metas)
                    if rows is not None:
                        return rows

            consume_args = (states, displays, key_metas, jnames, jlayout,
                            bound_groups, bound_aggs, hts_t, bplanes, fused)
            for cc, out in launch_chunks(
                    self.probe, pnames, pcap, pm,
                    lambda cc: pm.device_call("tpustarjoinagg", fused(),
                                              hts_t, cc.planes, bplanes,
                                              cc.nrows, 0)):
                self._consume(cc, out, *consume_args)
            return finalize_agg_states(bound_groups, bound_aggs, states,
                                       displays)
        return launch

    def _run_distributed(self, pnames, pschema, ppred, jschema, probe_slots,
                         build_slot_map, bound_groups, bound_aggs, hts_t,
                         bplanes, states, displays, key_metas):
        """Mesh-distributed star: the fact's padded planes shard over the
        mesh (resident in the tcache aux space, so a repeated query ships
        0 bytes), the dimensions' hash tables and planes replicate to each
        shard's device, and build_star_join_preagg_fn runs once a shard on
        it — so K3 (a unique unsorted dimension) and K2 (grouped mxu sums)
        launch on every shard.  Returns finalized rows, or None to fall
        back."""
        from ..parallel.mesh import mesh_for_config, mesh_size, per_shard
        from ..parallel.shuffle import shard_host
        from ..expr.lower_torch import planes_of_column
        from ..datastore import Chunk

        pm = self.perfmon
        ndev = mesh_size()
        mesh = mesh_for_config(ndev)
        n = self.probe.nrows
        shard_n = _next_pow2(max(-(-n // ndev), 1024))
        Npad = shard_n * ndev
        if Npad * len(pnames) > (1 << 28):
            return None                  # keep the host staging copy sane

        pcols = [self.probe.columns[nm] for nm in pnames]
        rkey = ("dist_star_args", tuple(c.uid for c in pcols),
                tuple(pnames), Npad, tuple(str(d) for d in mesh.devices))
        cached = TCACHE.get_aux(rkey, pm)
        if cached is not None:
            shard_planes = cached
            pm.bump("dist_resident_hits")
        else:
            hc = Chunk.from_table(self.probe, 0, n, Npad)
            with pm.timer("upload"):
                per_col = [[shard_host(p, mesh)
                            for p in planes_of_column(hc.columns[nm])]
                           for nm in pnames]
            shard_planes = [tuple(tuple(pl[s] for pl in col)
                                  for col in per_col)
                            for s in range(ndev)]
            pm.add_bytes("h2d", sum(p.nbytes for nm in pnames
                                    for p in planes_of_column(
                                        hc.columns[nm])))
            TCACHE.put_aux(rkey, shard_planes, self.probe.name, pcols)

        def replicate(tree, dev):
            if isinstance(tree, torch.Tensor):
                return tree.to(dev, non_blocking=True)
            if isinstance(tree, dict):
                return {k: replicate(v, dev) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(replicate(v, dev) for v in tree)
            return tree

        specs = [dict(s) for s in self._dim_specs]
        base = build_star_join_preagg_fn(
            pschema, specs, ppred, jschema, probe_slots, build_slot_map,
            bound_groups, bound_aggs, self._G, self._strategy)
        nrows_d = np.clip(n - shard_n * np.arange(ndev, dtype=np.int64),
                          0, shard_n)
        dims_on: dict = {}

        def run_shard(s, planes):
            dev = mesh.devices[s]
            if str(dev) not in dims_on:
                dims_on[str(dev)] = (replicate(hts_t, dev),
                                     replicate(bplanes, dev))
            hts_d, bplanes_d = dims_on[str(dev)]
            return pm.device_call("tpustarjoinagg", base, hts_d, planes,
                                  bplanes_d, int(nrows_d[s]), 0)
        with pm.timer("dispatch"):
            outs = per_shard(mesh, run_shard, shard_planes)
        with pm.timer("device_wait"):
            outs = fetch_host(outs)
        if any(bool(np.asarray(o["join_ovf"]).any()) for o in outs):
            return None
        extract = extract_with_dicts(bound_aggs, self._agg_dicts_star)
        st2: dict = {}
        dp2: dict = {}
        for d in range(ndev):
            if nrows_d[d] == 0:
                continue
            for so in outs[d]["slices"]:
                if int(so["err"]) != 0:
                    return None
                if bound_groups and "mxu_sums" in so:
                    if bool(np.asarray(so.get("dense_fail", False))):
                        return None
                    collided, overflow = mxu_absorb(
                        so, bound_groups, bound_aggs, key_metas, st2, dp2,
                        merge_partials, extract, canon_group_key,
                        dense_key=self._strategy == "mxu_dense")
                    if collided or overflow:
                        return None
                else:
                    if bound_groups and bool(so.get("collision", False)):
                        return None
                    absorb_preagg_out(so, bound_groups, bound_aggs,
                                      key_metas, st2, dp2, pm,
                                      self._agg_dicts_star,
                                      whole_chunk=False)
        for ck, parts in st2.items():
            if ck not in states:
                states[ck] = parts
                displays[ck] = dp2[ck]
            else:
                states[ck] = [merge_partials(inst, a, b) for inst, a, b
                              in zip(bound_aggs, states[ck], parts)]
        pm.bump("dist_star_steps")
        return finalize_agg_states(bound_groups, bound_aggs, states,
                                   displays)

    def _initial_fanout(self, d: DimSpec) -> int:
        """Starting F for a multi-mode inner: the exact duplicate maximum
        of the build key when cheaply computable (dims are small), else 2;
        the join_ovf ladder doubles on underestimate."""
        if len(d.build_keys) == 1 and isinstance(d.build_keys[0], ColumnRef):
            col = d.table.columns.get(d.build_keys[0].name)
            if (col is not None and col.data.dtype.kind in "iu"
                    and len(col.data) <= (1 << 22)):
                vals = col.data[col.valid]
                if len(vals):
                    _, cnts = np.unique(vals, return_counts=True)
                    return int(min(max(int(cnts.max()), 1), 64))
        return 2

    def _spec_tune(self) -> None:
        slices = 1
        for s in self._dim_specs:
            if s.get("mode") == "multi":
                s["fanout"] = max(int(s["fanout"]), 1)
                s["max_chain"] = max(config.join_max_bucket_probe,
                                     2 * s["fanout"])
                slices *= s["fanout"]
        if slices > config.join_star_max_slices:
            raise StarFallback(f"fanout slice count {slices} exceeds cap")

    def _grow_fanout(self) -> bool:
        grew = False
        for s in self._dim_specs:
            if s.get("mode") == "multi":
                s["fanout"] *= 2
                grew = True
        if not grew:
            return False
        try:
            self._spec_tune()
        except StarFallback:
            return False
        return True

    def _consume(self, cc, out, states, displays, key_metas, jnames,
                 jlayout, bound_groups, bound_aggs, hts_t, bplanes,
                 fused) -> None:
        """Absorb one chunk's slice outputs with the standard retry
        ladders.  Slices stage into scratch accumulators and commit only
        when EVERY slice absorbed: a mid-slice redispatch must not
        double-count the already-absorbed ones.  Out None: host replay."""
        pm = self.perfmon
        if out is None:
            with pm.timer("cpu_fallback"):
                self._host_chunk_agg(cc, states, displays, jnames, jlayout,
                                     bound_groups, bound_aggs)
            return
        lstrat = "mxu" if self._strategy == "mxu_dense" else self._strategy
        ladder = [(self._G, 0x9E3779B97F4A7C15, lstrat)]
        G2 = min(4 * self._G, config.max_groups_cap)
        if G2 > self._G:
            ladder += [(G2, 0, lstrat), (G2, 0xC2B2AE3D27D4EB4F, lstrat)]
        ladder.append((config.max_groups_cap, 0, "sort"))
        attempt = 0
        cur = (self._G, 0, self._strategy)
        extract = extract_with_dicts(bound_aggs, self._agg_dicts_star)

        def redispatch():
            g, salt, strategy = cur
            return fetch_host(fused(strategy, g)(
                hts_t, cc.planes, bplanes, cc.nrows, salt))

        while True:
            # bounded-fanout ladder first: some probe row matched more
            # inner rows than the built F (or a chain overran)
            if bool(np.asarray(out.get("join_ovf", False))):
                if not self._grow_fanout():
                    break                             # -> host replay
                pm.bump("fanout_retries")
                out = redispatch()
                continue
            st2: dict = {}
            dp2: dict = {}
            failed: str | None = None
            for so in out["slices"]:
                if int(so["err"]) != 0:
                    failed = "replay"
                    break
                if bound_groups and "mxu_sums" in so:
                    if bool(np.asarray(so.get("dense_fail", False))):
                        pm.bump("dense_fallbacks")
                        cur = (cur[0], cur[1], "mxu")
                        failed = "redispatch"
                        break
                    collided, overflow = mxu_absorb(
                        so, bound_groups, bound_aggs, key_metas, st2, dp2,
                        merge_partials, extract, canon_group_key,
                        dense_key=cur[2] == "mxu_dense")
                    if overflow:
                        failed = "replay"
                        break
                    if collided:
                        failed = "ladder"
                        break
                else:
                    collided = (bool(np.asarray(so.get("collision", False)))
                                if bound_groups else False)
                    if collided:
                        failed = "ladder"
                        break
                    absorb_preagg_out(so, bound_groups, bound_aggs,
                                      key_metas, st2, dp2, pm,
                                      self._agg_dicts_star,
                                      whole_chunk=False)
            if failed is None:
                for ck, parts in st2.items():
                    if ck not in states:
                        states[ck] = parts
                        displays[ck] = dp2[ck]
                    else:
                        states[ck] = [
                            merge_partials(inst, a, b) for inst, a, b
                            in zip(bound_aggs, states[ck], parts)]
                pm.bump("device_chunks")
                return
            if failed == "replay":
                break
            if failed == "ladder":
                if attempt >= len(ladder):
                    break
                cur = ladder[attempt]
                pm.bump("sort_fallbacks" if cur[2] == "sort"
                        else "salt_retries")
                attempt += 1
            out = redispatch()
        pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            self._host_chunk_agg(cc, states, displays, jnames, jlayout,
                                 bound_groups, bound_aggs)

    def _key_metas(self):
        metas = []
        for g in self.group_exprs:
            m = None
            if isinstance(g, ColumnRef) and g.type in (T.TEXT, T.BPCHAR):
                c = self.probe.columns.get(g.name)
                if c is None:
                    for d in self.dims:
                        c = d.table.columns.get(g.name)
                        if c is not None:
                            break
                if c is not None:
                    m = ColMeta(name=g.name, type=g.type,
                                dictionary=tuple(c.dictionary or ()),
                                dict_id=id(c.dictionary))
            metas.append(m)
        return metas

    # -- host-exact tier -----------------------------------------------------

    def _host_hash_tables(self) -> list[dict]:
        if self._host_hts is not None:
            return self._host_hts
        hts = []
        for d in self.dims:
            ht: dict = {}
            bl = d.table.column_names
            blayout = {n: i for i, n in enumerate(bl)}
            bkeys = [bind_columns(k, blayout) for k in d.build_keys]
            bpred = bind_columns(d.build_pred, blayout) \
                if d.build_pred is not None else None
            for i in range(d.table.nrows):
                row = lambda s: d.table.columns[bl[s]].get(i)
                if bpred is not None and eval_expr_cpu(bpred, row) is not True:
                    continue
                kv = tuple(eval_expr_cpu(k, row) for k in bkeys)
                if any(v is None for v in kv):
                    continue
                ht.setdefault(tuple(canon_group_key(v) for v in kv),
                              []).append(i)
            hts.append(ht)
        self._host_hts = hts
        return hts

    def _host_chunk_agg(self, cc, states, displays, jnames, jlayout,
                        bound_groups, bound_aggs) -> None:
        """N-way join + aggregate one fact chunk row-by-row, host-exactly
        (handles multi-match fan-out of any width)."""
        hts = self._host_hash_tables()
        chunk = cc.host_chunk(self.probe)
        pl = self.probe.column_names
        playout = {n: i for i, n in enumerate(pl)}
        # probe keys bind over their SOURCE relation's layout: the fact for
        # star dims, the parent dimension's table for snowflake sub-dims
        dim_pkeys = []
        for d in self.dims:
            if d.src is None:
                dim_pkeys.append([bind_columns(k, playout)
                                  for k in d.probe_keys])
            else:
                pt = self.dims[d.src].table
                slay = {n: i for i, n in enumerate(pt.column_names)}
                dim_pkeys.append([bind_columns(k, slay)
                                  for k in d.probe_keys])
        ppred = bind_columns(self.probe_pred, playout) \
            if self.probe_pred is not None else None
        side = []
        for c in jnames:
            if c in self.probe.columns:
                side.append(("p", None))
            else:
                for di, d in enumerate(self.dims):
                    if c in d.table.columns:
                        side.append(("d", di))
                        break

        for i in range(chunk.nrows):
            prow = lambda s: chunk.columns[pl[s]].get(i)
            if ppred is not None and eval_expr_cpu(ppred, prow) is not True:
                continue
            # resolve dims in dependency order: each partial combo carries
            # one matched row per resolved dim, and a snowflake dim's keys
            # evaluate against its PARENT's matched row in that combo.
            # Inner-join semantics: a combo whose keys are NULL or
            # unmatched dies; the others survive.
            combos: list[tuple] = [()]
            for di, (dks, ht) in enumerate(zip(dim_pkeys, hts)):
                d = self.dims[di]
                nxt: list[tuple] = []
                for combo in combos:
                    if d.src is None:
                        row = prow
                    else:
                        pt = self.dims[d.src].table
                        pn = pt.column_names
                        pidx = combo[d.src]
                        row = (lambda s, pt=pt, pn=pn, pidx=pidx:
                               pt.columns[pn[s]].get(pidx))
                    kv = tuple(eval_expr_cpu(k, row) for k in dks)
                    if any(v is None for v in kv):
                        continue
                    lst = ht.get(tuple(canon_group_key(v) for v in kv))
                    for m in (lst or ()):
                        nxt.append(combo + (m,))
                combos = nxt
                if not combos:
                    break
            for combo in combos:
                def jrow(s):
                    c = jnames[s]
                    kind, di = side[s]
                    if kind == "p":
                        return chunk.columns[c].get(i)
                    return self.dims[di].table.columns[c].get(combo[di])
                kvals = tuple(eval_expr_cpu(g, jrow) for g in bound_groups)
                ck = tuple(canon_group_key(v) for v in kvals)
                if ck not in states:
                    states[ck] = [new_state(inst) for inst in bound_aggs]
                    displays[ck] = kvals
                st = states[ck]
                for inst, s in zip(bound_aggs, st):
                    update_state(inst, s,
                                 [eval_expr_cpu(a, jrow) for a in inst.args])
