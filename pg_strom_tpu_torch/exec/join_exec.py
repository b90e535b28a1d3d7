"""Hash-join executor: device build once, streamed probe, exact fallback.

The execution shape of the reference (pg_strom_tpu/exec/join_exec.py,
§3.4 call stack): the inner (build) relation is hashed once and kept
device-resident across every outer chunk and across queries (the
DMA-once pattern, gpuhashjoin.c:4497-4555, through the device cache's aux
space); outer chunks stream through the probe with the same bounded async
window as scans; result overflow re-dispatches with a doubled output
buffer (the DataStoreNoSpace regrow, gpuhashjoin.c:4323-4425); flagged
chunks fall back to an exact host hash join (gpuhashjoin_next_tuple CPU
recheck, gpuhashjoin.c:2706-2772).

A unique single-int-key build side takes the row-aligned dense probe:
the identity branch for a serial key, K3 (ops/mxu_lookup.py) when the
keys span at most 2^16 slots, else a plain gather.  Probe row ids come
back chunk-local and are offset by the chunk start; the host gathers of
the output columns stay in numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..datastore import Table, Chunk, Column, column_from_values
from ..sqltypes import T
from ..expr.ir import Expr
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..expr.lower_torch import schema_from_chunk_columns, planes_of_column
from ..ops.hashjoin import (
    build_hash_table, build_probe_fn, build_probe_dense_fn, dense_cap_for,
    mxu_dense_window, _next_pow2,
)
from .devcache import TCACHE, chunk_capacity, device, fetch_host, \
    launch_chunks
from .hostexec import canon_group_key
from ..utils.devprog import tiered_capacity
from ..utils.perfmon import Perfmon


class HashJoinExecutor:
    """Equi-join: outer (probe) x inner (build); inner / left / full.

    probe_keys / build_keys: bound exprs over the respective table layouts.
    Output: a host Table with columns "<alias>.<col>" for the requested
    (side, column) pairs.

    jointype:
      inner — matched pairs only
      left  — plus probe rows with no (residual-surviving) match,
              build columns NULL-extended
      full  — plus unmatched build rows, probe columns NULL-extended
      (RIGHT is planned as LEFT with sides swapped.)
    residual: extra ON condition bound to the JOINED layout — a pair matches
    only if it passes; evaluated with the scan executor over the assembled
    pair table.  For outer joins probe_pred must be None (ON quals gate
    matching, never probe-row survival) and for full joins build_pred must
    be None too."""

    def __init__(self, probe: Table, build: Table,
                 probe_keys: Sequence[Expr], build_keys: Sequence[Expr],
                 out_probe_cols: Sequence[str], out_build_cols: Sequence[str],
                 probe_pred: Optional[Expr] = None,
                 build_pred: Optional[Expr] = None,
                 probe_alias: Optional[str] = "o",
                 build_alias: Optional[str] = "i",
                 jointype: str = "inner",
                 residual: Optional[Expr] = None,
                 perfmon: Perfmon | None = None, offload: bool = True):
        # alias=None => output columns keep their source names (planner
        # pre-renames tables to "alias.col", so names are already unique)
        self.probe = probe
        self.build = build
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.out_probe_cols = list(out_probe_cols)
        self.out_build_cols = list(out_build_cols)
        self.probe_pred = probe_pred
        self.build_pred = build_pred
        self.probe_alias = probe_alias
        self.build_alias = build_alias
        self.jointype = jointype
        self.residual = residual
        if jointype not in ("inner", "left", "full"):
            raise ValueError(f"join type {jointype!r}")
        if jointype != "inner" and probe_pred is not None:
            raise ValueError("an outer join takes no probe-side predicate")
        if jointype == "full" and build_pred is not None:
            raise ValueError("a full join takes no build-side predicate")
        self.perfmon = perfmon or Perfmon()
        # cost-model verdict (plan/cost.py cost_tpuhashjoin vs cost_hashjoin)
        self.offload = offload
        self._host_ht: dict | None = None
        self._track = jointype != "inner" or residual is not None
        self._pair_p: list[np.ndarray] = []   # global probe row ids per piece
        self._pair_b: list[np.ndarray] = []   # build row ids per piece

    def _pname(self, c: str) -> str:
        return c if self.probe_alias is None else f"{self.probe_alias}.{c}"

    def _bname(self, c: str) -> str:
        return c if self.build_alias is None else f"{self.build_alias}.{c}"

    # -- device build --------------------------------------------------------

    def _device_ok(self) -> bool:
        exprs = self.probe_keys + self.build_keys
        if self.probe_pred is not None:
            exprs.append(self.probe_pred)
        if self.build_pred is not None:
            exprs.append(self.build_pred)
        if any(not device_expression_supported(e) for e in exprs):
            return False
        # text join keys need a shared dictionary: they join on the host
        if any(k.type in (T.TEXT, T.BPCHAR)
               for k in self.probe_keys + self.build_keys):
            return False
        return True

    def run(self) -> Table:
        collected = {self._pname(c): [] for c in self.out_probe_cols}
        collected.update({self._bname(c): [] for c in self.out_build_cols})
        self._bview, self._boff = self.build, 0

        use_device = (config.enabled and config.enable_tpuhashjoin
                      and self.offload
                      and self._device_ok() and self.build.nrows > 0)
        if not use_device:
            self._host_join_all(collected)
            return self._finish(collected)

        # nloops partitioning (gpuhashjoin.c:322-431 estimate+divide,
        # 3565-3816 threshold split with outer rescan): a build side whose
        # device footprint exceeds the budget is row-sliced into nloops
        # partitions; the probe stream rescans once per partition (any
        # disjoint row partition of the build is exact).  Host fallbacks
        # inside a pass join against THAT partition only, so the union over
        # passes stays exact.
        budget = max(int(config.join_build_hbm_mb), 1) << 20
        est = self._build_bytes_est()
        nloops = 1
        while est // nloops > budget and nloops < 256:
            nloops *= 2
        if nloops > 1:
            self.perfmon.bump("nloops_passes", nloops)
            step = -(-self.build.nrows // nloops)
            for p0 in range(nloops):
                lo = p0 * step
                hi = min(self.build.nrows, lo + step)
                if lo >= hi:
                    break
                self._bview = _slice_table(self.build, lo, hi)
                self._boff = lo
                self._host_ht = None          # pass-scoped host hash table
                if not self._device_pass(collected):
                    self._host_join_all(collected)   # partition-local
            self._bview, self._boff = self.build, 0
            self._host_ht = None
            return self._finish(collected)
        if not self._device_pass(collected):
            self._host_join_all(collected)
        return self._finish(collected)

    def _build_bytes_est(self) -> int:
        """Device footprint estimate of the build side: column planes +
        hash-table lanes (keys, order, buckets ~ 3 int64/row)."""
        b = 0
        for c in self.build.columns.values():
            b += c.data.nbytes + c.valid.nbytes
            if c.num_exp is not None:
                b += c.num_exp.nbytes + c.num_dscale.nbytes
        return b + 24 * max(self.build.nrows, 1)

    def _hash_table(self, bl: list[str], bcap: int, row_bits: int):
        """The build view's device hash table, from the device cache or
        built now; None when the build side cannot go on the device."""
        pm = self.perfmon
        # keyed on the PARENT table's column uids + the partition row range
        # (_slice_table mints fresh Columns per query)
        parent_cols = [self.build.columns[n] for n in bl]
        ht_key = ("join_ht", tuple(c.uid for c in parent_cols),
                  (self._boff, self._bview.nrows), str(device()),
                  tuple(self.build_keys), self.build_pred, bcap, row_bits)
        ht = TCACHE.get_aux(ht_key, pm)
        if ht is not None:
            return ht
        bchunk = next(iter(self._bview.chunks(bcap)))
        if bchunk.row_recheck.any():
            return None
        bschema = schema_from_chunk_columns(bl, [bchunk.columns[n] for n in bl])
        dev = device()
        bplanes = tuple(
            tuple(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in planes_of_column(bchunk.columns[n])) for n in bl)
        build_fn = build_hash_table(bschema, self.build_keys, self.build_pred,
                                    row_bits=row_bits)
        with pm.timer("build_hash"):
            ht = build_fn(bplanes, bchunk.nrows)
        if int(ht["err"]) != 0:
            return None
        # anchor liveness on the parent columns — the sliced view dies at the
        # end of the query, which would instantly evict the entry
        TCACHE.put_aux(ht_key, ht, self._bview.name, parent_cols)
        return ht

    def _device_pass(self, collected) -> bool:
        """Device build+probe of the probe stream against self._bview.
        Returns False when the build side itself can't go on device (the
        caller host-joins this partition)."""
        pm = self.perfmon
        with pm.timer("prepare"):
            bl = self._bview.column_names
            bcap = _next_pow2(max(self._bview.nrows, 16))
            key_types = tuple(k.type for k in self.build_keys)
            row_bits = max(self._bview.nrows, 1).bit_length()
            ht = self._hash_table(bl, bcap, row_bits)
            if ht is None:
                return False
            nbuckets = int(ht["bucket_start"].shape[0]) - 1

            pl = self.probe.column_names
            pcap = tiered_capacity(chunk_capacity(self.probe.nrows),
                                   device(), pm)
            pschema = schema_from_chunk_columns(pl, [self.probe.columns[n]
                                                     for n in pl])
            out_cap = max(2 * pcap, 1024)
            max_chain = config.join_max_bucket_probe

            def get_probe_fn(cap_now):
                return build_probe_fn(pschema, self.probe_keys, key_types,
                                      nbuckets, max_chain, cap_now,
                                      self.probe_pred)

            # single-int-key unique build => row-aligned dense probe (one
            # lookup, no regrow): identity for a serial key, else K3 when
            # the keys span its window, else a plain gather
            use_dense = bool(ht["dense_ok"])
            dense_fn = None
            if use_dense:
                use_ident = bool(ht["dense_ident"])
                use_mxu = (not use_ident and config.join_mxu_lookup
                           and bool(ht["dense_m_ok"]))
                dcap_p = mxu_dense_window(bcap) if use_mxu \
                    else dense_cap_for(bcap)
                dense_fn = build_probe_dense_fn(
                    pschema, self.probe_keys, dcap_p, self.probe_pred,
                    use_mxu=use_mxu, row_bits=row_bits, use_ident=use_ident)
            chain_fn = None if use_dense else get_probe_fn(out_cap)

        def dispatch(cc):
            if use_dense:
                return pm.device_call("tpujoin_probe_dense", dense_fn, ht,
                                      cc.planes, cc.nrows)
            return pm.device_call("tpujoin_probe", chain_fn, ht, cc.planes,
                                  cc.nrows)

        for cc, res in launch_chunks(self.probe, pl, pcap, pm, dispatch):
            self._consume(cc, res, use_dense, out_cap, get_probe_fn, ht,
                          collected)
        return True

    def _consume(self, cc, res, use_dense, out_cap, get_probe_fn, ht,
                 collected) -> None:
        """Materialize one probe chunk's pairs, or join it on the host (res
        None: a chunk that needs the host; or its error lane set)."""
        pm = self.perfmon
        if res is not None and use_dense:
            matched, build_rows, nout, err = res
            if int(err) == 0:
                with pm.timer("materialize"):
                    probe_idx = np.flatnonzero(matched).astype(np.int32)
                    self._materialize(cc.start, probe_idx,
                                      build_rows[probe_idx], collected)
                pm.bump("device_chunks")
                return
        elif res is not None:
            probe_idx, build_row, nout, err = res
            cap_now = out_cap
            while int(err) == 0 and int(nout) > cap_now:
                # DataStoreNoSpace analog: regrow and re-dispatch
                pm.bump("regrow_retries")
                cap_now = _next_pow2(int(nout))
                probe_idx, build_row, nout, err = fetch_host(
                    get_probe_fn(cap_now)(ht, cc.planes, cc.nrows))
            if int(err) == 0:
                nout_i = int(nout)
                with pm.timer("materialize"):
                    self._materialize(cc.start, probe_idx[:nout_i],
                                      build_row[:nout_i], collected)
                pm.bump("device_chunks")
                return
        if res is not None:
            pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            self._host_join_chunk(cc.host_chunk(self.probe), collected)

    # -- materialization -----------------------------------------------------

    def _materialize(self, chunk_start: int, probe_idx: np.ndarray,
                     build_row: np.ndarray,
                     collected: dict[str, list]) -> None:
        # vectorized plane gathers (kern_gpuhashjoin_projection_row analog,
        # opencl_hashjoin.h:437-689); probe indexes are chunk-local, so
        # offset to table-global rows
        pidx = np.asarray(probe_idx, np.int64) + chunk_start
        for c in self.out_probe_cols:
            collected[self._pname(c)].append(
                ("planes", _gather_planes(self.probe.columns[c], pidx)))
        for c in self.out_build_cols:
            collected[self._bname(c)].append(
                ("planes", _gather_planes(self._bview.columns[c], build_row)))
        if self._track:
            self._pair_p.append(pidx)
            self._pair_b.append(np.asarray(build_row, np.int64) + self._boff)

    def _to_table(self, collected: dict[str, list]) -> Table:
        cols: dict[str, Column] = {}
        probe_names = {self._pname(c): c for c in self.out_probe_cols}
        build_names = {self._bname(c): c for c in self.out_build_cols}
        for name, pieces in collected.items():
            if name in probe_names:
                src_col = self.probe.columns[probe_names[name]]
            else:
                src_col = self.build.columns[build_names[name]]
            ctype = src_col.type
            if pieces and all(k == "planes" for k, _ in pieces):
                cols[name] = _concat_planes(ctype, src_col,
                                            [pl for _, pl in pieces])
                continue
            # mixed host/device pieces: go through python values
            values: list = []
            for kind, payload in pieces:
                if kind == "planes":
                    tmp = _concat_planes(ctype, src_col, [payload])
                    values.extend(tmp.get(i) for i in range(len(tmp)))
                else:
                    values.extend(payload)
            if ctype in (T.TEXT, T.BPCHAR) and src_col.dictionary is not None:
                # re-encode against the SOURCE dictionary (every value came
                # from src_col): the outer-join NULL-extension pieces in
                # _finish gather ORIGINAL codes, and _concat_tables assumes
                # one shared code space per column
                code = {s: i for i, s in enumerate(src_col.dictionary)}
                data = np.zeros(len(values), dtype=src_col.data.dtype)
                valid = np.zeros(len(values), dtype=np.bool_)
                for i, v in enumerate(values):
                    if v is not None:
                        valid[i] = True
                        data[i] = code[v]
                cols[name] = Column(type=ctype, data=data, valid=valid,
                                    dictionary=src_col.dictionary)
            else:
                cols[name] = column_from_values(ctype, values)
        return Table.from_columns("join_result", cols)

    # -- residual ON + outer-join NULL extension ------------------------------

    def _finish(self, collected: dict[str, list]) -> Table:
        t = self._to_table(collected)
        if not self._track:
            return t
        pidx = (np.concatenate(self._pair_p) if self._pair_p
                else np.empty(0, np.int64))
        bidx = (np.concatenate(self._pair_b) if self._pair_b
                else np.empty(0, np.int64))
        if self.residual is not None:
            # a pair matches only if the residual ON condition holds — run
            # the scan executor over the assembled pair table
            from .scan_exec import ScanExecutor
            from ..expr.ir import bind_columns
            lp = {n: i for i, n in enumerate(t.column_names)}
            keep = np.asarray(ScanExecutor(
                t, bind_columns(self.residual, lp),
                self.perfmon).row_indexes(), dtype=np.int64)
            t = _take_rows(t, keep)
            pidx, bidx = pidx[keep], bidx[keep]
        if self.jointype == "inner":
            return t
        matched_p = np.zeros(self.probe.nrows, np.bool_)
        matched_p[pidx] = True
        parts = [t, self._extend(np.flatnonzero(~matched_p), True)]
        if self.jointype == "full":
            matched_b = np.zeros(self.build.nrows, np.bool_)
            matched_b[bidx] = True
            parts.append(self._extend(np.flatnonzero(~matched_b), False))
        return _concat_tables(parts)

    def _extend(self, idxs: np.ndarray, probe_side: bool) -> Table:
        """Preserved-side rows at idxs, other side NULL-extended."""
        cols: dict[str, Column] = {}
        for c in self.out_probe_cols:
            src = self.probe.columns[c]
            cols[self._pname(c)] = (_col_gather(src, idxs) if probe_side
                                    else _col_null(src, len(idxs)))
        for c in self.out_build_cols:
            src = self.build.columns[c]
            cols[self._bname(c)] = (_col_null(src, len(idxs)) if probe_side
                                    else _col_gather(src, idxs))
        return Table.from_columns("join_ext", cols)

    # -- host exact path -----------------------------------------------------

    def _host_hash_table(self) -> dict:
        """Hash table over the CURRENT build view (whole table, or one
        nloops partition) with GLOBAL build row ids."""
        if self._host_ht is not None:
            return self._host_ht
        ht: dict = {}
        bv = self._bview
        bl = bv.column_names
        for i in range(bv.nrows):
            row = lambda s: bv.columns[bl[s]].get(i)
            if self.build_pred is not None and \
                    eval_expr_cpu(self.build_pred, row) is not True:
                continue
            kv = tuple(eval_expr_cpu(k, row) for k in self.build_keys)
            if any(v is None for v in kv):
                continue
            ht.setdefault(tuple(canon_group_key(v) for v in kv),
                          []).append(i + self._boff)
        self._host_ht = ht
        return ht

    def _host_join_chunk(self, chunk: Chunk, collected: dict[str, list]) -> None:
        ht = self._host_hash_table()
        pl = self.probe.column_names
        pvals = {c: [] for c in self.out_probe_cols}
        bvals = {c: [] for c in self.out_build_cols}
        pp, pb = [], []
        for i in range(chunk.nrows):
            row = lambda s: chunk.columns[pl[s]].get(i)
            if self.probe_pred is not None and \
                    eval_expr_cpu(self.probe_pred, row) is not True:
                continue
            kv = tuple(eval_expr_cpu(k, row) for k in self.probe_keys)
            if any(v is None for v in kv):
                continue
            for bi in ht.get(tuple(canon_group_key(v) for v in kv), ()):
                for c in self.out_probe_cols:
                    pvals[c].append(chunk.columns[c].get(i))
                for c in self.out_build_cols:
                    bvals[c].append(self.build.columns[c].get(bi))
                if self._track:
                    pp.append(chunk.start + i)
                    pb.append(bi)
        for c in self.out_probe_cols:
            collected[self._pname(c)].append(("vals", pvals[c]))
        for c in self.out_build_cols:
            collected[self._bname(c)].append(("vals", bvals[c]))
        if self._track:
            self._pair_p.append(np.asarray(pp, np.int64))
            self._pair_b.append(np.asarray(pb, np.int64))

    def _host_join_all(self, collected: dict[str, list]) -> None:
        for chunk in self.probe.chunks():
            self._host_join_chunk(chunk, collected)


def _slice_table(t: Table, lo: int, hi: int) -> Table:
    """Row-range view [lo, hi) sharing the underlying plane memory."""
    cols: dict[str, Column] = {}
    for nm, c in t.columns.items():
        nc = Column(type=c.type, data=c.data[lo:hi], valid=c.valid[lo:hi],
                    dictionary=c.dictionary)
        if c.type is T.NUMERIC:
            nc.num_exp = c.num_exp[lo:hi]
            nc.num_dscale = c.num_dscale[lo:hi]
            nc.recheck = c.recheck[lo:hi]
            if nc.recheck.any():
                for i, d in c._exact.items():
                    if lo <= i < hi:
                        nc._exact[i - lo] = d
        cols[nm] = nc
    return Table.from_columns(f"{t.name}[{lo}:{hi}]", cols)


def _gather_planes(col: Column, idx: np.ndarray) -> dict:
    """Vectorized numpy gather of every plane of col at idx."""
    idx = np.asarray(idx, dtype=np.int64)
    out = {"data": col.data[idx], "valid": col.valid[idx]}
    if col.type is T.NUMERIC:
        out["exp"] = col.num_exp[idx]
        out["dscale"] = col.num_dscale[idx]
        out["recheck"] = col.recheck[idx]
        if out["recheck"].any():
            out["exact"] = {int(p): col._exact[int(idx[p])]
                            for p in np.flatnonzero(out["recheck"])}
    return out


def _concat_planes(ctype, src_col: Column, pieces: list[dict]) -> Column:
    def cat(key, dtype):
        return (np.concatenate([p[key] for p in pieces]) if pieces
                else np.empty(0, dtype=dtype))
    col = Column(type=ctype, data=cat("data", src_col.data.dtype),
                 valid=cat("valid", np.bool_), dictionary=src_col.dictionary)
    if ctype is T.NUMERIC:
        col.num_exp = cat("exp", np.int32)
        col.num_dscale = cat("dscale", np.int32)
        col.recheck = cat("recheck", np.bool_)
        off = 0
        for p in pieces:
            for pos, d in p.get("exact", {}).items():
                col._exact[off + pos] = d
            off += len(p["data"])
    return col


def _col_gather(c: Column, idx: np.ndarray) -> Column:
    idx = np.asarray(idx, dtype=np.int64)
    nc = Column(type=c.type, data=c.data[idx], valid=c.valid[idx],
                dictionary=c.dictionary)
    if c.type is T.NUMERIC:
        nc.num_exp = c.num_exp[idx]
        nc.num_dscale = c.num_dscale[idx]
        nc.recheck = c.recheck[idx]
        for newpos in np.flatnonzero(nc.recheck):
            nc._exact[int(newpos)] = c._exact[int(idx[newpos])]
    return nc


def _col_null(like: Column, n: int) -> Column:
    nc = Column(type=like.type, data=np.zeros(n, dtype=like.data.dtype),
                valid=np.zeros(n, dtype=np.bool_), dictionary=like.dictionary)
    if like.type is T.NUMERIC:
        nc.num_exp = np.zeros(n, dtype=np.int32)
        nc.num_dscale = np.zeros(n, dtype=np.int32)
        nc.recheck = np.zeros(n, dtype=np.bool_)
    return nc


def _take_rows(t: Table, idx: np.ndarray) -> Table:
    return Table.from_columns(t.name, {nm: _col_gather(c, idx)
                                       for nm, c in t.columns.items()})


def _concat_tables(parts: list[Table]) -> Table:
    parts = [p for p in parts if p.nrows > 0] or parts[:1]
    if len(parts) == 1:
        return parts[0]
    cols: dict[str, Column] = {}
    for nm in parts[0].column_names:
        cs = [p.columns[nm] for p in parts]
        c0 = cs[0]
        if c0.dictionary is not None and any(
                c.dictionary is not c0.dictionary
                and list(c.dictionary or ()) != list(c0.dictionary)
                for c in cs[1:]):
            # parts encode against different dictionaries: remap every
            # piece's codes into the sorted union before concatenating
            # (code order must stay C-collation order for device compares)
            union = sorted(set().union(*[set(c.dictionary or ())
                                         for c in cs]))
            code = {s: i for i, s in enumerate(union)}
            datas = []
            for c in cs:
                d = list(c.dictionary or ())
                lut = np.array([code[s] for s in d] or [0],
                               dtype=c.data.dtype)
                safe = np.clip(c.data, 0, max(len(d) - 1, 0))
                datas.append(np.where(c.valid, lut[safe], 0)
                             .astype(c.data.dtype))
            cols[nm] = Column(type=c0.type, data=np.concatenate(datas),
                              valid=np.concatenate([c.valid for c in cs]),
                              dictionary=union)
            continue
        nc = Column(type=c0.type,
                    data=np.concatenate([c.data for c in cs]),
                    valid=np.concatenate([c.valid for c in cs]),
                    dictionary=c0.dictionary)
        if c0.type is T.NUMERIC:
            nc.num_exp = np.concatenate([c.num_exp for c in cs])
            nc.num_dscale = np.concatenate([c.num_dscale for c in cs])
            nc.recheck = np.concatenate([c.recheck for c in cs])
            off = 0
            for c in cs:
                if c.recheck is not None and c.recheck.any():
                    for i, d in c._exact.items():
                        nc._exact[off + int(i)] = d
                off += len(c)
        cols[nm] = nc
    return Table.from_columns(parts[0].name, cols)
