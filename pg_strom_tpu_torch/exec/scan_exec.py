"""Streaming scan executor: device filter + row materialization.

The GpuScan execution path (reference §3.3, pg_strom_tpu/exec/scan_exec.py):
device-resident chunks (exec/devcache.py) -> the qual lowered over each
chunk -> a bit-packed match mask -> global row indexes on the host.
Chunks whose error lane fires, or whose rows need a host recheck, are
replayed with exact host predicate evaluation (the gpuscan_next_tuple
CPU-recheck analog, gpuscan.c:999-1056).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import config
from ..datastore import Table, Chunk
from ..expr.ir import Expr
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..expr.lower_torch import schema_from_chunk_columns
from ..ops.filter import build_filter_mask_fn, unpack_maskbits
from .devcache import CachedChunk, chunk_capacity, launch_chunks
from ..utils.perfmon import Perfmon


class ScanExecutor:
    """Yields global row indexes (int64 ndarray) of `table` rows passing
    `pred` (None = all).  Kept as numpy end to end: consumers gather with
    it directly."""

    def __init__(self, table: Table, pred: Optional[Expr],
                 perfmon: Perfmon | None = None, offload: bool = True):
        self.table = table
        self.pred = pred
        self.perfmon = perfmon or Perfmon()
        # cost-model verdict from the planner (plan/cost.py): False routes
        # this scan to the host tier (cost_gpuscan loses, gpuscan.c:101-231)
        self.offload = offload

    def row_indexes(self) -> np.ndarray:
        t = self.table
        if t.nrows == 0:
            return np.empty(0, np.int64)
        if self.pred is None:
            return np.arange(t.nrows, dtype=np.int64)
        use_device = (config.enabled and config.enable_tpuscan
                      and self.offload
                      and device_expression_supported(self.pred))
        out: list[np.ndarray] = []
        pm = self.perfmon
        if not use_device:
            for chunk in t.chunks():
                with pm.timer("cpu_fallback"):
                    out.append(self._replay(chunk))
            return np.concatenate(out) if out else np.empty(0, np.int64)
        names = t.column_names
        with pm.timer("prepare"):
            schema = schema_from_chunk_columns(
                names, [t.columns[n] for n in names])
            fn = build_filter_mask_fn(self.pred, schema)
        for cc, res in launch_chunks(
                t, names, chunk_capacity(t.nrows), pm,
                lambda cc: pm.device_call("tpuscan_qual", fn, cc.planes,
                                          cc.nrows)):
            out.append(self._consume(cc, res))
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def _consume(self, cc: CachedChunk, res) -> np.ndarray:
        """One chunk's row indexes: from its mask, or replayed on the host
        (res None: a chunk that needs the host; or its error lane set)."""
        pm = self.perfmon
        if res is not None and int(res[2]) == 0:
            pm.bump("device_chunks")
            bits = unpack_maskbits(res[0], cc.nrows)
            return np.flatnonzero(bits) + cc.start
        if res is not None:
            pm.bump("recheck_chunks")
        with pm.timer("cpu_fallback"):
            return self._replay(cc.host_chunk(self.table))

    def _replay(self, chunk: Chunk) -> np.ndarray:
        names = self.table.column_names
        cols = [chunk.columns[n] for n in names]
        out = []
        for i in range(chunk.nrows):
            if eval_expr_cpu(self.pred, lambda s: cols[s].get(i)) is True:
                out.append(chunk.start + i)
        return np.asarray(out, dtype=np.int64)
