"""Device-resident columnar chunk cache — the tcache analog.

Reference: deadcode/tcache.c (a columnar cache so repeated scans skip
per-tuple deforming) and pg_strom_tpu/exec/devcache.py.  The datastore is
columnar at rest, so the cost the cache removes is per-query host slicing
/ padding and the host->device copy: chunk planes are uploaded once as
torch tensors on `config.device` and reused by every later query over the
same columns.

  - Keyed by the Column identities (Column.uid) and the device, not the
    Table: the planner re-wraps tables per query but shares Columns.
  - LRU eviction bounded by `config.tcache_size_mb`, whose default (0) is
    sized from the device: 40% of a CUDA card's memory; entries whose
    Columns were garbage collected are swept on access.
  - Chunks whose rows need host recheck (numeric outside the device
    window) carry planes=None — the executor replays them host-exactly.
  - Tables that would not fit in the budget stream: each chunk uploads,
    runs and is freed, uncached.
  - Auxiliary device state (join hash tables, pregrouped lookup tables)
    shares the same LRU and byte budget through put_aux / get_aux, the
    cross-query extension of the reference's DMA-hashtable-once pattern
    (gpuhashjoin.c:4497-4555).
  - launch_chunks is the executors' chunk pipeline over chunks_for: every
    chunk launched, outputs read back a drain at a time, host chunks
    handed back for replay in their place.
  - Launch plans (put_plan / get_plan) are an executor's state for its
    repeat queries over a cached chunk entry, kept on that entry: they
    leave the cache with it (eviction, replacement, a column garbage
    collected, clear), so a plan never serves or keeps stale planes.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..datastore import Table, Chunk
from ..expr.lower_torch import planes_of_column
from ..utils.perfmon import bump_active, span


# the default budget when config.device is the CPU (tests, rehearsals)
CPU_BUDGET_MB = 8192
# launch plans a cached chunk entry keeps (put_plan), the oldest dropped
MAX_PLANS = 16


def device() -> torch.device:
    """The configured execution device.  "cuda" with no GPU raises — the
    port never runs on the CPU unless told to (config.device = "cpu")."""
    d = torch.device(config.device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "config.device is 'cuda' but torch.cuda.is_available() is "
            "False; set config.device = 'cpu' to run the plain PyTorch "
            "versions of the kernels")
    return d


def _next_pow2(n: int, lo: int = 1024) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def chunk_capacity(nrows: int) -> int:
    """Canonical chunk capacity for a table: one shared value across the
    executors so they share cache entries."""
    return min(config.chunk_rows, _next_pow2(max(nrows, 1)))


def fetch_host(tree):
    """Device->host read of a result tree: every tensor leaf to numpy by
    its own `.cpu()` (each waits for the device; counted in the executing
    query's `d2h_reads`); other leaves as is."""
    if isinstance(tree, torch.Tensor):
        bump_active("d2h_reads")
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: fetch_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_host(v) for v in tree)
    return tree


def _upload(planes: tuple, dev: torch.device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                 for p in planes)


@dataclasses.dataclass
class CachedChunk:
    """One resident (or streamed) chunk: static metadata + device planes."""

    table_name: str
    start: int
    nrows: int
    capacity: int
    recheck_any: bool
    planes: Optional[tuple]      # per-column plane tuples; None => host path
    streamed: bool = False       # uploaded for this query only, not cached

    def host_chunk(self, table: Table) -> Chunk:
        """(Re)build the host-side padded chunk, e.g. for CPU replay."""
        return Chunk.from_table(table, self.start, self.start + self.nrows,
                                self.capacity)


@dataclasses.dataclass
class _Entry:
    table_name: str
    kind: str                    # 'chunks' | 'aux'
    chunks: Optional[list[CachedChunk]]
    aux: Any
    nbytes: int
    col_refs: list               # weakrefs keeping eviction honest
    hits: int = 0
    # launch plans over this entry's chunks, by the executor's key
    plans: dict = dataclasses.field(default_factory=dict)

    def alive(self) -> bool:
        return all(r() is not None for r in self.col_refs)


def _pytree_nbytes(tree: Any) -> int:
    """Bytes of every tensor or ndarray leaf of a dict / list / tuple tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(_pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_pytree_nbytes(v) for v in tree)
    return 0


class DeviceChunkCache:
    def __init__(self) -> None:
        self._lru: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # every LRU mutation holds this lock; chunk uploads happen outside
        # it (a generator must not hold a lock across yields)
        self._mu = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.streamed = 0        # chunks served uncached (budget/disabled)
        # set by a weakref callback when a cached entry's Column dies: the
        # sweep scans the LRU only then
        self._dead = False

    def budget_bytes(self) -> int:
        """The byte budget: `tcache_size_mb` when set, else 40% of the
        configured CUDA device's memory (in whole MiB), or 8192 MiB on the
        CPU."""
        mb = int(config.tcache_size_mb)
        if mb == 0:
            dev = torch.device(config.device)
            if dev.type != "cuda":
                return CPU_BUDGET_MB << 20
            total = torch.cuda.get_device_properties(dev).total_memory
            return (total * 2 // 5) >> 20 << 20
        return mb << 20

    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._lru.values())

    def clear(self) -> None:
        with self._mu:
            self._lru.clear()

    def _refs(self, cols: Sequence) -> list:
        return [weakref.ref(c, self._column_died) for c in cols]

    def _column_died(self, _ref) -> None:
        self._dead = True

    def _sweep(self) -> None:
        if not self._dead:
            return
        self._dead = False
        dead = [k for k, e in self._lru.items() if not e.alive()]
        for k in dead:
            del self._lru[k]

    def _evict_to_fit(self, incoming: int) -> None:
        budget = self.budget_bytes()
        while self._lru and self.total_bytes() + incoming > budget:
            self._lru.popitem(last=False)
            self.evictions += 1

    @staticmethod
    def _chunks_key(table: Table, names: Sequence[str], cap: int,
                    dev: torch.device) -> tuple:
        ids = tuple(table.columns[n].uid for n in names)
        if not ids:
            # count(*)-style empty layouts: key on the table's own columns
            # (+nrows) so two tables can never share an entry
            ids = ("norows", table.nrows) + tuple(
                c.uid for c in table.columns.values())
        return ("chunks", ids, cap, str(dev))

    def chunks_for(self, table: Table, names: Sequence[str], cap: int,
                   pm=None) -> Iterator[CachedChunk]:
        """Yield this table's chunks with planes on the configured device,
        cached when the table fits the byte budget."""
        dev = device()
        cols = [table.columns[n] for n in names]
        n = table.nrows
        if n == 0:
            return
        if not (config.enabled and config.enable_tcache):
            yield from self._stream(table, names, n, cap, dev, pm)
            return

        key = self._chunks_key(table, names, cap, dev)
        with span("chunks", pm), self._mu:
            self._sweep()
            ent = self._lru.get(key)
            if ent is not None:
                self._lru.move_to_end(key)
                ent.hits += 1
                self.hits += 1
        if ent is not None:
            if pm is not None:
                pm.bump("tcache_hits")
            yield from ent.chunks
            return

        if not self._fits(cols, n, cap):
            yield from self._stream(table, names, n, cap, dev, pm)
            return

        self.misses += 1
        if pm is not None:
            pm.bump("tcache_misses")
        chunks: list[CachedChunk] = []
        nbytes = 0
        for start in range(0, n, cap):
            with span("chunks", pm):
                cc, up = self._load(table, names, start,
                                    min(start + cap, n), cap, dev, pm)
            nbytes += up
            chunks.append(cc)
            yield cc
        with self._mu:
            self._evict_to_fit(nbytes)
            self._lru[key] = _Entry(table_name=table.name, kind="chunks",
                                    chunks=chunks, aux=None, nbytes=nbytes,
                                    col_refs=self._refs(cols))

    def _fits(self, cols: Sequence, n: int, cap: int) -> bool:
        """Whether n rows of cols, in chunks of cap, fit the byte budget."""
        est = -(-n // cap) * cap * sum(
            sum(p.dtype.itemsize for p in planes_of_column(c)) for c in cols)
        return est <= self.budget_bytes()

    def cached_chunks(self, table: Table, names: Sequence[str], cap: int,
                      pm=None) -> Optional[list[CachedChunk]]:
        """The table's chunks as chunks_for caches them (loaded now where
        they are not resident), or None where chunks_for would stream
        them."""
        if not (config.enabled and config.enable_tcache and table.nrows
                and self._fits([table.columns[n] for n in names],
                               table.nrows, cap)):
            return None
        return list(self.chunks_for(table, names, cap, pm))

    def _load(self, table: Table, names, start: int, stop: int, cap: int,
              dev: torch.device, pm) -> tuple[CachedChunk, int]:
        hc = Chunk.from_table(table, start, stop, cap)
        if hc.row_recheck.any():
            return CachedChunk(table.name, start, stop - start, cap, True,
                               None), 0
        host_planes = [planes_of_column(hc.columns[nm]) for nm in names]
        up = sum(p.nbytes for ps in host_planes for p in ps)
        if pm is not None:
            pm.add_bytes("h2d", up)
        with span("upload", pm):
            planes = tuple(_upload(ps, dev) for ps in host_planes)
        return CachedChunk(table.name, start, stop - start, cap, False,
                           planes), up

    def _stream(self, table: Table, names, n: int, cap: int,
                dev: torch.device, pm=None) -> Iterator[CachedChunk]:
        for start in range(0, n, cap):
            self.streamed += 1
            with span("chunks", pm):
                cc = self._load(table, names, start, min(start + cap, n),
                                cap, dev, pm)[0]
            cc.streamed = True
            yield cc

    # -- auxiliary device state (join hash tables) ---------------------------

    def get_aux(self, key: tuple, pm=None) -> Any:
        with span("chunks", pm), self._mu:
            self._sweep()
            ent = self._lru.get(("aux",) + key)
            if ent is None:
                return None
            self._lru.move_to_end(("aux",) + key)
            ent.hits += 1
            self.hits += 1
        if pm is not None:
            pm.bump("tcache_hits")
        return ent.aux

    def put_aux(self, key: tuple, value: Any, table_name: str,
                cols: Sequence = ()) -> None:
        """Cache `value` (a tree of tensors) under `key` while every Column
        of `cols` lives; counts against tcache_size_mb like chunk planes."""
        if not (config.enabled and config.enable_tcache):
            return
        nbytes = _pytree_nbytes(value)
        if nbytes > self.budget_bytes():
            return
        with self._mu:
            self.misses += 1
            self._evict_to_fit(nbytes)
            self._lru[("aux",) + key] = _Entry(
                table_name=table_name, kind="aux", chunks=None, aux=value,
                nbytes=nbytes, col_refs=self._refs(cols))

    # -- launch plans ---------------------------------------------------------

    def get_plan(self, table: Table, names: Sequence[str], cap: int,
                 key: tuple) -> Any:
        """The launch plan filed under `key` on the table's cached chunk
        entry (chunks_for's), or None.  A hit counts as a use of that
        entry (its LRU place, its hits)."""
        if not (config.enabled and config.enable_tcache):
            return None
        ckey = self._chunks_key(table, names, cap, device())
        with self._mu:
            self._sweep()
            ent = self._lru.get(ckey)
            plan = ent.plans.get(key) if ent is not None else None
            if plan is not None:
                self._lru.move_to_end(ckey)
                ent.hits += 1
        return plan

    def put_plan(self, table: Table, names: Sequence[str], cap: int,
                 key: tuple, plan: Any) -> bool:
        """File `plan` under `key` on the table's cached chunk entry; False,
        and nothing filed, when the entry is not cached now.  An entry
        keeps its MAX_PLANS newest plans."""
        if not (config.enabled and config.enable_tcache):
            return False
        ckey = self._chunks_key(table, names, cap, device())
        with self._mu:
            self._sweep()
            ent = self._lru.get(ckey)
            if ent is None:
                return False
            ent.plans.pop(key, None)
            if len(ent.plans) >= MAX_PLANS:
                del ent.plans[next(iter(ent.plans))]
            ent.plans[key] = plan
        return True

    def info_rows(self) -> list[dict]:
        with self._mu:
            self._sweep()
            entries = list(self._lru.values())
        return [{"table_name": e.table_name, "kind": e.kind,
                 "nchunks": len(e.chunks) if e.chunks else 0,
                 "nbytes": e.nbytes, "hits": e.hits} for e in entries]


TCACHE = DeviceChunkCache()


def launch_chunks(table: Table, names: Sequence[str], cap: int, pm,
                  dispatch: Callable[[CachedChunk], Any]
                  ) -> Iterator[tuple[CachedChunk, Any]]:
    """The chunk pipeline over the table's chunks as TCACHE.chunks_for
    serves them.  Each device chunk is launched by `dispatch(cc)` (the
    caller's `pm.device_call`) in the span `dispatch`; the outputs are read
    back together, one fetch_host a drain in the span `device_wait`: every
    `config.max_async_chunks` streamed chunks, which bounds the device
    memory they hold, and once after the last chunk.  Yields (chunk, its
    host output) in launch order at each drain, and (chunk, None) for a
    chunk that needs the host (recheck_any) where it comes, for the
    caller to replay; the caller may stop early."""
    pending: list = []
    streamed = 0
    for cc in itertools.chain(TCACHE.chunks_for(table, names, cap, pm),
                              [None]):
        if cc is not None:
            if cc.recheck_any:
                yield cc, None
                continue
            with pm.timer("dispatch"):
                pending.append((cc, dispatch(cc)))
            streamed += cc.streamed
            if not cc.streamed or streamed < config.max_async_chunks:
                continue
        streamed = 0              # a drain: the window is full, or the end
        if pending:
            with pm.timer("device_wait"):
                outs = fetch_host([out for _, out in pending])
            drained, pending = pending, []
            yield from zip([c for c, _ in drained], outs)
