"""Introspection virtual tables.

The reference exposes runtime internals as SQL SRFs
(pgstrom_shmem_info / pgstrom_shmem_active_info / pgstrom_mqueue_info /
pgstrom_opencl_device_info / pgstrom_opencl_program_info — SURVEY §2 rows
2,3,7,9; pg_strom--1.0.sql:9-92).  Here the same surface is a set of
virtual tables materialized on access:

  pgstrom_device_info   — torch devices of config.device (platform, kind, id)
  pgstrom_program_info  — the device program state (the devprog cache
                          analog): the CUDA kernel library's sources with
                          their build state, and the executor's plan memos
  pgstrom_arena_info    — native buddy-arena stats (shmem_info analog)
  pgstrom_tcache_info   — the device-resident chunk cache
  pgstrom_config_info   — every GUC with its current value

native.data_arena() registers the ingest arena at its creation, so the
arena and slab tables show the live planes of COPY loads and query chunks.
"""

from __future__ import annotations

import os
from typing import Optional

from ..sqltypes import T
from ..datastore import Table, column_from_values
from ..config import show_all

_ARENAS: list = []   # Arena objects registered for visibility
_MQUEUES: list = []  # (name, MQueue) pairs registered for visibility


def register_arena(a) -> None:
    _ARENAS.append(a)


def register_mqueue(name: str, q) -> None:
    _MQUEUES.append((name, q))


def _device_rows() -> list[tuple]:
    """(id, platform, device_kind, process_index) of the configured device:
    one row per CUDA device, or one "cpu" row."""
    import torch
    from ..exec.devcache import device
    if device().type == "cuda":
        return [(i, "gpu", torch.cuda.get_device_name(i), 0)
                for i in range(torch.cuda.device_count())]
    return [(0, "cpu", "cpu", 0)]


def _program_rows() -> list[tuple]:
    """(kind, plan_key): each kernel source with the library's build state
    and this process's build seconds, then the executor's plan memos."""
    from ..ops import cuda as kernels
    from ..exec import preagg_exec
    built = os.path.exists(kernels.library_path())
    secs = kernels.build_seconds
    rows = [(f"kernel:{'built' if built else 'not built'}",
             f"{src} ({'-' if secs is None else f'{secs:.3f}'}s)")
            for src in kernels.SOURCES]
    for memo, kind in ((preagg_exec._LADDER_MEMO, "preagg_ladder"),
                       (preagg_exec._GROUP_STATS, "preagg_groups")):
        for key in list(memo):
            rows.append((kind, repr(key)[:120]))
    return rows


def virtual_table(name: str) -> Optional[Table]:
    if name == "pgstrom_device_info":
        devs = _device_rows()
        return Table.from_columns(name, {
            "id": column_from_values(T.INT4, [d[0] for d in devs]),
            "platform": column_from_values(T.TEXT, [d[1] for d in devs]),
            "device_kind": column_from_values(T.TEXT, [d[2] for d in devs]),
            "process_index": column_from_values(T.INT4,
                                                [d[3] for d in devs]),
        })
    if name == "pgstrom_program_info":
        rows = _program_rows()
        return Table.from_columns(name, {
            "kind": column_from_values(T.TEXT, [r[0] for r in rows]),
            "plan_key": column_from_values(T.TEXT, [r[1] for r in rows]),
        })
    if name == "pgstrom_arena_info":
        stats = [a.stats() for a in _ARENAS]
        return Table.from_columns(name, {
            "zone": column_from_values(T.INT4, list(range(len(stats)))),
            "size": column_from_values(T.INT8, [s["size"] for s in stats]),
            "bytes_live": column_from_values(T.INT8, [s["bytes_live"] for s in stats]),
            "n_alloc": column_from_values(T.INT8, [s["n_alloc"] for s in stats]),
            "n_free": column_from_values(T.INT8, [s["n_free"] for s in stats]),
        })
    if name == "pgstrom_slab_info":
        # small-object slab classes over the buddy arena (the
        # pgstrom_shmem_slab_info SRF analog, reference shmem.c:1178-1252)
        rows = []
        for zone, a in enumerate(_ARENAS):
            try:
                for r in a.slab_stats():
                    rows.append((zone, r))
            except Exception:
                continue
        return Table.from_columns(name, {
            "zone": column_from_values(T.INT4, [z for z, _ in rows]),
            "size": column_from_values(T.INT8, [r["size"] for _, r in rows]),
            "n_alloc": column_from_values(T.INT8,
                                          [r["n_alloc"] for _, r in rows]),
            "n_free": column_from_values(T.INT8,
                                         [r["n_free"] for _, r in rows]),
            "n_objects": column_from_values(T.INT8,
                                            [r["n_objects"]
                                             for _, r in rows]),
        })
    if name == "pgstrom_mqueue_info":
        # the pgstrom_mqueue_info SRF analog (reference mqueue.c:592)
        return Table.from_columns(name, {
            "name": column_from_values(T.TEXT, [n for n, _ in _MQUEUES]),
            "depth": column_from_values(T.INT8,
                                        [q.depth() for _, q in _MQUEUES]),
        })
    if name == "pgstrom_tcache_info":
        # device-resident chunk cache (the tcache analog, exec/devcache.py)
        from ..exec.devcache import TCACHE
        rows = TCACHE.info_rows()
        return Table.from_columns(name, {
            "table_name": column_from_values(T.TEXT, [r["table_name"] for r in rows]),
            "kind": column_from_values(T.TEXT, [r["kind"] for r in rows]),
            "nchunks": column_from_values(T.INT4, [r["nchunks"] for r in rows]),
            "nbytes": column_from_values(T.INT8, [r["nbytes"] for r in rows]),
            "hits": column_from_values(T.INT8, [r["hits"] for r in rows]),
        })
    if name == "pgstrom_config_info":
        cfg = show_all()
        keys = sorted(cfg)
        return Table.from_columns(name, {
            "name": column_from_values(T.TEXT, keys),
            "setting": column_from_values(T.TEXT, [str(cfg[k]) for k in keys]),
        })
    return None
