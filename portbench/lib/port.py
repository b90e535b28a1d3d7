"""The benchmark's one door into the system under test,
`pg_strom_tpu_torch`: load the generated planes, run SQL, split a query
into plan and execution for the traced run, read its perfmon counters,
and free its state.  Nothing else under `portbench/` imports the program.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.lib.dataset import Dataset

_TYPES = {"int4": "INT4", "int8": "INT8", "float4": "FLOAT4",
          "float8": "FLOAT8", "date": "DATE", "text": "TEXT"}

# perfmon counters of the executors' retry ladder
LADDER_COUNTERS = ("salt_retries", "sort_fallbacks", "dense_fallbacks",
                   "regrow_retries", "fanout_retries", "recheck_chunks")


def check_package(root: str) -> None:
    """Import the program from this checkout, or fail."""
    import pg_strom_tpu_torch
    where = os.path.abspath(os.path.dirname(pg_strom_tpu_torch.__file__))
    if not where.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"pg_strom_tpu_torch comes from {where}, "
                           f"not from the checkout {root}")


def set_device(device: str) -> None:
    from pg_strom_tpu_torch import set_config
    set_config("device", device)


def init_device(device: str) -> None:
    """The CUDA context and the program's kernel library (built at first
    use into its `_build/` directory inside the checkout)."""
    if device != "cuda":
        return
    import torch
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    from pg_strom_tpu_torch.ops import cuda as kernels
    kernels.library()


def load(data: Dataset):
    from pg_strom_tpu_torch import Column, Database, Table, T
    from pg_strom_tpu_torch import column_from_numpy
    db = Database()
    for name, cols in data.tables.items():
        pcols = {}
        for cname, c in cols.items():
            t = getattr(T, _TYPES[c.type])
            if c.type == "text":
                pcols[cname] = Column(type=t, data=c.data,
                                      valid=np.ones(len(c.data), np.bool_),
                                      dictionary=list(c.dictionary))
            else:
                pcols[cname] = column_from_numpy(t, c.data)
        db.create(Table.from_columns(name, pcols))
    return db


def column_statistics(db, reads: dict) -> None:
    """The planner's statistics of the columns the cell reads; the first
    query would gather them otherwise."""
    from pg_strom_tpu_torch.datastore import column_stats
    for table, cols in reads.items():
        for c in cols:
            column_stats(db.get(table).column(c))


def execute(sql: str, db) -> list[tuple]:
    from pg_strom_tpu_torch.sql.api import execute as run
    return run(sql, db).rows


def plan(sql: str, db):
    """Parse, bind, cost and plan: the first half of `api.execute` for a
    SELECT; `.execute()` of the result is the second."""
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser
    return plan_query(parser.parse(sql), db)


def explain(sql: str, db) -> str:
    from pg_strom_tpu_torch.sql.api import explain as ex
    return ex(sql, db)


def explain_analyze(sql: str, db) -> str:
    from pg_strom_tpu_torch.sql.api import execute as run
    return "\n".join(r[0] for r in run("EXPLAIN ANALYZE " + sql, db).rows)


def ladder_counts(sql: str, db) -> dict:
    """Run one query with perfmon on; its retry-ladder counters."""
    from pg_strom_tpu_torch import override
    pq = plan(sql, db)
    with override(perfmon=True):
        pq.execute()
    return {k: int(pq.perfmon.counts.get(k, 0)) for k in LADDER_COUNTERS}


def free(db) -> None:
    """Drop the program's device state: its chunk cache and the tables."""
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    TCACHE.clear()
    for name in list(db.tables):
        db.drop(name)
