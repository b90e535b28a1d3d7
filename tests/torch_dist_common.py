"""Shared rig of the port's distributed SQL tests
(tests/test_torch_dist_*.py), which mirror tests/test_dist.py.

The reference runs on its 8 virtual CPU devices (tests/conftest.py); the
port on an 8-shard mesh of the CPU (`mesh_shards=8`).  Every query runs
through both planners on the same data, and:

- rows must be equal as PostgreSQL text at extra_float_digits=-3;
- the `dist_*` perfmon counters must be equal;
- where tests/test_dist.py holds the distributed rows against its
  single-device plan, the port's distributed rows must equal the port's
  single-device plan too, under test_dist.py's own rule (floats within
  1e-9 relative).
"""

from __future__ import annotations

from typing import Optional

import jax

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult

NDEV = len(jax.devices())
DIST = {"distributed": True, "debug_force_offload": True}


def dist_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items()
            if k.startswith("dist_") and k != "dist_prepare"}


class Run:
    """One package's run of one query: rows as text, rows, counters and
    byte counters."""

    def __init__(self, pq, rows, Result):
        self.text = Result(columns=pq.out_names, rows=rows,
                           types=pq.out_types).formatted(-3)
        self.rows = rows
        self.counts = dict(pq.perfmon.counts)
        self.bytes = dict(pq.perfmon.bytes)
        self.dist = dist_counts(self.counts)


def ref_run(sql: str, rdb, **cfg) -> Run:
    with R.override(perfmon=True, **cfg):
        pq = r_plan_query(r_ast.parse(sql), rdb)
        return Run(pq, pq.execute(), RResult)


def port_run(sql: str, pdb, **cfg) -> Run:
    cfg = dict({"mesh_shards": NDEV}, **cfg)
    with P.override(device="cpu", perfmon=True, **cfg):
        pq = p_plan_query(p_ast.parse(sql), pdb)
        return Run(pq, pq.execute(), PResult)


def port_db(rdb):
    return from_reference(rdb)


def both(rdb, sql: str, pdb=None, local: bool = True,
         cfg: Optional[dict] = None) -> tuple[Run, Run]:
    """(reference run, port run) of `sql` under DIST plus `cfg`; asserts
    equal rows and equal dist_* counters, and (local=True) the port's
    distributed rows equal to its single-device plan's."""
    pdb = pdb if pdb is not None else port_db(rdb)
    c = dict(DIST, **(cfg or {}))
    r = ref_run(sql, rdb, **c)
    p = port_run(sql, pdb, **c)
    assert p.text == r.text, (sql, p.text[:4], r.text[:4])
    assert p.dist == r.dist, (sql, p.dist, r.dist)
    if local:
        h = port_run(sql, pdb, debug_force_offload=True)
        assert rows_equal(h.rows, p.rows), (sql, p.rows[:4], h.rows[:4])
    return r, p


def rows_equal(local, dist) -> bool:
    """tests/test_dist.py's comparison: floats within 1e-9 relative."""
    if len(local) != len(dist):
        return False
    for h, d in zip(local, dist):
        for hv, dv in zip(h, d):
            if isinstance(hv, float) and isinstance(dv, float):
                if not (hv == dv or (hv != hv and dv != dv)
                        or abs(hv - dv) <= 1e-9 * max(abs(hv), abs(dv),
                                                      1.0)):
                    return False
            elif hv != dv:
                return False
    return True
