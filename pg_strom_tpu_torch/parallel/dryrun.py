"""Multi-shard dry run of the distributed pipeline.

The port's analog of the reference's `dryrun_multichip`
(__graft_entry__.py): it runs the FULL distributed pipeline on an n-shard
mesh of `config.device` (n shards round-robin over the visible devices, so
one card or the CPU runs a virtual mesh and several cards a real one):

  1. a real SQL join+GROUP BY through sql.execute, routed over the flat
     mesh (exec/dist_exec.py), diffed against the single-device result;
  2. a forced overflow -> repartition ladder (dist_repartitions >= 1);
  2b. the same join+GROUP BY over the 2D (2, n/2) hosts x chips mesh: a
     two-stage exchange step must be built, and the rows must match;
  3. the raw shuffle step (parallel/shuffle.py).

    python -c "from pg_strom_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; print(dryrun_multichip(4))"

Raises AssertionError on any divergence; returns a summary dict.
"""

from __future__ import annotations

import numpy as np


def _close(a, b) -> bool:
    return len(a) == len(b) and all(
        hv == dv or (isinstance(hv, float)
                     and abs(hv - dv) <= 1e-9 * max(abs(hv), 1.0))
        for h, d in zip(a, b) for hv, dv in zip(h, d))


def dryrun_multichip(n_devices: int) -> dict:
    from ..config import override
    from ..datastore import Database, Table, column_from_values
    from ..sqltypes import T
    from ..sql.api import execute
    from ..sql.parser import parse
    from ..plan.planner import plan_query
    from .dist import BUILD_COUNTS
    from .mesh import get_mesh
    from .shuffle import (build_shuffle_join_agg_step,
                          host_merge_group_partials, run_shuffle_join_agg)

    out: dict = {"shards": n_devices}
    with override(mesh_shards=n_devices):
        # ---- 1. distributed SQL: planner -> mesh, vs single-device -----
        rng = np.random.default_rng(7)
        nf, nd = 96 * n_devices, 48
        db = Database()
        db.create(Table.from_columns("fact", {
            "k": column_from_values(T.INT4, [int(v) for v in
                                             rng.integers(0, nd, nf)]),
            "x": column_from_values(T.FLOAT8, [float(v) for v in
                                               rng.random(nf)]),
            "q": column_from_values(T.INT8, [int(v) for v in
                                             rng.integers(-99, 99, nf)]),
        }))
        db.create(Table.from_columns("dim", {
            "dk": column_from_values(T.INT4, list(range(nd))),
            "cat": column_from_values(T.TEXT,
                                      [f"c{i % 5}" for i in range(nd)]),
        }))
        q = ("select dim.cat, count(*), sum(fact.x), min(fact.q), "
             "max(fact.q) from fact, dim where fact.k = dim.dk "
             "group by dim.cat order by dim.cat")
        with override(debug_force_offload=True):
            local = execute(q, db).rows
        with override(distributed=True, debug_force_offload=True,
                      perfmon=True):
            pq = plan_query(parse(q), db)
            dist = pq.execute()
        assert pq.perfmon.counts.get("dist_steps", 0) == 1, (
            "distributed executor did not engage", dict(pq.perfmon.counts))
        assert _close(local, dist), (local, dist)
        out["flat_rows"] = len(dist)

        # ---- 2. overflow -> repartition contract ------------------------
        # groups hash-shard over the mesh, so the per-shard G ladder only
        # overflows when distinct keys > dist_group_slots * n_devices
        nd2 = 96 * n_devices + 64
        db.create(Table.from_columns("fact2", {
            "k": column_from_values(T.INT4, [int(v) for v in
                                             rng.integers(0, nd2,
                                                          4 * nd2)]),
            "x": column_from_values(T.FLOAT8, [float(v) for v in
                                               rng.random(4 * nd2)]),
        }))
        db.create(Table.from_columns("dim2", {
            "dk": column_from_values(T.INT4, list(range(nd2))),
        }))
        q2 = ("select fact2.k, count(*), sum(fact2.x) from fact2, dim2 "
              "where fact2.k = dim2.dk group by fact2.k order by fact2.k")
        with override(debug_force_offload=True):
            local2 = execute(q2, db).rows
        with override(distributed=True, debug_force_offload=True,
                      dist_group_slots=64, perfmon=True):
            pq2 = plan_query(parse(q2), db)
            dist2 = pq2.execute()
        assert _close(local2, dist2)
        out["repartitions"] = pq2.perfmon.counts.get("dist_repartitions", 0)
        assert out["repartitions"] >= 1, (
            "overflow->repartition ladder did not fire",
            dict(pq2.perfmon.counts))

        # ---- 2b. 2D hosts x chips mesh: the two-stage exchange ----------
        if n_devices % 2 == 0 and n_devices >= 4:
            n2d = BUILD_COUNTS["exchange_2stage"]
            with override(distributed=True, debug_force_offload=True,
                          dist_mesh_hosts=2, perfmon=True):
                pq3 = plan_query(parse(q), db)
                dist2d = pq3.execute()
            assert BUILD_COUNTS["exchange_2stage"] > n2d, (
                "a 2D hosts x chips request did not build a two-stage "
                "exchange step", BUILD_COUNTS)
            assert pq3.perfmon.counts.get("dist_steps", 0) == 1
            assert _close(local, dist2d), (local[:3], dist2d[:3])
            out["mesh_2d"] = f"2x{n_devices // 2}"

        # ---- 3. the raw shuffle step ------------------------------------
        mesh = get_mesh(n_devices)
        NP_, NB = 32 * n_devices, 16 * n_devices
        pk = rng.integers(0, 24, NP_).astype(np.int64)
        pv = rng.random(NP_).astype(np.float64)
        bk = rng.integers(0, 24, NB).astype(np.int64)
        bp = rng.integers(1, 5, NB).astype(np.int64)
        step = build_shuffle_join_agg_step(mesh, bucket_cap=256,
                                           nbuckets=64, max_chain=32, G=64)
        outs = run_shuffle_join_agg(step, mesh, pk, pv, np.ones(NP_, bool),
                                    bk, bp, np.ones(NB, bool))
        assert not any(bool(o[4].any()) for o in outs)
        from .shuffle import gather_host
        fk, fv, fcnt, fsum, _ovf = gather_host(outs)
        merged = host_merge_group_partials(fk, fv, fcnt, fsum)
        want: dict = {}
        for k, v in zip(pk, pv):
            for b, p in zip(bk, bp):
                if k == b:
                    c, s = want.get(int(k), (0, 0.0))
                    want[int(k)] = (c + 1, s + float(v) * int(p))
        assert set(merged) == set(want)
        assert all(merged[k][0] == want[k][0]
                   and abs(merged[k][1] - want[k][1])
                   <= 1e-9 * max(abs(want[k][1]), 1.0) for k in want)
        out["shuffle_groups"] = len(merged)
    return out
