#!/usr/bin/env python3
"""The float sum lanes' digit window under one checkout of the port, on
the card: the window's fault tables through every column-sum route, and
the main path's warm times (the flagship on K1 and t0's agg_group on K2).

    python3 tools/torch_sum_window_ab.py [--root DIR] [--rows-log2 27]
                                         [--seed 0]

--root is a checkout of the repo whose pg_strom_tpu_torch runs (default:
this one; only that package is taken from it).  The tables, queries and
numpy checks are chip_smoke.py's, always from this checkout:

- fault tables, 4096 rows in one chunk, groups k = 0 and 1 alternating:
  x float4 1.0 beside 1e30, y float8 1e-30 beside 1.0, s float4
  subnormals beside 1.0; sum and avg of each on K1 (v2; float4 only),
  K2, K4 and the plain mxu_reduce, each against the port's host tier as
  PostgreSQL text, with recheck_chunks and group 0's shadow sums as the
  host's replay decision read them;
- the flagship (phase 4, 2^rows-log2 rows) and agg_group (phase 4b's t0,
  under perfmon), cold and 5 warm each, checked against numpy outside
  the time;
- K1 alone at the flagship's first chunk and K2 alone at agg_group's
  (G = 32), CUDA events, three times 10 launches.

Needs a CUDA card; prints one JSON line with the card's name and power
limit.  To compare two checkouts, run them in turns in one call on one
card (A, B, B, A), one process each.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# route -> settings; every route groups by k on the dense-key strategy,
# so bucket 0 is group 0
ROUTES = {"K1": {},
          "K2": {"use_fused_preagg2": False},
          "K4": {"use_fused_preagg": False, "use_pallas_reduce": True},
          "mxu_reduce": {"use_fused_preagg": False}}


def _fault_db(P):
    import numpy as np
    n = 4096
    k = (np.arange(n) % 2).astype(np.int32)
    sub = np.asarray([1.4e-45, 1e-40, 3e-39], np.float32)[np.arange(n) % 3]
    cols = {"k": P.column_from_numpy(P.T.INT4, k),
            "x": P.column_from_numpy(P.T.FLOAT4, np.where(
                k == 0, 1.0, 1e30).astype(np.float32)),
            "y": P.column_from_numpy(P.T.FLOAT8, np.where(k == 0, 1e-30,
                                                          1.0)),
            "s": P.column_from_numpy(P.T.FLOAT4, np.where(
                k == 0, sub, np.float32(1.0)).astype(np.float32))}
    db = P.Database()
    db.create(P.Table.from_columns("t", cols))
    return db


def _faults(P) -> dict:
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.ops import preagg_mxu
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    from pg_strom_tpu_torch.sql.api import Result
    db = _fault_db(P)
    seen = []
    real = preagg_mxu.mxu_overflow

    def spy(out, *a):
        import numpy as np
        fs = np.asarray(out["mxu_fsums"])
        seen.append(fs[0].tolist() if fs.shape[1] else [])
        return real(out, *a)
    preagg_mxu.mxu_overflow = spy

    def run(sql, cfg):
        seen.clear()
        with override(perfmon=True, debug_force_offload=True,
                      debug_force_tpupreagg=True, **cfg):
            pq = plan_query(ast.parse(sql), db)
            rows = pq.execute()
        return (Result(columns=pq.out_names, rows=rows,
                       types=pq.out_types).formatted(-3),
                dict(pq.perfmon.counts), list(seen))

    out = {}
    try:
        for col in ("x", "y", "s"):
            for route, cfg in ROUTES.items():
                if route == "K1" and col == "y":
                    continue               # no v2 plan sums a float8
                sql = (f"select k, sum({col}), avg({col}) from t group by k "
                       "order by k")
                host = run(sql, {"enabled": False})[0]
                rows, counts, shadows = run(sql, cfg)
                out[f"{col}_{route}"] = {
                    "rows": rows, "host": host, "equal": rows == host,
                    "recheck_chunks": counts.get("recheck_chunks", 0),
                    "group0_shadows": shadows[0] if shadows else None}
    finally:
        preagg_mxu.mxu_overflow = real
    return out


def _timed(run, n_warm: int = 5) -> dict:
    """run() checks one query's rows and returns the query's own ms and
    its perfmon phase seconds."""
    runs = [run() for _ in range(1 + n_warm)]
    times = [ms for ms, _ in runs]
    return {"cold_ms": times[0], "warm_ms": times[1:],
            "warm_median_ms": statistics.median(times[1:]),
            "warm_phases_s": [ph for _, ph in runs[1:]]}


def _k1_chunk_ms(cs, db) -> list:
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.expr.ir import Const, resolve_function
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.preagg_fused2 import (
        derive_v2_plan, fused2_cuda, _kernel_planes)
    t = db.get("t")
    c = cs._cols(t)
    pred = resolve_function(">", (c["x"], Const(type=T.FLOAT4, value=0.25)))
    cols = [t.columns[nm] for nm in t.column_names]
    plan = derive_v2_plan(
        cols, schema_from_chunk_columns(t.column_names, cols), [c["key"]],
        [cs._agg("sum", c["x"]), cs._agg("count", c["x"]),
         cs._agg("sum", c["y"])], pred, 4096)
    cc = next(iter(TCACHE.chunks_for(t, t.column_names,
                                     chunk_capacity(t.nrows))))
    scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
            "f4e": plan.f4e}
    planes = _kernel_planes(plan.sig, cc.planes)
    return [cs._time(lambda: fused2_cuda(plan.sig, planes, cc.nrows, scal,
                                         plan.G, pred), 10)
            for _ in range(3)]


def _k2_chunk_ms(cs, db) -> list:
    import torch
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    keys, aggs, vals, mask, seg, n = cs._t0_chunk_lanes(db, 32)
    plan, _ = pf._plan_cached(
        tuple(k.t for k in keys), tuple(tuple(a.slots) for a in aggs),
        tuple(tuple(v.t for v in vs) for vs in vals), True, True)
    inputs, scales, _ = pf.encode_lanes(keys, aggs, vals, mask, plan, True)
    sc = torch.stack(scales).float()
    seg = seg.to(torch.int32).contiguous()
    return [cs._time(lambda: pf.fused_cuda(plan, seg, inputs, sc, 32, n), 10)
            for _ in range(3)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows-log2", type=int, default=27)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_sum_window_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import pg_strom_tpu_torch as P
    from pg_strom_tpu_torch import execute
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.ops import cuda as kc
    kc.library()
    gpu = cs._gpu_line()
    res = {"root": os.path.relpath(os.path.abspath(args.root), HERE),
           "package": os.path.relpath(os.path.dirname(P.__file__), HERE),
           "gpu": gpu, "faults": _faults(P)}
    n = 1 << args.rows_log2

    db, data = cs._flagship_db(args.seed, n)
    want = cs._flagship_expected(data)
    TCACHE.clear()

    def flagship():
        t0 = time.perf_counter()
        rows = execute(cs.FLAGSHIP_SQL, db).rows
        dt = (time.perf_counter() - t0) * 1e3
        cs._check_flagship(rows, want)
        return dt, {}
    res["flagship"] = _timed(flagship)
    res["k1_chunk_ms"] = _k1_chunk_ms(cs, db)
    del db, data
    TCACHE.clear()
    torch.cuda.empty_cache()

    # chip_smoke.phase_testdb's t0 (seed + 1)
    db, data = cs._t0_db(args.seed + 1, n)

    def agg_group():
        rows, counts, info, dt = cs._run_qp(db, cs.T0_SQL["agg_group"], {})
        cs._check_t0("agg_group", rows, data)
        if counts.get("recheck_chunks", 0):
            raise AssertionError(f"agg_group replayed: {counts}")
        return dt * 1e3, {k: v for k, v in info.items() if k.endswith("_s")}
    res["agg_group"] = _timed(agg_group)
    res["k2_chunk_ms"] = _k2_chunk_ms(cs, db)
    res["at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
