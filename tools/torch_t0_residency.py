#!/usr/bin/env python3
"""t0 of the port's chip smoke (models/testdb.py's schema, 2^27 rows by
default) under one checkout of the port and one table-cache budget:
agg_group cold and 3 warm under perfmon, the bytes each run uploads, the
bytes t0's planes hold on the card, and whether t0 stayed resident.

    python3 tools/torch_t0_residency.py [--root DIR] [--budget-mb N]
                                        [--rows-log2 27] [--seed 0]

--root is a checkout of the repo whose pg_strom_tpu_torch runs (default:
this one; only that package is taken from it); --budget-mb sets
tcache_size_mb (default: that checkout's own default).  The table, the
query and the numpy check are chip_smoke.py's phase 4b, always from this
checkout.  Needs a CUDA card; prints one JSON line with
the card's name and power limit.  To compare two checkouts, run them in
turns in one call on one card (A, B, B, A), one process each.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--budget-mb", type=int)
    ap.add_argument("--rows-log2", type=int, default=27)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_t0_residency: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import pg_strom_tpu_torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.config import config
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.ops import cuda as kc
    kc.library()
    gpu = cs._gpu_line()
    n = 1 << args.rows_log2
    # chip_smoke.phase_testdb's t0 (seed + 1)
    db, data = cs._t0_db(args.seed + 1, n)
    cfg = ({} if args.budget_mb is None
           else {"tcache_size_mb": args.budget_mb})
    runs = []
    with override(**cfg):
        TCACHE.clear()
        for _ in range(4):
            rows, counts, nbytes, dt = cs._run_qp(
                db, cs.T0_SQL["agg_group"], {})
            cs._check_t0("agg_group", rows, data)
            runs.append({"ms": dt * 1e3, "h2d": int(nbytes.get("h2d", 0)),
                         "tcache_hits": counts.get("tcache_hits", 0),
                         "device_chunks": counts.get("device_chunks", 0)})
        budget = TCACHE.budget_bytes()
        resident = [r["nbytes"] for r in TCACHE.info_rows()
                    if r["table_name"] == "t0" and r["kind"] == "chunks"]
        out = {"root": os.path.relpath(os.path.abspath(args.root), HERE),
               "package": os.path.relpath(os.path.dirname(
                   pg_strom_tpu_torch.__file__), HERE),
               "tcache_size_mb": config.tcache_size_mb,
               "budget_bytes": budget, "rows": n,
               "resident_bytes": resident[0] if resident else 0,
               "streamed_chunks": TCACHE.streamed,
               "cold_ms": runs[0]["ms"], "cold_h2d": runs[0]["h2d"],
               "warm_ms": [r["ms"] for r in runs[1:]],
               "warm_h2d": [r["h2d"] for r in runs[1:]],
               "runs": runs, "gpu": gpu,
               "device": torch.cuda.get_device_name(0),
               "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
