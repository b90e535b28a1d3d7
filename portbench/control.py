"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision lower (every sum in float32),
judged by the same comparison against the reference in its own
precision.  It has to come out not correct.  Not part of a run.

    python3 portbench/control.py --workload ssb_sf20.q1_1 \\
        --seeds 101 102 103

For each seed it builds the cell's data at the cell's size, takes the
queries a run would check (`check_per_template` of each template from
the window's stream, and as many again), and prints the numbers compared
with their limits.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import cell, check, traffic  # noqa: E402


def readings(mix: dict, data, seed: int, n_queries: int) -> dict:
    stream = traffic.queries(mix, seed)
    qs = [next(stream) for _ in range(n_queries)]
    want = cell.reference_answers(qs, mix, data, "float64")
    got = cell.reference_answers(qs, mix, data, "float32")
    mismatched, gap = 0, 0.0
    for (g, _, _), (w, exact, ordered) in zip(got, want):
        bad, x = check.compare(g, w, exact, ordered)
        mismatched += bad
        gap = max(gap, x)
    limits = mix["limits"]
    out = {"mismatched_answers": {"value": mismatched,
                                  "limit": limits["mismatched_answers"]}}
    if "float_rel_gap" in limits:
        out["float_rel_gap"] = {"value": gap,
                                "limit": limits["float_rel_gap"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    _, wl, cfg, mix = cell.load_cell(ROOT, a.workload)
    gen = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    n = 2 * int(mix["check_per_template"]) * len(mix["templates"])
    for seed in a.seeds:
        t = time.perf_counter()
        data = gen.generate(cfg, seed)
        r = readings(mix, data, seed, n)
        correct = all(c["value"] <= c["limit"] for c in r.values())
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_correct": correct, "checks": r,
                          "seconds": round(time.perf_counter() - t, 3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
