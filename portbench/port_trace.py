"""A traced run of one cell, read down to the program's own spans.

    python3 portbench/port_trace.py --workload ssb_sf20.q1_1 --seed 7 \\
        --seconds 10 [--out FILE]

Runs the cell as `portbench/run.py --trace 1` does, from the same
harness, and reads the same trace once more with `lib/portspans.py`:
the device's idle time by the innermost span open, its device time by
the span open at each launch (and the share with no launch found), and
three per-layer quantities of the program's layers:

  exec_prepare_ms_p50   median of the `pgstrom.prepare` time inside each
                        `<template>.exec`: host work before the launches
  kernel_busy_share     device time launched inside `pgstrom.K1`-`K4`
                        over the device busy time inside the exec spans, %
  h2d_bytes_per_query   perfmon's `h2d` bytes of the window's queries, a
                        query

The tables go to standard error; the run's result line, with these under
`port_spans`, is the last line of standard output (and `--out`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import portbench.run  # noqa: E402,F401  (the caches inside the checkout)


def traced_run(root: str, workload: str, seed: int, seconds: float,
               device: str = "cuda", t_start: float | None = None,
               config_override: dict | None = None):
    """(exit code, result) of a traced run with `port_spans` added."""
    from portbench.lib import cell, port, portspans

    kept: dict = {}
    perfmons: list = []
    real_reduce, real_plan = cell.reduce, port.plan

    def reduce_and_keep(prof, names):
        kept["events"] = portspans.events(prof)
        kept["names"] = set(names)
        return real_reduce(prof, names)

    def plan_and_keep(sql, db):
        from torch.autograd import profiler
        pq = real_plan(sql, db)
        if profiler._is_profiler_enabled:     # a query of the window
            perfmons.append(pq.perfmon)
        return pq

    cell.reduce, port.plan = reduce_and_keep, plan_and_keep
    try:
        rc, result = cell.run_cell(root, workload, seed, seconds, True,
                                   device=device, t_start=t_start,
                                   config_override=config_override)
    finally:
        cell.reduce, port.plan = real_reduce, real_plan
    if result is None or "events" not in kept:
        return rc, result
    attr = portspans.attribute(kept["events"], kept["names"])
    nq = max(len(attr.exec_spans()), 1)
    # a program with spans counts h2d bytes with perfmon off
    counts_bytes = any(n.startswith(portspans.PREFIX) for n in attr.spans)
    evs = kept["events"]
    out = {
        "exec_prepare_ms_p50": portspans.exec_prepare_ms_p50(attr),
        "kernel_busy_share": portspans.kernel_busy_share(attr),
        "h2d_bytes_per_query": portspans.h2d_bytes_per_query(
            perfmons if counts_bytes else None),
        "queries": nq,
        # program spans opened (each also runs, untraced, as a no-op)
        "spans_per_query": sum(len(v) for n, v in attr.spans.items()
                               if n.startswith(portspans.PREFIX)) / nq,
        "device_side_program_spans": sum(
            e.device and e.name.startswith(portspans.PREFIX) for e in evs),
        "busy_s": attr.busy_s,
        "device_s": attr.device_s,
        "unmatched_device_share": (attr.unmatched_s / attr.device_s
                                   if attr.device_s else None),
        "exec_idle_ms_per_query": attr.exec_idle_s * 1e3 / nq,
        "exec_idle_port_share": (attr.exec_idle_port_s / attr.exec_idle_s
                                 if attr.exec_idle_s else None),
        "idle_ms_per_query": portspans.per_query_ms(attr.idle, nq),
        "device_ms_per_query": portspans.per_query_ms(attr.device, nq),
    }
    result["port_spans"] = out
    log = cell.log
    log(f"port spans: {nq} exec spans; device busy {attr.busy_s:.6f} s, "
        f"operations {attr.device_s:.6f} s, unmatched "
        f"{out['unmatched_device_share']}")
    log("idle ms a query by innermost span: " + ", ".join(
        f"{n} {v:.4f}" for n, v in out["idle_ms_per_query"]))
    log("device ms a query by span at launch: " + ", ".join(
        f"{n} {v:.4f}" for n, v in out["device_ms_per_query"]))
    log(f"idle inside exec spans {out['exec_idle_ms_per_query']:.4f} ms a "
        f"query, under a program span: {out['exec_idle_port_share']}")
    for k in ("exec_prepare_ms_p50", "kernel_busy_share",
              "h2d_bytes_per_query"):
        log(f"{k} {out[k]!r}")
    return rc, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    rc, result = traced_run(ROOT, a.workload, a.seed, a.seconds,
                            t_start=T_START)
    if result is not None:
        line = json.dumps(result)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "w") as f:
                f.write(line + "\n")
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
