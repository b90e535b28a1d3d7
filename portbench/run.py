"""Benchmark of pg_strom_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload ssb_sf20.q1_1 --seed 7 \\
        --seconds 10 --trace 0

Sets up the cell's data from the seed, warms up, runs a closed loop of
one client for --seconds, checks a sample of the answers against the
plain reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1 (the window under torch.profiler).  Exits non-zero without a
result when the cell's CUDA devices are missing or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "_cache")
# every cache a library of the run may write, at a fixed place in the
# checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from portbench.lib.cell import run_cell
    rc, result = run_cell(ROOT, a.workload, a.seed, a.seconds,
                          bool(a.trace), t_start=T_START)
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
