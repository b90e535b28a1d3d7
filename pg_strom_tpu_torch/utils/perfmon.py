"""Per-query performance counters.

The pgstrom_perfmon analog (reference pg_strom.h:174-213, harvested from
OpenCL event profiling in every respond callback and printed under
EXPLAIN ANALYZE when pg_strom.perfmon=on, main.c:441-660).  Here the phases
are: host chunk prep, device dispatch, device wait, result
materialization, CPU-fallback replay; byte counters track logical H2D/D2H
traffic; kernel device times come from CUDA events.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict
from typing import Iterator

from ..config import config

# the Perfmon of the query executing now (PlannedQuery.execute sets it), so
# that an op deep in a device function can count a route it took
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("perfmon",
                                                         default=None)


@contextlib.contextmanager
def active(pm: "Perfmon") -> Iterator[None]:
    """Make `pm` the counter target of bump_active while the block runs."""
    tok = _ACTIVE.set(pm)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def bump_active(counter: str, n: int = 1) -> None:
    """Bump `counter` on the executing query's Perfmon, if there is one."""
    pm = _ACTIVE.get()
    if pm is not None:
        pm.bump(counter, n)


class Perfmon:
    def __init__(self) -> None:
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, phase: str) -> Iterator[None]:
        if not config.perfmon:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def bump(self, counter: str, n: int = 1) -> None:
        self.counts[counter] += n

    def add_bytes(self, channel: str, n: int) -> None:
        if config.perfmon:
            self.bytes[channel] += n

    def device_call(self, kernel: str, fn, *args):
        """Dispatch `fn(*args)` attributing its DEVICE time to `kernel`.

        The per-kernel analog of the reference's OpenCL event profiling
        (clGetEventProfilingInfo per respond callback, gpuscan.c:1784-1866;
        rendered under EXPLAIN ANALYZE, main.c:504-660).  With perfmon on
        and a CUDA device, CUDA events on the current stream bracket the
        call and the host waits for the end event, so the recorded time is
        the device's; on the CPU it is the host clock around the call.
        perfmon off: zero overhead."""
        if not config.perfmon:
            return fn(*args)
        import torch
        dev = torch.device(config.device)
        if dev.type == "cuda" and torch.cuda.is_available():
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args)
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            h0 = time.perf_counter()
            out = fn(*args)
            dt = time.perf_counter() - h0
        self.times[f"kernel {kernel}"] += dt
        self.counts[f"kernel {kernel}"] += 1
        return out

    def merge(self, other: "Perfmon") -> None:
        for k, v in other.times.items():
            self.times[k] += v
        for k, v in other.counts.items():
            self.counts[k] += v
        for k, v in other.bytes.items():
            self.bytes[k] += v

    def report_lines(self) -> list[str]:
        out = []
        kernels = []
        for phase, t in sorted(self.times.items()):
            n = self.counts.get(phase, 0)
            avg = t / n if n else 0.0
            line = (f"{phase}: total {t*1e3:.3f}ms, calls {n}, "
                    f"avg {avg*1e3:.3f}ms")
            (kernels if phase.startswith("kernel ") else out).append(line)
        if kernels:
            # per-kernel device-time section (main.c:504-660 rendering)
            out.append("Device Kernels:")
            out.extend("  " + k for k in kernels)
        for ch, b in sorted(self.bytes.items()):
            t = self.times.get("dispatch" if ch == "h2d" else "device_wait",
                               0.0)
            # transfer bandwidth over the phase that carried the bytes
            bw = (b / t / 1e9) if t > 0 else 0.0
            out.append(f"{ch}: {b/1e6:.2f}MB"
                       + (f", {bw:.2f}GB/s" if bw else ""))
        for c in ("device_chunks", "recheck_chunks", "tcache_hits",
                  "dist_steps", "dist_repartitions", "dist_skew_routed",
                  "dist_distinct_steps", "dist_resident_hits",
                  "dist_star_steps", "devprog_tier_fallbacks",
                  "fanout_retries", "salt_retries", "sort_fallbacks",
                  "dense_fallbacks", "k4_shape_routed", "topk_packed",
                  "topk_threshold", "topk_adaptive", "topk_exact",
                  "unported_host_exact"):
            if self.counts.get(c):
                out.append(f"{c}: {self.counts[c]}")
        return out
