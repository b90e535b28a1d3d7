"""Device program readiness — the opencl_devprog.c analog.

The reference builds device programs asynchronously and parks queries on
the build (opencl_devprog.c:128-250, 270-569); the JAX package runs a
query at a small fallback chunk size while XLA compiles the big-chunk
program behind it.  The port has one fixed kernel library per source
version, built by nvcc once, before the first launch: there is no cold
tier to park on, so the chosen capacity always stands.
"""

from __future__ import annotations

from .perfmon import span


def tiered_capacity(cap: int, device, pm=None) -> int:
    """Chunk capacity for this query: `cap`.  On a CUDA device this first
    ensures the kernel library is built and loaded, charging the build to
    the span "kernel_build" instead of the first dispatch."""
    if device.type == "cuda":
        from ..ops.cuda import library
        with span("kernel_build", pm):
            library()
    return cap
