"""Per-query performance counters and the port's spans.

The pgstrom_perfmon analog (reference pg_strom.h:174-213, harvested from
OpenCL event profiling in every respond callback and printed under
EXPLAIN ANALYZE when pg_strom.perfmon=on, main.c:441-660).  Phases are
spans (`span`): named host intervals from the planner down to the kernel
launches.  While a `torch.profiler` session records, each span is a
`pgstrom.<name>` range of the trace, on the clock of the device activity
and nested as the calls nest on the query's thread; while a query's
Perfmon is active under `config.perfmon`, its host time is summed into
`times[<name>]` for EXPLAIN ANALYZE.  Otherwise a span costs one check of
each and nothing more.  Byte counters track logical H2D/D2H traffic;
kernel device times come from CUDA events, read once the query's rows
are back.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from collections import defaultdict
from typing import Iterator

import torch
from torch.autograd import profiler as _profiler

from ..config import config

# the Perfmon of the query executing now (PlannedQuery.execute sets it), so
# that an op deep in a device function can count a route it took
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("perfmon",
                                                         default=None)

# A profiler range of RecordScope FUNCTION: kineto keeps it on the host
# timeline only.  `record_function`'s USER_SCOPE ranges are also copied onto
# the device timeline (gpu_user_annotation), where a trace reader that takes
# every device activity for busy time would count them as device work.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


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


class _NoSpan:
    """The span when nothing records: one shared, reusable no-op."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "pm", "rng", "t0")

    def __init__(self, name: str, pm, recording: bool):
        self.name = name
        self.pm = pm
        self.rng = _RANGE("pgstrom." + name) if recording else None

    def __enter__(self) -> None:
        if self.rng is not None:
            self.rng.__enter__()
        if self.pm is not None:
            self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        if self.pm is not None:
            self.pm._times[self.name] += time.perf_counter() - self.t0
            self.pm.counts[self.name] += 1
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False


def span(name: str, pm: "Perfmon | None" = None):
    """A context manager over one phase `name` of the executing query.

    Records the range `pgstrom.<name>` while a profiler session records,
    and adds the host time to `pm.times[name]` (`pm` defaults to the
    active query's Perfmon) under `config.perfmon`."""
    recording = _profiler._is_profiler_enabled
    if not config.perfmon:
        pm = None
    elif pm is None:
        pm = _ACTIVE.get()
    if pm is None and not recording:
        return _NO_SPAN
    return _Span(name, pm, recording)


def spanned(name: str):
    """Decorator: run the function in the span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return deco


class Perfmon:
    def __init__(self) -> None:
        self._times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        # (key, start event, end event) of CUDA device calls not read yet
        self._events: list = []

    @property
    def times(self) -> dict[str, float]:
        """Seconds by phase, and by `kernel <name>` the device time of each
        device function.  Its CUDA events are read here: once the query's
        rows are on the host every event has completed, and nothing
        waits."""
        for key, t0, t1 in self._events:
            t1.synchronize()
            self._times[key] += t0.elapsed_time(t1) / 1e3
        self._events.clear()
        return self._times

    def timer(self, phase: str):
        """The span `phase`, summed into this Perfmon."""
        return span(phase, self)

    def bump(self, counter: str, n: int = 1) -> None:
        self.counts[counter] += n

    def add_bytes(self, channel: str, n: int) -> None:
        self.bytes[channel] += n

    def device_call(self, kernel: str, fn, *args):
        """Dispatch `fn(*args)` in the span `device.<kernel>`, attributing
        its DEVICE time to `kernel <kernel>`.

        The per-kernel analog of the reference's OpenCL event profiling
        (clGetEventProfilingInfo per respond callback, gpuscan.c:1784-1866;
        rendered under EXPLAIN ANALYZE, main.c:504-660).  With perfmon on
        and a CUDA device, CUDA events on the current stream bracket the
        call and are read when `times` is, after the query's rows are
        back: the host never waits here.  On the CPU it is the host clock
        around the call."""
        if not config.perfmon:
            if not _profiler._is_profiler_enabled:
                return fn(*args)
            with _Span("device." + kernel, None, True):
                return fn(*args)
        key = f"kernel {kernel}"
        with span("device." + kernel, self):
            dev = torch.device(config.device)
            if dev.type == "cuda" and torch.cuda.is_available():
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = fn(*args)
                t1.record()
                self._events.append((key, t0, t1))
            else:
                h0 = time.perf_counter()
                out = fn(*args)
                self._times[key] += time.perf_counter() - h0
        self.counts[key] += 1
        return out

    def merge(self, other: "Perfmon") -> None:
        for k, v in other.times.items():
            self._times[k] += v
        for k, v in other.counts.items():
            self.counts[k] += v
        for k, v in other.bytes.items():
            self.bytes[k] += v

    def report_lines(self) -> list[str]:
        times = self.times
        out = []
        kernels = []
        for phase, t in sorted(times.items()):
            n = self.counts.get(phase, 0)
            avg = t / n if n else 0.0
            line = (f"{phase}: total {t*1e3:.3f}ms, calls {n}, "
                    f"avg {avg*1e3:.3f}ms")
            (kernels if phase.startswith("kernel ") else out).append(line)
        if kernels:
            # per-kernel device-time section (main.c:504-660 rendering)
            out.append("Device Kernels:")
            out.extend("  " + k for k in kernels)
        up = times.get("upload", 0.0)
        for ch, b in sorted(self.bytes.items()):
            # H2D over the span that moves it; D2H rides on device waits
            # that also hold kernel time, so it has no rate of its own
            rate = (f", {b / up / 1e9:.2f}GB/s"
                    if ch == "h2d" and b and up > 0 else "")
            out.append(f"{ch}: {b/1e6:.2f}MB{rate}")
        for c, n in sorted(self.counts.items()):
            if n and c not in times:
                out.append(f"{c}: {n}")
        return out
