"""The traced window: `torch.profiler` over the queries, reduced to device
busy time, time by device operation, the harness's host spans, and the
device's idle gaps under each span.

The harness marks its own spans with `record_function`: `<template>.plan`
(parse, bind, cost, plan), `<template>.exec` (execution until the rows
are in host memory) and `between_queries`.  Every device activity
(kernels, copies, sets) counts as busy time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np

from portbench.lib.stats import clean_name


@dataclasses.dataclass
class Reduced:
    window: tuple[float, float]          # seconds, profiler clock
    busy_s: float                        # union of device activity
    device_ops: list                     # [[name, seconds]], largest first
    idle_gaps: list                      # [[span name, idle seconds]]
    spans: dict                          # name -> [(start, end)]
    _starts: np.ndarray = None
    _ends: np.ndarray = None
    _cum: np.ndarray = None

    def busy_in(self, start: float, end: float) -> float:
        """Device busy seconds inside [start, end]."""
        return _covered(self._starts, self._ends, self._cum, start, end)


@contextlib.contextmanager
def profiled(enabled: bool):
    if not enabled:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=False,
                                with_stack=False) as prof:
        yield prof


def span(name: str):
    import torch
    return torch.profiler.record_function(name)


def _raw_events(prof):
    """(name, on_device, start_s, end_s) of every event of the trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).split(".")[-1] != "CPU"
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((e.name(), dev, s, s + d))
    return out


def _union(iv: list) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if not iv:
        return np.zeros(0), np.zeros(0)
    a = np.array(iv, dtype=np.float64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    new = a[1:, 0] > reach[:-1]
    return a[np.r_[True, new], 0], reach[np.r_[new, True]]


def _covered(starts, ends, cum, a: float, b: float) -> float:
    """Length of the union intervals' overlap with [a, b]."""
    if len(starts) == 0 or b <= a:
        return 0.0
    i = int(np.searchsorted(ends, a, side="right"))
    j = int(np.searchsorted(starts, b, side="left"))
    if j <= i:
        return 0.0
    total = cum[j] - cum[i]
    total -= max(0.0, a - starts[i])
    total -= max(0.0, ends[j - 1] - b)
    return float(max(total, 0.0))


def reduce(prof, span_names: set[str]) -> Reduced:
    # the spans' own copies on the device timeline (user annotations) are
    # no device operations
    events = [ev for ev in _raw_events(prof)
              if not (ev[1] and ev[0] in span_names)]
    dev = [(s, e) for _, d, s, e in events if d and e > s]
    by_op: dict = collections.defaultdict(float)
    for name, d, s, e in events:
        if d:
            by_op[clean_name(name)] += e - s
    spans: dict = collections.defaultdict(list)
    for name, d, s, e in events:
        if not d and name in span_names:
            spans[name].append((s, e))
    for v in spans.values():
        v.sort()
    all_spans = [iv for v in spans.values() for iv in v]
    w0 = min(s for s, _ in all_spans)
    w1 = max(e for _, e in all_spans)
    starts, ends = _union([(max(s, w0), min(e, w1)) for s, e in dev
                           if e > w0 and s < w1])
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])
    busy = float(cum[-1])
    idle = {}
    for name, ivs in spans.items():
        idle[name] = sum((e - s) - _covered(starts, ends, cum, s, e)
                         for s, e in ivs)
    r = Reduced(window=(w0, w1), busy_s=busy,
                device_ops=sorted(([k, v] for k, v in by_op.items()),
                                  key=lambda kv: -kv[1])[:10],
                idle_gaps=sorted(([k, v] for k, v in idle.items()),
                                 key=lambda kv: -kv[1])[:10],
                spans=dict(spans))
    r._starts, r._ends, r._cum = starts, ends, cum
    return r
