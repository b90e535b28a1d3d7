"""The traced window read down to the program's own spans.

`pg_strom_tpu_torch` marks its phases as `pgstrom.<name>` ranges of the
profiler's host timeline (its `utils/perfmon.span`), nested inside the
harness's `<template>.plan`, `<template>.exec` and `between_queries`.
This module puts the device's idle time and its busy time down to them:

* idle time goes to the innermost span open on the query's thread;
* a device operation goes to the innermost span open at its launch, the
  host runtime or driver event with the operation's correlation id;
  operations with no such event are `unmatched`;
* device-side copies of user annotations (`gpu_user_annotation`, any
  name) are neither busy time nor operations.

The window is the harness's, as `trace.reduce` takes it, so the two agree
on busy time whatever spans the program adds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import numpy as np

from portbench.lib.stats import clean_name, percentile
from portbench.lib.trace import _covered, _union

PREFIX = "pgstrom."
NO_SPAN = "(no span)"
KERNEL_SPANS = tuple(f"{PREFIX}K{i}" for i in range(1, 5))


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str            # "op", "launch" (a CUDA runtime or driver call),
                         # "annotation" (a user range's device-side copy)
    device: bool
    start: float         # seconds, profiler clock
    end: float
    corr: int            # correlation id
    thread: int


def _call(e, method: str, default):
    f = getattr(e, method, None)
    return f() if f is not None else default


def events(prof) -> list:
    """Every event of a `torch.profiler` session, as `Event`s.

    A device event is an annotation when the profiler says so or when a
    host event bears its name (kernels and copies never do); a host event
    is a launch when it links to a host operation (runtime and driver
    calls do) or, where the profiler lacks that link, when its name is a
    CUDA call's."""
    raw = list(prof.profiler.kineto_results.events())
    host_names = {e.name() for e in raw
                  if str(e.device_type()).split(".")[-1] == "CPU"}
    out = []
    for e in raw:
        dev = str(e.device_type()).split(".")[-1] != "CPU"
        kind = str(_call(e, "activity_type", ""))
        if dev:
            note = ("user_annotation" in kind
                    or _call(e, "is_user_annotation", False)
                    or e.name() in host_names)
            kind = "annotation" if note else "op"
        else:
            if kind:
                launch = kind in ("cuda_runtime", "cuda_driver")
            else:
                linked = _call(e, "linked_correlation_id", None)
                launch = (linked > 0 if linked is not None
                          else e.name().startswith("cu"))
            kind = "launch" if launch else "host"
        s = e.start_ns()
        # both ends from integer ns: equal instants stay equal
        out.append(Event(e.name(), kind, dev, s * 1e-9,
                         (s + e.duration_ns()) * 1e-9,
                         int(e.correlation_id()), int(e.start_thread_id())))
    return out


@dataclasses.dataclass
class Attribution:
    window: tuple                  # harness window, seconds
    busy_s: float                  # union of device operations in it
    device_s: float                # their summed time in it
    unmatched_s: float             # of which with no launch found
    idle: dict                     # innermost span -> idle seconds
    device: dict                   # span at launch -> device seconds
    exec_idle_s: float             # idle inside the harness's exec spans
    exec_idle_port_s: float        # of which under a program span
    spans: dict                    # span name -> [(start, end)]
    launched: list                 # (span at launch, start, end) an op
    _busy: tuple = ()

    def busy_in(self, a: float, b: float) -> float:
        return _covered(*self._busy, a, b)

    def exec_spans(self) -> list:
        return sorted(iv for n, ivs in self.spans.items()
                      if n.endswith(".exec") and not n.startswith(PREFIX)
                      for iv in ivs)


def _segments(spans: list, w0: float, w1: float) -> list:
    """[(start, end, innermost span, outermost span)] covering [w0, w1]
    from properly nested (name, start, end) spans of one thread."""
    segs = []
    stack: list = []                 # (end, name), innermost last
    cur = w0

    def emit(t, name):
        nonlocal cur
        if t > cur:
            segs.append((cur, min(t, w1), name,
                         stack[0][1] if stack else None))
            cur = t

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        if s >= w1:
            break
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0], stack[-1][1])
            stack.pop()
        emit(s, stack[-1][1] if stack else None)
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, name))
    while stack:
        emit(stack[-1][0], stack[-1][1])
        stack.pop()
    emit(w1, None)
    return [sg for sg in segs if sg[1] > max(sg[0], w0)]


def attribute(evs: list, harness_names: set) -> Attribution:
    """Idle and device time of the traced window by span."""
    host = [e for e in evs if not e.device]
    hspans = [e for e in host if e.name in harness_names
              and not e.name.startswith(PREFIX)]
    w0 = min(e.start for e in hspans)
    w1 = max(e.end for e in hspans)
    qthread = collections.Counter(e.thread for e in hspans).most_common(1)
    qthread = qthread[0][0]
    spans = [(e.name, e.start, e.end) for e in host if e.thread == qthread
             and (e.name in harness_names or e.name.startswith(PREFIX))]
    by_name: dict = collections.defaultdict(list)
    for n, s, e in spans:
        by_name[n].append((s, e))

    ops = [e for e in evs if e.kind == "op" and e.end > e.start
           and e.end > w0 and e.start < w1]
    starts, ends = _union([(max(e.start, w0), min(e.end, w1)) for e in ops])
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

    segs = _segments(spans, w0, w1)
    idle: dict = collections.defaultdict(float)
    exec_idle = exec_idle_port = 0.0
    for a, b, inner, outer in segs:
        gap = (b - a) - _covered(starts, ends, cum, a, b)
        idle[inner or NO_SPAN] += gap
        if outer is not None and outer.endswith(".exec"):
            exec_idle += gap
            if inner.startswith(PREFIX):
                exec_idle_port += gap

    seg_starts = [sg[0] for sg in segs]
    launch = {e.corr: e.start for e in host if e.kind == "launch"}
    device: dict = collections.defaultdict(float)
    launched = []
    total = unmatched = 0.0
    for op in ops:
        d = min(op.end, w1) - max(op.start, w0)
        total += d
        t = launch.get(op.corr)
        if t is None:
            unmatched += d
            continue
        i = bisect.bisect_right(seg_starts, t) - 1
        name = NO_SPAN
        if 0 <= i and t < segs[i][1]:
            name = segs[i][2] or NO_SPAN
        device[name] += d
        launched.append((name, op.start, op.end))
    return Attribution(window=(w0, w1), busy_s=float(cum[-1]),
                       device_s=total, unmatched_s=unmatched,
                       idle=dict(idle), device=dict(device),
                       exec_idle_s=exec_idle, exec_idle_port_s=exec_idle_port,
                       spans=dict(by_name), launched=launched,
                       _busy=(starts, ends, cum))


def _union_in(ivs: list, a: float, b: float) -> float:
    s, e = _union([(max(x, a), min(y, b)) for x, y in ivs
                   if y > a and x < b])
    return float(np.sum(e - s))


def exec_prepare_ms_p50(attr: Attribution | None):
    """Median over the exec spans of the union of `pgstrom.prepare` spans
    inside each, in ms; None without such spans."""
    if attr is None or not attr.spans.get(PREFIX + "prepare"):
        return None
    prep = attr.spans[PREFIX + "prepare"]
    ms = [_union_in(prep, a, b) * 1e3 for a, b in attr.exec_spans()]
    return percentile(ms, 50) if ms else None


def kernel_busy_share(attr: Attribution | None):
    """Device time of the operations launched inside `pgstrom.K1`-`K4`,
    inside the exec spans, over the device busy time inside them, in %;
    None without such spans."""
    if attr is None or not any(attr.spans.get(k) for k in KERNEL_SPANS):
        return None
    execs = attr.exec_spans()
    busy = sum(attr.busy_in(a, b) for a, b in execs)
    if busy <= 0:
        return None
    es, ee = _union(execs)
    cum = np.concatenate([[0.0], np.cumsum(ee - es)])
    k = sum(_covered(es, ee, cum, s, e)
            for name, s, e in attr.launched if name in KERNEL_SPANS)
    return 100.0 * k / busy


def h2d_bytes_per_query(perfmons: list | None):
    """Perfmon's `h2d` bytes over the window's queries, a query; None when
    the run was not traced or the program counts bytes only under
    perfmon."""
    if not perfmons:
        return None
    return sum(int(pm.bytes.get("h2d", 0)) for pm in perfmons) \
        / len(perfmons)


def per_query_ms(table: dict, n: int) -> list:
    """[[span, ms a query]], largest first."""
    return [[clean_name(k), v * 1e3 / n] for k, v in
            sorted(table.items(), key=lambda kv: -kv[1])]
