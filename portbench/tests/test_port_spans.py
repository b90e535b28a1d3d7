"""CPU tests of `lib/portspans.py` and `port_trace.py` on synthetic
traces (`python -m pytest portbench/tests`).

One query's timeline, in microseconds, shifted by 1100 for the second:

    q.plan [0, 100] > pgstrom.plan [5, 95]
    q.exec [100, 1000] > pgstrom.execute [105, 995] >
        pgstrom.prepare [110, 300], pgstrom.dispatch [300, 400] >
            pgstrom.device.tpujoinagg [305, 395] > pgstrom.K3 [320, 330];
        pgstrom.device_wait [400, 990]
    between_queries [1000, 1100] (first query only)

Launches (runtime events) at 150 (a copy, [160, 200] on the device), 310
(a kernel, [400, 600]) and 325 (K3, [600, 700]); one kernel [700, 750]
with no launch event.  Device-side copies of the annotations `q.exec` and
`pgstrom.device.tpujoinagg` lie over the operations.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import cell, portspans, traffic  # noqa: E402
from portbench.lib.trace import reduce  # noqa: E402

HARNESS = {"q.plan", "q.exec", "between_queries"}
US = 1e-6


class BareEvent:
    """The part of a kineto event every PyTorch of 2.x has."""

    def __init__(self, name, kind, start_us, end_us, corr=0, device=False):
        self._n, self._k, self._corr, self._dev = name, kind, corr, device
        self._s, self._d = int(start_us * 1e3), int((end_us - start_us) * 1e3)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return 1


class FakeEvent(BareEvent):
    """A kineto event that names its activity type."""

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return "user_annotation" in self._k


class LinkedEvent(BareEvent):
    """A kineto event without the activity type, with the link from a
    runtime call or device operation to its host operation."""

    def linked_correlation_id(self):
        return 7 if self._k.startswith(("cuda_", "kernel", "gpu_")) else 0


class FakeProf:
    def __init__(self, evs):
        k = type("K", (), {"events": lambda self: evs})()
        self.profiler = type("P", (), {"kineto_results": k})()


def _query(t: float, between: bool, port: bool, dev_notes: bool,
           E=FakeEvent) -> list:
    evs = [E("q.plan", "user_annotation", t, t + 100),
           E("q.exec", "user_annotation", t + 100, t + 1000)]
    if between:
        evs.append(E("between_queries", "user_annotation", t + 1000,
                     t + 1100))
    if port:
        evs += [E("pgstrom.plan", "cpu_op", t + 5, t + 95),
                E("pgstrom.execute", "cpu_op", t + 105, t + 995),
                E("pgstrom.prepare", "cpu_op", t + 110, t + 300),
                E("pgstrom.dispatch", "cpu_op", t + 300, t + 400),
                E("pgstrom.device.tpujoinagg", "cpu_op", t + 305, t + 395),
                E("pgstrom.K3", "cpu_op", t + 320, t + 330),
                E("pgstrom.device_wait", "cpu_op", t + 400, t + 990)]
    c = int(t) + 1
    evs += [E("cudaMemcpyAsync", "cuda_runtime", t + 150, t + 152, c),
            E("cudaLaunchKernel", "cuda_runtime", t + 310, t + 312, c + 1),
            E("cuLaunchKernel", "cuda_driver", t + 325, t + 327, c + 2),
            E("Memcpy HtoD", "gpu_memcpy", t + 160, t + 200, c, True),
            E("elementwise_kernel", "kernel", t + 400, t + 600, c + 1,
              True),
            E("pgstrom_k3", "kernel", t + 600, t + 700, c + 2, True),
            E("orphan_kernel", "kernel", t + 700, t + 750, c + 99, True)]
    if dev_notes:
        evs += [E("q.exec", "gpu_user_annotation", t + 160, t + 750, 0,
                  True),
                E("pgstrom.device.tpujoinagg", "gpu_user_annotation",
                  t + 400, t + 700, 0, True)]
    return evs


def trace(port: bool = True, dev_notes: bool = True,
          E=FakeEvent) -> list:
    return (_query(0, True, port, dev_notes, E)
            + _query(1100, False, port, dev_notes, E))


def _attr(**kw):
    return portspans.attribute(portspans.events(FakeProf(trace(**kw))),
                               HARNESS)


@pytest.mark.parametrize("E", [FakeEvent, LinkedEvent, BareEvent])
def test_event_kinds_without_activity_types(E):
    """PyTorch builds whose events lack the activity type (or the link
    too) sort annotations, launches and operations alike."""
    got = [(e.name, e.kind) for e in
           portspans.events(FakeProf(trace(E=E)))]
    assert got == [(e.name, e.kind) for e in
                   portspans.events(FakeProf(trace()))]
    pairs = set(got)
    assert {("pgstrom.device.tpujoinagg", "host"),
            ("pgstrom.device.tpujoinagg", "annotation"),
            ("q.exec", "annotation"), ("cudaLaunchKernel", "launch"),
            ("cuLaunchKernel", "launch"), ("pgstrom_k3", "op"),
            ("Memcpy HtoD", "op")} <= pairs
    assert sum(k == "annotation" for _, k in got) == 4


def test_device_annotations_are_no_busy_time():
    a = _attr()
    assert a.busy_s == pytest.approx(2 * 390 * US)
    assert a.device_s == pytest.approx(2 * 390 * US)
    names = {n for n, _, _ in a.launched}
    assert not any("annotation" in n or n == "q.exec" for n in names)
    assert a.busy_s == pytest.approx(_attr(dev_notes=False).busy_s)


def test_idle_goes_to_the_innermost_open_span():
    a = _attr()
    want = {"q.exec": 10, "pgstrom.execute": 10, "pgstrom.prepare": 150,
            "pgstrom.dispatch": 10, "pgstrom.device.tpujoinagg": 80,
            "pgstrom.K3": 10, "pgstrom.device_wait": 240,
            "pgstrom.plan": 90, "q.plan": 10}
    for name, us in want.items():
        assert a.idle[name] == pytest.approx(2 * us * US), name
    assert a.idle["between_queries"] == pytest.approx(100 * US)
    assert a.exec_idle_s == pytest.approx(2 * 510 * US)
    assert a.exec_idle_port_s == pytest.approx(2 * 500 * US)
    # without the program's spans the harness keeps it all
    b = _attr(port=False)
    assert b.idle["q.exec"] == pytest.approx(2 * 510 * US)


def test_operation_goes_to_the_span_at_its_launch():
    a = _attr()
    assert a.device["pgstrom.device.tpujoinagg"] == pytest.approx(400 * US)
    assert a.device["pgstrom.K3"] == pytest.approx(200 * US)
    assert a.device["pgstrom.prepare"] == pytest.approx(80 * US)
    assert a.unmatched_s == pytest.approx(100 * US)
    assert "orphan_kernel" not in {n for n, _, _ in a.launched}


def _record(i: int) -> cell.Record:
    t = i * 1100 * US
    return cell.Record(traffic.Query(i, "q", "", {}), t, t + 1e-3, [(1,)],
                       None, plan_ms=0.1 + 0.01 * i, covered=100,
                       logical_bytes=3_350_000)


def _harness_ctx(port: bool) -> cell.Context:
    """The Context `run_cell` builds from this trace, its own spans only
    on the device timeline, as the program's spans are host ranges."""
    evs = trace(port=port, dev_notes=False)
    evs += [FakeEvent("q.exec", "gpu_user_annotation", t + 160, t + 750,
                      0, True) for t in (0, 1100)]
    recs = [_record(0), _record(1)]
    ctx = cell.Context(recs, window_s=2.1e-3, setup_s=1.0,
                       cold_query_ms=1.0)
    ctx.trace = reduce(FakeProf(evs), HARNESS)
    ctx.exec_spans = [(r, s, e) for r, (s, e) in
                      zip(recs, ctx.trace.spans["q.exec"])]
    return ctx


@pytest.mark.parametrize("name", ["device_idle_share", "device_roofline",
                                  "exec_host_ms_p50", "plan_ms_p50"])
def test_harness_metrics_read_alike_with_port_spans(name):
    reader = importlib.import_module(f"portbench.metrics.{name}")
    with_spans = reader.read(_harness_ctx(True))
    assert with_spans is not None
    assert with_spans == pytest.approx(reader.read(_harness_ctx(False)))
    # and the harness's busy time is this module's
    assert _harness_ctx(True).trace.busy_s == pytest.approx(_attr().busy_s)


class _PM:
    def __init__(self, h2d):
        self.bytes = {"h2d": h2d} if h2d is not None else {}


def test_readers_hand_computed():
    a = _attr()
    assert portspans.exec_prepare_ms_p50(a) == pytest.approx(0.19)
    assert portspans.kernel_busy_share(a) == pytest.approx(100 * 100 / 390)
    assert portspans.h2d_bytes_per_query(
        [_PM(0), _PM(4096), _PM(None), _PM(0)]) == 1024.0


def test_readers_none_without_a_trace_or_spans():
    assert portspans.exec_prepare_ms_p50(None) is None
    assert portspans.kernel_busy_share(None) is None
    assert portspans.h2d_bytes_per_query(None) is None
    assert portspans.h2d_bytes_per_query([]) is None
    b = _attr(port=False)                # the parent program: no spans
    assert portspans.exec_prepare_ms_p50(b) is None
    assert portspans.kernel_busy_share(b) is None


def test_port_trace_on_the_cpu():
    """A traced q1_1 run at a small size on the CPU, in a fresh process
    (the run refuses a process that loaded JAX): the result line has
    `port_spans`, the program's spans hold the exec spans' idle time and
    the harness's metrics are still there."""
    small = {"lineorder_rows": 60_000, "customer_rows": 3000,
             "supplier_rows": 200, "part_rows": 20_000}
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from portbench.port_trace import traced_run\n"
            "rc, res = traced_run(%r, 'ssb_sf20.q1_1', 2**31 + 77, 1.0,\n"
            "                     device='cpu', config_override=%r)\n"
            "print(json.dumps(res)); sys.exit(rc)\n") % (ROOT, ROOT, small)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    ps = res["port_spans"]
    assert ps["exec_prepare_ms_p50"] is not None
    assert ps["h2d_bytes_per_query"] == 0.0    # every plane is resident
    assert ps["kernel_busy_share"] is None     # no CUDA launch on the CPU
    assert ps["exec_idle_port_share"] > 0.9
    assert ps["device_side_program_spans"] == 0
    assert "exec_host_ms_p50" in res["metrics"]
