"""The port's spans (`pg_strom_tpu_torch.utils.perfmon.span`) under
`torch.profiler` with CPU activity, and the perfmon report they feed.

A span is a `pgstrom.<name>` range of the profiler's trace while one
records, host time in `Perfmon.times[<name>]` under `perfmon`, and nothing
otherwise: no range opened, no clock read.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pg_strom_tpu_torch import (Database, T, Table, column_from_numpy,
                                execute, override)
from pg_strom_tpu_torch.plan.planner import plan_query
from pg_strom_tpu_torch.sql import parser
from pg_strom_tpu_torch.utils import perfmon as pmod
from pg_strom_tpu_torch.utils.perfmon import Perfmon, span

JOIN_AGG = ("select sum(f.x * f.k) from f, d where f.k = d.k "
            "and d.y = 1993 and f.x < 25")
# grouped by a probe column: the dense join's PyTorch branch, not K5
JOIN_AGG_GROUPED = ("select f.x, sum(f.k), count(*) from f, d "
                    "where f.k = d.k and d.y = 1993 group by f.x")
GROUPED = "select key, sum(v), count(*) from t where v > 10 group by key"
# (sql, config, its device call)
QUERIES = {
    "join_agg": (JOIN_AGG, {"debug_force_offload": True}, "tpujoinagg"),
    "join_agg_grouped": (JOIN_AGG_GROUPED, {"debug_force_offload": True},
                         "tpujoinagg"),
    "grouped_preagg": (GROUPED, {"debug_force_tpupreagg": True},
                       "tpupreagg"),
}


def _db() -> Database:
    """Fresh tables: new column ids, so the device cache misses once."""
    rng = np.random.default_rng(15)
    db = Database()
    db.create(Table.from_columns("t", {
        "key": column_from_numpy(T.INT4,
                                 np.arange(6000, dtype=np.int32) % 37),
        "v": column_from_numpy(T.INT4, rng.integers(0, 100, 6000)
                               .astype(np.int32))}))
    db.create(Table.from_columns("f", {
        "k": column_from_numpy(T.INT4, rng.integers(0, 500, 20000)
                               .astype(np.int32)),
        "x": column_from_numpy(T.INT4, rng.integers(0, 100, 20000)
                               .astype(np.int32))}))
    db.create(Table.from_columns("d", {
        "k": column_from_numpy(T.INT4, rng.permutation(500)
                               .astype(np.int32)),
        "y": column_from_numpy(T.INT4, rng.integers(1990, 1999, 500)
                               .astype(np.int32))}))
    return db


def _traced(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the pgstrom spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("pgstrom.")]
    return out, spans


def _inside(spans, outer: str, inner: str) -> bool:
    """Some `inner` span lies within some `outer` span."""
    return any(o[1] <= i[1] and i[2] <= o[2]
               for o in spans if o[0] == "pgstrom." + outer
               for i in spans if i[0] == "pgstrom." + inner)


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_execution_spans_nest(case):
    sql, cfg, kernel = QUERIES[case]
    db = _db()
    with override(device="cpu", **cfg):
        _, spans = _traced(lambda: execute(sql, db))
    dev = f"device.{kernel}"
    assert _inside(spans, "execute", "prepare"), spans
    assert _inside(spans, "execute", "dispatch")
    assert _inside(spans, "dispatch", dev)
    # the dense join's branch probes, gathers, lowers and reduces in
    # PyTorch; K1 (the grouped plan) lowers inside the kernel; K5 (the
    # scalar join) is one pass, with none of the glue's spans
    glue = ["probe", "gather", "lower", "reduce"]
    steps = {"join_agg": [], "join_agg_grouped": glue,
             "grouped_preagg": ["reduce"]}[case]
    for step in steps:
        assert _inside(spans, dev, step), (step, spans)
    if case == "join_agg":
        assert not any(_inside(spans, dev, step) for step in glue), spans
    if case == "join_agg_grouped":
        assert _inside(spans, "probe", "lower")
    assert _inside(spans, "execute", "chunks")
    assert _inside(spans, "chunks", "upload")        # the first run misses
    assert _inside(spans, "execute", "absorb")
    assert _inside(spans, "execute", "finalize")
    # launch spans open only around a CUDA launch: none on the CPU
    assert not any(n.startswith("pgstrom.K") for n, _, _ in spans)


def test_parse_and_plan_spans():
    db = _db()
    with override(device="cpu"):
        _, spans = _traced(lambda: plan_query(parser.parse(JOIN_AGG), db))
    names = {n for n, _, _ in spans}
    assert {"pgstrom.parse", "pgstrom.plan", "pgstrom.plan.bind",
            "pgstrom.plan.cost", "pgstrom.plan.tree"} <= names, names
    for child in ("plan.bind", "plan.cost", "plan.tree"):
        assert _inside(spans, "plan", child), child
    assert not _inside(spans, "plan", "parse")
    assert "pgstrom.execute" not in names


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_every_perfmon_phase_is_a_span(case):
    sql, cfg, kernel = QUERIES[case]
    db = _db()
    with override(device="cpu", perfmon=True, **cfg):
        pq = plan_query(parser.parse(sql), db)
        _, spans = _traced(pq.execute)
    names = {n for n, _, _ in spans}
    phases = set(pq.perfmon.times)
    assert f"kernel {kernel}" in phases and "prepare" in phases
    for phase in phases:
        want = ("device." + phase[len("kernel "):]
                if phase.startswith("kernel ") else phase)
        assert "pgstrom." + want in names, (phase, sorted(names))
    # each span's host time went into the query's Perfmon, once a call
    n_exec = sum(n == "pgstrom.execute" for n in
                 (s[0] for s in spans))
    assert pq.perfmon.counts["execute"] == n_exec == 1


def test_spans_cost_nothing_when_nothing_records(monkeypatch):
    """No profiler and perfmon off: span() opens no range and reads no
    clock, on a whole query (parse, plan, execute, device calls)."""
    calls = {"range": 0, "clock": 0}
    real_clock = pmod.time.perf_counter

    def fake_range(name):
        calls["range"] += 1
        return torch.profiler.record_function(name)

    def clock():
        calls["clock"] += 1
        return real_clock()

    monkeypatch.setattr(pmod, "_RANGE", fake_range)
    monkeypatch.setattr(pmod.time, "perf_counter", clock)
    db = _db()
    with override(device="cpu", debug_force_offload=True, perfmon=False):
        assert span("prepare") is span("dispatch")    # the shared no-op
        rows = execute(JOIN_AGG, db).rows
    assert rows and calls == {"range": 0, "clock": 0}
    # the same query under a profiler opens ranges
    with override(device="cpu", debug_force_offload=True):
        _traced(lambda: execute(JOIN_AGG, db))
    assert calls["range"] > 0


def test_explain_analyze_report():
    db = _db()
    with override(device="cpu", debug_force_offload=True):
        text = "\n".join(r[0] for r in
                         execute("EXPLAIN ANALYZE " + JOIN_AGG, db).rows)
    assert "Device Kernels:" in text
    assert "kernel tpujoinagg: total" in text
    assert "device_chunks: 1" in text and "tcache_misses: 2" in text
    # H2D over the upload span's time; D2H without a rate
    h2d = next(ln for ln in text.splitlines() if "h2d:" in ln)
    assert "GB/s" in h2d and "upload: total" in text
    d2h = next(ln for ln in text.splitlines() if "d2h:" in ln)
    assert "GB/s" not in d2h
    assert "devprog_tier_fallbacks" not in text


def test_report_renders_every_counter():
    pm = Perfmon()
    pm.bump("nloops_passes", 4)
    pm.bump("dist_recheck")
    pm.bump("tcache_misses", 2)
    pm.bump("salt_retries", 0)
    pm.add_bytes("h2d", 3_000_000)
    pm.add_bytes("d2h", 1_000_000)
    with override(perfmon=True):
        with pm.timer("upload"):
            pass
    lines = pm.report_lines()
    for want in ("nloops_passes: 4", "dist_recheck: 1", "tcache_misses: 2"):
        assert want in lines, lines
    assert not any(ln.startswith("salt_retries") for ln in lines)
    assert any(ln.startswith("h2d: 3.00MB, ") and ln.endswith("GB/s")
               for ln in lines), lines
    assert "d2h: 1.00MB" in lines


def test_h2d_counted_with_perfmon_off():
    db = _db()
    with override(device="cpu", debug_force_offload=True, perfmon=False):
        pq = plan_query(parser.parse(JOIN_AGG), db)
        pq.execute()
        assert pq.perfmon.bytes["h2d"] > 0          # the first upload
        again = plan_query(parser.parse(JOIN_AGG), db)
        again.execute()
    assert again.perfmon.bytes.get("h2d", 0) == 0     # resident now
    assert pq.perfmon.times == {}                    # no phase timed


class _FakeEvent:
    """torch.cuda.Event's timing surface, counting waits."""
    waits = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3             # ms


def test_device_call_never_waits_per_call(monkeypatch):
    """Under perfmon on a CUDA device, each call records two events and
    returns; the events are read once, when the times are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.waits = 0
    pm = Perfmon()
    with override(device="cuda", perfmon=True):
        outs = [pm.device_call("tpujoinagg", lambda i: i * 2, i)
                for i in range(5)]
    assert outs == [0, 2, 4, 6, 8]
    assert _FakeEvent.waits == 0 and pm.counts["kernel tpujoinagg"] == 5
    assert pm.times["kernel tpujoinagg"] == pytest.approx(5.0)
    assert _FakeEvent.waits == 5 and pm._events == []
    assert pm.times["kernel tpujoinagg"] == pytest.approx(5.0)
    assert _FakeEvent.waits == 5
