"""The executors' one chunk pipeline (pg_strom_tpu_torch/exec/devcache.py's
`launch_chunks`).

Its order and drains alone, over chunks made up here: resident chunks
drain once at the end, streamed ones every `max_async_chunks`, a chunk
that needs the host comes back where it stands, and a consumer may stop
early.  Then the queries of the seven executors that run on it (scan,
hash join, pre-aggregation, the fused join+aggregate's generic and
pregrouped paths, the star join, ORDER BY ... LIMIT) and K5's, each on
the CPU over resident and over streamed chunks (a zero cache budget and
more chunks than `max_async_chunks`): the answers equal one another, the
port's host-exact tier and the JAX reference's, and the drains are as
many as the pipeline promises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import Database as RDatabase
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.config import config
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.exec import devcache
from pg_strom_tpu_torch.exec.devcache import TCACHE, CachedChunk, \
    launch_chunks
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.utils.perfmon import Perfmon

# ---------------------------------------------------------------------------
# launch_chunks alone
# ---------------------------------------------------------------------------


def _made_up(kinds: str, streamed: bool) -> list:
    """A chunk of 4 rows per letter: `d` on the device, `r` for the host."""
    return [CachedChunk("t", 4 * i, 4, 4, k == "r",
                        None if k == "r" else (torch.full((4,), i),),
                        streamed) for i, k in enumerate(kinds)]


def _events(monkeypatch, kinds: str, streamed: bool, window: int = 3,
            stop_after: int | None = None) -> tuple[list, Perfmon]:
    """What the pipeline did over the made-up chunks, in order:
    ("d", i) a dispatch, ("w", [i, ...]) a drain's read, ("y", i, out) a
    pair handed to the consumer (out None for a host chunk)."""
    chunks = _made_up(kinds, streamed)
    ev: list = []
    monkeypatch.setattr(TCACHE, "chunks_for",
                        lambda table, names, cap, pm=None: iter(chunks))
    real = devcache.fetch_host

    def fetch(tree):
        if isinstance(tree, list):       # a drain's read, not its leaves
            ev.append(("w", [int(t[0]) for t in tree]))
        return real(tree)
    monkeypatch.setattr(devcache, "fetch_host", fetch)

    def dispatch(cc):
        ev.append(("d", cc.start // 4))
        return torch.tensor([cc.start // 4])

    pm = Perfmon()
    with P.override(perfmon=True, max_async_chunks=window):
        for n, (cc, out) in enumerate(launch_chunks(None, [], 4, pm,
                                                    dispatch)):
            ev.append(("y", cc.start // 4,
                       None if out is None else int(out[0])))
            if stop_after is not None and n + 1 == stop_after:
                break
    return ev, pm


def _y(*ids):
    return [("y", i, i) for i in ids]


def test_resident_chunks_drain_once_at_the_end(monkeypatch):
    ev, pm = _events(monkeypatch, "ddddd", streamed=False)
    assert ev == [("d", i) for i in range(5)] + [("w", [0, 1, 2, 3, 4])] \
        + _y(0, 1, 2, 3, 4)
    assert pm.counts["dispatch"] == 5 and pm.counts["device_wait"] == 1


def test_streamed_chunks_drain_every_max_async_chunks(monkeypatch):
    ev, pm = _events(monkeypatch, "d" * 7, streamed=True)
    assert ev == ([("d", 0), ("d", 1), ("d", 2), ("w", [0, 1, 2])]
                  + _y(0, 1, 2)
                  + [("d", 3), ("d", 4), ("d", 5), ("w", [3, 4, 5])]
                  + _y(3, 4, 5) + [("d", 6), ("w", [6])] + _y(6))
    assert pm.counts["dispatch"] == 7 and pm.counts["device_wait"] == 3


@pytest.mark.parametrize("streamed", [False, True])
def test_host_chunk_comes_back_in_its_place(monkeypatch, streamed):
    """A chunk that needs the host is handed back when the pipeline
    reaches it, before the device chunks launched ahead of it are read,
    and takes no place in the streamed window."""
    ev, pm = _events(monkeypatch, "ddrdd", streamed, window=2)
    if streamed:
        assert ev == [("d", 0), ("d", 1), ("w", [0, 1])] + _y(0, 1) + [
            ("y", 2, None), ("d", 3), ("d", 4), ("w", [3, 4])] + _y(3, 4)
    else:
        assert ev == [("d", 0), ("d", 1), ("y", 2, None), ("d", 3),
                      ("d", 4), ("w", [0, 1, 3, 4])] + _y(0, 1, 3, 4)
    assert pm.counts["dispatch"] == 4


def test_consumer_that_stops_early(monkeypatch):
    """A consumer that stops at the first pair (as top-k does at a host
    chunk) launches and reads nothing more."""
    ev, pm = _events(monkeypatch, "d" * 7, streamed=True, stop_after=1)
    assert ev == [("d", 0), ("d", 1), ("d", 2), ("w", [0, 1, 2]),
                  ("y", 0, 0)]
    assert pm.counts["dispatch"] == 3 and pm.counts["device_wait"] == 1
    ev, _ = _events(monkeypatch, "drd", streamed=False, stop_after=1)
    assert ev == [("d", 0), ("y", 1, None)]


# ---------------------------------------------------------------------------
# the executors on it, resident and streamed
# ---------------------------------------------------------------------------

N = 3000
CHUNK = 256              # 12 chunks: more than max_async_chunks


@pytest.fixture(scope="module")
def dbs():
    """fact (id, k, k2, a, b, x) with a few NULL keys; dim: the keys 0..49
    shuffled (a unique dense build); dim2: 0..19 shuffled."""
    rng = np.random.default_rng(20)
    d = RDatabase()
    d.create(R.Table.from_columns("fact", {
        "id": R.column_from_values(R.T.INT4, list(range(N))),
        "k": R.column_from_values(R.T.INT4, [
            int(v) if v < 53 else None for v in rng.integers(0, 55, N)]),
        "k2": R.column_from_values(R.T.INT4,
                                   [int(v) for v in rng.integers(0, 20, N)]),
        "a": R.column_from_values(R.T.INT4,
                                  [int(v) for v in rng.integers(0, 100, N)]),
        "b": R.column_from_values(R.T.INT4,
                                  [int(v) for v in rng.integers(0, 10, N)]),
        "x": R.column_from_values(R.T.FLOAT8,
                                  [float(v) for v in rng.random(N)]),
    }))
    keys = rng.permutation(50)
    d.create(R.Table.from_columns("dim", {
        "k": R.column_from_values(R.T.INT4, [int(v) for v in keys]),
        "y": R.column_from_values(R.T.INT4,
                                  [1990 + int(v) % 7 for v in keys]),
        "w": R.column_from_values(R.T.INT4, [int(v) * 3 - 40 for v in keys]),
    }))
    d.create(R.Table.from_columns("dim2", {
        "k2": R.column_from_values(R.T.INT4,
                                   [int(v) for v in rng.permutation(20)]),
        "z": R.column_from_values(R.T.INT4, list(range(20))),
    }))
    return d, from_reference(d)


_JOIN = "from fact join dim on fact.k = dim.k"
# name -> (sql, the device function each chunk launches)
QUERIES = {
    "scan": ("select fact.id, fact.a from fact where fact.a > 90",
             "tpuscan_qual"),
    "hash_join": (f"select fact.id, dim.w {_JOIN} where fact.a > 85",
                  "tpujoin_probe_dense"),
    "preagg": ("select fact.b, count(*), sum(fact.a), sum(fact.x) from fact "
               "where fact.a > 5 group by fact.b", "tpupreagg"),
    "joinagg_generic": (f"select fact.b, count(*), sum(fact.a) {_JOIN} "
                        "group by fact.b", "tpujoinagg"),
    "joinagg_pregrouped": (f"select dim.y, count(*), sum(fact.a) {_JOIN} "
                           "group by dim.y", "tpujoinagg_pregrouped"),
    "star_join": ("select dim.y, count(*), sum(fact.a) from fact, dim, dim2 "
                  "where fact.k = dim.k and fact.k2 = dim2.k2 "
                  "and dim2.z < 12 group by dim.y", "tpustarjoinagg"),
    "topk": ("select fact.id, fact.a from fact where fact.b <> 3 "
             "order by fact.a desc, fact.id limit 9", "tpusort_topk"),
    "k5": (f"select sum(fact.a * fact.b), count(*) {_JOIN} "
           "where dim.y = 1993 and fact.b between 2 and 5", "tpujoinagg"),
}


def _rows(ast, plan_query, Result, sql, db) -> tuple[list, dict]:
    pq = plan_query(ast.parse(sql), db)
    rows = pq.execute()
    out = Result(columns=pq.out_names, rows=rows,
                 types=pq.out_types).formatted(-3)
    return (out if "order by" in sql else sorted(out)), \
        dict(pq.perfmon.counts)


def _port(sql, pdb, streamed: bool, monkeypatch) -> tuple[list, dict, int]:
    """Rows and counters of a cold run, and the chunks streamed."""
    TCACHE.clear()
    s0 = TCACHE.streamed
    with monkeypatch.context() as mp:
        if streamed:
            mp.setattr(TCACHE, "budget_bytes", lambda: 0)
        with P.override(device="cpu", debug_force_offload=True,
                        perfmon=True, chunk_rows=CHUNK):
            rows, pc = _rows(p_ast, p_plan_query, PResult, sql, pdb)
    return rows, pc, TCACHE.streamed - s0


@pytest.mark.parametrize("name", list(QUERIES))
def test_executor_resident_and_streamed(dbs, name, monkeypatch):
    sql, fn = QUERIES[name]
    rdb, pdb = dbs
    nchunks = -(-N // CHUNK)
    assert nchunks > config.max_async_chunks
    resident, rc, rs = _port(sql, pdb, False, monkeypatch)
    streamed, sc, ss = _port(sql, pdb, True, monkeypatch)
    with P.override(device="cpu", enabled=False, chunk_rows=CHUNK):
        host, _ = _rows(p_ast, p_plan_query, PResult, sql, pdb)
    with R.override(enabled=True, debug_force_offload=True,
                    force_fused_preagg_cpu=True, chunk_rows=CHUNK):
        want, _ = _rows(r_ast, r_plan_query, RResult, sql, rdb)
    assert resident == streamed == host == want, \
        (resident, streamed, host, want)
    assert rs == 0 and ss >= nchunks, (rs, ss)
    for c in (rc, sc):
        assert c.get("recheck_chunks", 0) == 0, c
        assert c.get("unported_host_exact", 0) == 0, c
    # streamed: every chunk launched alone, a drain every max_async_chunks
    assert sc.get(f"kernel {fn}") == sc.get("dispatch") == nchunks, sc
    assert sc.get("device_wait") == -(-nchunks // config.max_async_chunks), sc
    # resident: one drain at the end (K5's launch plan: one launch too)
    assert rc.get("device_wait") == 1, rc
    assert rc.get(f"kernel {fn}") == (1 if name == "k5" else nchunks), rc
    if name == "k5":
        assert rc.get("k5_plan_builds") == 1, rc
        assert "k5_plan_builds" not in sc and "k5_plan_hits" not in sc, sc
        for c in (rc, sc):
            assert c.get("joinagg_scalar_chunks") == nchunks, c
            assert c.get("device_chunks") == nchunks, c
