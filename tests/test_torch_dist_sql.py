"""The port's distributed join+aggregate, DISTINCT and skew routing at the
SQL boundary against the reference: tests/test_dist.py's
TestDistributedSQL, repartition, DISTINCT and skew cases, case for case,
through both packages (tests/torch_dist_common.py: rows as text at
extra_float_digits=-3 and equal dist_* counters, the reference on its 8
CPU devices and the port on an 8-shard CPU mesh)."""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import pytest

import pg_strom_tpu_torch as P
from pg_strom_tpu import T
from pg_strom_tpu.datastore import Database, Table, column_from_values
from torch_dist_common import NDEV, both, port_db, port_run

pytestmark = pytest.mark.skipif(NDEV < 2, reason="needs the 8-device rig")


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(20260820)
    nf, nd = 12000, 240
    db = Database()
    fk = rng.integers(0, nd, nf)
    db.create(Table.from_columns("fact", {
        "k": column_from_values(T.INT4, [int(v) for v in fk]),
        "k2": column_from_values(T.INT4, [int(v) % 3 for v in fk]),
        "x": column_from_values(
            T.FLOAT8, [None if i % 37 == 0 else float(v)
                       for i, v in enumerate(rng.random(nf))]),
        "xf": column_from_values(
            T.FLOAT4, [float(np.float32(v)) for v in rng.random(nf)]),
        "q": column_from_values(
            T.INT8, [int(v) for v in rng.integers(-10**9, 10**9, nf)]),
        "s": column_from_values(
            T.INT2, [int(v) for v in rng.integers(-300, 300, nf)]),
    }))
    db.create(Table.from_columns("dim", {
        "dk": column_from_values(T.INT4, list(range(nd))),
        "dk2": column_from_values(T.INT4, [i % 3 for i in range(nd)]),
        "cat": column_from_values(T.TEXT, [f"cat{i % 7}" for i in range(nd)]),
        "w": column_from_values(T.FLOAT8, [float(i) * 0.5
                                           for i in range(nd)]),
    }))
    return db, port_db(db)


def _engaged(p) -> bool:
    return p.counts.get("dist_steps", 0) >= 1


class TestDistributedSQL:
    def test_join_group_by_text_key(self, dbs):
        q = ("select dim.cat, count(*), sum(fact.x) from fact, dim "
             "where fact.k = dim.dk group by dim.cat order by dim.cat")
        _r, p = both(dbs[0], q, pdb=dbs[1])
        assert _engaged(p)

    def test_full_agg_families(self, dbs):
        q = ("select dim.cat, count(fact.x), sum(fact.q), min(fact.q), "
             "max(fact.q), avg(fact.x), stddev(fact.x), var_samp(fact.x), "
             "sum(fact.xf), corr(fact.x, dim.w) "
             "from fact, dim where fact.k = dim.dk "
             "group by dim.cat order by dim.cat")
        _r, p = both(dbs[0], q, pdb=dbs[1])
        assert _engaged(p)

    def test_multi_key_join(self, dbs):
        q = ("select dim.cat, count(*), sum(fact.s) from fact, dim "
             "where fact.k = dim.dk and fact.k2 = dim.dk2 "
             "group by dim.cat order by dim.cat")
        both(dbs[0], q, pdb=dbs[1])

    def test_group_by_int_key_from_probe(self, dbs):
        q = ("select fact.k2, count(*), sum(dim.w), min(fact.s) "
             "from fact, dim where fact.k = dim.dk "
             "group by fact.k2 order by fact.k2")
        both(dbs[0], q, pdb=dbs[1])

    def test_ungrouped(self, dbs):
        q = ("select count(*), sum(fact.x), max(dim.w) from fact, dim "
             "where fact.k = dim.dk")
        both(dbs[0], q, pdb=dbs[1])

    def test_where_preds_applied_per_side(self, dbs):
        q = ("select dim.cat, count(*), sum(fact.x) from fact, dim "
             "where fact.k = dim.dk and fact.s > 0 and dim.w < 60 "
             "group by dim.cat order by dim.cat")
        both(dbs[0], q, pdb=dbs[1])

    def test_overflow_repartitions_and_stays_exact(self):
        rng = np.random.default_rng(5)
        nf = 4000
        skewed = np.where(rng.random(nf) < 0.9, 7, rng.integers(0, 50, nf))
        db2 = Database()
        db2.create(Table.from_columns("f2", {
            "k": column_from_values(T.INT4, [int(v) for v in skewed]),
            "x": column_from_values(T.FLOAT8,
                                    [float(v) for v in rng.random(nf)]),
        }))
        db2.create(Table.from_columns("d2", {
            "dk": column_from_values(T.INT4, list(range(50))),
        }))
        q = ("select f2.k, count(*), sum(f2.x) from f2, d2 "
             "where f2.k = d2.dk group by f2.k order by f2.k")
        both(db2, q)

    def test_numeric_agg_distributes(self):
        db3 = Database()
        rng = np.random.default_rng(13)
        n = 600
        vals = [None if i % 17 == 0
                else Decimal(int(rng.integers(-10**9, 10**9))) / Decimal(100)
                for i in range(n)]
        db3.create(Table.from_columns("fn", {
            "k": column_from_values(T.INT4,
                                    [int(v) for v in rng.integers(1, 9, n)]),
            "n": column_from_values(T.NUMERIC, vals),
        }))
        db3.create(Table.from_columns("dn", {
            "dk": column_from_values(T.INT4, list(range(1, 9))),
        }))
        q = ("select fn.k, sum(fn.n), avg(fn.n), count(fn.n), min(fn.n), "
             "max(fn.n) from fn, dn where fn.k = dn.dk "
             "group by fn.k order by fn.k")
        _r, p = both(db3, q)
        assert _engaged(p), "numeric agg did not distribute"

    def test_numeric_recheck_rows_fall_back(self):
        db4 = Database()
        db4.create(Table.from_columns("fr", {
            "k": column_from_values(T.INT4, [1, 1, 2]),
            "n": column_from_values(T.NUMERIC,
                                    [Decimal("1E+49"), Decimal("2"),
                                     Decimal("3")]),
        }))
        db4.create(Table.from_columns("dr", {
            "dk": column_from_values(T.INT4, [1, 2]),
        }))
        q = ("select fr.k, sum(fr.n) from fr, dr where fr.k = dr.dk "
             "group by fr.k order by fr.k")
        _r, p = both(db4, q)
        assert not _engaged(p)

    def test_distributed_guc_surface(self, dbs):
        from pg_strom_tpu_torch.config import config
        from pg_strom_tpu_torch.sql import execute
        with P.override(device="cpu"):
            execute("set pg_strom.distributed to on", dbs[1])
            assert config.distributed is True
            execute("set pg_strom.mesh_shards to 4", dbs[1])
            assert config.mesh_shards == 4
            execute("set pg_strom.distributed to off", dbs[1])
            assert config.distributed is False


def test_executor_repartition_counter():
    """A small dist_group_slots: the G ladder must double until the
    groups fit, in both packages alike (dist_repartitions equal)."""
    rng = np.random.default_rng(9)
    nf, ngroups = 6000, 2000
    db = Database()
    db.create(Table.from_columns("f", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in
                                 rng.integers(0, ngroups, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("d", {
        "dk": column_from_values(T.INT4, list(range(ngroups))),
    }))
    q = ("select f.k, count(*), sum(f.x) from f, d where f.k = d.dk "
         "group by f.k order by f.k")
    _r, p = both(db, q, cfg={"dist_group_slots": 64})
    assert p.counts.get("dist_repartitions", 0) >= 1, p.counts


def _dd_db():
    rng = np.random.default_rng(46)
    n = 9000
    db = Database()
    db.create(Table.from_columns("dd", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 12, n)]),
        "x": column_from_values(
            T.INT4, [None if i % 17 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 60, n))]),
        "y": column_from_values(T.INT8,
                                [int(v) for v in
                                 rng.integers(-1000, 1000, n)]),
    }))
    return db


@pytest.mark.parametrize("q", [
    "select dd.g, count(distinct dd.x), count(*), sum(dd.y) from dd "
    "group by dd.g order by dd.g",
    "select dd.g, sum(distinct dd.x), min(dd.y) from dd "
    "group by dd.g order by dd.g",
    "select count(distinct dd.x) from dd",
    "select dd.g, avg(distinct dd.x) from dd group by dd.g order by dd.g",
])
def test_distinct_aggregate_distributes(q):
    _r, p = both(_dd_db(), q)
    assert p.counts.get("dist_distinct_steps", 0) >= 1, p.counts


@pytest.mark.parametrize("q", [
    "select jd.cat, count(distinct jf.x), count(*), sum(jd.w) "
    "from jf, jd where jf.k = jd.dk group by jd.cat order by jd.cat",
    "select count(distinct jf.x), sum(jf.x) from jf, jd "
    "where jf.k = jd.dk",
])
def test_distinct_aggregate_distributes_through_join(q):
    rng = np.random.default_rng(47)
    nf, nd = 8000, 30
    db = Database()
    db.create(Table.from_columns("jf", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, nd, nf)]),
        "x": column_from_values(
            T.INT4, [None if i % 13 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 40, nf))]),
    }))
    db.create(Table.from_columns("jd", {
        "dk": column_from_values(T.INT4, list(range(nd))),
        "cat": column_from_values(T.TEXT, [f"c{i % 4}" for i in range(nd)]),
        "w": column_from_values(T.INT8, [5 * i for i in range(nd)]),
    }))
    _r, p = both(db, q)
    assert p.counts.get("dist_distinct_steps", 0) >= 1, p.counts


def test_device_distinct_without_distributed():
    """agg(DISTINCT x) takes the device dedup tier with distributed off
    (the mesh of one shard on the CPU by default, as on one GPU), and the
    kill switch device_distinct=off reverts to the host tier."""
    rng = np.random.default_rng(51)
    n = 8000
    db = Database()
    db.create(Table.from_columns("lv", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 10, n)]),
        "x": column_from_values(
            T.INT4, [None if i % 19 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 50, n))]),
    }))
    q = ("select g, count(distinct x), count(*) from lv group by g "
         "order by g")
    pdb = port_db(db)
    r, p = both(db, q, pdb=pdb, cfg={"distributed": False})
    assert p.counts.get("dist_distinct_steps", 0) >= 1, p.counts
    p1 = port_run(q, pdb, debug_force_offload=True, mesh_shards=0)
    assert p1.text == r.text
    assert p1.counts.get("dist_distinct_steps", 0) >= 1, p1.counts
    _r, p2 = both(db, q, pdb=pdb, cfg={"distributed": False,
                                       "device_distinct": False})
    assert p2.counts.get("dist_distinct_steps", 0) == 0


def test_distinct_float_args_pg_equality():
    f4 = [1.5, -0.0, 0.0, float("nan"), float("nan"), 2.5, 1.5, None]
    f8 = [3.25, 0.0, -0.0, float("nan"), 7.5, float("nan"), 3.25, None]
    g = [1, 1, 1, 1, 1, 2, 2, 2]
    db = Database()
    db.create(Table.from_columns("fd", {
        "g": column_from_values(T.INT4, g * 50),
        "a": column_from_values(T.FLOAT4, f4 * 50),
        "b": column_from_values(T.FLOAT8, f8 * 50),
    }))
    pdb = port_db(db)
    for q in (
        "select g, count(distinct a) from fd group by g order by g",
        "select g, count(distinct b) from fd group by g order by g",
        "select g, sum(distinct b) from fd group by g order by g",
    ):
        _r, p = both(db, q, pdb=pdb)
        assert p.counts.get("dist_distinct_steps", 0) >= 1, q


def test_multiple_distinct_aggs_one_query():
    rng = np.random.default_rng(52)
    n = 6000
    db = Database()
    db.create(Table.from_columns("md", {
        "g": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 7, n)]),
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 25, n)]),
        "b": column_from_values(
            T.INT8, [None if i % 11 == 0 else int(v)
                     for i, v in enumerate(rng.integers(0, 90, n))]),
    }))
    q = ("select g, count(distinct a), count(distinct b), sum(distinct a), "
         "count(*) from md group by g order by g")
    _r, p = both(db, q)
    assert p.counts.get("dist_distinct_steps", 0) >= 3, p.counts


def test_distinct_numeric_count():
    vals = [Decimal("1.0"), Decimal("1.00"), Decimal("1.000"),
            Decimal("2.5"), Decimal("2.50"), None, Decimal("0"),
            Decimal("0.00"), Decimal("-3.14")]
    g = [1, 1, 1, 1, 2, 2, 2, 2, 2]
    db = Database()
    db.create(Table.from_columns("nd", {
        "g": column_from_values(T.INT4, g * 40),
        "n": column_from_values(T.NUMERIC, vals * 40),
    }))
    q = "select g, count(distinct n), count(n) from nd group by g order by g"
    _r, p = both(db, q)
    assert [r[1] for r in p.rows] == [2, 3]
    assert p.counts.get("dist_distinct_steps", 0) >= 1


def _skew_db(seed, nf, nd, hot, w=True):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(nf) < 0.9, hot,
                    rng.integers(0, nd, nf)).astype(int)
    db = Database()
    db.create(Table.from_columns("sf", {
        "k": column_from_values(T.INT4, [int(v) for v in keys]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    dim = {"dk": column_from_values(T.INT4, list(range(nd)))}
    if w:
        dim["w"] = column_from_values(T.INT8, [3 * i for i in range(nd)])
    db.create(Table.from_columns("sd", dim))
    return db


def test_skew_routing_keeps_hot_key_distributed():
    """~90% of probe rows carry ONE key: the heavy-hitter router keeps the
    query distributed with no capacity doubling, in both packages."""
    db = _skew_db(44, 16000, 50, 7)
    q = ("select sf.k, count(*), sum(sf.x), sum(sd.w) from sf, sd "
         "where sf.k = sd.dk group by sf.k order by sf.k")
    _r, p = both(db, q)
    assert p.counts.get("dist_skew_routed", 0) >= 1, p.counts
    assert p.counts.get("dist_repartitions", 0) == 0, p.counts
    assert _engaged(p)


def test_skew_routing_2d_mesh_exact():
    db = _skew_db(48, 8000, 30, 11, w=False)
    q = ("select sf.k, count(*), sum(sf.x) from sf, sd "
         "where sf.k = sd.dk group by sf.k order by sf.k")
    _r, p = both(db, q, cfg={"dist_mesh_hosts": 2})
    assert p.counts.get("dist_skew_routed", 0) >= 1, p.counts
    assert p.counts.get("dist_repartitions", 0) == 0, p.counts


def test_skew_routing_off_still_exact():
    db = _skew_db(45, 4000, 20, 3, w=False)
    q = ("select sf.k, count(*), sum(sf.x) from sf, sd "
         "where sf.k = sd.dk group by sf.k order by sf.k")
    both(db, q, cfg={"dist_skew_routing": False})


def test_skew_routing_balance_property():
    """The router's balance is a pure function of the hash and the spread:
    the port's host_combine_hash and detect_heavy_keys give the
    reference's routing, so the same loads."""
    from pg_strom_tpu.parallel.dist import host_combine_hash as r_hash
    from pg_strom_tpu.parallel.shuffle import detect_heavy_keys as r_heavy
    from pg_strom_tpu_torch.parallel.dist import host_combine_hash
    from pg_strom_tpu_torch.parallel.shuffle import detect_heavy_keys, \
        _HEAVY_SENTINEL
    rng = np.random.default_rng(50)
    n, ndev = 200_000, 8
    keys = np.where(rng.random(n) < 0.9, 7,
                    rng.integers(0, 1000, n)).astype(np.int64)
    h = host_combine_hash([keys])
    np.testing.assert_array_equal(h, r_hash([keys]))
    part_plain = (h.astype(np.uint64) % np.uint64(ndev)).astype(int)
    loads = np.bincount(part_plain, minlength=ndev)
    assert loads.max() > 3.0 * loads.mean(), loads
    heavy = detect_heavy_keys(h, np.ones(n, bool), k_heavy=8)
    np.testing.assert_array_equal(heavy, r_heavy(h, np.ones(n, bool),
                                                 k_heavy=8))
    nh = int((heavy != _HEAVY_SENTINEL).sum())
    assert nh >= 1
    part = np.where(np.isin(h, heavy[:nh]), np.arange(n) % ndev, part_plain)
    loads2 = np.bincount(part, minlength=ndev)
    assert loads2.max() <= 1.15 * loads2.mean(), loads2
