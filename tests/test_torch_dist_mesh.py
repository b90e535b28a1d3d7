"""The port's data-parallel aggregation, edge cases, resident lanes, the
hosts x chips mesh, expression lanes, distributed top-k and the grouping
sets / window surface under pg_strom.distributed, against the reference:
tests/test_dist.py's remaining cases, case for case, through both
packages (tests/torch_dist_common.py)."""

from __future__ import annotations

import numpy as np
import pytest

import pg_strom_tpu_torch as P
from pg_strom_tpu import T
from pg_strom_tpu.datastore import Database, Table, column_from_values
from torch_dist_common import NDEV, both, port_db, port_run, ref_run, DIST

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
        "q": column_from_values(
            T.INT8, [int(v) for v in rng.integers(-10**9, 10**9, nf)]),
        "s": column_from_values(
            T.INT2, [int(v) for v in rng.integers(-300, 300, nf)]),
    }))
    return db, port_db(db)


class TestDistPreAgg:
    """Single-table distributed GROUP BY (data-parallel shards + host
    merge) engages in both packages and agrees."""

    def test_single_table_group_by(self, dbs):
        q = ("select fact.k2, count(*), sum(fact.q), min(fact.s), "
             "max(fact.s), avg(fact.x), stddev(fact.x) "
             "from fact group by fact.k2 order by fact.k2")
        _r, p = both(dbs[0], q, pdb=dbs[1])
        assert p.counts.get("dist_steps", 0) == 1, p.counts

    def test_single_table_with_where(self, dbs):
        q = ("select fact.k2, count(fact.x), sum(fact.x) from fact "
             "where fact.s > 0 group by fact.k2 order by fact.k2")
        both(dbs[0], q, pdb=dbs[1])

    def test_ungrouped_single_table(self, dbs):
        both(dbs[0], "select count(*), sum(fact.q), max(fact.x) from fact",
             pdb=dbs[1])

    def test_group_slot_ladder(self, dbs):
        q = ("select fact.k, count(*) from fact group by fact.k "
             "order by fact.k")
        _r, p = both(dbs[0], q, pdb=dbs[1], cfg={"dist_group_slots": 64})
        assert p.counts.get("dist_repartitions", 0) >= 1, p.counts


class TestDistEdgeCases:
    def test_all_null_join_keys(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [None] * 64),
            "x": column_from_values(T.FLOAT8, [1.0] * 64)}))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.INT4, list(range(8)))}))
        _r, p = both(db, "select count(*), sum(f.x) from f, d "
                         "where f.k = d.dk")
        assert p.rows == [(0, None)]

    def test_null_group_key_group(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [1, 1, 2, 2, 1, 2] * 20),
            "g": column_from_values(T.INT4,
                                    ([None, 5, None, 7, 5, 7] * 20)),
            "x": column_from_values(T.FLOAT8, [float(i) for i in range(120)]),
        }))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.INT4, [1, 2])}))
        q = ("select f.g, count(*), sum(f.x) from f, d where f.k = d.dk "
             "group by f.g order by f.g")
        _r, p = both(db, q)
        assert p.rows[-1][0] is None

    def test_float_join_keys_negzero_and_nan(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.FLOAT8,
                                    [0.0, -0.0, float("nan"), 1.5] * 16),
            "x": column_from_values(T.FLOAT8, [1.0] * 64)}))
        db.create(Table.from_columns("d", {
            "dk": column_from_values(T.FLOAT8, [0.0, float("nan"), 1.5])}))
        _r, p = both(db, "select count(*) from f, d where f.k = d.dk")
        assert p.rows[0][0] == 64

    def test_single_table_all_rows_filtered(self):
        db = Database()
        db.create(Table.from_columns("f", {
            "k": column_from_values(T.INT4, [1, 2, 3]),
            "x": column_from_values(T.FLOAT8, [1.0, 2.0, 3.0])}))
        _r, p = both(db, "select f.k, count(*) from f where f.x > 99 "
                         "group by f.k")
        assert p.rows == []


def test_resident_sharded_lanes_reused():
    """The prepared lanes shard over the mesh once (tcache aux space): a
    repeated query hits them and ships 0 bytes host to device."""
    rng = np.random.default_rng(21)
    nf = 2000
    db = Database()
    db.create(Table.from_columns("rf", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 40, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("rd_", {
        "dk": column_from_values(T.INT4, list(range(40))),
    }))
    q = ("select rf.k, count(*), sum(rf.x) from rf, rd_ "
         "where rf.k = rd_.dk group by rf.k order by rf.k")
    pdb = port_db(db)
    r1, p1 = both(db, q, pdb=pdb, local=False)
    r2, p2 = both(db, q, pdb=pdb, local=False)
    assert p1.text == p2.text
    assert p1.counts.get("dist_resident_hits", 0) == 0
    assert p1.bytes.get("h2d", 0) > 0
    assert p2.counts.get("dist_resident_hits", 0) >= 1, p2.counts
    assert p2.bytes.get("h2d", 0) == 0, p2.bytes


class TestHierarchicalMesh:
    """The 2D hosts x chips mesh: the exchange runs all_to_all over
    "chips" then "hosts"; rows must match the flat mesh and the
    reference."""

    @pytest.fixture(scope="class")
    def hdb(self):
        rng = np.random.default_rng(77)
        nf, nd = 4000, 120
        db = Database()
        db.create(Table.from_columns("hf", {
            "k": column_from_values(T.INT4,
                                    [int(v) for v in
                                     rng.integers(0, nd, nf)]),
            "x": column_from_values(T.FLOAT8,
                                    [None if i % 23 == 0 else float(v)
                                     for i, v in enumerate(rng.random(nf))]),
            "q": column_from_values(T.INT8,
                                    [int(v) for v in
                                     rng.integers(-10**6, 10**6, nf)]),
        }))
        db.create(Table.from_columns("hd", {
            "dk": column_from_values(T.INT4, list(range(nd))),
            "cat": column_from_values(T.TEXT,
                                      [f"c{i % 5}" for i in range(nd)]),
        }))
        return db, port_db(db)

    def test_2d_mesh_join_agg_matches(self, hdb):
        q = ("select hd.cat, count(*), sum(hf.x), min(hf.q), max(hf.q) "
             "from hf, hd where hf.k = hd.dk group by hd.cat "
             "order by hd.cat")
        _r, p2 = both(hdb[0], q, pdb=hdb[1], cfg={"dist_mesh_hosts": 2})
        _r, p1 = both(hdb[0], q, pdb=hdb[1])
        assert p1.text == p2.text

    def test_2d_mesh_shapes(self):
        from pg_strom_tpu_torch.parallel.mesh import get_mesh2, \
            mesh_for_config
        with P.override(device="cpu", mesh_shards=NDEV):
            m = get_mesh2(2, 4)
            assert m.axis_names == ("hosts", "chips")
            assert m.shape["hosts"] == 2 and m.shape["chips"] == 4
            with P.override(dist_mesh_hosts=2):
                assert mesh_for_config(8).axis_names == ("hosts", "chips")
            with P.override(dist_mesh_hosts=1):
                assert mesh_for_config(8).axis_names == ("dp",)

    def test_2d_single_table_group_by(self, hdb):
        q = ("select hf.k, count(*), sum(hf.q) from hf group by hf.k "
             "order by hf.k")
        both(hdb[0], q, pdb=hdb[1], cfg={"dist_mesh_hosts": 2})

    def test_2d_distinct_aggregate(self, hdb):
        q = ("select hf.k, count(distinct hf.q), count(*) from hf "
             "group by hf.k order by hf.k")
        _r, p = both(hdb[0], q, pdb=hdb[1], cfg={"dist_mesh_hosts": 2})
        assert p.counts.get("dist_distinct_steps", 0) >= 1

    def test_mesh_toggle_switches_programs(self, hdb):
        """Toggling pg_strom.dist_mesh_hosts builds a step for the new
        topology instead of serving the cached one; back to flat, the
        cached flat step serves."""
        from pg_strom_tpu_torch.parallel.dist import BUILD_COUNTS
        q = ("select hd.cat, count(*), sum(hf.q) from hf, hd "
             "where hf.k = hd.dk group by hd.cat order by hd.cat")
        both(hdb[0], q, pdb=hdb[1])
        n2d = BUILD_COUNTS["exchange_2stage"]
        both(hdb[0], q, pdb=hdb[1], cfg={"dist_mesh_hosts": 2})
        assert BUILD_COUNTS["exchange_2stage"] > n2d, BUILD_COUNTS
        nflat = BUILD_COUNTS["exchange_flat"]
        both(hdb[0], q, pdb=hdb[1])
        assert BUILD_COUNTS["exchange_flat"] == nflat


def test_expression_keys_and_args_distribute():
    rng = np.random.default_rng(31)
    nf = 3000
    db = Database()
    db.create(Table.from_columns("ef", {
        "k": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 60, nf)]),
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 50, nf)]),
        "x": column_from_values(T.FLOAT8,
                                [float(v) for v in rng.random(nf)]),
    }))
    db.create(Table.from_columns("ed", {
        "dk": column_from_values(T.INT4, list(range(60))),
    }))
    q = ("select ef.k % 7, count(*), sum(ef.a + 1), sum(ef.x * 2) "
         "from ef, ed where ef.k = ed.dk group by ef.k % 7 "
         "order by ef.k % 7")
    _r, p = both(db, q)
    assert p.counts.get("dist_steps", 0) == 1, p.counts


def test_distributed_topk(monkeypatch):
    """ORDER BY + LIMIT shards over the mesh (a top-k a shard, host
    candidate merge) in both packages, ties resolved by row order."""
    from pg_strom_tpu.plan import planner as r_planner
    from pg_strom_tpu_torch.plan import planner as p_planner
    rng = np.random.default_rng(41)
    n = 9000
    db = Database()
    db.create(Table.from_columns("tk", {
        "a": column_from_values(T.INT4,
                                [int(v) for v in rng.integers(0, 500, n)]),
        "x": column_from_values(T.FLOAT8,
                                [None if i % 31 == 0 else float(v)
                                 for i, v in enumerate(rng.random(n))]),
        "id": column_from_values(T.INT8, list(range(n))),
    }))
    q = ("select tk.a, tk.x, tk.id from tk where tk.a < 400 "
         "order by tk.a desc, tk.x limit 25")
    ran = {}
    for tag, mod in (("ref", r_planner), ("port", p_planner)):
        orig = mod._topk_rows_dist

        def spy(*a, _orig=orig, _tag=tag, **kw):
            r = _orig(*a, **kw)
            ran[_tag] = r is not None
            return r
        monkeypatch.setattr(mod, "_topk_rows_dist", spy)
    pdb = port_db(db)
    both(db, q, pdb=pdb)
    assert ran == {"ref": True, "port": True}, ran
    p2 = port_run(q, pdb, **DIST)      # resident shard planes: 0 bytes
    assert p2.counts.get("dist_resident_hits", 0) >= 1
    assert p2.bytes.get("h2d", 0) == 0, p2.bytes


class TestDistNewSurface:
    """Grouping sets ride the distributed aggregate per set, and windowed
    queries distribute their inner stage."""

    @pytest.fixture(scope="class")
    def sdb(self):
        rng = np.random.default_rng(11)
        n = 4000
        d = Database()
        d.create(Table.from_columns("ds", {
            "a": column_from_values(T.INT4,
                                    [int(v) for v in rng.integers(0, 6, n)]),
            "b": column_from_values(T.INT4,
                                    [int(v) for v in rng.integers(0, 4, n)]),
            "v": column_from_values(T.INT4,
                                    [int(v) for v in
                                     rng.integers(0, 100, n)]),
        }))
        return d, port_db(d)

    def test_rollup_engages_mesh(self, sdb):
        q = "select a, b, sum(v), count(*) from ds group by rollup(a, b)"
        r = ref_run(q, sdb[0], **DIST)
        p = port_run(q, sdb[1], **DIST)
        assert sorted(p.text) == sorted(r.text)
        assert p.dist == r.dist
        assert p.counts.get("dist_steps", 0) >= 1

    def test_window_inner_engages_mesh(self, sdb):
        q = ("select a, rank() over (order by s desc) from "
             "(select a, sum(v) s from ds group by a) q")
        r = ref_run(q, sdb[0], **DIST)
        p = port_run(q, sdb[1], **DIST)
        assert sorted(p.text) == sorted(r.text)
        _r, pi = both(sdb[0], "select a, sum(v) s from ds group by a "
                              "order by a", pdb=sdb[1])
        assert pi.counts.get("dist_steps", 0) >= 1

    def test_windowed_plain_query_runs_distributed(self, sdb):
        q = ("select a, sum(v) over (partition by a order by b, v) "
             "from ds where v > 10")
        r = ref_run(q, sdb[0], **DIST)
        p = port_run(q, sdb[1], **DIST)
        assert sorted(p.text) == sorted(r.text)


def test_mesh_hosts_gucs_degrade_on_too_few_devices():
    """dist_mesh_hosts is a layout hint: a shard count it cannot split
    degrades to the flat mesh instead of failing."""
    from pg_strom_tpu_torch.parallel.mesh import mesh_for_config
    with P.override(device="cpu", mesh_shards=1, dist_mesh_hosts=2):
        m = mesh_for_config()
        assert m.ndev == 1 and m.axis_names == ("dp",)
    with P.override(device="cpu", mesh_shards=8, dist_mesh_hosts=3):
        m = mesh_for_config()
        assert len(m.dims) == 1 and m.ndev == 8


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    """The port's dryrun_multichip on an n-shard CPU mesh: the flat and
    the (2, n/2) meshes, the repartition ladder and the raw shuffle."""
    from pg_strom_tpu_torch.parallel.dryrun import dryrun_multichip
    with P.override(device="cpu"):
        out = dryrun_multichip(n)
    assert out["mesh_2d"] == f"2x{n // 2}" and out["repartitions"] >= 1
    assert out["flat_rows"] == 5 and out["shuffle_groups"] > 0
