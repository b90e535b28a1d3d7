"""The port's distributed steps (pg_strom_tpu_torch/parallel/dist.py) shard
for shard against the reference's on its 8-device CPU rig.

The same seeded lanes go through `build_dist_join_agg_step` (flat and the
(2, 4) hosts x chips mesh, skew routing on and off, with a DISTINCT phase)
and `build_dist_preagg_step` (grouped and ungrouped, with DISTINCT
phases).  For every shard and every phase, the shard's groups must equal
the reference device's as a set: group keys and their validity, counts,
integer partials, `err` and `ovf` exactly, float partials within 1e-12
relative (the summation order may differ).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pg_strom_tpu  # noqa: F401
from pg_strom_tpu.parallel import dist as rd, mesh as r_mesh
from pg_strom_tpu.parallel import shuffle as r_shuffle
from pg_strom_tpu.sqltypes import T as RT
from pg_strom_tpu_torch import override as p_override
from pg_strom_tpu_torch.parallel import dist as pd, mesh as p_mesh
from pg_strom_tpu_torch.parallel.shuffle import shard_host
from pg_strom_tpu_torch.sqltypes import T as PT

NDEV = 8


@pytest.fixture(autouse=True)
def _cpu_mesh():
    with p_override(device="cpu", mesh_shards=NDEV):
        yield


def _sig(mod, T, join: bool, ungrouped: bool = False):
    L = mod.LaneSpec
    b = "build" if join else "probe"
    gkeys = () if ungrouped else (L("probe", T.INT4, "gkey"),
                                  L(b, T.TEXT, "gkey"))
    aggs = (
        ((), ("nrows",)),
        ((L("probe", T.FLOAT8, "arg"),), ("count", "sum_f", "sumsq_f")),
        ((L(b, T.INT8, "arg"),), ("sum_i", "sumsq_i")),
        ((L("probe", T.INT4, "arg"),), ("min", "max")),
        ((L("probe", T.FLOAT4, "arg"),), ("count", "sum_f")),
        ((L("probe", T.INT4, "arg"),), ("count", "sum_i")),   # DISTINCT
        ((L(b, T.FLOAT8, "arg"),), ("count", "sum_f")),       # DISTINCT
    )
    return mod.DistPlanSig(n_probe_jkeys=1 if join else 0,
                           n_build_jkeys=1 if join else 0,
                           gkeys=gkeys, aggs=aggs, ungrouped=ungrouped)


DISTINCT = (5, 6)


def _lanes(rng, n, side, hot=False, nkeys=120):
    """Wire lanes of one side: (join key, {spec index: (data, valid)})."""
    k = rng.integers(0, nkeys, n).astype(np.int64)
    if hot:
        k = np.where(rng.random(n) < 0.85, 7, k)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.02] = -0.0
    x[rng.random(n) < 0.02] = np.nan
    f4 = rng.normal(size=n).astype(np.float32)
    return {
        "jk": k,
        "g_int": (rng.integers(0, 9, n).astype(np.int64),
                  rng.random(n) > 0.05),
        "g_text": (rng.integers(0, 6, n).astype(np.int64),
                   rng.random(n) > 0.05),
        "f8": (np.ascontiguousarray(x).view(np.int64),
               rng.random(n) > 0.05),
        "i8": (rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64),
               rng.random(n) > 0.05),
        "i4": (rng.integers(-500, 500, n).astype(np.int64),
               rng.random(n) > 0.05),
        "f4": (f4, rng.random(n) > 0.05),
        "d4": (rng.integers(0, 40, n).astype(np.int64),
               rng.random(n) > 0.1),
        "df8": (np.ascontiguousarray(np.round(rng.normal(size=n), 1))
                .view(np.int64), rng.random(n) > 0.1),
    }


def _zero_nulls(d, v):
    return np.where(v, d, np.zeros((), d.dtype))


def _join_args(seed, hot):
    rng = np.random.default_rng(seed)
    npr, nb = 2048, 512
    p = _lanes(rng, npr, "probe", hot=hot)
    b = _lanes(rng, nb, "build")
    b["jk"] = np.arange(nb, dtype=np.int64) % 150     # 0..149, some twice
    pvalid = rng.random(npr) > 0.03
    bvalid = np.ones(nb, bool)
    plan = [p["g_int"], p["f8"], p["i4"], p["f4"], p["d4"]]
    blan = [b["g_text"], b["i8"], b["df8"]]
    args = ([p["jk"], pvalid] + [_zero_nulls(d, v) for d, v in plan]
            + [v for _, v in plan]
            + [b["jk"], bvalid] + [_zero_nulls(d, v) for d, v in blan]
            + [v for _, v in blan])
    return args, p["jk"], pvalid


def _preagg_args(seed, ungrouped):
    rng = np.random.default_rng(seed)
    n = 4096
    p = _lanes(rng, n, "probe")
    names = ([] if ungrouped else ["g_int", "g_text"]) + \
        ["f8", "i8", "i4", "f4", "d4", "df8"]
    lanes = [p[nm] for nm in names]
    valid = rng.random(n) > 0.03
    return ([valid] + [_zero_nulls(d, v) for d, v in lanes]
            + [v for _, v in lanes])


def _phase_groups(gk, gkv, gvalid, slots):
    """{(key lanes, key valids): [{slot: value}, ...]} of one shard's
    phase.  A key can own several slots: the local grouping sorts by a
    packed hash, and the host merge folds such repeats (both packages
    repeat the same keys in the same order)."""
    out: dict = {}
    gvalid = np.asarray(gvalid)
    for g in np.flatnonzero(gvalid):
        key = tuple(int(np.asarray(a)[g]) for a in gk) + \
            tuple(bool(np.asarray(a)[g]) for a in gkv)
        vals = {}
        for ai, d in enumerate(slots):
            for nm, arr in d.items():
                vals[(ai, nm)] = np.asarray(arr)[g]
        out.setdefault(key, []).append(vals)
    return out


def _assert_same_groups(got, want, where):
    assert set(got) == set(want), where
    for key, wl in want.items():
        gl = got[key]
        assert len(gl) == len(wl), (where, key)
        for gv, wv in zip(gl, wl):
            _assert_same_slots(gv, wv, (where, key))


def _assert_same_slots(gv, wv, where):
    assert set(gv) == set(wv), where
    for slot, w in wv.items():
        g = gv[slot]
        if np.asarray(w).dtype.kind == "f":
            if np.isnan(w):
                assert np.isnan(g), (where, slot)
            else:
                assert g == pytest.approx(w, rel=1e-12, abs=1e-300), \
                    (where, slot, g, w)
        else:
            assert g == w, (where, slot, g, w)


def _split(tree, d):
    """Device d's block of the reference's global (sharded) outputs."""
    if isinstance(tree, dict):
        return {k: _split(v, d) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, d) for v in tree)
    a = np.asarray(tree)
    return np.split(a, NDEV)[d]


def _compare(rout, pouts, n_distinct):
    for d, po in enumerate(pouts):
        ro = _split(tuple(rout), d)
        po = tuple(p.numpy() if isinstance(p, torch.Tensor) else p
                   for p in po)
        assert int(np.asarray(po[4])[0]) == int(np.asarray(ro[4])[0]), d
        assert bool(np.asarray(po[5])[0]) == bool(np.asarray(ro[5])[0]), d
        phases = [(0, 1, 2, 3)] + [(6 + 4 * j, 7 + 4 * j, 8 + 4 * j,
                                    9 + 4 * j) for j in range(n_distinct)]
        for ph, idx in enumerate(phases):
            got = _phase_groups(*(_host(po[i]) for i in idx))
            want = _phase_groups(*(ro[i] for i in idx))
            _assert_same_groups(got, want, (d, ph))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


@pytest.mark.parametrize("topo", ["flat", "2x4"])
@pytest.mark.parametrize("skew", [False, True], ids=["plain", "skew"])
def test_dist_join_agg_step_matches_reference(topo, skew):
    args, pk, pvalid = _join_args(5, hot=skew)
    rmesh = r_mesh.get_mesh(NDEV) if topo == "flat" else \
        r_mesh.get_mesh2(2, 4)
    pmesh = p_mesh.get_mesh(NDEV) if topo == "flat" else \
        p_mesh.get_mesh2(2, 4)
    kw = dict(bucket_cap=512, nbuckets=512, max_chain=16, G=1024,
              distinct_idxs=DISTINCT, dedup_cap=2048)
    heavy = None
    if skew:
        h = pd.host_combine_hash([pk])
        np.testing.assert_array_equal(h, rd.host_combine_hash([pk]))
        heavy = r_shuffle.detect_heavy_keys(h, pvalid, k_heavy=8)
        assert (heavy != r_shuffle._HEAVY_SENTINEL).sum() >= 1
        kw.update(k_heavy=8, heavy_cap=256)
    rstep = rd.build_dist_join_agg_step(rmesh, _sig(rd, RT, True), **kw)
    pstep = pd.build_dist_join_agg_step(pmesh, _sig(pd, PT, True), **kw)
    rout = rstep(*args, heavy) if skew else rstep(*args)
    sh = [shard_host(a, pmesh) for a in args]
    pouts = pstep(*sh, torch.from_numpy(heavy)) if skew else pstep(*sh)
    _compare(rout, pouts, len(DISTINCT))
    # capacities that hold: the comparison is of real partials
    assert not any(bool(o[5][0]) for o in pouts)


def test_dist_join_agg_overflow_flags_match_reference():
    """Undersized buckets, chains and group slots: the overflow flags that
    drive the repartition ladder are the reference's, shard for shard."""
    args, _pk, _pv = _join_args(9, hot=True)
    kw = dict(bucket_cap=64, nbuckets=64, max_chain=2, G=16,
              distinct_idxs=(5,), dedup_cap=64)
    rout = rd.build_dist_join_agg_step(r_mesh.get_mesh(NDEV),
                                       _sig(rd, RT, True), **kw)(*args)
    pmesh = p_mesh.get_mesh(NDEV)
    pouts = pd.build_dist_join_agg_step(pmesh, _sig(pd, PT, True), **kw)(
        *[shard_host(a, pmesh) for a in args])
    want = [bool(v) for v in np.asarray(rout[5])]
    assert [bool(o[5][0]) for o in pouts] == want
    assert any(want)


@pytest.mark.parametrize("topo", ["flat", "2x4"])
@pytest.mark.parametrize("ungrouped", [False, True],
                         ids=["grouped", "ungrouped"])
def test_dist_preagg_step_matches_reference(topo, ungrouped):
    args = _preagg_args(13, ungrouped)
    rmesh = r_mesh.get_mesh(NDEV) if topo == "flat" else \
        r_mesh.get_mesh2(2, 4)
    pmesh = p_mesh.get_mesh(NDEV) if topo == "flat" else \
        p_mesh.get_mesh2(2, 4)
    kw = dict(G=1024, distinct_idxs=DISTINCT, dedup_cap=1024)
    rout = rd.build_dist_preagg_step(
        rmesh, _sig(rd, RT, False, ungrouped), **kw)(*args)
    pouts = pd.build_dist_preagg_step(
        pmesh, _sig(pd, PT, False, ungrouped), **kw)(
        *[shard_host(a, pmesh) for a in args])
    _compare(rout, pouts, len(DISTINCT))
    assert not any(bool(o[5][0]) for o in pouts)


def test_build_counts_follow_topology():
    before = dict(pd.BUILD_COUNTS)
    pd.build_dist_join_agg_step(p_mesh.get_mesh(NDEV), _sig(pd, PT, True))
    pd.build_dist_join_agg_step(p_mesh.get_mesh2(2, 4), _sig(pd, PT, True))
    assert pd.BUILD_COUNTS["exchange_flat"] == before["exchange_flat"] + 1
    assert pd.BUILD_COUNTS["exchange_2stage"] == \
        before["exchange_2stage"] + 1


def test_lexsort_and_canon_match_reference():
    """The dedup phase's building blocks: the stable LSD lexsort is
    jnp.lexsort's order, and float canonicalization gives PG equality
    (-0.0 == +0.0, one NaN) as the reference's bits."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, 4, 300).astype(np.int64) for _ in range(3)] + \
        [rng.random(300) > 0.5]
    want = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
    got = pd._lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)
    f = np.array([0.0, -0.0, np.nan, -np.nan, 1.5, np.inf], np.float64)
    bits = f.view(np.int64).copy()
    bits[3] = np.int64(0x7FF0000000000001)           # another NaN payload
    sp = pd.LaneSpec("probe", PT.FLOAT8, "arg")
    c = pd._canon(torch.from_numpy(bits), sp).numpy()
    assert c[0] == c[1] == 0 and c[2] == c[3] == 0x7FF8000000000000
    f4 = torch.tensor([0.0, -0.0, float("nan"), 2.5], dtype=torch.float32)
    c4 = pd._bitproxy(pd._canon(f4, pd.LaneSpec("probe", PT.FLOAT4, "arg")),
                      pd.LaneSpec("probe", PT.FLOAT4, "arg")).numpy()
    assert c4[0] == c4[1] == 0 and c4[2] == 0x7FC00000
