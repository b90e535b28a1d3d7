"""The port's mesh collectives and shuffle join+aggregate step against the
JAX reference on its 8-device CPU rig (tests/conftest.py).

- `all_to_all` / `all_gather` over a list of per-shard tensors equal
  `lax.all_to_all(x, ax, 0, 0, tiled=False)` / `lax.all_gather` under
  `shard_map`, flat and along each axis of a (2, 4) mesh.
- `build_shuffle_join_agg_step` (tests/test_shuffle.py case for case):
  every shard's groups equal the reference device's — keys, validity,
  counts and overflow flags exactly, float sums within 1e-12 relative —
  with the shard count `mesh_shards=8` on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pg_strom_tpu  # noqa: F401
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as Pspec

from pg_strom_tpu.parallel import mesh as r_mesh, shuffle as r_shuffle
from pg_strom_tpu_torch import override as p_override
from pg_strom_tpu_torch.parallel import mesh as p_mesh, shuffle as p_shuffle


@pytest.fixture(autouse=True)
def _cpu_mesh():
    with p_override(device="cpu", mesh_shards=8):
        yield


def _shard_out(arr, ndev):
    a = np.asarray(arr)
    return np.split(a, ndev)


# --- the collectives ---------------------------------------------------------

def _ref_collective(mesh, axis, fn, x):
    axes = tuple(mesh.axis_names)
    spec = Pspec(axes if len(axes) > 1 else axes[0])
    f = shard_map(lambda b: fn(b[0], axis)[None], mesh=mesh,
                  in_specs=spec, out_specs=spec)
    return np.asarray(jax.jit(f)(x))


@pytest.mark.parametrize("topo,axis", [("flat", "dp"), ("2d", "chips"),
                                       ("2d", "hosts")])
@pytest.mark.parametrize("op", ["all_to_all", "all_gather",
                                "all_gather_tiled"])
def test_collectives_match_lax(topo, axis, op):
    rmesh = r_mesh.get_mesh(8) if topo == "flat" else r_mesh.get_mesh2(2, 4)
    pmesh = p_mesh.get_mesh(8) if topo == "flat" else p_mesh.get_mesh2(2, 4)
    assert pmesh.axis_names == tuple(rmesh.axis_names)
    assert pmesh.shape == dict(rmesh.shape)
    na = pmesh.shape[axis]
    rng = np.random.default_rng(3)
    x = rng.integers(-1000, 1000, (8, na, 5)).astype(np.int64)
    if op == "all_to_all":
        want = _ref_collective(
            rmesh, axis,
            lambda b, ax: jax.lax.all_to_all(b, ax, 0, 0, tiled=False), x)
        got = p_mesh.all_to_all([torch.from_numpy(b) for b in x], pmesh,
                                axis)
    else:
        tiled = op == "all_gather_tiled"
        want = _ref_collective(
            rmesh, axis,
            lambda b, ax: jax.lax.all_gather(b, ax, tiled=tiled), x)
        got = p_mesh.all_gather([torch.from_numpy(b) for b in x], pmesh,
                                axis, tiled=tiled)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_mesh_shards_and_topologies():
    with p_override(mesh_shards=0):
        assert p_mesh.mesh_size() == 1          # the CPU: one shard
    m = p_mesh.get_mesh2(2, 4)
    assert m.axis_names == ("hosts", "chips") and m.dims == (2, 4)
    assert [m.peers(5, "chips"), m.peers(5, "hosts")] == \
        [[4, 5, 6, 7], [1, 5]]
    with p_override(dist_mesh_hosts=2):
        assert p_mesh.mesh_for_config(8).axis_names == ("hosts", "chips")
    with p_override(dist_mesh_hosts=3):      # 8 % 3: degrades to flat
        assert p_mesh.mesh_for_config(8).axis_names == ("dp",)
    with p_override(dist_mesh_hosts=2, mesh_shards=1):
        m1 = p_mesh.mesh_for_config()
        assert m1.axis_names == ("dp",) and m1.ndev == 1
    with pytest.raises(RuntimeError, match="mesh shards"):
        p_mesh.get_mesh(9)


# --- build_shuffle_join_agg_step, shard for shard ---------------------------

def _both_steps(ndev, args, heavy=None, **kw):
    rmesh = r_mesh.get_mesh(ndev)
    pmesh = p_mesh.get_mesh(ndev)
    rstep = r_shuffle.build_shuffle_join_agg_step(rmesh, **kw)
    pstep = p_shuffle.build_shuffle_join_agg_step(pmesh, **kw)
    rout = rstep(*args, heavy) if heavy is not None else rstep(*args)
    sh = [p_shuffle.shard_host(np.asarray(a), pmesh) for a in args]
    pout = pstep(*sh, torch.from_numpy(heavy)) if heavy is not None \
        else pstep(*sh)
    return rout, pout


def _assert_same_shards(rout, pout, ndev):
    fk, fv, fcnt, fsum, ovf = (_shard_out(a, ndev) for a in rout)
    for d, (pk, pv, pc, ps, po) in enumerate(pout):
        assert bool(po.numpy()[0]) == bool(ovf[d][0]), d
        np.testing.assert_array_equal(pv.numpy(), fv[d])
        want = {int(k): (int(c), float(s))
                for k, v, c, s in zip(fk[d], fv[d], fcnt[d], fsum[d]) if v}
        got = {int(k): (int(c), float(s))
               for k, v, c, s in zip(pk.numpy(), pv.numpy(), pc.numpy(),
                                     ps.numpy()) if v}
        assert set(got) == set(want), d
        for k, (c, s) in want.items():
            assert got[k][0] == c
            assert got[k][1] == pytest.approx(s, rel=1e-12, abs=0)


@pytest.mark.parametrize("ndev", [2, 8])
def test_shuffle_join_agg_matches_reference(ndev):
    rng = np.random.default_rng(42)
    NP_, NB = 64 * ndev, 32 * ndev
    args = (rng.integers(0, 40, NP_).astype(np.int64),
            rng.random(NP_).astype(np.float64), rng.random(NP_) > 0.1,
            rng.integers(0, 40, NB).astype(np.int64),
            rng.integers(1, 10, NB).astype(np.int64), rng.random(NB) > 0.1)
    rout, pout = _both_steps(ndev, args, bucket_cap=256, nbuckets=256,
                             max_chain=16, G=128)
    _assert_same_shards(rout, pout, ndev)
    got = p_shuffle.host_merge_group_partials(
        *p_shuffle.gather_host(pout)[:4])
    assert got == pytest.approx(r_shuffle.host_merge_group_partials(
        *rout[:4]), rel=1e-12)


def test_each_group_on_one_shard():
    rng = np.random.default_rng(1)
    NP_, NB = 256, 128
    args = (rng.integers(0, 16, NP_).astype(np.int64),
            np.ones(NP_, dtype=np.float64), np.ones(NP_, bool),
            np.arange(NB).astype(np.int64) % 16, np.ones(NB, dtype=np.int64),
            np.ones(NB, bool))
    rout, pout = _both_steps(4, args, bucket_cap=512, nbuckets=128,
                             max_chain=16, G=64)
    _assert_same_shards(rout, pout, 4)
    seen = {}
    for d, (fk, fv, *_r) in enumerate(pout):
        for k in fk.numpy()[fv.numpy()]:
            assert int(k) not in seen
            seen[int(k)] = d
    assert len(seen) == 16


def test_bucket_overflow_flagged():
    N = 512
    pk = np.zeros(N, dtype=np.int64)
    args = (pk, np.ones(N), np.ones(N, bool), pk[:64],
            np.ones(64, dtype=np.int64), np.ones(64, bool))
    rout, pout = _both_steps(2, args, bucket_cap=8, nbuckets=64,
                             max_chain=4, G=32)
    assert [bool(o[4][0]) for o in pout] == \
        [bool(v) for v in np.asarray(rout[4])]
    assert any(bool(o[4][0]) for o in pout)


@pytest.mark.parametrize("skew", [False, True])
def test_skew_routing_matches_reference(skew):
    rng = np.random.default_rng(5)
    NP_, NB = 128 * 4, 16 * 4
    pk = np.where(rng.random(NP_) < 0.9, 7,
                  rng.integers(0, 40, NP_)).astype(np.int64)
    args = (pk, rng.random(NP_), np.ones(NP_, bool),
            np.arange(NB).astype(np.int64) % 40,
            rng.integers(1, 5, NB).astype(np.int64), np.ones(NB, bool))
    heavy = None
    kw = dict(bucket_cap=96, nbuckets=128, max_chain=8, G=64)
    if skew:
        heavy = p_shuffle.detect_heavy_keys(pk, args[2], k_heavy=2,
                                            sample_rows=256, threshold=0.10)
        np.testing.assert_array_equal(heavy, r_shuffle.detect_heavy_keys(
            pk, args[2], k_heavy=2, sample_rows=256, threshold=0.10))
        assert 7 in heavy.tolist()
        kw["k_heavy"] = 2
    rout, pout = _both_steps(4, args, heavy=heavy, **kw)
    _assert_same_shards(rout, pout, 4)
    # plain hash partitioning overflows on the hot key; the router does not
    assert any(bool(o[4][0]) for o in pout) is (not skew)


def test_skew_detect_empty_and_uniform():
    out = p_shuffle.detect_heavy_keys(np.array([], dtype=np.int64),
                                      np.array([], dtype=bool), 4)
    assert (out == p_shuffle._HEAVY_SENTINEL).all()
    keys = np.arange(1000, dtype=np.int64)
    out = p_shuffle.detect_heavy_keys(keys, np.ones(1000, bool), 4,
                                      sample_rows=512, threshold=0.05)
    assert (out == p_shuffle._HEAVY_SENTINEL).all()


def test_umod_and_partition_match_reference():
    """Which shard owns a key, and each bucket's overflow flag, are the
    reference's: _umod equals uint64 `%` bit for bit."""
    rng = np.random.default_rng(8)
    k = rng.integers(-(1 << 62), 1 << 62, 4096).astype(np.int64)
    k[:4] = [0, -1, -(1 << 63), (1 << 63) - 1]
    for m in (1, 2, 3, 7, 8, 4096):
        want = np.asarray(r_shuffle._mix64(jnp.asarray(k)) % jnp.uint64(m))
        got = p_shuffle._umod(p_shuffle._mix64(torch.from_numpy(k)), m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    valid = rng.random(4096) > 0.2
    rl, rv, rc, ro = r_shuffle._partition_lanes(
        (jnp.asarray(k),), jnp.asarray(k), jnp.asarray(valid), 8, 400)
    pl, pv, pc, po = p_shuffle._partition_lanes(
        (torch.from_numpy(k),), torch.from_numpy(k),
        torch.from_numpy(valid), 8, 400)
    np.testing.assert_array_equal(pl[0].numpy(), np.asarray(rl[0]))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    assert bool(po) == bool(ro)
