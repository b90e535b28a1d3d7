"""The launch planner of the accumulation core of K1, K2 and K4
(pg_strom_tpu_torch/ops/launch_plan.py), K4's plan and tables
(ops/preagg_pallas.py) and the kernel build's cache key
(ops/cuda/__init__.py): pure Python, no GPU and no nvcc needed."""

from __future__ import annotations

import os
import re
import shutil

import pytest
import torch

from pg_strom_tpu_torch.ops import cuda as kc
from pg_strom_tpu_torch.ops import launch_plan as lp
from pg_strom_tpu_torch.ops import preagg_pallas as pp

# every shape the main path and the kernel cases give the planner:
# (G, K, shadow columns)
SHAPES = [(8, 40, 1), (32, 15, 0), (32, 42, 2), (40, 30, 1), (64, 42, 2),
          (128, 21, 1), (128, 65, 1), (256, 42, 2), (1024, 42, 2),
          (1024, 114, 5), (2048, 42, 2), (2048, 114, 5), (4096, 4, 0),
          (4096, 128, 0)]
TABLES = 1024           # the wrappers' own tables: a few hundred bytes


def test_agg_group_cold_fits_one_tile():
    """G = 1024, K = 42 with its two float shadows: one column tile of s32
    cells, so the lanes are read once."""
    p = lp.plan_launch(1024, 42, 2, TABLES)
    assert (p.ntiles, p.Kt) == (1, 42)
    assert p.smem <= lp.SMEM_MAX == 232448
    assert p.smem == 4 * 1024 * 42 + 4 * 1024 * 2 + TABLES


@pytest.mark.parametrize("G", [1, 8, 16, 32, 64, 128, 129, 256, 1024])
def test_one_tile_wherever_the_table_fits(G):
    """agg_group's K = 42 at every G up to the cold run's 1024: one column
    tile; a block that leaves room for a second one an SM gets fewer
    threads, so that an SM holds about 1024."""
    p = lp.plan_launch(G, 42, 2, TABLES)
    assert (p.ntiles, p.Kt) == (1, 42)
    per_sm = max(1, min(4, (lp.SMEM_MAX + 1024) // p.smem))
    assert p.block % 32 == 0
    assert 1024 - 32 * per_sm < p.block * per_sm <= 1024


@pytest.mark.parametrize("G,K,n_sh", SHAPES)
def test_accumulators_stay_exact_for_a_chunk(G, K, n_sh):
    """Whatever the grid, an s32 cell sums at most S32_ROWS rows before it
    flushes: digits are at most 255 in magnitude, so it cannot leave its
    exact range, for chunk_rows = 2^26 or any other size."""
    assert 255 * lp.S32_ROWS < 2 ** 31
    p = lp.plan_launch(G, K, n_sh, TABLES)
    assert 0 < p.flush_rows <= lp.S32_ROWS
    assert p.flush_tiles >= 1
    assert p.smem <= lp.SMEM_MAX
    assert p.block % 32 == 0 and 256 <= p.block <= 1024


def test_a_chunk_crosses_the_flush_on_few_blocks():
    """The exactness-window cases of chip_smoke.py (2^24 + 3 rows on one
    block) cross the flush period."""
    assert (1 << 24) + 3 > lp.plan_launch(32, 29, 1, TABLES).flush_rows
    assert (1 << 24) + 3 > lp.plan_launch(32, 5, 0, TABLES).flush_rows


def test_wide_g_gets_shared_memory():
    """K1's wide_g shape (G = 4096, a few columns) runs on shared-memory
    s32 cells, one tile, and so does the widest K1 plan by column tiles."""
    p = lp.plan_launch(4096, 4, 0, TABLES)
    assert p.ntiles == 1
    assert p.smem <= lp.SMEM_MAX
    wide = lp.plan_launch(4096, 128, 0, TABLES)
    assert wide.ntiles == -(-128 // wide.Kt) > 1
    assert wide.smem <= lp.SMEM_MAX


@pytest.mark.parametrize("G,K,n_sh", SHAPES)
def test_column_tiles_cover_every_column(G, K, n_sh):
    p = lp.plan_launch(G, K, n_sh, TABLES)
    assert p.Kt * p.ntiles >= K > p.Kt * (p.ntiles - 1)


def test_a_shape_that_fits_nothing_is_refused():
    with pytest.raises(ValueError, match="no room"):
        lp.plan_launch(60000, 1, 0, TABLES)
    with pytest.raises(ValueError):
        lp.plan_launch(0, 42, 2, TABLES)
    with pytest.raises(ValueError):
        lp.plan_launch(32, 0, 0, TABLES)


def test_geo_vector_matches_the_kernel_layout():
    """LaunchPlan.geo() fills onehot::Geo::load in its order, and the
    core's shared-memory bytes are the planner's."""
    hdr = open(os.path.join(kc._DIR, "onehot_accum.cuh")).read()
    slots = {int(i): nm for nm, i in re.findall(r"q\.(\w+) = v\[(\d+)\]",
                                                hdr)}
    names = {"n_sh": "n_shadow"}
    p = lp.plan_launch(2048, 114, 5, TABLES)
    geo = p.geo()
    assert sorted(slots) == list(range(len(geo)))
    for i, nm in slots.items():
        assert geo[i] == getattr(p, names.get(nm, nm)), nm
    assert p.smem == (lp._a16(4 * p.G * p.Kt) + lp._a16(4 * p.G * p.n_shadow)
                      + TABLES)


# K4 on agg_group's value matrix: S = 42 columns, two float shadows
K4_S, K4_SH = 42, 2


@pytest.mark.parametrize("G", [32, 1024, 2048])
def test_k4_plan_on_the_agg_group_shape(G):
    """K4's plan: the core's table and K4's own within a block's shared
    memory, every column in a tile, an s32 cell flushed within S32_ROWS
    rows, and as many blocks an SM as the plan's threads assume."""
    p = pp.k4_plan(G, K4_S, K4_SH)
    assert p.smem == (lp._a16(4 * G * p.Kt) + lp._a16(4 * G * K4_SH)
                      + pp.k4_table_bytes(K4_S, K4_SH, p.block, p.Kt)
                      ) <= lp.SMEM_MAX
    assert p.Kt * p.ntiles >= K4_S > p.Kt * (p.ntiles - 1)
    assert 0 < p.flush_rows <= lp.S32_ROWS
    assert p.block % 32 == 0 and 256 <= p.block <= 1024
    per_sm = max(1, min(4, (lp.SMEM_MAX + 1024) // p.smem))
    assert per_sm * (p.smem + 1024) <= 233472      # an H100 SM's 228 KB


def test_k4_agg_group_cold_fits_one_tile():
    """G = 1024 x S = 42 is one column tile: V is read once."""
    p = pp.k4_plan(1024, K4_S, K4_SH)
    assert (p.ntiles, p.Kt) == (1, K4_S)


def test_k4_widest_g_takes_two_tiles_at_most():
    assert pp.k4_plan(pp.MAX_G, K4_S, K4_SH).ntiles <= 2


def test_k4_table_bytes_follow_the_kernel():
    """k4_table_bytes mirrors table_bytes in preagg_pallas.cu: the same
    step rows, whole rows when the tile is every column, else windows whose
    stride is = S mod 8 and leaves room for the vectors of a window that
    starts anywhere in its first one; two buffers a warp of the plan's
    block, which the kernel's bound allows."""
    src = open(os.path.join(kc._DIR, "preagg_pallas.cu")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["RG"]) == pp._RG and pp._RG % 8 == 0
    assert "Kt == K ? K : Kt + 14 + ((K - Kt - 14) & 7)" in src
    assert (pp.k4_table_bytes(K4_S, K4_SH, 1024, K4_S)
            == lp._a16(4 * (K4_S + K4_SH)) + 32 * 2 * pp._RG * K4_S * 2)
    assert (pp.k4_table_bytes(K4_S, K4_SH, 256, 21)
            == lp._a16(4 * (K4_S + K4_SH)) + 8 * 2 * pp._RG * 42 * 2)
    for S in (5, 42, 111, 255):
        for Kt in range(1, S):
            st = pp._window_stride(S, Kt)
            assert st % 8 == S % 8 and Kt + 14 <= st < Kt + 22
    assert pp.K4_BLOCK <= int(consts["MAX_BLOCK"])


@pytest.mark.parametrize("G", [1, 32, 256, 1024, 2048])
def test_k4_blocks_take_1024_threads(G):
    """One 1024-thread block an SM: faster than two of 512 or four of 256
    at every G of agg_group's value matrix (PERF.md), so K4's plan fixes
    it and sizes the staging for its 32 warps."""
    p = pp.k4_plan(G, K4_S, K4_SH)
    assert p.block == pp.K4_BLOCK == 1024
    assert p.flush_rows == lp.S32_ROWS


# twelve float8 sums: a value matrix of 240 columns with 12 shadows
K4_WIDE_S, K4_WIDE_SH = 240, 12


@pytest.mark.parametrize("G", [1, 32, 1024, 2048])
def test_k4_plans_a_wide_value_matrix(G):
    """K4 takes a value matrix far wider than K2's 128 columns at every G:
    its staging grows with the column tile and the block, not with S."""
    p = pp.k4_plan(G, K4_WIDE_S, K4_WIDE_SH)
    assert p.smem <= lp.SMEM_MAX
    assert p.Kt * p.ntiles >= K4_WIDE_S > p.Kt * (p.ntiles - 1)
    assert p.smem == (lp._a16(4 * G * p.Kt) + lp._a16(4 * G * K4_WIDE_SH)
                      + pp.k4_table_bytes(K4_WIDE_S, K4_WIDE_SH, p.block,
                                          p.Kt))
    assert pp.k4_plan(1, 1000, 50).smem <= lp.SMEM_MAX


def _k4_row_bytes(p) -> int:
    """Bytes of V a row costs the plan's column tiles at most: the 16-byte
    vectors that cover each tile's window of the row."""
    if p.ntiles == 1:
        return 2 * p.K
    widths = [min(p.Kt, p.K - t * p.Kt) for t in range(p.ntiles)]
    # a window starting at any element of a vector: at most (kt + 14) // 8
    assert all(-(-(off + kt) // 8) <= (kt + 14) // 8
               for kt in widths for off in range(8))
    return sum(16 * ((kt + 14) // 8) for kt in widths)


@pytest.mark.parametrize("G,S,n_sh", [(2048, 114, 5), (2048, 42, 2),
                                      (2048, 240, 12), (1, 240, 12)])
def test_k4_tiles_stage_only_their_columns(G, S, n_sh):
    """corr's value matrix (S = 114, five shadows) at G = 2048 and the
    other tiled shapes: each column tile copies the vectors of its own
    columns, so V costs at most twice its bytes (before the windows, 13
    tiles each copied every column: 13x)."""
    p = pp.k4_plan(G, S, n_sh)
    assert p.ntiles > 1
    assert _k4_row_bytes(p) <= 2 * (2 * S)
    if (G, S) == (2048, 114):
        assert p.ntiles <= 6


def test_k4_refuses_a_shadow_table_past_its_room():
    """At G = 2048 the compact shadow table (8 KB a shadow, in every tile)
    leaves no room for one s32 column past 24 shadows (24 float8 sums,
    20 columns each)."""
    assert pp.k4_plan(2048, 20 * 24 + 1, 24).ntiles > 1
    with pytest.raises(ValueError, match="no room"):
        pp.k4_plan(2048, 20 * 25 + 1, 25)


@pytest.mark.parametrize("n_sh", [24, 25])
def test_mxu_reduce_routes_by_k4_shape(monkeypatch, n_sh):
    """Under use_pallas_reduce at G = 2048, 24 shadows plan K4 and take it;
    25 do not fit (k4_fits, with no launch tried), so mxu_reduce takes its
    own path, counts `k4_shape_routed` and answers bit-equal to the flag
    off."""
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_reduce
    from pg_strom_tpu_torch.utils.perfmon import Perfmon, active
    G, n, S = 2048, 4096, 20 * n_sh + 1
    g = torch.Generator().manual_seed(n_sh)
    fc = list(range(0, S - 1, 20))
    V = torch.randint(-255, 256, (n, S), generator=g).to(torch.bfloat16)
    V[:, fc] = (torch.rand(n, len(fc), generator=g) * 1e4).to(torch.bfloat16)
    seg = torch.randint(0, G + 1, (n,), generator=g, dtype=torch.int32)
    k4_calls = []
    real = pp.pallas_reduce_reference
    monkeypatch.setattr(pp, "pallas_reduce_reference",
                        lambda *a: k4_calls.append(1) or real(*a))
    with override(use_pallas_reduce=False):
        want = mxu_reduce(V, seg, G, n, fc)
    pm = Perfmon()
    with override(use_pallas_reduce=True), active(pm):
        got = mxu_reduce(V, seg, G, n, fc)
    ints = [c for c in range(S) if c not in fc]
    assert torch.equal(got[0][:, ints], want[0][:, ints])
    assert pp.k4_fits(G, S, n_sh) == (n_sh == 24)
    if n_sh == 24:
        assert pp.k4_plan(G, S, n_sh).ntiles > 1
        assert k4_calls == [1] and dict(pm.counts) == {}
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1.0)
    else:
        assert k4_calls == [] and dict(pm.counts) == {"k4_shape_routed": 1}
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k4_desc_lists_and_maps_the_shadow_columns():
    assert pp._desc(6, [4, 1]) == [4, 1, -1, 1, -1, -1, 0, -1]
    assert pp._desc(3, []) == [-1, -1, -1]


def test_k4_launcher_refuses_a_cpu_tensor():
    """The launcher raises before it builds anything: only pallas_reduce
    takes a CPU V, and then it runs the plain version."""
    V = torch.zeros(64, 6, dtype=torch.bfloat16)
    seg = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="K4 needs"):
        pp.pallas_cuda(V, seg, 8, 64, [1])
    ints, fsums = pp.pallas_reduce(V, seg, 8, 64, [1])
    assert ints.shape == (8, 6) and fsums.shape == (8, 1)


def test_library_path_keys_on_headers(tmp_path):
    """The built library's name changes with any .cu or .cuh of the kernel
    directory, and only with them."""
    src = tmp_path / "cuda"
    shutil.copytree(kc._DIR, src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    build = str(tmp_path / "build")
    first = kc.library_path(str(src), build)
    assert first == kc.library_path(str(src), build)
    assert os.path.dirname(first) == build
    (src / "notes.txt").write_text("not a source")
    assert kc.library_path(str(src), build) == first
    hdr = src / "onehot_accum.cuh"
    hdr.write_text(hdr.read_text() + "\n// an edit\n")
    second = kc.library_path(str(src), build)
    assert second != first
    cu = src / "mxu_lookup.cu"
    cu.write_text(cu.read_text() + "\n")
    assert kc.library_path(str(src), build) not in (first, second)
    # the package's own key covers the header too
    assert "onehot_accum.cuh" in os.listdir(kc._DIR)
    assert set(kc.SOURCES) <= set(os.listdir(kc._DIR))
