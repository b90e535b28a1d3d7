"""The launch planner of K1 and K2's accumulation core
(pg_strom_tpu_torch/ops/launch_plan.py) and the kernel build's cache key
(ops/cuda/__init__.py): pure Python, no GPU and no nvcc needed."""

from __future__ import annotations

import os
import re
import shutil

import pytest

from pg_strom_tpu_torch.ops import cuda as kc
from pg_strom_tpu_torch.ops import launch_plan as lp

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
