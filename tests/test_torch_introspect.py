"""The port's introspection virtual tables (pg_strom_tpu_torch/utils/
introspect.py) on the CPU, beside the reference's.

Each `pgstrom_*` table has the reference's columns.  On device="cpu"
`pgstrom_device_info` is one "cpu" row; `pgstrom_program_info` lists the
CUDA kernel library's sources with their build state, then the
executor's plan memos; `pgstrom_tcache_info` shows the tables a device
query left resident; `pgstrom_config_info` names the reference's settings.
Since the port's native/ module (ROADMAP item 7), the arena and slab
tables show its data arena, as the reference's do; no message queue is
registered in either package, so that table stays empty.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pg_strom_tpu as R
from pg_strom_tpu.sql import execute as r_execute
from pg_strom_tpu_torch import override as p_override
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.exec import preagg_exec
from pg_strom_tpu_torch.exec.devcache import TCACHE
from pg_strom_tpu_torch.ops import cuda as kernels
from pg_strom_tpu_torch.sql import execute as p_execute

TABLES = ("pgstrom_device_info", "pgstrom_program_info",
          "pgstrom_arena_info", "pgstrom_slab_info", "pgstrom_mqueue_info",
          "pgstrom_tcache_info", "pgstrom_config_info")


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(11)
    n = 5000
    rdb = R.Database()
    rdb.create(R.Table.from_columns("t", {
        "k": R.column_from_numpy(R.T.INT4,
                                 rng.integers(0, 12, n).astype(np.int32)),
        "x": R.column_from_numpy(R.T.FLOAT8, rng.random(n)),
    }))
    return rdb, from_reference(rdb)


def _port(sql, pdb, **cfg):
    with p_override(device="cpu", debug_force_offload=True, **cfg):
        return p_execute(sql, pdb)


@pytest.mark.parametrize("name", TABLES)
def test_columns_are_the_reference_columns(dbs, name):
    rdb, pdb = dbs
    assert _port(f"select * from {name}", pdb).columns == \
        r_execute(f"select * from {name}", rdb).columns


def test_device_info_on_cpu(dbs):
    _, pdb = dbs
    assert _port("select * from pgstrom_device_info", pdb).rows == \
        [(0, "cpu", "cpu", 0)]


def test_device_info_needs_the_configured_device(dbs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, pdb = dbs
    with p_override(device="cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            p_execute("select * from pgstrom_device_info", pdb)


@pytest.mark.gpu
def test_device_info_on_cuda(dbs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    _, pdb = dbs
    with p_override(device="cuda"):
        rows = p_execute("select * from pgstrom_device_info", pdb).rows
    assert rows == [(i, "gpu", torch.cuda.get_device_name(i), 0)
                    for i in range(torch.cuda.device_count())]


def test_program_info_lists_sources_and_memos(dbs):
    _, pdb = dbs
    _port("select k, sum(x) from t group by k", pdb)
    rows = _port("select kind, plan_key from pgstrom_program_info", pdb).rows
    kernel_rows = [r for r in rows if r[0].startswith("kernel:")]
    assert [r[1].split(" ")[0] for r in kernel_rows] == list(kernels.SOURCES)
    import os
    state = ("kernel:built" if os.path.exists(kernels.library_path())
             else "kernel:not built")
    assert all(r[0] == state for r in kernel_rows)
    memo_rows = [r for r in rows if not r[0].startswith("kernel:")]
    assert len(memo_rows) == \
        len(preagg_exec._LADDER_MEMO) + len(preagg_exec._GROUP_STATS)
    assert any(r[0] == "preagg_groups" for r in memo_rows)
    assert all(len(r[1]) <= 120 for r in memo_rows)


def test_tcache_info_shows_resident_table(dbs):
    _, pdb = dbs
    TCACHE.clear()
    _port("select sum(x) from t where x > 0.5", pdb)
    rows = _port("select table_name, kind, nchunks, nbytes "
                 "from pgstrom_tcache_info", pdb).rows
    t_rows = [r for r in rows if r[0] == "t"]
    assert t_rows and t_rows[0][1] == "chunks" and t_rows[0][2] == 1
    # k int4 + valid, x float8 + valid (no bits plane), padded to 8192 rows
    assert t_rows[0][3] == 8192 * (4 + 1 + 8 + 1)


@pytest.mark.parametrize("name", ("pgstrom_arena_info", "pgstrom_slab_info",
                                  "pgstrom_mqueue_info"))
def test_native_tables_are_empty_until_item_7(dbs, name):
    """Item 7 has landed: a device query's chunk planes come from the data
    arena, which the arena table shows live and the slab table shows by
    class, with the reference's columns and row counts; the queue table
    stays empty in both packages."""
    rdb, pdb = dbs
    _port("select count(*), sum(x) from t", pdb)
    r_execute("select count(*), sum(x) from t", rdb)
    got = _port(f"select * from {name}", pdb)
    want = r_execute(f"select * from {name}", rdb)
    assert got.columns == want.columns
    assert len(got.rows) == len(want.rows)
    if name == "pgstrom_mqueue_info":
        assert got.rows == []
    elif name == "pgstrom_arena_info":
        assert got.rows[0][1] == 1 << 28 and got.rows[0][3] >= 1
    else:
        assert [r[1] for r in got.rows] == [96, 240, 512, 1184, 2520]


def test_config_info_names_the_reference_settings(dbs):
    rdb, pdb = dbs
    pnames = {r[0] for r in _port("select name from pgstrom_config_info",
                                  pdb).rows}
    rnames = {r[0] for r in r_execute("select name from pgstrom_config_info",
                                      rdb).rows}
    # the port adds `device` (cuda or cpu) and `mesh_shards` (the shard
    # count of its mesh, where the reference counts jax devices) and drops
    # `fetch_block_first`, a read-back switch of the TPU runtime that the
    # port has no use for
    assert pnames == (rnames - {"fetch_block_first"}) | {"device",
                                                         "mesh_shards"}
    rows = dict(_port("select * from pgstrom_config_info", pdb).rows)
    assert rows["device"] == "cpu"
    assert rows["debug_force_offload"] == "True"
