"""The device scan (pg_strom_tpu_torch/ops/filter.py, exec/scan_exec.py)
against the JAX reference, and the scan parts of tests/test_tcache.py.

Each case builds the same table and qual in both packages (numpy-seeded
values, each package's own IR) and requires equal results: the bit-packed
mask bytes, the filter function's (maskbits, nmatch, err), and the
ScanExecutor's global row indexes, including tables with NULLs, a numeric
chunk that the host replays, and several chunks.  The port runs on the
CPU, i.e. the plain PyTorch lowering.
"""

from __future__ import annotations

import gc
from decimal import Decimal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.ops import filter as r_filter
from pg_strom_tpu.exec import scan_exec as r_scan
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr.lower_jax import (
    schema_from_chunk_columns as r_schema, planes_of_column as r_planes)
from pg_strom_tpu.utils.perfmon import Perfmon as RPerfmon
from pg_strom_tpu_torch.ops import filter as p_filter
from pg_strom_tpu_torch.exec import scan_exec as p_scan
from pg_strom_tpu_torch.exec.devcache import TCACHE
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr.lower_torch import (
    schema_from_chunk_columns as p_schema, planes_of_column as p_planes)
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.utils.perfmon import Perfmon as PPerfmon


def _table(seed: int, n: int, numeric: bool = False):
    """A reference Table with NULLs (and a numeric column whose first rows
    leave the device window when `numeric`), and its port copy."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": R.column_from_values(R.T.INT4, [
            None if v < 3 else int(v) for v in rng.integers(0, 50, n)]),
        "x": R.column_from_values(R.T.FLOAT8, [
            None if v < 0.07 else float(v) for v in rng.random(n)]),
        "y": R.column_from_values(R.T.INT8, [
            int(v) for v in rng.integers(-1000, 1000, n)]),
    }
    if numeric:
        vals = [None if v < 0.1 else Decimal(f"{v * 10:.2f}")
                for v in rng.random(n)]
        vals[5] = Decimal("1E+49")          # outside the device window
        cols["num"] = R.column_from_values(R.T.NUMERIC, vals)
    rt = R.Table.from_columns("t", cols)
    return rt, from_reference(rt)


def _pred(M, ir, table, kind: str):
    """The same qual in package M's IR, bound to table's layout."""
    names = table.column_names
    col = {nm: ir.ColumnRef(type=table.columns[nm].type, name=nm,
                            index=names.index(nm)) for nm in names}
    k_lt = ir.resolve_function("<", (col["k"], ir.Const(type=M.T.INT4,
                                                         value=30)))
    x_gt = ir.resolve_function(">", (col["x"], ir.Const(type=M.T.FLOAT8,
                                                         value=0.25)))
    if kind == "and":
        return ir.BoolExpr(type=M.T.BOOL, op="and", args=(k_lt, x_gt))
    if kind == "or_isnull":
        return ir.BoolExpr(type=M.T.BOOL, op="or", args=(
            x_gt, ir.NullTest(type=M.T.BOOL, arg=col["k"], isnull=True)))
    if kind == "numeric":
        return ir.resolve_function(">", (col["num"], ir.Const(
            type=M.T.NUMERIC, value=Decimal("4.5"))))
    raise ValueError(kind)


@pytest.mark.parametrize("n", [1, 1000, 1024, 3001])
def test_bitpack_mask_bytes_equal(n):
    mask = np.random.default_rng(n).random(n) < 0.4
    want = np.asarray(r_filter.bitpack_mask(jnp.asarray(mask)))
    got = p_filter.bitpack_mask(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p_filter.unpack_maskbits(got, n), mask)


def test_compact_mask_equal():
    mask = np.random.default_rng(3).random(777) < 0.3
    r_ids, r_n = r_filter.compact_mask(jnp.asarray(mask))
    p_ids, p_n = p_filter.compact_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))
    assert int(p_n) == int(r_n)


@pytest.mark.parametrize("kind", ["and", "or_isnull"])
def test_filter_mask_fn_outputs_equal(kind):
    rt, pt = _table(11, 2000)
    names = rt.column_names
    nrows = 1900                                # ragged live-row tail
    r_fn = jax.jit(r_filter.build_filter_mask_fn(
        _pred(R, r_ir, rt, kind),
        r_schema(names, [rt.columns[n] for n in names])))
    r_out = r_fn(tuple(tuple(jnp.asarray(p) for p in r_planes(rt.columns[n]))
                       for n in names), np.int32(nrows))
    p_fn = p_filter.build_filter_mask_fn(
        _pred(P, p_ir, pt, kind),
        p_schema(names, [pt.columns[n] for n in names]))
    p_out = p_fn(tuple(tuple(torch.from_numpy(np.ascontiguousarray(p))
                             for p in p_planes(pt.columns[n]))
                       for n in names), nrows)
    for a, b in zip(p_out, r_out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _row_indexes(rt, pt, kind, chunk_rows, **cfg):
    r_pm, p_pm = RPerfmon(), PPerfmon()
    with R.override(chunk_rows=chunk_rows, **cfg):
        want = r_scan.ScanExecutor(rt, _pred(R, r_ir, rt, kind),
                                   r_pm).row_indexes()
    with P.override(device="cpu", chunk_rows=chunk_rows, **cfg):
        got = p_scan.ScanExecutor(pt, _pred(P, p_ir, pt, kind),
                                  p_pm).row_indexes()
    return want, got, dict(r_pm.counts), dict(p_pm.counts)


COUNTERS = ("device_chunks", "recheck_chunks")


@pytest.mark.parametrize("kind,n,chunk_rows,nchunks", [
    ("and", 3000, 1 << 20, 1),           # one chunk, NULL keys and values
    ("or_isnull", 3000, 1 << 20, 1),
    ("and", 5000, 1024, 5),              # five chunks, ragged tail
])
def test_scan_executor_row_indexes_equal(kind, n, chunk_rows, nchunks):
    rt, pt = _table(n + chunk_rows, n)
    want, got, rc, pc = _row_indexes(rt, pt, kind, chunk_rows)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert {c: pc.get(c, 0) for c in COUNTERS} == \
        {c: rc.get(c, 0) for c in COUNTERS}
    assert pc.get("device_chunks", 0) == nchunks


def test_scan_numeric_recheck_chunk_replays_on_host():
    """A numeric value outside the device window flags its chunk; the
    other chunks stay on the device.  The reference's device scan cannot
    run this table (scan_exec.py:99 extends its list of arrays with the
    replayed chunk's scalars, and the final concatenate raises), so the
    port is held against the reference's host tier."""
    rt, pt = _table(21, 3000, numeric=True)
    with pytest.raises(ValueError, match="zero-dimensional"):
        _row_indexes(rt, pt, "numeric", 1024)
    want, _, _, _ = _row_indexes(rt, pt, "numeric", 1024, enabled=False)
    pm = PPerfmon()
    with P.override(device="cpu", chunk_rows=1024):
        got = p_scan.ScanExecutor(pt, _pred(P, p_ir, pt, "numeric"),
                                  pm).row_indexes()
    pc = dict(pm.counts)
    np.testing.assert_array_equal(got, want)
    assert 5 in set(got.tolist())                      # 1E+49 > 4.5
    assert pc.get("device_chunks", 0) == 2


def test_scan_on_host_when_not_offloaded():
    rt, pt = _table(5, 1500)
    want, got, _, pc = _row_indexes(rt, pt, "and", 1024, enabled=False)
    np.testing.assert_array_equal(got, want)
    assert pc.get("device_chunks", 0) == 0


# ---------------------------------------------------------------------------
# the scan parts of tests/test_tcache.py, through SQL in the port
# ---------------------------------------------------------------------------

@pytest.fixture()
def pdb():
    rng = np.random.default_rng(4)
    n = 3000
    d = P.Database()
    d.create(P.Table.from_columns("t", {
        "k": P.column_from_numpy(P.T.INT4,
                                 rng.integers(0, 7, n).astype(np.int32)),
        "x": P.column_from_numpy(P.T.FLOAT4, rng.random(n).astype(np.float32)),
        "y": P.column_from_numpy(P.T.INT8, rng.integers(-100, 100, n)),
    }))
    d.create(P.Table.from_columns("dim", {
        "k": P.column_from_numpy(P.T.INT4, np.arange(7, dtype=np.int32)),
        "label": P.column_from_numpy(P.T.INT8, np.arange(7) * 10),
    }))
    return d


def _run(db, sql, **cfg):
    with P.override(device="cpu", debug_force_offload=True, **cfg):
        return P.execute(sql, db).formatted(-3)


SCAN_SQL = "select k, x, y from t where x > 0.5 and y < 50 order by y, k, x"


def test_repeat_scan_hits_cache_and_matches_host(pdb):
    TCACHE.clear()
    first = _run(pdb, SCAN_SQL, chunk_rows=1024)
    h0 = TCACHE.hits
    second = _run(pdb, SCAN_SQL, chunk_rows=1024)
    assert first == second
    assert TCACHE.hits > h0, "second run should reuse device planes"
    assert first == _run(pdb, SCAN_SQL, enabled=False)


def test_scan_and_preagg_share_planes(pdb):
    TCACHE.clear()
    _run(pdb, "select sum(y) from t where x > 0.0", chunk_rows=1024)
    h0 = TCACHE.hits
    _run(pdb, "select k from t where x > 0.5", chunk_rows=1024)
    assert TCACHE.hits > h0, "scan and preagg share the chunk entry"


def test_join_hash_table_cached_in_aux_space(pdb):
    TCACHE.clear()
    sql = "select t.y, dim.label from t join dim on t.k = dim.k " \
          "where t.x > 0.9 order by 1, 2"
    first = _run(pdb, sql, chunk_rows=1024)
    aux = [r for r in TCACHE.info_rows() if r["kind"] == "aux"]
    h0 = TCACHE.hits
    second = _run(pdb, sql, chunk_rows=1024)
    assert first == second == _run(pdb, sql, enabled=False)
    assert aux and aux[0]["nbytes"] > 0, "join build should cache its table"
    assert TCACHE.hits > h0


def test_zero_budget_streams_scan(pdb, monkeypatch):
    # tcache_size_mb=0 now means "sized from the device", so the zero
    # budget is set on the cache itself
    TCACHE.clear()
    s0 = TCACHE.streamed
    monkeypatch.setattr(TCACHE, "budget_bytes", lambda: 0)
    out = _run(pdb, SCAN_SQL, chunk_rows=1024)
    monkeypatch.undo()
    assert TCACHE.streamed > s0
    assert TCACHE.total_bytes() == 0
    assert out == _run(pdb, SCAN_SQL, enabled=False)


def test_disable_tcache_scan(pdb):
    TCACHE.clear()
    out = _run(pdb, SCAN_SQL, chunk_rows=1024, enable_tcache=False)
    assert TCACHE.total_bytes() == 0
    assert out == _run(pdb, SCAN_SQL, enabled=False)


def test_drop_releases_scan_entries():
    TCACHE.clear()
    d = P.Database()
    d.create(P.Table.from_columns("gone", {
        "v": P.column_from_numpy(P.T.INT8, np.arange(2048))}))
    _run(d, "select v from gone where v > 7", chunk_rows=1024)
    assert TCACHE.total_bytes() > 0
    d.drop("gone")
    gc.collect()
    assert all(r["table_name"] != "gone" for r in TCACHE.info_rows())
