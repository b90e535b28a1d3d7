"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: K1 (pg_strom_tpu_torch/ops/cuda/preagg_fused2.cu), K2
(preagg_fused.cu), K3 (mxu_lookup.cu), K4 (preagg_pallas.cu) and K5
(joinagg_scalar.cu).

Needs an NVIDIA GPU and skips without one.  It imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit (tests/conftest.py
imports jax, hence --noconftest there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The cases are chip_smoke.py's kernel phase at 2^16 rows with a ragged
live-row tail, K1, K2 and K4 at the edges of their accumulation core's
launch plan (ops/launch_plan.py: G not a multiple of 16, K = 114, column
tiles, K4's S = 255), K4 with non-finite integer cells, and the
exactness windows at 2^24 rows on one and two blocks; `ints` must be
bit-equal and the host-replay decision the same."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.KERNEL_CASES)
def test_kernel_matches_plain_version(cuda_device, name):
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.preagg_fused2 import derive_v2_plan
    n = 1 << 16
    t = cs._case_table(name, np.random.default_rng(5), n)
    pred, groups, aggs = cs._case_query(name, cs._cols(t))
    cols = [t.columns[nm] for nm in t.column_names]
    with override(use_preagg_int8=(name != "flagship_int8_off")):
        plan = derive_v2_plan(cols, schema_from_chunk_columns(
            t.column_names, cols), groups, aggs, pred, 4096)
    assert plan is not None
    assert cs._compare(plan, aggs, pred,
                       cs._device_cols(t, cuda_device), n - 37) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.KERNEL_EDGE_CASES)
def test_kernel_edge_matches_plain_version(cuda_device, name):
    """K1 at G = 8 (no multiple of 16, NaN in the float shadow), 128 and
    256."""
    n = 1 << 16
    t = cs._case_table(name, np.random.default_rng(8), n)
    pred, groups, aggs = cs._case_query(name, cs._cols(t))
    plan = cs._k1_plan(t, name, pred, groups, aggs)
    assert cs._compare(plan, aggs, pred,
                       cs._device_cols(t, cuda_device), n - 37) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,data,G", cs.K2_EDGE_CASES)
def test_k2_edge_matches_plain_version(cuda_device, name, data, G):
    """K2 at G = 40 (no multiple of 16, NaN and inf in the shadows), 128,
    256, and corr's K = 114 at G = 32 and in column tiles at G = 2048."""
    n = 1 << 16
    case = cs._k2_case(data, np.random.default_rng(9), n, cuda_device, G)
    err, _, _, _ = cs._k2_compare(name, *case[:6], n - 37, case[6])
    assert err == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
def test_exactness_window(cuda_device, kernel):
    """2^24 + 3 rows in one bucket at digit 255 on one and two blocks: past
    the 2^23-row s32 flush of one block."""
    window = {"K1": cs.k1_exact_window, "K2": cs.k2_exact_window,
              "K4": cs.k4_exact_window}[kernel]
    assert window(cuda_device, 20) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.K2_CASES)
def test_k2_matches_plain_version(cuda_device, name):
    """K2 (ops/cuda/preagg_fused.cu): ints bit-equal, same replay."""
    n = 1 << 16
    case = cs._k2_case(name, np.random.default_rng(6), n, cuda_device)
    err, _, _, _ = cs._k2_compare(name, *case[:6], n - 37, case[6])
    assert err == 0


@pytest.mark.gpu
@pytest.mark.parametrize("G", [32, 2048])
@pytest.mark.parametrize("name", ["agg_group", "two_hashed_int4"])
def test_k4_matches_plain_version(cuda_device, name, G):
    """K4 (ops/cuda/preagg_pallas.cu): ints bit-equal, same replay."""
    n = 1 << 16
    keys, aggs, vals, mask, seg, G0, dense = cs._k2_case(
        name, np.random.default_rng(7), n, cuda_device)
    seg = torch.where(seg < G0, seg % G, torch.full_like(seg, G))
    err, _ = cs._k4_compare(name, keys, aggs, vals, mask, seg, G, n - 37,
                            dense)
    assert err == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,data,G", cs.K4_EDGE_CASES)
def test_k4_edge_matches_plain_version(cuda_device, name, data, G):
    """K4 at G = 40 (NaN and inf in the shadows), 256 and 1024 (one column
    tile), corr's wide value matrix in column tiles at G = 2048, and
    twelve float8 sums (S = 255, wider than K2 takes) at G = 1 and in
    column tiles at G = 2048."""
    n = 1 << 16
    keys, aggs, vals, mask, seg, G, dense = cs._k2_case(
        data, np.random.default_rng(10), n, cuda_device, G)
    err, _ = cs._k4_compare(name, keys, aggs, vals, mask, seg, G, n - 37,
                            dense)
    assert err == 0


@pytest.mark.gpu
def test_k4_nonfinite_int_cells(cuda_device):
    """inf, -inf, NaN and digits past [-255, 255] in integer columns: ints
    bit-equal to pallas_reduce_reference's saturating int64 sums."""
    assert cs.k4_nonfinite(cuda_device, np.random.default_rng(11),
                           1 << 16) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("D,K", cs.K3_CASES)
def test_k3_matches_plain_version(cuda_device, D, K):
    """K3 (ops/cuda/mxu_lookup.cu): bit-equal, edge and padding slots and
    out-of-range indexes included."""
    assert cs.k3_compare(np.random.default_rng(D * 8 + K), D, K, 1 << 16) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", cs.K5_ROWS)
@pytest.mark.parametrize("name", cs.K5_CASES)
def test_k5_matches_plain_version(cuda_device, name, n):
    """K5 (ops/cuda/joinagg_scalar.cu): its output bit-equal to the plain
    version's at 1 row, at 4099 rows of 8192-row planes (a tail that is no
    whole 4-row group, live rows below the capacity) and on a full 2^26-row
    chunk; the overflow case sets ERR_INT4_OVERFLOW; each launch counted."""
    cap = 8192 if n == 4099 else n
    assert cs.k5_compare(np.random.default_rng(12), name, n, cap) == 0
