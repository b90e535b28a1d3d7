"""K3, the table lookup (pg_strom_tpu_torch/ops/mxu_lookup.py), against the
JAX reference (pg_strom_tpu/ops/mxu_lookup.py).

The reference encodes the table as a bf16 digit matrix for its MXU
contraction; the port keeps the raw padded int32 table.  Both must give the
same int32 per index, exactly: the reference through its CPU branch and
through the Pallas kernel in interpret mode, the port through its plain
version on the CPU.  The `gpu` case holds the CUDA kernel against the
plain version on the card and skips here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pg_strom_tpu.ops import mxu_lookup as R
from pg_strom_tpu_torch.ops import mxu_lookup as P

CASES = [(100, 8), (2048, 12), (40960, 12), (65536, 16), (5000, 32)]


def _table(rng, D, bits):
    hi = min(1 << bits, 1 << 31)
    return rng.integers(0, hi, D).astype(np.uint32)


@pytest.mark.parametrize("D,bits", CASES)
def test_plain_lookup_matches_reference(rng, D, bits):
    K = R.lookup_digits(bits)
    tab = _table(rng, D, bits)
    idx = rng.integers(0, D, 10_000).astype(np.int32)
    idx[:2] = (0, D - 1)
    want = np.asarray(R.mxu_lookup(jnp.asarray(idx),
                                   jnp.asarray(R.encode_table(tab, D, K)),
                                   D, K, idx.shape[0]))
    table = torch.from_numpy(P.encode_table(tab, D, K))
    got = P.mxu_lookup(torch.from_numpy(idx), table, D, K, idx.shape[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tab[idx].astype(np.int32))


def test_plain_lookup_matches_pallas_interpret(rng):
    D, bits, N = 2048, 12, 1024
    K = R.lookup_digits(bits)
    tab = _table(rng, D, bits)
    idx = rng.integers(0, D, N).astype(np.int32)
    M = jnp.asarray(R.encode_table(tab, D, K))
    TILE = R._pick_tile(N)
    idx_p = jnp.pad(jnp.asarray(idx), (0, (-N) % TILE))
    want = np.asarray(R._build_kernel(int(idx_p.shape[0]), M.shape[1], K,
                                      TILE, True)(idx_p, M))[:N]
    got = P.mxu_lookup(torch.from_numpy(idx),
                       torch.from_numpy(P.encode_table(tab, D, K)), D, K, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D,bits", CASES)
def test_decode_digit_matrix_is_the_port_table(rng, D, bits):
    """The reference's digit matrix decodes to the port's padded table,
    and encode_table_torch gives the same table with a sentinel pad."""
    K = R.lookup_digits(bits)
    tab = _table(rng, D, bits)
    dec = P.decode_digit_matrix(np.asarray(R.encode_table(tab, D, K)), D, K)
    np.testing.assert_array_equal(dec, P.encode_table(tab, D, K))
    np.testing.assert_array_equal(dec[:D], tab.view(np.int32))
    sent = (1 << min(8 * K, 31)) - 1
    dev = P.encode_table_torch(torch.from_numpy(tab.astype(np.int64)), D, K,
                               pad_value=sent).numpy()
    ref_dev = P.decode_digit_matrix(np.asarray(R.encode_table_jax(
        jnp.asarray(tab.astype(np.int64)), D, K, pad_value=sent)), D, K)
    np.testing.assert_array_equal(dev, ref_dev)


def test_out_of_range_index_reads_the_sentinel(rng):
    D, K = 300, 2
    table = torch.from_numpy(P.encode_table(_table(rng, D, 16), D, K))
    idx = torch.tensor([-1, 0, 299, table.shape[0], 1 << 30],
                       dtype=torch.int32)
    got = P.mxu_lookup_reference(idx, table, 5, sentinel=77)
    assert got.tolist() == [77, int(table[0]), int(table[299]), 77, 77]


def test_digits_and_slots():
    assert [P.lookup_digits(b) for b in (1, 8, 9, 16, 32)] == \
        [R.lookup_digits(b) for b in (1, 8, 9, 16, 32)] == [1, 1, 2, 2, 4]
    for D in (1, 100, 2048, 2049, 40960, 65536):
        assert P.table_slots(D) == R.encode_table(
            np.zeros(D, np.uint32), D, 1).shape[1] * R.LANE


@pytest.mark.gpu
@pytest.mark.parametrize("D", [100, 2048, 40960, 65536])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_kernel_matches_plain_version(D, K):
    """K3 on the card (ops/cuda/mxu_lookup.cu): bit-equal to the plain
    version, the edge indexes and the padding slots included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    assert cs.k3_compare(np.random.default_rng(D + K), D, K, 1 << 16) == 0
