"""K3: table lookup, out[i] = table[idx[i]].

The reference (pg_strom_tpu/ops/mxu_lookup.py) computes the lookup on the
TPU as a bilinear one-hot contraction over a bf16 digit matrix
M[k*128+lo, hi] = digit_k(table[hi*128+lo]), because the TPU has no
hardware vector gather.  The digit matrix is the MXU's layout, not the
contract.  The contract the port keeps:

  * the table has D <= MAX_D slots, padded to Hp*128 slots (Hp a multiple
    of 16, as in the reference) with the caller's sentinel;
  * values are < 2^(8K), K = lookup_digits(value bits) in 1..4 (a value is
    kept modulo 2^(8K), as the reference's K digits keep it);
  * the caller clips idx into [0, D); out-of-range / unmatched semantics
    ride on the sentinel stored in the table itself.

The port's table is the raw padded int32 vector, and the CUDA kernel
(ops/cuda/mxu_lookup.cu) is a gather through the read-only cache:

* `mxu_lookup` — the entry: a CUDA idx launches the kernel (or raises), a
  CPU idx runs the plain version;
* `mxu_lookup_reference` — the plain PyTorch version, `table[idx]`;
* `encode_table` (host, numpy) / `encode_table_torch` (device) build the
  padded table; `decode_digit_matrix` turns the reference's digit matrix
  back into it (the tests compare the two packages' hash tables with it).

An index outside the table's Hp*128 slots never reads out of bounds: the
kernel and the plain version both return `sentinel` for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.perfmon import span

LANE = 128
MAX_D = 1 << 16
_HPAD = 16


def lookup_digits(value_bits: int) -> int:
    """Digits needed for values < 2^value_bits."""
    return max(1, (value_bits + 7) // 8)


def table_slots(D: int) -> int:
    """Padded slot count Hp*128 of a D-slot table."""
    H = -(-D // LANE)
    return -(-H // _HPAD) * _HPAD * LANE


def _value_mask(K: int) -> int:
    return (1 << (8 * K)) - 1


def encode_table(table: np.ndarray, D: int, K: int) -> np.ndarray:
    """int32[Hp*128] padded table (0 in the padding) of non-negative ints
    < 2^(8K); values of 2^31 and above keep their bits (uint32 view)."""
    assert table.shape[0] == D and D <= MAX_D
    t = np.zeros(table_slots(D), dtype=np.uint32)
    t[:D] = np.asarray(table, dtype=np.uint32) & np.uint32(_value_mask(K))
    return t.view(np.int32)


def encode_table_torch(vals: torch.Tensor, D: int, K: int,
                       pad_value: int = 0) -> torch.Tensor:
    """Device encode_table: vals int32[D] non-negative -> int32[Hp*128] on
    vals' device; slots beyond D hold pad_value (callers pass their
    sentinel so padded reads stay unmatched)."""
    assert vals.shape[0] == D and D <= MAX_D
    t = torch.full((table_slots(D),), pad_value, dtype=torch.int64,
                   device=vals.device)
    t[:D] = vals.to(torch.int64)
    t = t & _value_mask(K)
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def decode_digit_matrix(M: np.ndarray, D: int, K: int) -> np.ndarray:
    """The reference's (K*128, Hp) digit matrix -> the port's int32[Hp*128]
    padded table (M[k*128+lo, hi] = digit_k(table[hi*128+lo]))."""
    M = np.asarray(M).astype(np.float32).astype(np.uint32)
    Hp = M.shape[1]
    assert M.shape[0] == K * LANE and Hp * LANE >= D
    t = np.zeros(Hp * LANE, dtype=np.uint32)
    for k in range(K):
        t |= M[k * LANE:(k + 1) * LANE, :].T.reshape(-1) << np.uint32(8 * k)
    return t.view(np.int32)


def mxu_lookup_reference(idx: torch.Tensor, table: torch.Tensor, n: int,
                         sentinel: int = 0) -> torch.Tensor:
    """Plain K3: int32[n], table[idx[i]], or sentinel where idx[i] lies
    outside the table."""
    i = idx[:n].to(torch.int64)
    ok = (i >= 0) & (i < table.shape[0])
    out = table[torch.where(ok, i, torch.zeros_like(i))]
    return torch.where(ok, out, torch.full_like(out, sentinel))


_BLOCK = 256
_BLOCKS_PER_SM = 8


def mxu_lookup_cuda(idx: torch.Tensor, table: torch.Tensor, n: int,
                    sentinel: int = 0) -> torch.Tensor:
    """Launch K3 (ops/cuda/mxu_lookup.cu): the same int32[n] as
    mxu_lookup_reference.  Raises on a bad input, a build or a launch
    failure."""
    import ctypes
    from .cuda import library, cuda_error_text, sm_count
    dev = idx.device
    if (idx.dtype != torch.int32 or table.dtype != torch.int32
            or table.device != dev or not idx.is_contiguous()
            or not table.is_contiguous() or idx.dim() != 1
            or table.dim() != 1 or idx.shape[0] < n):
        raise ValueError(f"K3 needs contiguous int32 idx [>= n] and table on "
                         f"one device; got idx {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}, table "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}, n={n}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    sms = sm_count(dev.index if dev.index is not None
                   else torch.cuda.current_device())
    grid = max(1, min(-(-n // _BLOCK), sms * _BLOCKS_PER_SM))
    lib = library()
    with torch.cuda.device(dev), span("K3"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pgstrom_k3_launch(
            ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(table.data_ptr()),
            int(table.shape[0]), int(sentinel), ctypes.c_longlong(n),
            ctypes.c_void_p(out.data_ptr()), grid, _BLOCK,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: {cuda_error_text(rc)}")
    mxu_lookup_cuda.launches += 1
    return out


mxu_lookup_cuda.launches = 0   # main-path launch count (chip_smoke.py reads it)


def mxu_lookup(idx: torch.Tensor, table: torch.Tensor, D: int, K: int,
               n: int, sentinel: int = 0) -> torch.Tensor:
    """out[i] = table[idx[i]] (int32[n]) for a table from encode_table /
    encode_table_torch over D slots with K-digit values.

    idx int32[n], clipped into [0, D) by the caller."""
    assert table.shape[0] == table_slots(D) and 1 <= K <= 4
    if idx.device.type == "cuda":
        return mxu_lookup_cuda(idx.to(torch.int32).contiguous(),
                               table.contiguous(), n, sentinel)
    if idx.device.type == "cpu":
        return mxu_lookup_reference(idx, table, n, sentinel)
    raise RuntimeError(f"K3 has no kernel for device {idx.device}")
