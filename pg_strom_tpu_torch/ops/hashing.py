"""Vectorized key hashing for group-by (and, later, hash join).

The reference (pg_strom_tpu/ops/hashing.py) hashes whole lanes with a
splitmix64 / lowbias32 avalanche and combines columns with a boost-style
mixer; only equality structure matters, because exactness never depends on
hash quality (collision checks and exact key compares run downstream).
The port's hashes are bit-identical to the reference's: the salted buckets,
their collisions and the retry ladder's rungs all follow from them.

Torch has no unsigned 32/64-bit arithmetic on the CPU, so the unsigned
lanes ride as int64:

  u32  values in [0, 2^32), masked after every operation that can carry
       above bit 31 (a u32 product is formed in int64, whose wrap mod 2^64
       keeps the low 32 bits right);
  u64  the two's-complement reinterpretation of the u64 value; add and
       multiply wrap mod 2^64 exactly like uint64, and a logical right
       shift is an arithmetic shift followed by a mask.

Canonicalization before hashing (SQL equality, not bit equality):
  float   : -0.0 -> +0.0, any NaN -> canonical NaN   (PG: -0=0, NaN=NaN)
  numeric : (mant,exp) lanes are normalized at load (no trailing zeros)
  NULL    : hashed as a fixed tag; SQL GROUP BY puts NULLs in one group
"""

from __future__ import annotations

import torch

from ..sqltypes import T

M32 = 0xFFFFFFFF


def _s64(u: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


_NULL_TAG = _s64(0x9E3779B97F4A7C15)
_NULL_TAG32 = 0x9E3779B9


def _shr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 lanes held as int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: full avalanche on u64 lanes (int64 bits)."""
    x = x.to(torch.int64)
    x = (x ^ _shr64(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr64(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _shr64(x, 31)


def _canonical_f64(d: torch.Tensor) -> torch.Tensor:
    d = d.to(torch.float64)
    d = torch.where(d == 0.0, torch.zeros_like(d), d)           # -0.0 == +0.0
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def _canonical_bits(t: T, data: torch.Tensor) -> torch.Tensor:
    """u64 lanes (int64 bits) such that SQL-equal values have equal bits."""
    if t in (T.FLOAT4, T.FLOAT8):
        return _canonical_f64(data).view(torch.int64)
    return data.to(torch.int64)


def canonical_f64_bits(bits: torch.Tensor) -> torch.Tensor:
    """Canonicalize raw IEEE double bits: -0 -> +0, NaNs -> one pattern.
    Equal canonical bits <=> SQL-equal float8 values."""
    b = bits.to(torch.int64)
    b = torch.where(b == -(1 << 63), torch.zeros_like(b), b)
    expmask = 0x7FF0000000000000
    frac = b & 0x000FFFFFFFFFFFFF
    is_nan = ((b & expmask) == expmask) & (frac != 0)
    return torch.where(is_nan, torch.full_like(b, 0x7FF8000000000000), b)


def hash_column(t: T, data: torch.Tensor, valid: torch.Tensor,
                exp: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row u64 hash (int64 bits) of one key column (NULL-aware).  A
    float8 lane hashes its canonical IEEE bits, as the reference does from
    its bits plane."""
    h = _mix64(_canonical_bits(t, data))
    if t is T.NUMERIC and exp is not None:
        h = _mix64(h ^ _mix64(exp.to(torch.int64)))
    return torch.where(valid, h, torch.full_like(h, _NULL_TAG))


def combine_hashes(hs: list[torch.Tensor]) -> torch.Tensor | None:
    """boost::hash_combine-style fold across key columns (u64 lanes)."""
    acc = torch.zeros_like(hs[0]) if hs else None
    for h in hs:
        acc = _mix64(acc ^ (h + _NULL_TAG + (acc << 6) + _shr64(acc, 2)))
    return acc


# ---------------------------------------------------------------------------
# 32-bit pipeline: the bucketing hashes of grouped aggregation
# ---------------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer: full avalanche on u32 lanes (int64 in [0, 2^32))."""
    x = x.to(torch.int64) & M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _fold32(t: T, data: torch.Tensor) -> torch.Tensor:
    """u32 lanes such that SQL-equal values have equal bits."""
    if t is T.FLOAT4:
        d = data.to(torch.float32)
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        return d.view(torch.int32).to(torch.int64) & M32
    if t is T.BOOL:
        return data.to(torch.int64)
    if data.dtype in (torch.int64, torch.float64):
        d = data.to(torch.int64)
        return (d ^ (d >> 32)) & M32
    return data.to(torch.int32).to(torch.int64) & M32


def hash_column32(t: T, data: torch.Tensor, valid: torch.Tensor,
                  exp: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row u32 hash of one key column (NULL-aware, SQL equality)."""
    if t is T.FLOAT8:
        b = _canonical_f64(data).view(torch.int64)
        h = _mix32((b ^ (b >> 32)) & M32)
    else:
        h = _mix32(_fold32(t, data))
    if t is T.NUMERIC and exp is not None:
        h = _mix32(h ^ _mix32(exp.to(torch.int32).to(torch.int64) & M32))
    return torch.where(valid, h, torch.full_like(h, _NULL_TAG32))


def combine_hashes32(hs: list[torch.Tensor]) -> torch.Tensor | None:
    acc = torch.zeros_like(hs[0]) if hs else None
    for h in hs:
        acc = _mix32(acc ^ ((h + _NULL_TAG32 + ((acc << 6) & M32)
                             + (acc >> 2)) & M32))
    return acc
