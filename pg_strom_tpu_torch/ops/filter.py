"""Scan filter with a bit-packed match mask or device-side compaction.

The GpuScan kernel analog (reference opencl_gpuscan.h:98-177) as the
reference writes it (pg_strom_tpu/ops/filter.py): the qual is lowered over
a chunk, and the passing rows leave the device either as a bit-packed mask
(`build_filter_mask_fn`, what the scan executor uses: 32x smaller than
int32 row ids) or compacted by a prefix sum (`build_filter_compact_fn`).
The bit order is the reference's tiled one, so `unpack_maskbits` decodes
both packages' masks.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..expr.ir import Expr
from ..expr.lower_torch import Lowerer, ColMeta, _live, pred_mask, err_max
from ..utils.perfmon import spanned


def compact_mask(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_ids int32[n] padded with n, nmatch int32).

    row_ids[:nmatch] are the indexes of True lanes, in row order."""
    n = mask.shape[0]
    nmatch = mask.to(torch.int32).sum().to(torch.int32)
    ids = torch.nonzero(mask).reshape(-1).to(torch.int32)
    row_ids = torch.full((n,), n, dtype=torch.int32, device=mask.device)
    row_ids[:ids.shape[0]] = ids
    return row_ids, nmatch


_BIT_WEIGHTS = np.asarray([1, 2, 4, 8, 16, 32, 64, 128],
                          dtype=np.int32).reshape(1, 8, 1)


def bitpack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/1024)*128] tiled bitmask (n padded to 1024).

    Tiled bit order (the reference's): bit b of byte [j, l] (flattened
    j*128 + l) holds row (j*8 + b)*128 + l.  unpack_maskbits() is the
    matching host decoder."""
    n = mask.shape[0]
    pad = (-n) % 1024
    if pad:
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                            device=mask.device)])
    m = mask.reshape(-1, 8, 128).to(torch.int32)
    w = torch.as_tensor(_BIT_WEIGHTS, device=mask.device)
    return (m * w).sum(dim=1).to(torch.uint8).reshape(-1)


@spanned("unpack_mask")
def unpack_maskbits(maskbits: np.ndarray, nrows: int) -> np.ndarray:
    """Host decoder for bitpack_mask's tiled order -> bool[nrows]."""
    b = np.asarray(maskbits).reshape(-1, 1, 128)
    bits = np.unpackbits(b, axis=1, bitorder="little")   # (J, 8, 128)
    return bits.reshape(-1)[:nrows].astype(bool)


@spanned("lower")
def _qual_mask(pred: Optional[Expr], schema, cols: tuple, nrows):
    live = _live(cols, nrows)
    lw = Lowerer(schema, cols, live)
    return pred_mask(lw, pred, live), err_max(lw, live)


def build_filter_mask_fn(pred: Optional[Expr],
                         schema: Sequence[ColMeta]) -> Callable:
    """f(cols, nrows) -> (maskbits uint8[ceil(n/8)], nmatch, err_max).

    The standalone GpuScan with a bit-packed match mask instead of
    device-side compaction (see bitpack_mask)."""
    def f(cols: tuple, nrows):
        mask, err = _qual_mask(pred, schema, cols, nrows)
        return bitpack_mask(mask), mask.to(torch.int32).sum(), err
    return f


def build_filter_compact_fn(pred: Expr, schema: Sequence[ColMeta]) -> Callable:
    """f(cols, nrows) -> (row_ids, nmatch, err_max).

    The standalone GpuScan: qual eval + compaction.  err_max != 0 => the
    executor replays the chunk host-side."""
    def f(cols: tuple, nrows):
        mask, err = _qual_mask(pred, schema, cols, nrows)
        row_ids, nmatch = compact_mask(mask)
        return row_ids, nmatch, err
    return f


def gather_columns(cols: tuple, row_ids: torch.Tensor) -> tuple:
    """Materialize passing rows: gather every plane at row_ids (clipped);
    lanes past nmatch are garbage and masked by the caller."""
    n = cols[0][0].shape[0] if cols else 0
    idx = row_ids.to(torch.int64).clamp(0, max(n - 1, 0))
    return tuple(tuple(p[idx] for p in planes) for planes in cols)
