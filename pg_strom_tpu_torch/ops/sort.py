"""Stable argsort of a non-negative int lane.

The reference (pg_strom_tpu/ops/sort.py) packs sort keys with the row
position into int64 words for XLA's sort; `argsort_i32` is the entry the
pre-aggregation sort strategy uses.  A stable sort gives one permutation
for a given key lane, so the port's `torch.argsort(stable=True)` returns
the reference's `packed_argsort` permutation.  The rest of sort.py (the
adaptive packed argsort, the two-word tier and top-k) is ROADMAP queue 1,
"Sort".
"""

from __future__ import annotations

import torch


def argsort_i32(vals: torch.Tensor) -> torch.Tensor:
    """Stable argsort (int64 positions, for indexing) of a non-negative
    int lane."""
    return torch.argsort(vals.to(torch.int64), stable=True)
