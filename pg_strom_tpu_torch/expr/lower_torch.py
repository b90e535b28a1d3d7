"""Schema helpers of the device expression lowering.

The reference's expr/lower_jax.py traces the typed expression tree into a
jitted XLA program.  This slice of the PyTorch port carries only the
helpers the pre-aggregation path needs — per-slot static metadata and the
runtime plane tuple of a datastore Column; the Lowerer (DVal, error lanes,
the numeric window) is ROADMAP queue 1, "Expression lowering and hashing".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..sqltypes import T


@dataclasses.dataclass(frozen=True)
class ColMeta:
    """Static (plan-time) metadata of one input slot."""
    name: str
    type: T
    dictionary: Optional[tuple[str, ...]] = None  # text columns
    dict_id: int = -1   # identity token; equal ids => comparable codes


def schema_from_chunk_columns(names: Sequence[str], cols) -> list[ColMeta]:
    """Build ColMeta list from datastore Columns (dictionary identity via id)."""
    out = []
    for name, c in zip(names, cols):
        out.append(ColMeta(name=name, type=c.type,
                           dictionary=tuple(c.dictionary) if c.dictionary else None,
                           dict_id=id(c.dictionary) if c.dictionary is not None else -1))
    return out


def planes_of_column(c) -> tuple:
    """Runtime plane tuple for one datastore Column (host ndarrays).

    FLOAT8 carries a third plane, the raw IEEE-754 bits as int64, so that
    comparisons, grouping and min/max can run bit-exactly through integer
    ordering (the reference's layout, kept so the two packages agree)."""
    if c.type is T.NUMERIC:
        return (c.data, c.valid, c.num_exp, c.num_dscale)
    if c.type is T.FLOAT8:
        return (c.data, c.valid, c.data.view(np.int64))
    return (c.data, c.valid)
