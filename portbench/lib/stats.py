"""The benchmark's own arithmetic: percentiles and logical bytes."""

from __future__ import annotations

import re

import numpy as np

from portbench.lib.dataset import VALUE_BYTES, Dataset

# H100 SXM5 HBM3 bandwidth, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
# each value of a result row, as the host receives it
RESULT_VALUE_BYTES = 8


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def logical_bytes(data: Dataset, reads: dict, result_rows: int,
                  result_cols: int) -> int:
    """Each column a query reads, at its value width, read once, and the
    result rows written once."""
    n = 0
    for table, cols in reads.items():
        rows = data.nrows(table)
        for c in cols:
            n += rows * VALUE_BYTES[data.col(table, c).type]
    return n + result_rows * result_cols * RESULT_VALUE_BYTES


def clean_name(s: str, n: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s)[:n]
