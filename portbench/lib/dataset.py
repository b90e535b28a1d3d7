"""The generated data of one configuration: tables of NumPy planes.

A generator returns a `Dataset`; the loader hands its planes to the
program and the reference reads the same planes.  Text columns are
dictionary-encoded: `data` holds int32 codes into `dictionary`, which is
sorted, so code order is text order.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable

import numpy as np

# value width of each column type, in bytes, as the device holds it
VALUE_BYTES = {"int4": 4, "int8": 8, "float4": 4, "float8": 8, "date": 4,
               "text": 4}


@dataclasses.dataclass
class Col:
    type: str               # int4 | int8 | float4 | float8 | date | text
    data: np.ndarray
    dictionary: list[str] | None = None


@dataclasses.dataclass
class Dataset:
    tables: dict[str, dict[str, Col]]

    def nrows(self, table: str) -> int:
        return len(next(iter(self.tables[table].values())).data)

    def col(self, table: str, name: str) -> Col:
        return self.tables[table][name]


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole seed, negative or
    wider than 64 bits included."""
    s = seed % (1 << 128)
    words = [(s >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    return np.random.default_rng(np.random.SeedSequence(words + list(stream)))


def text_col(values: list[str], idx: np.ndarray) -> Col:
    """A text column whose row i is values[idx[i]]; the dictionary is
    the sorted distinct values."""
    uniq, inv = np.unique(np.asarray(values, dtype=object),
                          return_inverse=True)
    codes = inv.astype(np.int32)[idx]
    return Col("text", codes.astype(np.int32), [str(u) for u in uniq])


def unique_text_col(strings: np.ndarray) -> Col:
    """A text column from a NumPy bytes array, one string a row."""
    uniq, inv = np.unique(strings, return_inverse=True)
    return Col("text", inv.astype(np.int32),
               [u.decode() for u in uniq.tolist()])


def parallel_fill(n: int, seed: int, stream: int, dtypes: dict[str, str],
                  fill: Callable[[np.random.Generator, int, int, dict], None],
                  block: int = 1 << 22, workers: int = 8) -> dict:
    """Fill arrays of n rows block by block in threads; block b draws from
    its own generator (seed, stream, b), so the result does not depend on
    the thread schedule.  `fill(rng, start, stop, out)` writes rows
    [start, stop) into `out`, {name: the arrays' slices}."""
    arrays = {k: np.empty(n, dtype=dt) for k, dt in dtypes.items()}
    starts = list(range(0, n, block))

    def one(b: int) -> None:
        a, z = starts[b], min(starts[b] + block, n)
        fill(rng_of(seed, stream, b), a, z,
             {k: v[a:z] for k, v in arrays.items()})

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for f in [ex.submit(one, b) for b in range(len(starts))]:
            f.result()
    return arrays
