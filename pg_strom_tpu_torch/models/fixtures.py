"""Regression fixtures.

Reproduces the *shape* of the reference's agg_init.sql fixture
(input/sql/agg_init.sql): a table with every numeric SQL type in four
sections — positive random, negative random, mixed sign, all NULL — with 5%
NULLs sprinkled in, plus a zero-row twin and an extreme-values "overflow"
twin.  Data is generated with our own seeded PRNG (values are engine-exact
python objects, so the host path is the golden reference the same way
vanilla PostgreSQL is for make_expected.sh).
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from ..sqltypes import T
from ..datastore import Table, column_from_values

INT2_MAX, INT4_MAX, INT8_MAX = 32767, 2147483647, 9223372036854775807


def make_preagg_test(nrows: int = 4000, seed: int = 0,
                     name: str = "gpupreagg_test") -> Table:
    rng = np.random.default_rng(seed)
    n4 = nrows // 4
    ids, keys = [], []
    i2, i4, i8, f4, f8, nm = [], [], [], [], [], []

    def maybe_null(v):
        return None if rng.random() > 0.95 else v

    for sec in range(4):
        for i in range(n4):
            rid = sec * n4 + i + 1
            ids.append(rid)
            if sec == 3:
                keys.append(None)
                for lst in (i2, i4, i8, f4, f8, nm):
                    lst.append(None)
                continue
            keys.append(sec * 10 + (i % 10) + 1)
            sign = 1 if sec == 0 else (-1 if sec == 1 else (1 if rng.random() < 0.5 else -1))
            i2.append(maybe_null(int(sign * rng.integers(0, INT2_MAX // 1000 + 1))))
            i4.append(maybe_null(int(sign * rng.integers(0, INT4_MAX // 1000 + 1))))
            i8.append(maybe_null(int(sign * rng.integers(0, INT8_MAX // 1000 + 1))))
            f4.append(maybe_null(float(np.float32(sign * round(rng.random(), 4)))))
            f8.append(maybe_null(float(sign * round(rng.random(), 13))))
            nm.append(maybe_null(Decimal(str(round(sign * rng.random(), 4)))))

    return Table.from_columns(name, {
        "id": column_from_values(T.INT4, ids),
        "key": column_from_values(T.INT4, keys),
        "smlint_x": column_from_values(T.INT2, i2),
        "integer_x": column_from_values(T.INT4, i4),
        "bigint_x": column_from_values(T.INT8, i8),
        "real_x": column_from_values(T.FLOAT4, f4),
        "float_x": column_from_values(T.FLOAT8, f8),
        "nume_x": column_from_values(T.NUMERIC, nm),
    })


def make_preagg_zero(name: str = "gpupreagg_zero_test") -> Table:
    return Table.from_columns(name, {
        "id": column_from_values(T.INT4, []),
        "key": column_from_values(T.INT4, []),
        "smlint_x": column_from_values(T.INT2, []),
        "integer_x": column_from_values(T.INT4, []),
        "bigint_x": column_from_values(T.INT8, []),
        "real_x": column_from_values(T.FLOAT4, []),
        "float_x": column_from_values(T.FLOAT8, []),
        "nume_x": column_from_values(T.NUMERIC, []),
    })


def make_preagg_overflow(nrows: int = 4000, seed: int = 0,
                         name: str = "gpupreagg_overflow_test") -> Table:
    """Extreme values: int maxima, 1e38 float4, 1e308 float8, 21-digit
    numerics — exercises every overflow / recheck path
    (input/sql/agg_init.sql overflow table analog)."""
    rng = np.random.default_rng(seed + 1)
    n4 = nrows // 4
    ids, keys = [], []
    i2, i4, i8, f4, f8, nm = [], [], [], [], [], []

    def maybe_null(v):
        return None if rng.random() > 0.95 else v

    for sec in range(4):
        for i in range(n4):
            ids.append(sec * n4 + i + 1)
            if sec == 3:
                keys.append(None)
                for lst in (i2, i4, i8, f4, f8, nm):
                    lst.append(None)
                continue
            keys.append(sec * 10 + (i % 10) + 1)
            if sec == 0:
                sv = 1
            elif sec == 1:
                sv = -1
            else:
                sv = 1 if rng.random() < 0.5 else -1
            i2.append(maybe_null(INT2_MAX if sv > 0 else -INT2_MAX - 1))
            i4.append(maybe_null(INT4_MAX if sv > 0 else -INT4_MAX - 1))
            i8.append(maybe_null(INT8_MAX if sv > 0 else -INT8_MAX - 1))
            f4.append(maybe_null(float(np.float32(sv * 1.0e38))))
            f8.append(maybe_null(sv * 1.0e308))
            big = int(rng.integers(0, 10**10)) * 10**11 + int(rng.integers(0, 10**11))
            nm.append(maybe_null(Decimal(sv * big)))

    return Table.from_columns(name, {
        "id": column_from_values(T.INT4, ids),
        "key": column_from_values(T.INT4, keys),
        "smlint_x": column_from_values(T.INT2, i2),
        "integer_x": column_from_values(T.INT4, i4),
        "bigint_x": column_from_values(T.INT8, i8),
        "real_x": column_from_values(T.FLOAT4, f4),
        "float_x": column_from_values(T.FLOAT8, f8),
        "nume_x": column_from_values(T.NUMERIC, nm),
    })
