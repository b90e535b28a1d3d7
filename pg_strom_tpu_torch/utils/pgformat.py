"""PostgreSQL-compatible text output formatting.

The regression corpus compares *text* output (pg_regress diffs .out files),
with `set extra_float_digits to -3` shrinking float precision
(input/sql/nogrp_agg.sql:6).  These functions reproduce PG's float4_out /
float8_out / numeric_out / bool / date text rules so result rows can be
diffed exactly like the reference's harness does.
"""

from __future__ import annotations

import math
from decimal import Decimal
from typing import Any

from ..sqltypes import T
from .. import pgnumeric as pgn

FLT_DIG = 6
DBL_DIG = 15


def float_out(v: float, is_float4: bool, extra_float_digits: int = 0) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    ndig = (FLT_DIG if is_float4 else DBL_DIG) + extra_float_digits
    ndig = max(ndig, 1)
    s = f"%.{ndig}g" % v
    # PG uses e+XX / e-XX with at least 2 exponent digits (like %g)
    return s


def value_out(v: Any, t: T, extra_float_digits: int = 0) -> str:
    """NULL prints as empty string (psql default)."""
    if v is None:
        return ""
    if t is T.BOOL:
        return "t" if v else "f"
    if t is T.FLOAT4:
        return float_out(float(v), True, extra_float_digits)
    if t is T.FLOAT8:
        return float_out(float(v), False, extra_float_digits)
    if t is T.NUMERIC:
        return pgn.numeric_out(v if isinstance(v, Decimal) else Decimal(v))
    if t in (T.TEXT, T.BPCHAR):
        return str(v)
    if t is T.DATE:
        import datetime
        d = datetime.date(2000, 1, 1) + datetime.timedelta(days=int(v))
        return d.isoformat()
    if t is T.TIMESTAMP:
        import datetime
        ts = datetime.datetime(2000, 1, 1) + datetime.timedelta(microseconds=int(v))
        s = ts.strftime("%Y-%m-%d %H:%M:%S")
        if ts.microsecond:
            s += ("%.6f" % (ts.microsecond / 1e6))[1:].rstrip("0")
        return s
    return str(int(v))


def row_out(values: tuple, types: tuple, extra_float_digits: int = 0) -> str:
    return "|".join(value_out(v, t, extra_float_digits)
                    for v, t in zip(values, types))
