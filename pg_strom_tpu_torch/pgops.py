"""Exact scalar operation semantics (host path).

This is the host-exact twin of the device function catalog — the same
operation set the reference implements in opencl_mathlib.h /
opencl_numeric.h / opencl_textlib.h / opencl_timelib.h, but with full
PostgreSQL semantics (error text included).  Used for:
  * generating golden results (the make_expected.sh analog),
  * the CpuReCheck fallback path (gpuscan.c:1038, gpupreagg.c:2507 analog),
  * host-side aggregate finalization.

Key PG behaviors reproduced:
  * integer ops check the result range of the *result type* and raise
    "smallint/integer/bigint out of range";
  * integer division truncates toward zero; INT_MIN / -1 overflows;
  * x % 0 and x / 0 raise "division by zero";
  * float ops raise "value out of range: overflow/underflow" when a finite
    input produces inf/0 the way PG's CHECKFLOATVAL does;
  * float4 arithmetic happens in float4 (numpy float32), float8 in float64.
"""

from __future__ import annotations

import math
from decimal import Decimal
from typing import Any

import numpy as np

from .errors import (
    SqlError, ERR_DIV_BY_ZERO, ERR_INT2_OVERFLOW, ERR_INT4_OVERFLOW,
    ERR_INT8_OVERFLOW, ERR_FLOAT_OVERFLOW, ERR_FLOAT_UNDERFLOW,
)
from .sqltypes import T, INT_BOUNDS
from . import pgnumeric as pgn

_INT_ERR = {T.INT2: (ERR_INT2_OVERFLOW, "smallint out of range"),
            T.INT4: (ERR_INT4_OVERFLOW, "integer out of range"),
            T.INT8: (ERR_INT8_OVERFLOW, "bigint out of range")}


def check_int_range(t: T, v: int) -> int:
    lo, hi = INT_BOUNDS[t]
    if not (lo <= v <= hi):
        code, msg = _INT_ERR[t]
        raise SqlError(msg, code)
    return v


def int_add(t: T, a: int, b: int) -> int:
    return check_int_range(t, a + b)


def int_sub(t: T, a: int, b: int) -> int:
    return check_int_range(t, a - b)


def int_mul(t: T, a: int, b: int) -> int:
    return check_int_range(t, a * b)


def int_div(t: T, a: int, b: int) -> int:
    if b == 0:
        raise SqlError("division by zero", ERR_DIV_BY_ZERO)
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return check_int_range(t, q)


def int_mod(t: T, a: int, b: int) -> int:
    if b == 0:
        raise SqlError("division by zero", ERR_DIV_BY_ZERO)
    # sign follows dividend (C semantics)
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def int_neg(t: T, a: int) -> int:
    return check_int_range(t, -a)


def int_abs(t: T, a: int) -> int:
    return check_int_range(t, abs(a))


# --- float -----------------------------------------------------------------

def _checkfloat(t: T, result: float, inf_ok: bool, zero_ok: bool) -> float:
    """PG CHECKFLOATVAL: error if result is inf (and inputs weren't) or
    result is 0 (and it shouldn't be)."""
    if math.isinf(result) and not inf_ok:
        raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
    if result == 0.0 and not zero_ok:
        raise SqlError("value out of range: underflow", ERR_FLOAT_UNDERFLOW)
    return result


def _f(t: T, v: float) -> float:
    """Round to storage precision (float4 math happens in float32)."""
    if t is T.FLOAT4:
        r = float(np.float32(v))
        if math.isinf(r) and not math.isinf(v):
            raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
        return r
    return float(v)


def float_add(t: T, a: float, b: float) -> float:
    with np.errstate(over="ignore"):   # overflow->inf is the PG semantics;
        # _checkfloat turns it into the exact PG error surface
        r = _f(t, np.float32(a) + np.float32(b)) if t is T.FLOAT4 else a + b
    return _checkfloat(t, r, math.isinf(a) or math.isinf(b), True)


def float_sub(t: T, a: float, b: float) -> float:
    with np.errstate(over="ignore"):
        r = _f(t, np.float32(a) - np.float32(b)) if t is T.FLOAT4 else a - b
    return _checkfloat(t, r, math.isinf(a) or math.isinf(b), True)


def float_mul(t: T, a: float, b: float) -> float:
    with np.errstate(over="ignore"):
        r = _f(t, np.float32(a) * np.float32(b)) if t is T.FLOAT4 else a * b
    return _checkfloat(t, r, math.isinf(a) or math.isinf(b),
                       a == 0.0 or b == 0.0)


def float_div(t: T, a: float, b: float) -> float:
    if b == 0.0:
        raise SqlError("division by zero", ERR_DIV_BY_ZERO)
    with np.errstate(over="ignore"):
        r = _f(t, np.float32(a) / np.float32(b)) if t is T.FLOAT4 else a / b
    return _checkfloat(t, r, math.isinf(a) or math.isinf(b), a == 0.0)


def float_neg(t: T, a: float) -> float:
    return -a


def float_abs(t: T, a: float) -> float:
    return abs(a)


# --- casts -------------------------------------------------------------------

def cast_to_int(t: T, v: Any) -> int:
    """Numeric-family value -> integer type t, PG rounding (half away from 0)."""
    if isinstance(v, bool):
        return check_int_range(t, int(v))
    if isinstance(v, (int, np.integer)):
        return check_int_range(t, int(v))
    if isinstance(v, Decimal):
        r = int(pgn.round_to_scale(v, 0))
        return check_int_range(t, r)
    # float: PG rint() = round-half-to-even
    f = float(v)
    if math.isnan(f) or math.isinf(f):
        code, msg = _INT_ERR[t]
        raise SqlError(msg, code)
    r = int(np.rint(f))
    return check_int_range(t, r)


def cast_to_float(t: T, v: Any) -> float:
    f = float(v)
    if t is T.FLOAT4:
        r = float(np.float32(f))
        if math.isinf(r) and not math.isinf(f):
            raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
        return r
    return f


def cast_to_numeric(v: Any) -> Decimal:
    if isinstance(v, Decimal):
        return v
    if isinstance(v, bool):
        return Decimal(int(v))
    if isinstance(v, (int, np.integer)):
        return Decimal(int(v))
    f = float(v)
    if math.isnan(f):
        return Decimal("NaN")
    if math.isinf(f):
        raise SqlError("cannot convert infinity to numeric")
    # PG float8_numeric: snprintf("%.*g", DBL_DIG=15) then numeric_in
    return Decimal("%.15g" % f)


def cast_float4_to_numeric(v: Any) -> Decimal:
    """PG float4_numeric: snprintf("%.*g", FLT_DIG=6) then numeric_in."""
    f = float(v)
    if math.isnan(f):
        return Decimal("NaN")
    if math.isinf(f):
        raise SqlError("cannot convert infinity to numeric")
    return Decimal("%.6g" % f)


# --- comparisons (generic over python values; Decimal/int/float mix ok) ------

def cmp_values(a: Any, b: Any) -> int:
    if isinstance(a, Decimal) and isinstance(b, float):
        b = Decimal(repr(b))
    if isinstance(b, Decimal) and isinstance(a, float):
        a = Decimal(repr(a))
    if isinstance(a, str) and isinstance(b, str):
        ab, bb = a.encode(), b.encode()  # C collation: bytewise
        return -1 if ab < bb else (1 if ab > bb else 0)
    # PG float/numeric ordering: NaN equals NaN and sorts above everything
    # (float8_cmp_internal / numeric comparison semantics)
    a_nan = (isinstance(a, float) and math.isnan(a)) or \
            (isinstance(a, Decimal) and a.is_nan())
    b_nan = (isinstance(b, float) and math.isnan(b)) or \
            (isinstance(b, Decimal) and b.is_nan())
    if a_nan or b_nan:
        if a_nan and b_nan:
            return 0
        return 1 if a_nan else -1
    if a < b:
        return -1
    if a > b:
        return 1
    return 0


# --- math functions (float8 domain, PG errors) --------------------------------

def _float8_math(name: str, fn, *args: float) -> float:
    try:
        r = fn(*args)
    except ValueError:
        raise SqlError("input is out of range")
    except OverflowError:
        raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
    if math.isinf(r) and not any(math.isinf(a) for a in args):
        raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
    return r


MATH1 = {
    "cbrt": lambda x: math.copysign(abs(x) ** (1.0 / 3.0), x),
    "ceil": math.ceil, "ceiling": math.ceil,
    "floor": math.floor,
    "exp": math.exp,
    "ln": math.log,
    "log": math.log10,
    "sqrt": math.sqrt,
    "sign": lambda x: float(np.sign(x)),
    "degrees": math.degrees,
    "radians": math.radians,
    "trunc": math.trunc,
    "round": lambda x: float(np.rint(x)),  # PG dround = rint (half-to-even)
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "cot": lambda x: math.cos(x) / math.sin(x),
}

MATH2 = {
    "pow": math.pow, "power": math.pow,
    "atan2": math.atan2,
}


def math1(name: str, x: float) -> float:
    return _float8_math(name, MATH1[name], x)


def math2(name: str, x: float, y: float) -> float:
    return _float8_math(name, MATH2[name], x, y)


# --- bit ops -----------------------------------------------------------------

def _wrap_int(t: T, v: int) -> int:
    bits = {T.INT2: 16, T.INT4: 32, T.INT8: 64}[t]
    m = (1 << bits) - 1
    v &= m
    if v >= (1 << (bits - 1)):
        v -= 1 << bits
    return v


def bit_and(t: T, a: int, b: int) -> int:
    return _wrap_int(t, a & b)


def bit_or(t: T, a: int, b: int) -> int:
    return _wrap_int(t, a | b)


def bit_xor(t: T, a: int, b: int) -> int:
    return _wrap_int(t, a ^ b)


def bit_not(t: T, a: int) -> int:
    return _wrap_int(t, ~a)


def bit_shl(t: T, a: int, n: int) -> int:
    bits = {T.INT2: 16, T.INT4: 32, T.INT8: 64}[t]
    return _wrap_int(t, a << (n & (bits - 1)))


def bit_shr(t: T, a: int, n: int) -> int:
    bits = {T.INT2: 16, T.INT4: 32, T.INT8: 64}[t]
    return _wrap_int(t, a >> (n & (bits - 1)))


# --- date/time (PG epoch 2000-01-01; date=int32 days, ts=int64 usec) ----------

def date_pl_int(d: int, n: int) -> int:
    return int(np.int32(d + n))


def date_mi_int(d: int, n: int) -> int:
    return int(np.int32(d - n))


def date_mi_date(a: int, b: int) -> int:
    return a - b


def date_to_timestamp(d: int) -> int:
    return d * 86_400_000_000


def timestamp_to_date(ts: int) -> int:
    # floored: pre-epoch timestamps land on the right day (timestamp2date)
    return int(np.int32(ts // 86_400_000_000))


def timestamp_to_time(ts: int) -> int:
    # time-of-day in usec; floored division keeps pre-epoch timestamps in
    # [0, 86400e6) (reference opencl_timelib.h:261 pgfn_timestamp_time)
    return ts - (ts // 86_400_000_000) * 86_400_000_000


def datetime_timestamp(d: int, t: int) -> int:
    # date + time -> timestamp (reference opencl_timelib.h:382
    # pgfn_datetime_pl)
    return d * 86_400_000_000 + t
