"""SQL type system.

TPU-native analog of the reference's device type catalog (codegen.c:46-78:
bool/int2/int4/int8/float4/float8/date/time/timestamp/bpchar/numeric/bytea/text)
and the pg_<type>_t NULL-carrying wrappers (codegen.c:632-861).

Storage model (struct-of-arrays, the TPU-idiomatic replacement for the
reference's kern_data_store row formats, opencl_common.h:276-434):

  every column chunk = (data ndarray[s], valid bool ndarray)

  BOOL      -> bool_
  INT2      -> int16  (device arithmetic widens to int32 for overflow checks)
  INT4      -> int32
  INT8      -> int64
  FLOAT4    -> float32
  FLOAT8    -> float64
  NUMERIC   -> 3 planes: mant int64, exp int32 (value = mant * 10^exp),
               dscale int32 (display scale for text output).  Device-representable
               range mirrors the reference's packed 64-bit format
               (opencl_numeric.h: sign/6-bit-exponent/57-bit-mantissa):
               |mant| < 2^57, exp in [-32, 31].  Out-of-range values carry
               valid=True but recheck=True (per-row), forcing CpuReCheck.
  DATE      -> int32 days since 2000-01-01 (PostgreSQL epoch)
  TIME      -> int64 microseconds since midnight
  TIMESTAMP -> int64 microseconds since 2000-01-01
  TEXT      -> int32 dictionary codes, order-preserving under C collation
               (dictionary sorted bytewise => code comparisons == strcmp,
                matching the reference's C-collation-only rule, codegen.c:152-164)
  BPCHAR    -> as TEXT with blank-padded compare semantics handled at dict build

NULL is carried in the valid plane, never in data (data lanes under NULL are
zero).  This is the SoA version of the reference's pg_<t>_t {isnull, value}.
"""

from __future__ import annotations

import enum
from decimal import Decimal
from typing import Any

import numpy as np


class T(enum.Enum):
    BOOL = "bool"
    INT2 = "smallint"
    INT4 = "integer"
    INT8 = "bigint"
    FLOAT4 = "real"
    FLOAT8 = "double precision"
    NUMERIC = "numeric"
    DATE = "date"
    TIME = "time without time zone"
    TIMESTAMP = "timestamp without time zone"
    TEXT = "text"
    BPCHAR = "character"

    def __repr__(self) -> str:  # terse in plans
        return self.name


# SQL-name aliases accepted by the frontend
SQL_TYPE_NAMES = {
    "bool": T.BOOL, "boolean": T.BOOL,
    "smallint": T.INT2, "int2": T.INT2, "smallserial": T.INT2,
    "int": T.INT4, "integer": T.INT4, "int4": T.INT4, "serial": T.INT4,
    "bigint": T.INT8, "int8": T.INT8, "bigserial": T.INT8,
    "real": T.FLOAT4, "float4": T.FLOAT4,
    "float": T.FLOAT8, "float8": T.FLOAT8, "double precision": T.FLOAT8,
    "numeric": T.NUMERIC, "decimal": T.NUMERIC,
    "date": T.DATE,
    "time": T.TIME,
    "timestamp": T.TIMESTAMP,
    "text": T.TEXT, "varchar": T.TEXT, "character varying": T.TEXT,
    "char": T.BPCHAR, "character": T.BPCHAR, "bpchar": T.BPCHAR,
}

INT_TYPES = (T.INT2, T.INT4, T.INT8)
FLOAT_TYPES = (T.FLOAT4, T.FLOAT8)
NUMERIC_LIKE = INT_TYPES + FLOAT_TYPES + (T.NUMERIC,)
STRING_TYPES = (T.TEXT, T.BPCHAR)
DATETIME_TYPES = (T.DATE, T.TIME, T.TIMESTAMP)

# numpy storage dtype of the primary data plane
STORAGE_DTYPE: dict[T, np.dtype] = {
    T.BOOL: np.dtype(np.bool_),
    T.INT2: np.dtype(np.int16),
    T.INT4: np.dtype(np.int32),
    T.INT8: np.dtype(np.int64),
    T.FLOAT4: np.dtype(np.float32),
    T.FLOAT8: np.dtype(np.float64),
    T.NUMERIC: np.dtype(np.int64),   # mantissa plane; exp/dscale are extra planes
    T.DATE: np.dtype(np.int32),
    T.TIME: np.dtype(np.int64),
    T.TIMESTAMP: np.dtype(np.int64),
    T.TEXT: np.dtype(np.int32),      # dictionary code plane
    T.BPCHAR: np.dtype(np.int32),
}

INT_BOUNDS = {
    T.INT2: (-(1 << 15), (1 << 15) - 1),
    T.INT4: (-(1 << 31), (1 << 31) - 1),
    T.INT8: (-(1 << 63), (1 << 63) - 1),
}

# Device-numeric representable window (see module docstring / config.py)
NUMERIC_MAX_MANT = (1 << 57) - 1
NUMERIC_MIN_EXP = -32
NUMERIC_MAX_EXP = 31

PG_EPOCH_DATE = np.datetime64("2000-01-01")


def is_integer(t: T) -> bool:
    return t in INT_TYPES


def is_float(t: T) -> bool:
    return t in FLOAT_TYPES


def is_string(t: T) -> bool:
    return t in STRING_TYPES


def type_from_sql(name: str) -> T:
    key = name.strip().lower()
    if key not in SQL_TYPE_NAMES:
        raise KeyError(f'type "{name}" does not exist')
    return SQL_TYPE_NAMES[key]


# ---------------------------------------------------------------------------
# numeric <-> (mant, exp, dscale) conversion helpers (host side, exact)
# ---------------------------------------------------------------------------

def numeric_from_decimal(d: Decimal) -> tuple[int, int, int, bool]:
    """Decompose a Decimal into (mant, exp, dscale, device_ok).

    value = mant * 10**exp;  dscale = number of displayed fraction digits.
    device_ok=False when the value can't live in the device window — the row
    is then tagged recheck (reference: numeric conversion sets CpuReCheck,
    opencl_numeric.h per SURVEY §2 row 24).
    """
    if not d.is_finite():
        return 0, 0, 0, False
    sign, digits, dexp = d.as_tuple()
    mant = int("".join(map(str, digits)) or "0")
    if sign:
        mant = -mant
    exp = dexp
    dscale = max(0, -dexp)
    # normalize: strip factors of 10 from mant into exp (keeps window wide)
    while mant != 0 and mant % 10 == 0:
        mant //= 10
        exp += 1
    if mant == 0:
        exp = 0
    # exp above window: denormalize by shifting digits back into the mantissa
    # (1E+48 = mant 10^17, exp 31 — representable, matching the reference's
    #  recheck_agg boundary: 1E+48 on-device, 1E+49 rechecked)
    if exp > NUMERIC_MAX_EXP and mant != 0:
        shift = exp - NUMERIC_MAX_EXP
        if shift <= 18 and abs(mant) * (10 ** shift) <= NUMERIC_MAX_MANT:
            mant *= 10 ** shift
            exp = NUMERIC_MAX_EXP
    ok = (abs(mant) <= NUMERIC_MAX_MANT
          and NUMERIC_MIN_EXP <= exp <= NUMERIC_MAX_EXP)
    if not ok:
        return 0, 0, dscale, False
    return mant, exp, dscale, True


def numeric_to_decimal(mant: int, exp: int, dscale: int) -> Decimal:
    d = Decimal(int(mant)).scaleb(int(exp))
    # re-impose display scale (PG numeric keeps trailing zeros per dscale)
    if dscale > 0:
        d = d.quantize(Decimal(1).scaleb(-int(dscale)))
    elif exp >= 0:
        d = d.quantize(Decimal(1))
    return d


def python_value_dtype_ok(t: T, v: Any) -> bool:
    if v is None:
        return True
    if t in INT_TYPES:
        lo, hi = INT_BOUNDS[t]
        return isinstance(v, (int, np.integer)) and lo <= int(v) <= hi
    if t in FLOAT_TYPES:
        return isinstance(v, (int, float, np.floating, np.integer))
    if t is T.NUMERIC:
        return isinstance(v, (Decimal, int))
    if t is T.BOOL:
        return isinstance(v, (bool, np.bool_))
    if t in STRING_TYPES:
        return isinstance(v, str)
    return True
