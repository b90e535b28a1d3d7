"""Host-exact PostgreSQL `numeric` arithmetic over Decimal.

The device path carries numeric as (mant int64, exp int32) lanes with the
reference's representable window (opencl_numeric.h: 57-bit mantissa, 6-bit
exponent); everything outside that window — and every finalization step
(division for avg, sqrt for stddev) — runs here, host-exact, mirroring how the
reference finishes aggregates with pgstrom.*_final SQL functions on the CPU
(pg_strom--1.0.sql:229-401, gpupreagg.c:4431-4773).

PostgreSQL numeric results carry a *display scale* (dscale) chosen by the
operation (numeric.c in PG; rules reimplemented here from its documented
behavior):
  add/sub : dscale = max(d1, d2)
  mul     : dscale = d1 + d2 (capped), exact product
  div     : rscale via select_div_scale: >= 16 significant digits
  sqrt    : rscale >= 16 significant digits
We replicate these so text output matches PG row-for-row.
"""

from __future__ import annotations

from decimal import Decimal, ROUND_HALF_UP, getcontext, localcontext

NUMERIC_MIN_SIG_DIGITS = 16
NUMERIC_MIN_DISPLAY_SCALE = 0
NUMERIC_MAX_DISPLAY_SCALE = 1000
DEC_DIGITS = 4  # PG stores base-10000 digits; weights are in these units

getcontext().prec = 200


def dscale_of(d: Decimal) -> int:
    """Display scale = digits after the decimal point as PG tracks it."""
    exp = d.as_tuple().exponent
    if not isinstance(exp, int):
        return 0
    return max(0, -exp)


def _weight_and_firstdigit(d: Decimal) -> tuple[int, int]:
    """PG base-10000 normalized weight and first digit: |d| = f.xxx *
    10000^w with f in [1,9999] (numeric.c digit representation)."""
    if d == 0:
        return 0, 0
    ad = abs(d)
    w = ad.adjusted() // DEC_DIGITS  # python floor division handles negatives
    with localcontext() as ctx:
        ctx.prec = 60
        f = int(ad.scaleb(-w * DEC_DIGITS).to_integral_value(rounding="ROUND_FLOOR"))
    return w, f


def round_to_scale(d: Decimal, scale: int) -> Decimal:
    """PG numeric rounding: half away from zero at the given scale."""
    q = Decimal(1).scaleb(-scale)
    # PG numeric spans up to 131072 digits before the point; size the
    # context to the value instead of failing on huge magnitudes
    need = max(d.adjusted() + scale + 20, 40) if d.is_finite() else 40
    with localcontext() as ctx:
        ctx.prec = min(max(need, ctx.prec), 200_000)
        r = d.quantize(q, rounding=ROUND_HALF_UP)
    # PG numeric has no negative zero: "-0.0000" normalizes to "0.0000"
    if r == 0 and r.is_signed():
        r = -r
    return r


def num_add(a: Decimal, b: Decimal) -> Decimal:
    r = a + b
    return round_to_scale(r, max(dscale_of(a), dscale_of(b)))


def num_sub(a: Decimal, b: Decimal) -> Decimal:
    r = a - b
    return round_to_scale(r, max(dscale_of(a), dscale_of(b)))


def num_mul(a: Decimal, b: Decimal) -> Decimal:
    r = a * b
    # PG mul_var produces exact product; display scale = d1+d2 but never
    # truncates significant digits (exact result keeps its scale)
    return round_to_scale(r, min(dscale_of(a) + dscale_of(b),
                                 NUMERIC_MAX_DISPLAY_SCALE))


def select_div_scale(a: Decimal, b: Decimal) -> int:
    """PG numeric.c select_div_scale: estimate the quotient weight from the
    normalized base-10000 weights and first digits, then pick a result scale
    giving at least NUMERIC_MIN_SIG_DIGITS significant digits."""
    w1, f1 = _weight_and_firstdigit(a)
    w2, f2 = _weight_and_firstdigit(b)
    qweight = w1 - w2
    if f1 <= f2:
        qweight -= 1
    rscale = NUMERIC_MIN_SIG_DIGITS - qweight * DEC_DIGITS
    rscale = max(rscale, dscale_of(a))
    rscale = max(rscale, dscale_of(b))
    rscale = max(rscale, NUMERIC_MIN_DISPLAY_SCALE)
    rscale = min(rscale, NUMERIC_MAX_DISPLAY_SCALE)
    return rscale


def num_div(a: Decimal, b: Decimal, rscale: int | None = None) -> Decimal:
    from .errors import SqlError, ERR_DIV_BY_ZERO
    if b == 0:
        raise SqlError("division by zero", ERR_DIV_BY_ZERO)
    if rscale is None:
        rscale = select_div_scale(a, b)
    with localcontext() as ctx:
        ctx.prec = 250
        r = a / b
    return round_to_scale(r, rscale)


def num_mod(a: Decimal, b: Decimal) -> Decimal:
    from .errors import SqlError, ERR_DIV_BY_ZERO
    if b == 0:
        raise SqlError("division by zero", ERR_DIV_BY_ZERO)
    # PG mod: result sign follows dividend; trunc division
    q = (a / b).to_integral_value(rounding="ROUND_DOWN")
    r = a - q * b
    return round_to_scale(r, max(dscale_of(a), dscale_of(b)))


def num_sqrt(a: Decimal, rscale: int | None = None) -> Decimal:
    from .errors import SqlError
    if a < 0:
        raise SqlError("cannot take square root of a negative number")
    if rscale is None:
        # PG numeric_sqrt: sweight = (weight+1) * DEC_DIGITS / 2 - 1
        # (C integer arithmetic, base-10000 weight)
        w, _ = _weight_and_firstdigit(a)
        sweight = _c_div((w + 1) * DEC_DIGITS, 2) - 1
        rscale = NUMERIC_MIN_SIG_DIGITS - sweight
        rscale = max(rscale, dscale_of(a))
        rscale = max(rscale, NUMERIC_MIN_DISPLAY_SCALE)
        rscale = min(rscale, NUMERIC_MAX_DISPLAY_SCALE)
    if a == 0:
        return round_to_scale(Decimal(0), rscale)
    with localcontext() as ctx:
        ctx.prec = 250
        r = a.sqrt()
    return round_to_scale(r, rscale)


def _c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def num_abs(a: Decimal) -> Decimal:
    return abs(a)


def num_neg(a: Decimal) -> Decimal:
    return -a


def num_cmp(a: Decimal, b: Decimal) -> int:
    if a < b:
        return -1
    if a > b:
        return 1
    return 0


# ---------------------------------------------------------------------------
# text formatting (PG numeric_out): plain notation, dscale fraction digits
# ---------------------------------------------------------------------------

def numeric_out(d: Decimal) -> str:
    if d != d:  # NaN
        return "NaN"
    sign, digits, exp = d.as_tuple()
    if isinstance(exp, str):
        return "NaN"
    s = format(d, "f")
    # Decimal("1E+3") formats as "1000" with 'f'; dscale trailing zeros kept
    return s


# average/stddev finalization helpers used by the aggregate layer ------------

def numeric_avg(sum_: Decimal, count: int) -> Decimal:
    """PG numeric avg = sum / count with select_div_scale."""
    return num_div(sum_, Decimal(count))


def int_avg(sum_: int, count: int) -> Decimal:
    """PG int2/4/8 avg: numeric division of exact integer sum by count
    (int8_avg / numeric_poly_avg semantics)."""
    return num_div(Decimal(sum_), Decimal(count))


def numeric_stddev_internal(count: int, sum_x: Decimal, sum_x2: Decimal,
                            variance: bool, sample: bool) -> Decimal | None:
    """PG numeric_stddev_internal (numeric.c): var = (N*sumX2 - sumX^2) /
    (N*(N-1)); the division rscale comes from select_div_scale(numerator,
    denominator), and for stddev the sqrt is taken at that SAME rscale."""
    n = count
    if n == 0 or (sample and n == 1):
        return None
    vN = Decimal(n)
    # N*sumX2 at rscale dscale(sumX2); sumX*sumX at rscale 2*dscale(sumX):
    # both exact for our exact Decimal sums
    t1 = num_mul(vN, sum_x2)
    t2 = num_mul(sum_x, sum_x)
    numerator = num_sub(t1, t2)
    if numerator <= 0:
        # PG: roundoff guard — returns plain 0 (dscale 0)
        return Decimal(0)
    denom = vN * ((vN - 1) if sample else vN)
    rscale = select_div_scale(numerator, denom)
    var = num_div(numerator, denom, rscale)
    if variance:
        return var
    return num_sqrt(var, rscale)
