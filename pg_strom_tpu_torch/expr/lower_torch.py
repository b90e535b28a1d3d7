"""Lowering of typed expression trees to PyTorch (the device compute path).

The reference (pg_strom_tpu/expr/lower_jax.py) traces the tree into an XLA
program; the port evaluates the same tree eagerly with torch ops on the
planes' device.  Each SQL value is struct-of-arrays lanes

    DVal(data, valid[, exp])      # exp lane only for NUMERIC

and errors are a per-row uint8 code lane, max-merged so the most severe
error wins (the kern_writeback_error_status analog, opencl_common.h:1481).
Error contributions are masked by a `live` lane (rows actually being
evaluated — rows beyond nrows, NULL-strict argument rows, and untaken CASE
branches never raise), which reproduces PostgreSQL's lazy evaluation on a
data-parallel device.  Constants lower as 0-d tensors and broadcast.

Device numeric is (mant int64, exp int32) with the reference's
representable window (|mant| < 2^57, exp in [-32,31], opencl_numeric.h);
any op leaving the window writes ERR_CPU_RECHECK instead of a wrong answer.

Float8 is IEEE double on the device: a FLOAT8 column ships (data, valid)
and a reader that needs its bits takes `data.view(torch.int64)`.  The
float8 sites that still defer to the host (arithmetic that overflows or
underflows, a numeric cast out of float8's range, math functions outside
their domain) carry PostgreSQL's own errors: the host replay raises
PostgreSQL's "value out of range" / domain error text for the first
offending row.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..sqltypes import T, STORAGE_DTYPE, INT_BOUNDS, NUMERIC_MAX_MANT
from ..errors import (
    ERR_CPU_RECHECK, ERR_DIV_BY_ZERO, ERR_INT2_OVERFLOW, ERR_INT4_OVERFLOW,
    ERR_INT8_OVERFLOW, ERR_FLOAT_OVERFLOW, ERR_FLOAT_UNDERFLOW,
)
from .ir import (Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr, NullTest,
                 BooleanTest, CaseExpr, CoalesceExpr)
from .catalog import entry_for_funcexpr

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

# 10^k tables for numeric rescaling (k in [0,18]; >18 always overflows i64)
_POW10 = np.array([10 ** k for k in range(19)], dtype=np.int64)
_POW10_LIMIT = np.array([INT64_MAX // (10 ** k) for k in range(19)],
                        dtype=np.int64)
_POW10_F64 = np.array([10.0 ** k for k in range(-40, 41)], dtype=np.float64)

_INT_OVF_ERR = {T.INT2: ERR_INT2_OVERFLOW, T.INT4: ERR_INT4_OVERFLOW,
                T.INT8: ERR_INT8_OVERFLOW}

_TORCH_DTYPE = {np.dtype(np.bool_): torch.bool, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def storage_dtype(t: T) -> torch.dtype:
    """The torch dtype of a SQL type's data plane."""
    return _TORCH_DTYPE[np.dtype(STORAGE_DTYPE[t])]


@dataclasses.dataclass(frozen=True)
class ColMeta:
    """Static (plan-time) metadata of one input slot."""
    name: str
    type: T
    dictionary: Optional[tuple[str, ...]] = None  # text columns
    dict_id: int = -1   # identity token; equal ids => comparable codes


@dataclasses.dataclass
class DVal:
    t: T
    data: torch.Tensor
    valid: torch.Tensor
    exp: Optional[torch.Tensor] = None          # NUMERIC only
    dscale_lane: Optional[torch.Tensor] = None  # NUMERIC columns: dscale


def trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division toward zero (XLA's div).  A divisor of -1 negates
    (wrapping INT64_MIN to itself, as XLA defines it) instead of trapping
    in the CPU's integer divide."""
    m1 = b == -1
    q = torch.div(a, torch.where(m1, torch.ones_like(b), b),
                  rounding_mode="trunc")
    return torch.where(m1, -a, q)


def trunc_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Remainder with the dividend's sign (XLA's rem); b == -1 gives 0."""
    m1 = b == -1
    r = torch.fmod(a, torch.where(m1, torch.ones_like(b), b))
    return torch.where(m1, torch.zeros_like(r), r)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1/0/+1, NaN stays NaN, a signed zero keeps its sign."""
    if not x.dtype.is_floating_point:
        return torch.sign(x)
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _two_square(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """y*y as an exact float64 sum p + e (Dekker's product, no FMA)."""
    c = y * 134217729.0                       # 2^27 + 1 (Veltkamp split)
    hi = c - (c - y)
    lo = y - hi
    p = y * y
    return p, ((hi * hi - p) + 2.0 * (hi * lo)) + lo * lo


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 sqrt.  torch's CPU sqrt can be one ulp off
    (sqrt(2.0)); of the result and its two neighbours, keep the one whose
    exact square lies nearest x."""
    y = torch.sqrt(x)
    # compare at a power-of-two scale (exact) where no square under- or
    # overflows: x * 2^-2m in [0.25, 1), y * 2^-m in [0.5, 1)
    _, ex = torch.frexp(x)
    m = torch.div(ex + 1, 2, rounding_mode="floor")
    xs = torch.ldexp(x, -2 * m)
    ys = torch.ldexp(y, -m)
    best, best_r = ys, None
    for cand in (ys, torch.nextafter(ys, torch.zeros_like(ys)),
                 torch.nextafter(ys, torch.full_like(ys, float("inf")))):
        p, e = _two_square(cand)
        r = ((xs - p) - e).abs()
        if best_r is None:
            best_r = r
        else:
            take = r < best_r
            best = torch.where(take, cand, best)
            best_r = torch.where(take, r, best_r)
    fine = torch.isfinite(y) & (y > 0)
    return torch.where(fine, torch.ldexp(best, m), y)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root in float64 (torch has no cbrt): |x|^(1/3) refined by
    two Newton steps; zeros, infinities and NaN pass through."""
    a = x.abs()
    y = torch.pow(a, 1.0 / 3.0)
    for _ in range(2):
        y = y - (y * y * y - a) / (3.0 * y * y)
    y = torch.where((a == 0) | torch.isinf(a) | torch.isnan(a), a, y)
    return torch.where(torch.signbit(x), -y, y)


class Lowerer:
    """One lowering session over a fixed input schema.

    cols[i] is the runtime plane tuple for slot i:
      non-numeric: (data, valid) ; numeric: (data, valid, exp, dscale)
    """

    def __init__(self, schema: Sequence[ColMeta], cols: Sequence[tuple],
                 base_live: torch.Tensor, params: Sequence[Any] = ()):
        self.schema = list(schema)
        self.cols = list(cols)
        self.base_live = base_live
        self.params = list(params)
        self.n = base_live.shape[0]
        self.dev = base_live.device
        self.err = self._c(0, torch.uint8)

    def _c(self, v, dtype) -> torch.Tensor:
        """A 0-d constant on the lowering device."""
        return torch.tensor(v, dtype=dtype, device=self.dev)

    def _tab(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.dev)

    # -- error plumbing ------------------------------------------------------

    def _raise(self, cond: torch.Tensor, code: int,
               live: torch.Tensor) -> None:
        e = torch.where(cond & live, self._c(code, torch.uint8),
                        self._c(0, torch.uint8))
        self.err = torch.maximum(self.err, e)

    # -- entry ---------------------------------------------------------------

    def lower(self, e: Expr, live: torch.Tensor) -> DVal:
        if isinstance(e, Const):
            return self._lower_pyvalue(e.type, e.value, live)
        if isinstance(e, Param):
            return self._lower_pyvalue(e.type, self.params[e.index], live)
        if isinstance(e, ColumnRef):
            if e.index < 0:
                raise RuntimeError(
                    f"unbound column ref {e.name} reached device lowering")
            planes = self.cols[e.index]
            meta = self.schema[e.index]
            if meta.type is T.NUMERIC:
                v = DVal(T.NUMERIC, planes[0], planes[1], planes[2])
                if len(planes) >= 4:  # display-scale plane (aggregation)
                    v.dscale_lane = planes[3]
                return v
            return DVal(meta.type, planes[0], planes[1])
        if isinstance(e, FuncExpr):
            return self._lower_func(e, live)
        if isinstance(e, BoolExpr):
            return self._lower_bool(e, live)
        if isinstance(e, NullTest):
            v = self.lower(e.arg, live)
            d = (~v.valid) if e.isnull else v.valid
            return DVal(T.BOOL, d, torch.ones_like(d, dtype=torch.bool))
        if isinstance(e, BooleanTest):
            v = self.lower(e.arg, live)
            b = v.data.to(torch.bool)
            tv = v.valid & b
            fv = v.valid & ~b
            uv = ~v.valid
            d = {"is_true": tv, "is_not_true": ~tv, "is_false": fv,
                 "is_not_false": ~fv, "is_unknown": uv,
                 "is_not_unknown": ~uv}[e.test]
            return DVal(T.BOOL, d, torch.ones_like(d, dtype=torch.bool))
        if isinstance(e, CaseExpr):
            return self._lower_case(e, live)
        if isinstance(e, CoalesceExpr):
            vals = [self.lower(a, live) for a in e.args]
            out = vals[-1]
            for v in reversed(vals[:-1]):
                out = _select(v.valid, v, out)
            return out
        raise TypeError(f"cannot lower {type(e)}")

    # -- leaves --------------------------------------------------------------

    def _lower_pyvalue(self, t: T, v: Any, live: torch.Tensor) -> DVal:
        # constants lower as 0-d tensors; broadcasting handles the rest
        if v is None:
            return DVal(t, self._c(0, storage_dtype(t)),
                        self._c(False, torch.bool),
                        self._c(0, torch.int32) if t is T.NUMERIC else None)
        if t is T.NUMERIC:
            from ..sqltypes import numeric_from_decimal
            from decimal import Decimal
            d = v if isinstance(v, Decimal) else Decimal(v)
            mant, exp, _, ok = numeric_from_decimal(d)
            if not ok:
                # constant outside device window: whole-expression recheck
                self._raise(self._c(True, torch.bool), ERR_CPU_RECHECK, live)
                mant, exp = 0, 0
            return DVal(t, self._c(mant, torch.int64), self._c(True, torch.bool),
                        self._c(exp, torch.int32))
        if t in (T.TEXT, T.BPCHAR):
            raise NotImplementedError(
                "text constants lower inside comparisons only")
        return DVal(t, self._c(v, storage_dtype(t)), self._c(True, torch.bool))

    # -- bool ----------------------------------------------------------------

    def _lower_bool(self, e: BoolExpr, live: torch.Tensor) -> DVal:
        if e.op == "not":
            v = self.lower(e.args[0], live)
            return DVal(T.BOOL, ~v.data.to(torch.bool), v.valid)
        vals = [self.lower(a, live) for a in e.args]
        if e.op == "and":
            # Kleene: false dominates null
            d = torch.ones_like(live)
            allv = torch.ones_like(live)
            for v in vals:
                d = d & (v.data.to(torch.bool) | ~v.valid)
                allv = allv & v.valid
            return DVal(T.BOOL, d, allv | ~d)
        if e.op == "or":
            d = torch.zeros_like(live)
            allv = torch.ones_like(live)
            for v in vals:
                d = d | (v.data.to(torch.bool) & v.valid)
                allv = allv & v.valid
            return DVal(T.BOOL, d, allv | d)
        raise ValueError(e.op)

    # -- CASE ----------------------------------------------------------------

    def _lower_case(self, e: CaseExpr, live: torch.Tensor) -> DVal:
        taken = self._c(False, torch.bool)
        branches: list[tuple[torch.Tensor, DVal]] = []
        for cond, res in e.whens:
            cv = self.lower(cond, live)
            fire = cv.valid & cv.data.to(torch.bool) & ~taken
            rv = self.lower(res, live & fire)
            branches.append((fire, rv))
            taken = taken | fire
        if e.orelse is not None:
            out = self.lower(e.orelse, live & ~taken)
        else:
            out = self._lower_pyvalue(e.type, None, live)
        for fire, rv in reversed(branches):
            out = _select(fire, rv, out)
        return out

    # -- function dispatch ---------------------------------------------------

    def _lower_func(self, e: FuncExpr, live: torch.Tensor) -> DVal:
        entry = entry_for_funcexpr(e)
        kind = entry.kind

        # text comparison special case: needs dictionary metadata
        if kind[0] == "cmp" and kind[2] in (T.TEXT, T.BPCHAR):
            return self._lower_text_cmp(e, kind[1], live)

        args = [self.lower(a, live) for a in e.args]
        valid = torch.ones_like(live)
        for a in args:
            valid = valid & a.valid
        alive = live & valid  # strict: errors only where args valid

        k0 = kind[0]
        if k0 == "int_arith":
            return self._int_arith(kind[1], kind[2], args[0], args[1], valid,
                                   alive)
        if k0 == "float_arith":
            return self._float_arith(kind[1], kind[2], args[0], args[1],
                                     valid, alive)
        if k0 == "num_arith":
            return self._num_arith(kind[1], args[0], args[1], valid, alive)
        if k0 == "int_neg":
            return self._int_result(kind[1], -args[0].data.to(torch.int64),
                                    valid, alive)
        if k0 == "int_abs":
            t = kind[1]
            r = args[0].data.to(torch.int64).abs()
            # abs(INT64_MIN) wraps; detect
            if t is T.INT8:
                self._raise(args[0].data == INT64_MIN, ERR_INT8_OVERFLOW,
                            alive)
            return self._int_result(t, r, valid, alive)
        if k0 == "float_neg":
            return DVal(kind[1], -args[0].data, valid)
        if k0 == "float_abs":
            return DVal(kind[1], args[0].data.abs(), valid)
        if k0 == "num_neg":
            return DVal(T.NUMERIC, -args[0].data, valid, args[0].exp)
        if k0 == "num_abs":
            return DVal(T.NUMERIC, args[0].data.abs(), valid, args[0].exp)
        if k0 == "cmp":
            return self._cmp(kind[1], args[0], args[1], valid)
        if k0 == "cast":
            return self._cast(kind[1], kind[2], args[0], valid, alive)
        if k0 == "math1":
            return self._math1(kind[1], args[0], valid, alive)
        if k0 == "math2":
            return self._math2(kind[1], args[0], args[1], valid, alive)
        if k0 == "const_pi":
            return DVal(T.FLOAT8, self._c(np.pi, torch.float64),
                        self._c(True, torch.bool))
        if k0 == "bit":
            return self._bit(kind[1], kind[2], args, valid)
        if k0 == "date_pl_int":
            r = args[0].data.to(torch.int32) + args[1].data.to(torch.int32)
            return DVal(T.DATE, r, valid)
        if k0 == "date_mi_int":
            r = args[0].data.to(torch.int32) - args[1].data.to(torch.int32)
            return DVal(T.DATE, r, valid)
        if k0 == "date_mi_date":
            r = args[0].data.to(torch.int32) - args[1].data.to(torch.int32)
            return DVal(T.INT4, r, valid)
        if k0 == "date_pl_time":
            r = (args[0].data.to(torch.int64) * 86_400_000_000
                 + args[1].data.to(torch.int64))
            return DVal(T.TIMESTAMP, r, valid)
        if k0 == "time_pl_date":
            r = (args[1].data.to(torch.int64) * 86_400_000_000
                 + args[0].data.to(torch.int64))
            return DVal(T.TIMESTAMP, r, valid)
        raise NotImplementedError(f"no device lowering for kind {kind}")

    # -- integer arithmetic with PG overflow semantics ----------------------

    def _int_result(self, t: T, wide: torch.Tensor, valid: torch.Tensor,
                    alive: torch.Tensor) -> DVal:
        """wide is int64; range-check into t and narrow."""
        if t is not T.INT8:
            lo, hi = INT_BOUNDS[t]
            self._raise((wide < lo) | (wide > hi), _INT_OVF_ERR[t], alive)
        return DVal(t, wide.to(storage_dtype(t)), valid)

    def _int_arith(self, op: str, t: T, a: DVal, b: DVal,
                   valid: torch.Tensor, alive: torch.Tensor) -> DVal:
        x = a.data.to(torch.int64)
        y = b.data.to(torch.int64)
        if op == "add":
            r = x + y
            if t is T.INT8:
                ovf = ((torch.sign(x) == torch.sign(y))
                       & (torch.sign(r) != torch.sign(x)) & (x != 0))
                self._raise(ovf, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "sub":
            r = x - y
            if t is T.INT8:
                ovf = ((torch.sign(x) != torch.sign(y))
                       & (torch.sign(r) == torch.sign(y)) & (y != 0))
                self._raise(ovf, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "mul":
            r = x * y
            if t is T.INT8:
                # exact check: r/x != y  (trunc division) unless x==0
                safe_x = torch.where(x == 0, torch.ones_like(x), x)
                bad = (x != 0) & (trunc_div(r, safe_x) != y)
                bad = (bad | ((x == -1) & (y == INT64_MIN))
                       | ((y == -1) & (x == INT64_MIN)))
                self._raise(bad, ERR_INT8_OVERFLOW, alive)
            return self._int_result(t, r, valid, alive)
        if op == "div":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            safe_y = torch.where(y == 0, torch.ones_like(y), y)
            minedge = (x == INT64_MIN) & (y == -1)
            if t is T.INT8:
                self._raise(minedge, ERR_INT8_OVERFLOW, alive)
            safe_y = torch.where(minedge, torch.ones_like(safe_y), safe_y)
            r = trunc_div(x, safe_y)  # trunc toward zero, PG semantics
            return self._int_result(t, r, valid, alive)
        if op == "mod":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            safe_y = torch.where((y == 0) | (y == -1), torch.ones_like(y), y)
            r = trunc_rem(x, safe_y)  # sign follows dividend
            return DVal(t, r.to(storage_dtype(t)), valid)
        raise ValueError(op)

    # -- float arithmetic with CHECKFLOATVAL semantics -----------------------

    def _float_arith(self, op: str, t: T, a: DVal, b: DVal,
                     valid: torch.Tensor, alive: torch.Tensor) -> DVal:
        # float4 anomalies are hard SQL errors; a float8 overflow or
        # underflow defers to the host replay, which raises PostgreSQL's
        # "value out of range" text for the first offending row
        dt = torch.float32 if t is T.FLOAT4 else torch.float64
        ovf_err = ERR_FLOAT_OVERFLOW if t is T.FLOAT4 else ERR_CPU_RECHECK
        und_err = ERR_FLOAT_UNDERFLOW if t is T.FLOAT4 else ERR_CPU_RECHECK
        x = a.data.to(dt)
        y = b.data.to(dt)
        inf_in = torch.isinf(x) | torch.isinf(y)
        if op == "add":
            r = x + y
            zero_ok = True
        elif op == "sub":
            r = x - y
            zero_ok = True
        elif op == "mul":
            r = x * y
            zero_ok = None  # (x==0)|(y==0)
        elif op == "div":
            self._raise(y == 0, ERR_DIV_BY_ZERO, alive)
            r = x / torch.where(y == 0, torch.ones_like(y), y)
            zero_ok = "div"
        else:
            raise ValueError(op)
        self._raise(torch.isinf(r) & ~inf_in, ovf_err, alive)
        if zero_ok is None:
            self._raise((r == 0) & (x != 0) & (y != 0), und_err, alive)
        elif zero_ok == "div":
            self._raise((r == 0) & (x != 0), und_err, alive)
        return DVal(t, r, valid)

    # -- device numeric ------------------------------------------------------

    def _pow10(self, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(10^k as int64, overflow_flag) for k >= 0 lanes."""
        kk = k.clamp(0, 18).to(torch.int64)
        return self._tab(_POW10)[kk], k > 18

    def _num_rescale(self, mant: torch.Tensor, delta: torch.Tensor,
                     alive: torch.Tensor) -> torch.Tensor:
        """mant * 10^delta with CpuReCheck on overflow (delta >= 0)."""
        p, kovf = self._pow10(delta)
        lim = self._tab(_POW10_LIMIT)[delta.clamp(0, 18).to(torch.int64)]
        ovf = kovf | (mant.abs() > lim)
        self._raise(ovf, ERR_CPU_RECHECK, alive)
        return mant * torch.where(ovf, torch.ones_like(p), p)

    def _num_window_check(self, mant: torch.Tensor, exp: torch.Tensor,
                          alive: torch.Tensor) -> None:
        from ..sqltypes import NUMERIC_MIN_EXP, NUMERIC_MAX_EXP
        bad = ((mant.abs() > NUMERIC_MAX_MANT) | (exp < NUMERIC_MIN_EXP)
               | (exp > NUMERIC_MAX_EXP))
        self._raise(bad, ERR_CPU_RECHECK, alive)

    def _num_align(self, a: DVal, b: DVal, alive: torch.Tensor):
        e = torch.minimum(a.exp, b.exp)
        ma = self._num_rescale(a.data, a.exp - e, alive)
        mb = self._num_rescale(b.data, b.exp - e, alive)
        return ma, mb, e

    def _num_arith(self, op: str, a: DVal, b: DVal, valid: torch.Tensor,
                   alive: torch.Tensor) -> DVal:
        if op in ("add", "sub"):
            ma, mb, e = self._num_align(a, b, alive)
            r = ma + mb if op == "add" else ma - mb
            self._num_window_check(r, e, alive)
            return DVal(T.NUMERIC, r, valid, e)
        if op == "mul":
            x, y = a.data, b.data
            r = x * y
            safe_x = torch.where(x == 0, torch.ones_like(x), x)
            bad = (x != 0) & (trunc_div(r, safe_x) != y)
            self._raise(bad, ERR_CPU_RECHECK, alive)
            e = a.exp + b.exp
            self._num_window_check(r, e, alive)
            return DVal(T.NUMERIC, r, valid, e)
        raise NotImplementedError(f"device numeric {op}")

    # -- comparisons ---------------------------------------------------------

    def _cmp(self, tag: str, a: DVal, b: DVal, valid: torch.Tensor) -> DVal:
        if a.t is T.NUMERIC:
            # align exponents exactly; if the rescale would overflow int64
            # lanes flag CPU_RECHECK — an inexact compare could misorder
            e = torch.minimum(a.exp, b.exp)
            pa, ova = self._pow10(a.exp - e)
            pb, ovb = self._pow10(b.exp - e)
            lim = self._tab(_POW10_LIMIT)
            la = lim[(a.exp - e).clamp(0, 18).to(torch.int64)]
            lb = lim[(b.exp - e).clamp(0, 18).to(torch.int64)]
            exact = ~(ova | ovb | (a.data.abs() > la) | (b.data.abs() > lb))
            self._raise(~exact, ERR_CPU_RECHECK, valid)
            ma = a.data * torch.where(exact, pa, torch.ones_like(pa))
            mb = b.data * torch.where(exact, pb, torch.ones_like(pb))
            d = _cmp_from_lt_eq(tag, ma < mb, ma == mb)
            return DVal(T.BOOL, d, valid)
        x, y = a.data, b.data
        if x.dtype != y.dtype:
            ct = torch.promote_types(x.dtype, y.dtype)
            x = x.to(ct)
            y = y.to(ct)
        if a.t in (T.FLOAT4, T.FLOAT8):
            # PG float comparison: NaN == NaN and NaN > everything; IEEE
            # compares are exact over the whole double range
            xn, yn = torch.isnan(x), torch.isnan(y)
            lt = torch.where(xn | yn, (~xn) & yn, x < y)
            eq = torch.where(xn | yn, xn & yn, x == y)
            return DVal(T.BOOL, _cmp_from_lt_eq(tag, lt, eq), valid)
        d = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
             "gt": torch.gt, "ge": torch.ge}[tag](x, y)
        return DVal(T.BOOL, d, valid)

    def _lower_text_cmp(self, e: FuncExpr, tag: str,
                        live: torch.Tensor) -> DVal:
        """Text comparisons via order-preserving dictionary codes.

        col vs const: const is translated to a code boundary at plan time.
        col vs col: only when both share the same dictionary object."""
        a, b = e.args
        if isinstance(a, Const) and isinstance(b, Const):
            # const vs const folds at plan time (C collation: bytewise)
            if a.value is None or b.value is None:
                z = torch.zeros_like(live)
                return DVal(T.BOOL, z, z)          # NULL result
            c = (a.value.encode() > b.value.encode()) - \
                (a.value.encode() < b.value.encode())
            r = {"eq": c == 0, "ne": c != 0, "lt": c < 0, "le": c <= 0,
                 "gt": c > 0, "ge": c >= 0}[tag]
            return DVal(T.BOOL, torch.full_like(live, bool(r)),
                        torch.ones_like(live))
        if isinstance(b, Const) and isinstance(a, ColumnRef):
            return self._text_col_const(a, b, tag, live)
        if isinstance(a, Const) and isinstance(b, ColumnRef):
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                    "eq": "eq", "ne": "ne"}[tag]
            return self._text_col_const(b, a, flip, live)
        if isinstance(a, ColumnRef) and isinstance(b, ColumnRef):
            ma, mb = self.schema[a.index], self.schema[b.index]
            if ma.dict_id == mb.dict_id and ma.dict_id != -1:
                va, vb = self.lower(a, live), self.lower(b, live)
                return self._cmp(tag, va, vb, va.valid & vb.valid)
        raise NotImplementedError("text compare requires col-vs-const or "
                                  "same-dictionary columns on device")

    def _text_col_const(self, col: ColumnRef, c: Const, tag: str,
                        live: torch.Tensor) -> DVal:
        meta = self.schema[col.index]
        d = list(meta.dictionary or ())
        v = self.lower(col, live)
        s = c.value
        if s is None:
            z = torch.zeros_like(live)
            return DVal(T.BOOL, z, z)  # NULL compare -> NULL
        lo = bisect.bisect_left(d, s)
        present = lo < len(d) and d[lo] == s
        code = v.data
        if tag == "eq":
            r = (code == lo) if present else torch.zeros_like(live)
        elif tag == "ne":
            r = (code != lo) if present else torch.ones_like(live)
        elif tag == "lt":
            r = code < lo
        elif tag == "le":
            r = code < (lo + 1 if present else lo)
        elif tag == "gt":
            r = code >= (lo + 1 if present else lo)
        else:  # ge
            r = code >= lo
        return DVal(T.BOOL, r, v.valid)

    # -- casts ---------------------------------------------------------------

    def _cast(self, src: T, dst: T, a: DVal, valid: torch.Tensor,
              alive: torch.Tensor) -> DVal:
        if dst in INT_BOUNDS:
            if src in INT_BOUNDS:
                return self._int_result(dst, a.data.to(torch.int64), valid,
                                        alive)
            if src in (T.FLOAT4, T.FLOAT8):
                f = a.data.to(torch.float64)
                bad = torch.isnan(f) | torch.isinf(f)
                lo, hi = INT_BOUNDS[dst]
                bad = bad | (f < lo - 1.0) | (f > hi + 1.0)
                self._raise(bad, _INT_OVF_ERR[dst], alive)
                r = torch.round(torch.where(bad, torch.zeros_like(f), f)
                                ).to(torch.int64)
                return self._int_result(dst, r, valid, alive)
            if src is T.NUMERIC:
                return self._numeric_to_int(dst, a, valid, alive)
        if dst in (T.FLOAT4, T.FLOAT8):
            dt = torch.float32 if dst is T.FLOAT4 else torch.float64
            if src is T.NUMERIC:
                f = a.data.to(torch.float64) * self._tab(_POW10_F64)[
                    (a.exp + 40).clamp(0, 80).to(torch.int64)]
                # beyond float8's range PostgreSQL raises "value out of
                # range" (over- or underflow): the host replay raises it
                self._raise(torch.isinf(f) | ((f == 0) & (a.data != 0)),
                            ERR_CPU_RECHECK, alive)
                r = f.to(dt)
            else:
                r = a.data.to(dt)
            if dst is T.FLOAT4 and src in (T.FLOAT8, T.NUMERIC):
                self._raise(torch.isinf(r)
                            & ~torch.isinf(a.data.to(torch.float64)),
                            ERR_FLOAT_OVERFLOW, alive)
            return DVal(dst, r, valid)
        if dst is T.NUMERIC:
            if src in INT_BOUNDS:
                return DVal(T.NUMERIC, a.data.to(torch.int64), valid,
                            torch.zeros_like(a.data, dtype=torch.int32))
            # float->numeric needs shortest-repr digits: host only
            self._raise(torch.ones_like(valid), ERR_CPU_RECHECK, alive)
            return DVal(T.NUMERIC, torch.zeros_like(a.data, dtype=torch.int64),
                        valid, torch.zeros_like(a.data, dtype=torch.int32))
        if dst is T.TIMESTAMP and src is T.DATE:
            return DVal(T.TIMESTAMP, a.data.to(torch.int64) * 86_400_000_000,
                        valid)
        if dst is T.DATE and src is T.TIMESTAMP:
            # usec -> days, floored so pre-epoch timestamps land on the
            # right day (pgfn_timestamp_date, opencl_timelib.h)
            r = torch.div(a.data.to(torch.int64), 86_400_000_000,
                          rounding_mode="floor")
            return DVal(T.DATE, r.to(torch.int32), valid)
        if dst is T.TIME and src is T.TIMESTAMP:
            # floored day division keeps pre-epoch times in [0, 86400e6)
            ts = a.data.to(torch.int64)
            day = torch.div(ts, 86_400_000_000, rounding_mode="floor")
            return DVal(T.TIME, ts - day * 86_400_000_000, valid)
        if dst is T.TEXT and src is T.BPCHAR:
            return DVal(T.TEXT, a.data, valid)
        raise NotImplementedError(f"device cast {src} -> {dst}")

    def _numeric_to_int(self, dst: T, a: DVal, valid: torch.Tensor,
                        alive: torch.Tensor) -> DVal:
        mant, exp = a.data, a.exp
        # exp >= 0: value = mant * 10^exp
        up = self._num_rescale(mant, exp.clamp(min=0), alive)
        # exp < 0: round half away from zero
        k = (-exp).clamp(0, 18).to(torch.int64)
        p = self._tab(_POW10)[k]
        q = trunc_div(mant, p)
        r = trunc_rem(mant, p)
        adj = torch.where(r.abs() * 2 >= p, torch.sign(mant),
                          torch.zeros_like(mant))
        down = q + adj
        self._raise((-exp) > 18, ERR_CPU_RECHECK, alive)  # ultra-small: host
        res = torch.where(exp >= 0, up, down)
        return self._int_result(dst, res, valid, alive)

    # -- math ----------------------------------------------------------------

    def _math1(self, name: str, a: DVal, valid: torch.Tensor,
               alive: torch.Tensor) -> DVal:
        x = a.data.to(torch.float64)
        fns = {
            "cbrt": _cbrt, "ceil": torch.ceil, "ceiling": torch.ceil,
            "floor": torch.floor, "exp": torch.exp, "ln": torch.log,
            "log": torch.log10, "sqrt": _sqrt, "sign": _sign,
            "degrees": lambda v: v * (180.0 / np.pi),
            "radians": lambda v: v * (np.pi / 180.0),
            "trunc": torch.trunc, "round": torch.round,
            "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
            "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
            "cot": lambda v: torch.cos(v) / torch.sin(v),
        }
        r = fns[name](x)
        if name in ("sqrt", "ln", "log", "asin", "acos"):
            self._raise(torch.isnan(r) & ~torch.isnan(x), ERR_CPU_RECHECK,
                        alive)
        # a result leaving float8's range (exp(1000)) is PostgreSQL's
        # "value out of range" error: the host replay raises it
        self._raise(torch.isinf(r) & ~torch.isinf(x), ERR_CPU_RECHECK, alive)
        return DVal(T.FLOAT8, r, valid)

    def _math2(self, name: str, a: DVal, b: DVal, valid: torch.Tensor,
               alive: torch.Tensor) -> DVal:
        x = a.data.to(torch.float64)
        y = b.data.to(torch.float64)
        if name in ("pow", "power"):
            r = torch.pow(x, y)
            self._raise(torch.isnan(r) & ~(torch.isnan(x) | torch.isnan(y)),
                        ERR_CPU_RECHECK, alive)
        else:
            r = torch.atan2(x, y)
        self._raise(torch.isinf(r) & ~(torch.isinf(x) | torch.isinf(y)),
                    ERR_CPU_RECHECK, alive)
        return DVal(T.FLOAT8, r, valid)

    # -- bit ops -------------------------------------------------------------

    def _bit(self, op: str, t: T, args: list[DVal],
             valid: torch.Tensor) -> DVal:
        dt = storage_dtype(t)
        x = args[0].data.to(dt)
        if op == "not":
            return DVal(t, ~x, valid)
        y = args[1].data.to(dt)
        if op == "and":
            return DVal(t, x & y, valid)
        if op == "or":
            return DVal(t, x | y, valid)
        if op == "xor":
            return DVal(t, x ^ y, valid)
        bits = {T.INT2: 16, T.INT4: 32, T.INT8: 64}[t]
        sh = (args[1].data.to(torch.int32) & (bits - 1)).to(dt)
        if op == "shl":
            return DVal(t, x << sh, valid)
        return DVal(t, x >> sh, valid)


def f64_bits(data: torch.Tensor) -> torch.Tensor:
    """The IEEE-754 bits of a float8 lane as int64: a view of the float64
    data plane, so a FLOAT8 column needs no bits plane of its own."""
    return data.to(torch.float64).view(torch.int64)


def _f64_orderkey(bits: torch.Tensor) -> torch.Tensor:
    """Map IEEE-754 double bits (int64) to int64 keys with PG float ordering:
    total order, -0 == +0, NaN equal to NaN and greater than everything."""
    b = bits.to(torch.int64)
    b = torch.where(b == INT64_MIN, torch.zeros_like(b), b)
    expmask = 0x7FF0000000000000
    frac = b & 0x000FFFFFFFFFFFFF
    is_nan = ((b & expmask) == expmask) & (frac != 0)
    b = torch.where(is_nan, torch.full_like(b, 0x7FF8000000000000), b)
    return torch.where(b < 0, -1 - (b & INT64_MAX), b)


def _select(mask: torch.Tensor, a: DVal, b: DVal) -> DVal:
    """where(mask, a, b) lane-wise; a and b must share type."""
    exp = None
    if a.t is T.NUMERIC:
        exp = torch.where(mask, a.exp, b.exp)
    return DVal(a.t, torch.where(mask, a.data, b.data),
                torch.where(mask, a.valid, b.valid), exp)


def _cmp_from_lt_eq(tag: str, lt: torch.Tensor,
                    eq: torch.Tensor) -> torch.Tensor:
    return {"eq": eq, "ne": ~eq, "lt": lt, "le": lt | eq,
            "gt": ~(lt | eq), "ge": ~lt}[tag]


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------

def schema_from_chunk_columns(names: Sequence[str], cols) -> list[ColMeta]:
    """Build ColMeta list from datastore Columns (dictionary identity via id)."""
    out = []
    for name, c in zip(names, cols):
        out.append(ColMeta(name=name, type=c.type,
                           dictionary=tuple(c.dictionary) if c.dictionary else None,
                           dict_id=id(c.dictionary) if c.dictionary is not None else -1))
    return out


def planes_of_column(c) -> tuple:
    """Runtime plane tuple for one datastore Column (host ndarrays):
    (data, valid), and for NUMERIC also (exp, dscale).  A FLOAT8 column's
    IEEE bits are `data.view(torch.int64)` on the device, so they ship no
    plane of their own."""
    if c.type is T.NUMERIC:
        return (c.data, c.valid, c.num_exp, c.num_dscale)
    return (c.data, c.valid)


def _live(cols: tuple, nrows) -> torch.Tensor:
    n = cols[0][0].shape[0] if cols else 0
    dev = cols[0][0].device if cols else torch.device("cpu")
    return torch.arange(n, dtype=torch.int32, device=dev) < int(nrows)


def pred_mask(lw: Lowerer, pred: Optional[Expr],
              live: torch.Tensor) -> torch.Tensor:
    """Rows of `live` where `pred` is TRUE (all of them for no pred)."""
    if pred is None:
        return live
    v = lw.lower(pred, live)
    return live & v.valid & v.data.to(torch.bool)


def err_max(lw: Lowerer, live: torch.Tensor) -> torch.Tensor:
    """The most severe error code raised on a live row (uint8 scalar)."""
    if not live.shape[0]:
        return torch.tensor(0, dtype=torch.uint8, device=live.device)
    return torch.where(live, lw.err, torch.zeros_like(lw.err)).max()


def build_qual_fn(pred: Expr, schema: Sequence[ColMeta]) -> Callable:
    """Return f(cols, nrows) -> (pass_mask bool[n], err uint8[n]).

    pass_mask is True only for rows < nrows where the qual is TRUE (SQL:
    NULL/false both drop the row).  The gpuscan_qual kernel analog
    (opencl_gpuscan.h:98-136)."""
    def f(cols: tuple, nrows):
        live = _live(cols, nrows)
        lw = Lowerer(schema, cols, live)
        v = lw.lower(pred, live)
        mask = live & v.valid & v.data.to(torch.bool)
        return mask, torch.where(live, lw.err, torch.zeros_like(lw.err))
    return f


def build_project_fn(exprs: Sequence[Expr], schema: Sequence[ColMeta],
                     pred: Optional[Expr] = None) -> Callable:
    """Return f(cols, nrows) -> (outs, mask, err) where outs is a tuple of
    plane-tuples per expression (fused filter+projection)."""
    def f(cols: tuple, nrows):
        live = _live(cols, nrows)
        lw = Lowerer(schema, cols, live)
        if pred is not None:
            pv = lw.lower(pred, live)
            mask = live & pv.valid & pv.data.to(torch.bool)
        else:
            mask = live
        outs = []
        for e in exprs:
            v = lw.lower(e, mask)
            if v.t is T.NUMERIC:
                outs.append((v.data, v.valid & mask, v.exp))
            else:
                outs.append((v.data, v.valid & mask))
        return (tuple(outs), mask,
                torch.where(live, lw.err, torch.zeros_like(lw.err)))
    return f
