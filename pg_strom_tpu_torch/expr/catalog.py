"""Device function catalog.

The analog of the reference's devtype/devfunc catalogs (codegen.c:46-630,
~190 entries).  Each entry records:
  rettype   — SQL result type
  kind      — a lowering tag dispatched by expr/lower_jax.py (replaces the
              reference's template mini-language, codegen.c:183-209)
  cpu       — exact host implementation (PG semantics incl. error text)
  device_ok — False => host-only (forces the dev/host qual split the
              reference does via pgstrom_codegen_available_expression,
              codegen.c:1631-1759)

Signatures are resolved with PG's numeric promotion lattice; mixed
numeric×float goes to float8 like PG operator resolution does.
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Callable, Optional

from ..sqltypes import T, INT_TYPES, FLOAT_TYPES, STRING_TYPES
from .. import pgops as ops
from .. import pgnumeric as pgn

Sig = tuple[str, tuple[T, ...]]


@dataclasses.dataclass(frozen=True)
class DevFunc:
    rettype: T
    kind: tuple            # lowering dispatch tag
    cpu: Callable[..., Any]
    device_ok: bool = True
    strict: bool = True    # NULL in -> NULL out without evaluation


FUNCTION_CATALOG: dict[Sig, DevFunc] = {}


def _reg(name: str, argtypes: tuple[T, ...], ret: T, kind: tuple,
         cpu: Callable[..., Any], device_ok: bool = True) -> None:
    FUNCTION_CATALOG[(name, argtypes)] = DevFunc(ret, kind, cpu, device_ok)


# ---------------------------------------------------------------------------
# integer arithmetic: homogeneous signatures per result type (mixed-width
# calls resolve via promotion to the wider type)
# ---------------------------------------------------------------------------

for t in INT_TYPES:
    _reg("+", (t, t), t, ("int_arith", "add", t), (lambda tt: lambda a, b: ops.int_add(tt, a, b))(t))
    _reg("-", (t, t), t, ("int_arith", "sub", t), (lambda tt: lambda a, b: ops.int_sub(tt, a, b))(t))
    _reg("*", (t, t), t, ("int_arith", "mul", t), (lambda tt: lambda a, b: ops.int_mul(tt, a, b))(t))
    _reg("/", (t, t), t, ("int_arith", "div", t), (lambda tt: lambda a, b: ops.int_div(tt, a, b))(t))
    _reg("%", (t, t), t, ("int_arith", "mod", t), (lambda tt: lambda a, b: ops.int_mod(tt, a, b))(t))
    _reg("neg", (t,), t, ("int_neg", t), (lambda tt: lambda a: ops.int_neg(tt, a))(t))
    _reg("abs", (t,), t, ("int_abs", t), (lambda tt: lambda a: ops.int_abs(tt, a))(t))
    _reg("&", (t, t), t, ("bit", "and", t), (lambda tt: lambda a, b: ops.bit_and(tt, a, b))(t))
    _reg("|", (t, t), t, ("bit", "or", t), (lambda tt: lambda a, b: ops.bit_or(tt, a, b))(t))
    _reg("#", (t, t), t, ("bit", "xor", t), (lambda tt: lambda a, b: ops.bit_xor(tt, a, b))(t))
    _reg("~", (t,), t, ("bit", "not", t), (lambda tt: lambda a: ops.bit_not(tt, a))(t))
    _reg("<<", (t, T.INT4), t, ("bit", "shl", t), (lambda tt: lambda a, b: ops.bit_shl(tt, a, b))(t))
    _reg(">>", (t, T.INT4), t, ("bit", "shr", t), (lambda tt: lambda a, b: ops.bit_shr(tt, a, b))(t))

for t in FLOAT_TYPES:
    _reg("+", (t, t), t, ("float_arith", "add", t), (lambda tt: lambda a, b: ops.float_add(tt, a, b))(t))
    _reg("-", (t, t), t, ("float_arith", "sub", t), (lambda tt: lambda a, b: ops.float_sub(tt, a, b))(t))
    _reg("*", (t, t), t, ("float_arith", "mul", t), (lambda tt: lambda a, b: ops.float_mul(tt, a, b))(t))
    _reg("/", (t, t), t, ("float_arith", "div", t), (lambda tt: lambda a, b: ops.float_div(tt, a, b))(t))
    _reg("neg", (t,), t, ("float_neg", t), (lambda tt: lambda a: ops.float_neg(tt, a))(t))
    _reg("abs", (t,), t, ("float_abs", t), (lambda tt: lambda a: ops.float_abs(tt, a))(t))

# numeric arithmetic (device ops work in the (mant,exp) window, overflow =>
# CpuReCheck; host ops are Decimal-exact with PG dscale rules)
_reg("+", (T.NUMERIC, T.NUMERIC), T.NUMERIC, ("num_arith", "add"), pgn.num_add)
_reg("-", (T.NUMERIC, T.NUMERIC), T.NUMERIC, ("num_arith", "sub"), pgn.num_sub)
_reg("*", (T.NUMERIC, T.NUMERIC), T.NUMERIC, ("num_arith", "mul"), pgn.num_mul)
_reg("/", (T.NUMERIC, T.NUMERIC), T.NUMERIC, ("num_arith", "div"), pgn.num_div,
     device_ok=False)  # div rscale rules are host-side (like reference: no numeric div on device)
_reg("%", (T.NUMERIC, T.NUMERIC), T.NUMERIC, ("num_arith", "mod"), pgn.num_mod,
     device_ok=False)
_reg("neg", (T.NUMERIC,), T.NUMERIC, ("num_neg",), pgn.num_neg)
_reg("abs", (T.NUMERIC,), T.NUMERIC, ("num_abs",), pgn.num_abs)

# ---------------------------------------------------------------------------
# comparisons — homogeneous per family supertype + strings + datetimes
# ---------------------------------------------------------------------------

_CMPS = [("=", "eq"), ("<>", "ne"), ("<", "lt"), ("<=", "le"), (">", "gt"), (">=", "ge")]
_CMP_PY = {
    "eq": lambda c: c == 0, "ne": lambda c: c != 0, "lt": lambda c: c < 0,
    "le": lambda c: c <= 0, "gt": lambda c: c > 0, "ge": lambda c: c >= 0,
}

_COMPARABLE = list(INT_TYPES) + list(FLOAT_TYPES) + [T.NUMERIC, T.BOOL,
                                                     T.DATE, T.TIME, T.TIMESTAMP,
                                                     T.TEXT, T.BPCHAR]
for t in _COMPARABLE:
    for name, tag in _CMPS:
        _reg(name, (t, t), T.BOOL, ("cmp", tag, t),
             (lambda tg: lambda a, b: _CMP_PY[tg](ops.cmp_values(a, b)))(tag))

# ---------------------------------------------------------------------------
# casts within the numeric family (+ date->timestamp)
# ---------------------------------------------------------------------------

_CAST_NAME = {T.INT2: "int2", T.INT4: "int4", T.INT8: "int8",
              T.FLOAT4: "float4", T.FLOAT8: "float8", T.NUMERIC: "numeric"}
for src in list(INT_TYPES) + list(FLOAT_TYPES) + [T.NUMERIC]:
    for dst in list(INT_TYPES) + list(FLOAT_TYPES) + [T.NUMERIC]:
        if src == dst:
            continue
        if dst in INT_TYPES:
            cpu = (lambda dd: lambda v: ops.cast_to_int(dd, v))(dst)
        elif dst in FLOAT_TYPES:
            cpu = (lambda dd: lambda v: ops.cast_to_float(dd, v))(dst)
        elif src is T.FLOAT4:
            cpu = ops.cast_float4_to_numeric  # %.6g (FLT_DIG) text path
        else:
            cpu = ops.cast_to_numeric
        _reg(f"cast::{dst.name.lower()}", (src,), dst, ("cast", src, dst), cpu)
_reg("cast::timestamp", (T.DATE,), T.TIMESTAMP, ("cast", T.DATE, T.TIMESTAMP),
     ops.date_to_timestamp)
_reg("cast::date", (T.TIMESTAMP,), T.DATE, ("cast", T.TIMESTAMP, T.DATE),
     ops.timestamp_to_date)
_reg("cast::text", (T.BPCHAR,), T.TEXT, ("cast", T.BPCHAR, T.TEXT), lambda v: v)

# ---------------------------------------------------------------------------
# math library (float8 domain) — opencl_mathlib.h analog
# ---------------------------------------------------------------------------

for f1 in ops.MATH1:
    _reg(f1, (T.FLOAT8,), T.FLOAT8, ("math1", f1),
         (lambda nn: lambda x: ops.math1(nn, x))(f1))
for f2 in ops.MATH2:
    _reg(f2, (T.FLOAT8, T.FLOAT8), T.FLOAT8, ("math2", f2),
         (lambda nn: lambda x, y: ops.math2(nn, x, y))(f2))
_reg("pi", (), T.FLOAT8, ("const_pi",), lambda: 3.141592653589793)
# numeric-flavored round/trunc/ceil/floor (host-only: dscale bookkeeping)
_reg("round", (T.NUMERIC, T.INT4), T.NUMERIC, ("num_round",),
     lambda d, s: pgn.round_to_scale(d, s), device_ok=False)
_reg("trunc", (T.NUMERIC,), T.NUMERIC, ("num_trunc",),
     lambda d: d.to_integral_value(rounding="ROUND_DOWN"), device_ok=False)
_reg("ceil", (T.NUMERIC,), T.NUMERIC, ("num_ceil",),
     lambda d: d.to_integral_value(rounding="ROUND_CEILING"), device_ok=False)
_reg("floor", (T.NUMERIC,), T.NUMERIC, ("num_floor",),
     lambda d: d.to_integral_value(rounding="ROUND_FLOOR"), device_ok=False)
_reg("sqrt", (T.NUMERIC,), T.NUMERIC, ("num_sqrt",), pgn.num_sqrt, device_ok=False)

# ---------------------------------------------------------------------------
# date/time arithmetic — opencl_timelib.h analog
# ---------------------------------------------------------------------------

_reg("+", (T.DATE, T.INT4), T.DATE, ("date_pl_int",), ops.date_pl_int)
_reg("-", (T.DATE, T.INT4), T.DATE, ("date_mi_int",), ops.date_mi_int)
_reg("-", (T.DATE, T.DATE), T.INT4, ("date_mi_date",), ops.date_mi_date)
# timestamp -> time-of-day and date + time -> timestamp (reference
# opencl_timelib.h:261 pgfn_timestamp_time, :382 pgfn_datetime_pl)
_reg("cast::time", (T.TIMESTAMP,), T.TIME, ("cast", T.TIMESTAMP, T.TIME),
     ops.timestamp_to_time)
_reg("+", (T.DATE, T.TIME), T.TIMESTAMP, ("date_pl_time",),
     ops.datetime_timestamp)
_reg("+", (T.TIME, T.DATE), T.TIMESTAMP, ("time_pl_date",),
     lambda t, d: ops.datetime_timestamp(d, t))

# ---------------------------------------------------------------------------
# text — opencl_textlib.h analog (C collation compare only on device);
# length/concat are host-only, exercising the dev/host split
# ---------------------------------------------------------------------------

_reg("length", (T.TEXT,), T.INT4, ("text_length",), lambda s: len(s),
     device_ok=False)
_reg("||", (T.TEXT, T.TEXT), T.TEXT, ("text_cat",), lambda a, b: a + b,
     device_ok=False)
_reg("like", (T.TEXT, T.TEXT), T.BOOL, ("text_like",),
     lambda s, p: _sql_like(s, p), device_ok=False)


def _sql_like(s: str, pat: str) -> bool:
    import re
    rx = "".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                 for c in pat)
    return re.fullmatch(rx, s, flags=re.DOTALL) is not None


# common PostgreSQL text functions — host tier (varlena manipulation
# stays on the CPU in the reference too; only fixed-width compares ride
# the device).  Semantics match PG: 1-based substr with clamping,
# strpos 0 when absent, trim removes SPACES only by default,
# left/right negative-count complements.

def _pg_substr(s: str, start: int, ln: int = None) -> str:
    if ln is None:
        return s[max(start - 1, 0):]
    if ln < 0:
        from ..errors import SqlError
        raise SqlError("negative substring length not allowed")
    return s[max(start - 1, 0):max(start - 1 + ln, 0)]


def _pg_left(s: str, n: int) -> str:
    return "" if n == 0 else s[:n]


def _pg_right(s: str, n: int) -> str:
    return "" if n == 0 else s[-n:]


# C-locale case mapping: PostgreSQL in C collation uppercases ASCII only
# (python str.upper is Unicode-aware and can even change
# string length — 'ß'.upper() == 'SS' — diverging from the parity target)
_ASCII_UPPER = str.maketrans("abcdefghijklmnopqrstuvwxyz",
                             "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_ASCII_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                             "abcdefghijklmnopqrstuvwxyz")
_reg("upper", (T.TEXT,), T.TEXT, ("text_upper",),
     lambda s: s.translate(_ASCII_UPPER), device_ok=False)
_reg("lower", (T.TEXT,), T.TEXT, ("text_lower",),
     lambda s: s.translate(_ASCII_LOWER), device_ok=False)
for _nm, _how in (("btrim", str.strip), ("trim", str.strip),
                  ("ltrim", str.lstrip), ("rtrim", str.rstrip)):
    _reg(_nm, (T.TEXT,), T.TEXT, (f"text_{_nm}",),
         (lambda how: lambda s: how(s, " "))(_how), device_ok=False)
    _reg(_nm, (T.TEXT, T.TEXT), T.TEXT, (f"text_{_nm}2",),
         (lambda how: lambda s, cs: how(s, cs))(_how), device_ok=False)
_reg("substr", (T.TEXT, T.INT4), T.TEXT, ("text_substr2",), _pg_substr,
     device_ok=False)
_reg("substr", (T.TEXT, T.INT4, T.INT4), T.TEXT, ("text_substr3",),
     _pg_substr, device_ok=False)
_reg("substring", (T.TEXT, T.INT4), T.TEXT, ("text_substr2",), _pg_substr,
     device_ok=False)
_reg("substring", (T.TEXT, T.INT4, T.INT4), T.TEXT, ("text_substr3",),
     _pg_substr, device_ok=False)
_reg("strpos", (T.TEXT, T.TEXT), T.INT4, ("text_strpos",),
     lambda s, sub: s.find(sub) + 1, device_ok=False)
_reg("replace", (T.TEXT, T.TEXT, T.TEXT), T.TEXT, ("text_replace",),
     lambda s, a, b: s.replace(a, b), device_ok=False)
_reg("repeat", (T.TEXT, T.INT4), T.TEXT, ("text_repeat",),
     lambda s, n: s * max(n, 0), device_ok=False)
_reg("left", (T.TEXT, T.INT4), T.TEXT, ("text_left",), _pg_left,
     device_ok=False)
_reg("right", (T.TEXT, T.INT4), T.TEXT, ("text_right",), _pg_right,
     device_ok=False)
_reg("starts_with", (T.TEXT, T.TEXT), T.BOOL, ("text_starts",),
     lambda s, p: s.startswith(p), device_ok=False)


# float8 exp/ln/log/power/sign etc. already ride the device math library
# (ops.MATH1/MATH2 above — opencl_mathlib.h analog); log10 is PG's alias
# for log(double)
FUNCTION_CATALOG[("log10", (T.FLOAT8,))] = \
    FUNCTION_CATALOG[("log", (T.FLOAT8,))]
_reg("sign", (T.NUMERIC,), T.NUMERIC, ("num_sign",),
     lambda x: __import__("decimal").Decimal(0 if x == 0
                                             else (1 if x > 0 else -1)),
     device_ok=False)

# mod(a, b) is the function form of % (same transition, same errors)
for _t in INT_TYPES + (T.NUMERIC,):
    _sig = ("%", (_t, _t))
    if _sig in FUNCTION_CATALOG:
        FUNCTION_CATALOG[("mod", (_t, _t))] = FUNCTION_CATALOG[_sig]


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

_PROMO = [T.INT2, T.INT4, T.INT8, T.NUMERIC, T.FLOAT4, T.FLOAT8]


def lookup_signature(name: str, argtypes: tuple[T, ...]) -> Optional[Sig]:
    """Exact match, then family promotion (PG-operator-resolution-lite)."""
    if (name, argtypes) in FUNCTION_CATALOG:
        return (name, argtypes)
    # bpchar -> text fallback
    at2 = tuple(T.TEXT if t is T.BPCHAR else t for t in argtypes)
    if at2 != argtypes and (name, at2) in FUNCTION_CATALOG:
        return (name, at2)
    # numeric-family promotion
    if argtypes and all(t in _PROMO for t in argtypes):
        idx = max(_PROMO.index(t) for t in argtypes)
        ct = _PROMO[idx]
        # PG: numeric mixed with float -> float8
        if (ct in (T.FLOAT4, T.FLOAT8)) and any(t is T.NUMERIC for t in argtypes):
            ct = T.FLOAT8
        cand = (name, tuple(ct for _ in argtypes))
        if cand in FUNCTION_CATALOG:
            return cand
        # int2/int4 shift ops keep 2nd arg int4 etc: try (ct, original) forms
        for sig in FUNCTION_CATALOG:
            if sig[0] != name or len(sig[1]) != len(argtypes):
                continue
            if all(_promotable(a, b) for a, b in zip(argtypes, sig[1])):
                return sig
    # date/timestamp mixing
    if argtypes and all(t in (T.DATE, T.TIMESTAMP) for t in argtypes):
        cand = (name, tuple(T.TIMESTAMP for _ in argtypes))
        if cand in FUNCTION_CATALOG:
            return cand
    # last resort: unique promotable signature
    matches = [sig for sig in FUNCTION_CATALOG
               if sig[0] == name and len(sig[1]) == len(argtypes)
               and all(_promotable(a, b) for a, b in zip(argtypes, sig[1]))]
    if len(matches) == 1:
        return matches[0]
    return None


def _promotable(src: T, dst: T) -> bool:
    if src == dst:
        return True
    if src in _PROMO and dst in _PROMO:
        return _PROMO.index(src) < _PROMO.index(dst)
    if src is T.BPCHAR and dst is T.TEXT:
        return True
    if src is T.DATE and dst is T.TIMESTAMP:
        return True
    return False


def device_expression_supported(e) -> bool:
    """True when the whole expression tree lowers to the TPU path — the
    pgstrom_codegen_available_expression analog (codegen.c:1631)."""
    from .ir import (Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr,
                     NullTest, BooleanTest, CaseExpr, CoalesceExpr, Aggref)
    if isinstance(e, (Const, ColumnRef, Param)):
        return True
    if isinstance(e, FuncExpr):
        entry = _entry_for(e)
        if entry is None or not entry.device_ok:
            return False
        return all(device_expression_supported(a) for a in e.args)
    if isinstance(e, (BoolExpr, CoalesceExpr)):
        return all(device_expression_supported(a) for a in e.args)
    if isinstance(e, (NullTest, BooleanTest)):
        return device_expression_supported(e.arg)
    if isinstance(e, CaseExpr):
        return all(device_expression_supported(c) for c in e.children())
    if isinstance(e, Aggref):
        return all(device_expression_supported(a) for a in e.args)
    return False


def _entry_for(e) -> Optional[DevFunc]:
    """Catalog entry for a resolved FuncExpr (fname = 'name::t1,t2')."""
    name, _, typestr = e.fname.partition("::")
    if name.startswith("cast"):
        # cast::dst stored with src argtypes
        sig = (e.fname.split("::")[0] + "::" + e.fname.split("::")[1],
               tuple(a.type for a in e.args))
        return FUNCTION_CATALOG.get(sig)
    argts = tuple(a.type for a in e.args)
    return FUNCTION_CATALOG.get((name, argts))


def entry_for_funcexpr(e) -> DevFunc:
    entry = _entry_for(e)
    if entry is None:
        raise KeyError(f"no catalog entry for {e.fname}")
    return entry
