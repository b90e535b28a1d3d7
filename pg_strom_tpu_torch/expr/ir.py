"""Typed expression IR.

Node set mirrors what the reference's codegen walker supports
(codegen.c:1065-1392: Const, Param, Var, FuncExpr, OpExpr, NullTest,
BooleanTest, BoolExpr, RelabelType, CaseExpr) plus Aggref/Coalesce for the
aggregation rewrite layer (gpupreagg.c:1033+ analog).

Operator/function resolution with implicit numeric promotion follows the
PostgreSQL lattice: int2 -> int4 -> int8 -> numeric -> float4 -> float8.
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Optional, Sequence

from ..sqltypes import T, INT_TYPES, FLOAT_TYPES, STRING_TYPES


@dataclasses.dataclass(frozen=True)
class Expr:
    type: T

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: Any  # python exact value: int / float / Decimal / str / bool / None

    def __repr__(self) -> str:
        return f"Const({self.value!r}::{self.type.name})"


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    index: int


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    name: str            # qualified "rel.col" or bare column name
    index: int = -1      # slot in the bound input row layout

    def __repr__(self) -> str:
        return f"Col({self.name}::{self.type.name})"


@dataclasses.dataclass(frozen=True)
class FuncExpr(Expr):
    """A resolved call of a catalog function (operators included: '+' etc.)."""
    fname: str
    args: tuple[Expr, ...]

    def children(self) -> tuple[Expr, ...]:
        return self.args

    def __repr__(self) -> str:
        return f"{self.fname}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class BoolExpr(Expr):
    """Kleene AND/OR (n-ary) and NOT."""
    op: str  # 'and' | 'or' | 'not'
    args: tuple[Expr, ...]

    def children(self) -> tuple[Expr, ...]:
        return self.args


@dataclasses.dataclass(frozen=True)
class NullTest(Expr):
    arg: Expr
    isnull: bool  # True: IS NULL; False: IS NOT NULL

    def children(self) -> tuple[Expr, ...]:
        return (self.arg,)


@dataclasses.dataclass(frozen=True)
class BooleanTest(Expr):
    arg: Expr
    test: str  # 'is_true' | 'is_not_true' | 'is_false' | 'is_not_false' | 'is_unknown' | 'is_not_unknown'

    def children(self) -> tuple[Expr, ...]:
        return (self.arg,)


@dataclasses.dataclass(frozen=True)
class CaseExpr(Expr):
    whens: tuple[tuple[Expr, Expr], ...]  # (condition, result)
    orelse: Optional[Expr]

    def children(self) -> tuple[Expr, ...]:
        out: list[Expr] = []
        for c, r in self.whens:
            out += [c, r]
        if self.orelse is not None:
            out.append(self.orelse)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class CoalesceExpr(Expr):
    args: tuple[Expr, ...]

    def children(self) -> tuple[Expr, ...]:
        return self.args


@dataclasses.dataclass(frozen=True)
class Aggref(Expr):
    """An aggregate call in a target list (rewritten by the preagg planner
    into partial slots + final expression, gpupreagg.c:104-333 analog)."""
    aggname: str
    args: tuple[Expr, ...]
    distinct: bool = False
    star: bool = False  # count(*)

    def children(self) -> tuple[Expr, ...]:
        return self.args

    def __repr__(self) -> str:
        inner = "*" if self.star else ", ".join(map(repr, self.args))
        return f"{self.aggname}({inner})::{self.type.name}"


_SUBPLAN_UID = iter(range(1, 1 << 62))


@dataclasses.dataclass(frozen=True)
class SubPlan(Expr):
    """A correlated subquery expression (PostgreSQL's SubPlan).  The
    reference system leaves SubPlan nodes to the PostgreSQL CPU executor
    — its planner hook only swaps scan/join/agg nodes below them
    (grafter.c:24-149); this engine owns the executor, so the same host
    tier lives here.  outer_args evaluate against the outer row; the
    runner (plan/correlated.py) re-plans its carried query template with
    those values substituted, memoized on the canonical value tuple.
    Never device-lowered (device_expression_supported -> False)."""
    kind: str                       # 'scalar' | 'exists' | 'in'
    outer_args: tuple[Expr, ...]    # for 'in': probe expr first
    uid: int = dataclasses.field(default_factory=lambda: next(_SUBPLAN_UID))
    runner: Any = dataclasses.field(default=None, compare=False,
                                    repr=False)

    def children(self) -> tuple[Expr, ...]:
        return self.outer_args

    def __repr__(self) -> str:
        return f"SubPlan({self.kind}#{self.uid})"


# ---------------------------------------------------------------------------
# Implicit casts and operator resolution (PG numeric promotion lattice)
# ---------------------------------------------------------------------------

_PROMOTION_ORDER = [T.INT2, T.INT4, T.INT8, T.NUMERIC, T.FLOAT4, T.FLOAT8]


def can_implicit_cast(src: T, dst: T) -> bool:
    if src == dst:
        return True
    if src in _PROMOTION_ORDER and dst in _PROMOTION_ORDER:
        return _PROMOTION_ORDER.index(src) < _PROMOTION_ORDER.index(dst)
    if src is T.BPCHAR and dst is T.TEXT:
        return True
    if src is T.DATE and dst is T.TIMESTAMP:
        return True
    return False


def common_supertype(a: T, b: T) -> Optional[T]:
    if a == b:
        return a
    for cand in (a, b):
        if can_implicit_cast(a, cand) and can_implicit_cast(b, cand):
            return cand
    # both numeric-ish: promote to the later of the two in the lattice
    if a in _PROMOTION_ORDER and b in _PROMOTION_ORDER:
        return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a), _PROMOTION_ORDER.index(b))]
    return None


def implicit_cast(e: Expr, dst: T) -> Expr:
    """Wrap e in a cast FuncExpr if needed."""
    if e.type == dst:
        return e
    if not can_implicit_cast(e.type, dst):
        raise TypeError(f"cannot cast {e.type.name} to {dst.name} implicitly")
    if isinstance(e, Const):
        return Const(type=dst, value=_cast_const(e.value, e.type, dst))
    return FuncExpr(type=dst, fname=f"cast::{dst.name.lower()}", args=(e,))


def explicit_cast(e: Expr, dst: T) -> Expr:
    if e.type == dst:
        return e
    if isinstance(e, Const) and e.value is None:
        return Const(type=dst, value=None)
    return FuncExpr(type=dst, fname=f"cast::{dst.name.lower()}", args=(e,))


def _cast_const(v: Any, src: T, dst: T) -> Any:
    if v is None:
        return None
    if dst in INT_TYPES:
        return int(v)
    if dst in FLOAT_TYPES:
        return float(v)
    if dst is T.NUMERIC:
        if isinstance(v, float):
            return Decimal(repr(v))
        return Decimal(v)
    return v


def resolve_function(fname: str, args: Sequence[Expr]) -> FuncExpr:
    """Resolve a call against the catalog with implicit casts.

    The analog of the reference's devfunc_info lookup
    (pgstrom_devfunc_lookup, codegen.c:993+)."""
    from .catalog import FUNCTION_CATALOG, lookup_signature

    sig = lookup_signature(fname, tuple(a.type for a in args))
    if sig is None:
        typestr = ", ".join(a.type.value for a in args)
        raise TypeError(f"function {fname}({typestr}) does not exist")
    entry = FUNCTION_CATALOG[sig]
    cast_args = tuple(implicit_cast(a, t) for a, t in zip(args, sig[1]))
    return FuncExpr(type=entry.rettype, fname=_sig_name(sig), args=cast_args)


def _sig_name(sig: tuple[str, tuple[T, ...]]) -> str:
    name, argts = sig
    return f"{name}::" + ",".join(t.name.lower() for t in argts)


def bind_columns(e: Expr, layout: dict[str, int]) -> Expr:
    """Assign slot indexes to ColumnRefs per an input layout (name -> slot)."""
    if isinstance(e, ColumnRef):
        if e.name not in layout:
            raise KeyError(f'column "{e.name}" does not exist in input layout')
        return dataclasses.replace(e, index=layout[e.name])
    if isinstance(e, FuncExpr):
        return dataclasses.replace(e, args=tuple(bind_columns(a, layout) for a in e.args))
    if isinstance(e, SubPlan):
        return dataclasses.replace(e, outer_args=tuple(
            bind_columns(a, layout) for a in e.outer_args))
    if isinstance(e, BoolExpr):
        return dataclasses.replace(e, args=tuple(bind_columns(a, layout) for a in e.args))
    if isinstance(e, NullTest):
        return dataclasses.replace(e, arg=bind_columns(e.arg, layout))
    if isinstance(e, BooleanTest):
        return dataclasses.replace(e, arg=bind_columns(e.arg, layout))
    if isinstance(e, CaseExpr):
        return dataclasses.replace(
            e,
            whens=tuple((bind_columns(c, layout), bind_columns(r, layout)) for c, r in e.whens),
            orelse=None if e.orelse is None else bind_columns(e.orelse, layout),
        )
    if isinstance(e, CoalesceExpr):
        return dataclasses.replace(e, args=tuple(bind_columns(a, layout) for a in e.args))
    if isinstance(e, Aggref):
        return dataclasses.replace(e, args=tuple(bind_columns(a, layout) for a in e.args))
    return e


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def referenced_columns(e: Expr) -> list[str]:
    out: list[str] = []
    for n in walk(e):
        if isinstance(n, ColumnRef) and n.name not in out:
            out.append(n.name)
    return out
