"""Name/type resolution: untyped SQL AST -> typed expression IR.

The reference leans on PostgreSQL's parser for typing and only decides
device placement (pgstrom_codegen_available_expression); standalone, the
binder owns PG's typing rules: literal typing (integral -> int4/int8,
decimal -> numeric, quoted -> text), operator resolution with the numeric
promotion lattice, NULL literals adopting their context type, aggregate
resolution, alias/ordinal references in GROUP BY / ORDER BY.
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Optional, Sequence

from ..sqltypes import T, type_from_sql
from ..datastore import Table
from ..expr.ir import (
    Expr, Const, ColumnRef, FuncExpr, BoolExpr, NullTest, BooleanTest,
    CaseExpr, CoalesceExpr, Aggref, resolve_function, explicit_cast,
    implicit_cast, common_supertype,
)
from ..ops.preagg import lookup_agg, AGG_CATALOG
from ..sql import parser as ast


class BindError(Exception):
    pass


AGG_NAMES = {name for name, _ in AGG_CATALOG}


@dataclasses.dataclass
class Scope:
    """Visible relations: list of (alias, Table).  Column refs resolve to
    'alias.col' names; bare names must be unambiguous.  `db` enables
    uncorrelated subquery expressions (scalar / IN / EXISTS), which plan
    and run their subplan at bind time."""
    rels: list[tuple[str, Table]]
    db: Any = None

    def resolve(self, parts: tuple[str, ...]) -> tuple[str, T]:
        if len(parts) == 2:
            alias, col = parts
            for a, tbl in self.rels:
                if a == alias:
                    if col not in tbl.columns:
                        raise BindError(
                            f'column {alias}.{col} does not exist')
                    return f"{a}.{col}", tbl.columns[col].type
            raise BindError(f'missing FROM-clause entry for table "{alias}"')
        col = parts[0]
        hits = [(a, tbl) for a, tbl in self.rels if col in tbl.columns]
        if not hits:
            raise BindError(f'column "{col}" does not exist')
        if len(hits) > 1:
            raise BindError(f'column reference "{col}" is ambiguous')
        a, tbl = hits[0]
        return f"{a}.{col}", tbl.columns[col].type

    def all_columns(self, rel: Optional[str] = None) -> list[tuple[str, T]]:
        out = []
        for a, tbl in self.rels:
            if rel is not None and a != rel:
                continue
            for c, col in tbl.columns.items():
                out.append((f"{a}.{c}", col.type))
        return out


def _retype_null(e: Expr, t: T) -> Expr:
    if isinstance(e, Const) and e.value is None:
        return Const(type=t, value=None)
    return e


def bind_expr(a: Any, scope: Scope, allow_aggs: bool = False) -> Expr:
    if isinstance(a, ast.ALiteral):
        v = a.value
        if v is None:
            return Const(type=T.TEXT, value=None)   # untyped NULL; retyped in context
        if a.is_string:
            return Const(type=T.TEXT, value=v)
        if isinstance(v, bool):
            return Const(type=T.BOOL, value=v)
        if isinstance(v, int):
            t = T.INT4 if -(1 << 31) <= v < (1 << 31) else T.INT8
            return Const(type=t, value=v)
        if isinstance(v, Decimal):
            return Const(type=T.NUMERIC, value=v)
        raise BindError(f"cannot bind literal {v!r}")
    if isinstance(a, ast.AName):
        name, t = scope.resolve(a.parts)
        return ColumnRef(type=t, name=name)
    if isinstance(a, ast.AOp):
        if a.op in ("is_true", "is_not_true", "is_false", "is_not_false"):
            arg = bind_expr(a.args[0], scope, allow_aggs)
            return BooleanTest(type=T.BOOL, arg=arg, test=a.op)
        args = [bind_expr(x, scope, allow_aggs) for x in a.args]
        args = _retype_nulls(args)
        return resolve_function(a.op, args)
    if isinstance(a, ast.AFunc):
        if a.name in AGG_NAMES or a.star:
            return _bind_aggref(a, scope, allow_aggs)
        if a.name == "coalesce":
            args = [bind_expr(x, scope, allow_aggs) for x in a.args]
            ct = None
            for x in args:
                if not (isinstance(x, Const) and x.value is None):
                    ct = x.type if ct is None else (common_supertype(ct, x.type) or ct)
            ct = ct or T.TEXT
            args = tuple(implicit_cast(_retype_null(x, ct), ct) for x in args)
            return CoalesceExpr(type=ct, args=args)
        if a.name == "nullif":
            if len(a.args) != 2:
                raise BindError("nullif takes exactly two arguments")
            x = bind_expr(a.args[0], scope, allow_aggs)
            y = bind_expr(a.args[1], scope, allow_aggs)
            eq = resolve_function("=", _retype_nulls([x, y]))
            # NULLIF(v1, v2) = CASE WHEN v1 = v2 THEN NULL ELSE v1 END
            return CaseExpr(type=x.type, whens=(
                (eq, Const(type=x.type, value=None)),), orelse=x)
        if a.name in ("greatest", "least"):
            args = [bind_expr(x, scope, allow_aggs) for x in a.args]
            if not args:
                raise BindError(f"{a.name} requires at least one argument")
            ct = None
            for x in args:
                if not (isinstance(x, Const) and x.value is None):
                    ct = x.type if ct is None else \
                        (common_supertype(ct, x.type) or ct)
            ct = ct or T.TEXT
            args = [implicit_cast(_retype_null(x, ct), ct) for x in args]
            op = ">=" if a.name == "greatest" else "<="
            # pairwise fold; PG skips NULL inputs (NULL only when ALL are)
            acc = args[0]
            for b in args[1:]:
                cmpv = resolve_function(op, [acc, b])
                acc = CaseExpr(type=ct, whens=(
                    (NullTest(type=T.BOOL, arg=acc, isnull=True), b),
                    (NullTest(type=T.BOOL, arg=b, isnull=True), acc),
                    (cmpv, acc)), orelse=b)
            return acc
        args = [bind_expr(x, scope, allow_aggs) for x in a.args]
        return resolve_function(a.name, _retype_nulls(args))
    if isinstance(a, ast.ACast):
        arg = bind_expr(a.arg, scope, allow_aggs)
        dst = type_from_sql(a.typename)
        if isinstance(arg, Const) and arg.value is None:
            return Const(type=dst, value=None)
        if isinstance(arg, Const) and arg.type is T.TEXT and dst is not T.TEXT:
            return Const(type=dst, value=_parse_text_literal(arg.value, dst))
        return explicit_cast(arg, dst)
    if isinstance(a, ast.ABool):
        args = tuple(_coerce_bool(bind_expr(x, scope, allow_aggs))
                     for x in a.args)
        return BoolExpr(type=T.BOOL, op=a.op, args=args)
    if isinstance(a, ast.ANullTest):
        return NullTest(type=T.BOOL, arg=bind_expr(a.arg, scope, allow_aggs),
                        isnull=a.isnull)
    if isinstance(a, ast.ADistinctFrom):
        x = bind_expr(a.a, scope, allow_aggs)
        y = bind_expr(a.b, scope, allow_aggs)
        x, y = _retype_nulls([x, y])
        eq = resolve_function("=", [x, y])

        def _nt(e):
            # constant-fold nullness of literals (text consts have no
            # standalone device lowering; a literal's nullness is static)
            if isinstance(e, Const):
                return Const(type=T.BOOL, value=e.value is None)
            return NullTest(type=T.BOOL, arg=e, isnull=True)

        xn = _nt(x)
        yn = _nt(y)
        # null-safe equality: both NULL -> TRUE, one NULL -> FALSE, else =
        same = CaseExpr(type=T.BOOL, whens=(
            (BoolExpr(type=T.BOOL, op="and", args=(xn, yn)),
             Const(type=T.BOOL, value=True)),
            (BoolExpr(type=T.BOOL, op="or", args=(xn, yn)),
             Const(type=T.BOOL, value=False))), orelse=eq)
        if a.negated:
            return BoolExpr(type=T.BOOL, op="not", args=(same,))
        return same
    if isinstance(a, ast.ACase):
        whens = []
        rtypes = []
        bound = []
        for c, r in a.whens:
            cb = _coerce_bool(bind_expr(c, scope, allow_aggs))
            rb = bind_expr(r, scope, allow_aggs)
            bound.append((cb, rb))
            if not (isinstance(rb, Const) and rb.value is None):
                rtypes.append(rb.type)
        ob = bind_expr(a.orelse, scope, allow_aggs) if a.orelse is not None else None
        if ob is not None and not (isinstance(ob, Const) and ob.value is None):
            rtypes.append(ob.type)
        ct = rtypes[0] if rtypes else T.TEXT
        for t2 in rtypes[1:]:
            ct = common_supertype(ct, t2) or ct
        whens = tuple((c, implicit_cast(_retype_null(r, ct), ct))
                      for c, r in bound)
        if ob is not None:
            ob = implicit_cast(_retype_null(ob, ct), ct)
        return CaseExpr(type=ct, whens=whens, orelse=ob)
    if isinstance(a, ast.ABetween):
        arg = bind_expr(a.arg, scope, allow_aggs)
        lo = bind_expr(a.lo, scope, allow_aggs)
        hi = bind_expr(a.hi, scope, allow_aggs)
        ge = resolve_function(">=", _retype_nulls([arg, lo]))
        le = resolve_function("<=", _retype_nulls([arg, hi]))
        e: Expr = BoolExpr(type=T.BOOL, op="and", args=(ge, le))
        if a.negated:
            e = BoolExpr(type=T.BOOL, op="not", args=(e,))
        return e
    if isinstance(a, ast.AIn):
        arg = bind_expr(a.arg, scope, allow_aggs)
        if isinstance(a.items, ast.ASubquery):
            try:
                vals = _run_subquery(a.items.query, scope, ncols=1)
            except BindError as err:
                from .correlated import bind_correlated
                return bind_correlated(a, scope, allow_aggs, err)
            items = [Const(type=vals[1][0], value=r[0]) for r in vals[0]]
            if not items:
                # IN (empty set) = FALSE, NOT IN (empty set) = TRUE — even
                # for NULL arguments (PostgreSQL semantics)
                return Const(type=T.BOOL, value=bool(a.negated))
        else:
            items = [bind_expr(x, scope, allow_aggs) for x in a.items]
        eqs = tuple(resolve_function("=", _retype_nulls([arg, x]))
                    for x in items)
        e = eqs[0] if len(eqs) == 1 else BoolExpr(type=T.BOOL, op="or", args=eqs)
        if a.negated:
            e = BoolExpr(type=T.BOOL, op="not", args=(e,))
        return e
    if isinstance(a, ast.ASubquery):
        try:
            rows, types = _run_subquery(a.query, scope, ncols=1)
        except BindError as err:
            from .correlated import bind_correlated
            return bind_correlated(a, scope, allow_aggs, err)
        if len(rows) > 1:
            raise BindError("more than one row returned by a subquery "
                            "used as an expression")
        v = rows[0][0] if rows else None
        return Const(type=types[0], value=v)
    if isinstance(a, ast.AExists):
        try:
            rows, _ = _run_subquery(a.query, scope, ncols=None)
        except BindError as err:
            from .correlated import bind_correlated
            return bind_correlated(a, scope, allow_aggs, err)
        return Const(type=T.BOOL, value=bool(rows) != a.negated)
    if isinstance(a, ast.ABoundConst):
        return Const(type=a.vtype, value=a.value)
    raise BindError(f"cannot bind {type(a).__name__}")


def _run_subquery(q, scope: Scope, ncols):
    """Plan + run an uncorrelated subquery at bind time (PG runs InitPlans
    once per query too; correlated subqueries are not supported yet)."""
    if scope.db is None:
        raise BindError("subquery expressions need a database context")
    from .planner import plan_query
    pq = plan_query(q, scope.db)
    if ncols is not None and len(pq.out_types) != ncols:
        raise BindError("subquery must return only one column")
    return pq.execute(), pq.out_types


def _parse_text_literal(s: str, dst: T) -> Any:
    """PG casts quoted literals through the target type's input function."""
    from ..sqltypes import INT_BOUNDS
    try:
        if dst in INT_BOUNDS:
            return int(s.strip())
        if dst in (T.FLOAT4, T.FLOAT8):
            return float(s.strip())
        if dst is T.NUMERIC:
            return Decimal(s.strip())
        if dst is T.BOOL:
            return s.strip().lower() in ("t", "true", "yes", "on", "1")
    except Exception:
        raise BindError(f'invalid input syntax for type {dst.value}: "{s}"')
    return s


def _retype_nulls(args: Sequence[Expr]) -> list[Expr]:
    """NULL literals adopt the type of a sibling argument."""
    ctx = None
    for x in args:
        if not (isinstance(x, Const) and x.value is None):
            ctx = x.type
            break
    if ctx is None:
        return list(args)
    return [_retype_null(x, ctx) for x in args]


def _coerce_bool(e: Expr) -> Expr:
    if e.type is not T.BOOL:
        raise BindError(
            f"argument of AND/OR/NOT/WHERE must be type boolean, "
            f"not type {e.type.value}")
    return e


def _bind_aggref(a: ast.AFunc, scope: Scope, allow_aggs: bool) -> Aggref:
    if not allow_aggs:
        raise BindError("aggregate functions are not allowed here")
    if a.star or (a.name == "count" and not a.args):
        d, fam = lookup_agg("count", (), star=True)
        return Aggref(type=d.rettype, aggname="count", args=(), star=True)
    args = [bind_expr(x, scope, allow_aggs=False) for x in a.args]
    if a.name in ("corr", "covar_pop", "covar_samp", "regr_sxx"):
        args = [implicit_cast(_retype_null(x, T.FLOAT8), T.FLOAT8) for x in args]
    d, fam = lookup_agg(a.name, tuple(x.type for x in args))
    return Aggref(type=d.rettype, aggname=a.name, args=tuple(args),
                  distinct=a.distinct)
