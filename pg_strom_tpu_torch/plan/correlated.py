"""Correlated subquery expressions (SubPlans).

The reference system never loses this surface because pg_strom only swaps
scan/join/agg nodes inside PostgreSQL's finished plan — SubPlan nodes keep
running row-at-a-time on the PostgreSQL CPU executor (grafter.c:24-149;
gpuscan.c:168 adds paths, never removes capability).  This engine IS the
database, so the equivalent host tier lives here:

 1. BIND: when the uncorrelated InitPlan path fails with a BindError, the
    subquery's AST is walked with a stack of inner-scope frames (FROM
    aliases -> column sets, innermost-first like PG name resolution);
    names that resolve in no inner frame but DO resolve in the outer
    scope are replaced by ACorrParam placeholders, and a SubPlan IR node
    captures the template + the bound outer expressions.  A validation
    plan with NULL parameters runs immediately so genuinely broken
    subqueries still error at bind time with their own message.
 2. EVAL (expr/eval_cpu.py): per outer row, the outer expressions
    evaluate, the template re-plans with the values substituted as typed
    constants (ABoundConst — so the subquery's own device offload still
    applies to each instantiation), and the result memoizes on the
    canonical parameter tuple.  PostgreSQL re-executes the subplan per
    row with no such cache, so repeated keys are strictly faster here.

Scalar subqueries raise on >1 row; IN follows SQL three-valued logic
(no match + NULL in the set => NULL).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..sqltypes import T
from ..errors import SqlError
from ..sql import parser as ast
from ..expr.ir import Expr, SubPlan, BoolExpr
from ..pgops import cmp_values

_ANY = None          # sentinel column-set: unknown => treat as "has every column"
_MEMO_CAP = 1 << 16


class _Rewriter:
    """Scope-aware outer-reference substitution over a subquery AST."""

    def __init__(self, outer_scope, bind_expr_fn):
        self.scope = outer_scope
        self.bind_expr = bind_expr_fn
        self.outer_exprs: list[Expr] = []
        self.types: list[T] = []

    # -- inner-scope frames -------------------------------------------------

    def _frame_of(self, q) -> dict:
        fr: dict = {}
        refs = list(q.frm) + [jc.table for jc in q.joins]
        for tr in refs:
            alias = tr.alias or tr.name
            if tr.subquery is not None:
                cols = self._out_cols(tr.subquery)
                if tr.col_aliases:
                    cols = (_ANY if cols is _ANY
                            else set(tr.col_aliases) | cols)
            else:
                db = getattr(self.scope, "db", None)
                try:
                    cols = set(db.get(tr.name).columns.keys())
                except Exception:
                    cols = _ANY       # unknown rel: let the plan error
            fr[alias] = cols
        return fr

    def _out_cols(self, sub):
        if isinstance(sub, ast.SetOpStmt):
            return self._out_cols(sub.left)
        out: set = set()
        for it in sub.items:
            if isinstance(it.expr, ast.AStar):
                for v in self._frame_of(sub).values():
                    if v is _ANY:
                        return _ANY
                    out |= v
            elif it.alias:
                out.add(it.alias)
            elif isinstance(it.expr, ast.AName):
                out.add(it.expr.parts[-1])
            elif isinstance(it.expr, ast.AFunc):
                out.add(it.expr.name)
            else:
                out.add("?column?")
        return out

    # -- rewriting ----------------------------------------------------------

    def rewrite_query(self, q, frames=()):
        if isinstance(q, ast.SetOpStmt):
            return dataclasses.replace(
                q, left=self.rewrite_query(q.left, frames),
                right=self.rewrite_query(q.right, frames))
        fr2 = frames + (self._frame_of(q),)
        fields = {}
        for f in dataclasses.fields(q):
            v = getattr(q, f.name)
            if f.name == "frm":
                # FROM subqueries get the OUTER frames only (they cannot
                # see this level's siblings, like non-LATERAL PG)
                fields[f.name] = self._rw(v, frames)
            elif f.name == "joins":
                # join TABLES scope like FROM entries, but their ON
                # conditions see this level's relations
                fields[f.name] = [dataclasses.replace(
                    jc, table=self._rw(jc.table, frames),
                    on=(self._rw(jc.on, fr2)
                        if jc.on is not None else None))
                    for jc in v]
            else:
                fields[f.name] = self._rw(v, fr2)
        return dataclasses.replace(q, **fields)

    def _rw(self, n, frames):
        if isinstance(n, (ast.SelectStmt, ast.SetOpStmt)):
            return self.rewrite_query(n, frames)
        if isinstance(n, ast.AName):
            return self._name(n, frames)
        if isinstance(n, list):
            return [self._rw(x, frames) for x in n]
        if isinstance(n, tuple):
            return tuple(self._rw(x, frames) for x in n)
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            return dataclasses.replace(n, **{
                f.name: self._rw(getattr(n, f.name), frames)
                for f in dataclasses.fields(n)})
        return n

    def _name(self, n: "ast.AName", frames):
        parts = n.parts
        if len(parts) == 2:
            alias = parts[0]
            for fr in reversed(frames):
                if alias in fr:
                    return n            # inner reference
        else:
            col = parts[0]
            for fr in reversed(frames):
                for cols in fr.values():
                    if cols is _ANY or col in cols:
                        return n        # inner (or indeterminable) ref
        from .binder import BindError
        try:
            e = self.bind_expr(n, self.scope, False)
        except BindError:
            return n                    # let the inner plan raise its error
        for i, x in enumerate(self.outer_exprs):
            if x == e:
                return ast.ACorrParam(i)
        self.outer_exprs.append(e)
        self.types.append(e.type)
        return ast.ACorrParam(len(self.outer_exprs) - 1)


def _substitute(n, values, types):
    """Template with every ACorrParam(i) replaced by a typed constant."""
    if isinstance(n, ast.ACorrParam):
        return ast.ABoundConst(values[n.index], types[n.index])
    if isinstance(n, list):
        return [_substitute(x, values, types) for x in n]
    if isinstance(n, tuple):
        return tuple(_substitute(x, values, types) for x in n)
    if dataclasses.is_dataclass(n) and not isinstance(n, type):
        return dataclasses.replace(n, **{
            f.name: _substitute(getattr(n, f.name), values, types)
            for f in dataclasses.fields(n)})
    return n


class _Runner:
    """Executes one SubPlan: substitute -> plan -> run, memoized."""

    def __init__(self, template, types, db, negated: bool = False):
        self.template = template
        self.types = types
        self.db = db
        self.negated = negated
        self.memo: dict = {}

    def _rows(self, pvals) -> list:
        from ..exec.hostexec import canon_group_key
        key = tuple(canon_group_key(v) for v in pvals)
        try:
            return self.memo[key]
        except KeyError:
            pass
        except TypeError:
            key = None                   # unhashable param: run uncached
        from .planner import plan_query
        q = _substitute(self.template, list(pvals), self.types)
        rows = plan_query(q, self.db).execute()
        if key is not None:
            if len(self.memo) >= _MEMO_CAP:
                self.memo.clear()
            self.memo[key] = rows
        return rows

    def __call__(self, kind: str, vals: list):
        if kind == "scalar":
            rows = self._rows(vals)
            if len(rows) > 1:
                raise SqlError("more than one row returned by a subquery "
                               "used as an expression")
            return rows[0][0] if rows else None
        if kind == "exists":
            rows = self._rows(vals)
            return bool(rows) != self.negated
        if kind == "in":
            probe, pvals = vals[0], vals[1:]
            rows = self._rows(pvals)
            if probe is None:
                return None if rows else False
            saw_null = False
            for r in rows:
                if r[0] is None:
                    saw_null = True
                elif cmp_values(probe, r[0]) == 0:
                    return True
            return None if saw_null else False
        raise RuntimeError(f"unknown SubPlan kind {kind!r}")


def bind_correlated(a, scope, allow_aggs: bool, orig_err) -> Expr:
    """Bind an ASubquery / AExists / AIn-subquery whose uncorrelated
    InitPlan path failed, as a SubPlan; re-raises orig_err when nothing
    in the subquery actually resolves to the outer scope."""
    from .binder import bind_expr, BindError
    from .planner import plan_query, _expand_ctes

    q = a.items.query if isinstance(a, ast.AIn) else a.query
    if getattr(q, "ctes", None):
        q = _expand_ctes(q)              # CTE names must not look "outer"
    rw = _Rewriter(scope, bind_expr)
    template = rw.rewrite_query(q)
    if not rw.outer_exprs:
        raise orig_err

    # validation plan with NULL parameters: genuine subquery errors
    # (missing tables, bad functions, wrong arity) surface NOW, at bind
    # time, with their own message — and it types the scalar result
    val = _substitute(template, [None] * len(rw.types), rw.types)
    pq = plan_query(val, scope.db)

    if isinstance(a, ast.ASubquery):
        if len(pq.out_types) != 1:
            raise BindError("subquery must return only one column")
        runner = _Runner(template, rw.types, scope.db)
        return SubPlan(type=pq.out_types[0], kind="scalar",
                       outer_args=tuple(rw.outer_exprs), runner=runner)
    if isinstance(a, ast.AExists):
        runner = _Runner(template, rw.types, scope.db, negated=a.negated)
        return SubPlan(type=T.BOOL, kind="exists",
                       outer_args=tuple(rw.outer_exprs), runner=runner)
    if isinstance(a, ast.AIn):
        if len(pq.out_types) != 1:
            raise BindError("subquery must return only one column")
        probe = bind_expr(a.arg, scope, allow_aggs)
        runner = _Runner(template, rw.types, scope.db)
        node: Expr = SubPlan(type=T.BOOL, kind="in",
                             outer_args=(probe,) + tuple(rw.outer_exprs),
                             runner=runner)
        if a.negated:
            node = BoolExpr(type=T.BOOL, op="not", args=(node,))
        return node
    raise orig_err
