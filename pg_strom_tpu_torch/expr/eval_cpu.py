"""Exact host evaluation of expression trees, row at a time.

This is the trusted CPU path: the analog of letting vanilla PostgreSQL run
the query (which is exactly how the reference generates its expected/*.out —
input/make_expected.sh runs the suite with pg_strom.enabled=off).  It is used
to produce goldens, to re-check rows the device flagged (CpuReCheck), and to
evaluate host-only quals after the dev/host split.

Values: python scalars; None is NULL; Decimal for numeric; str for text.
Three-valued logic for AND/OR/NOT per SQL.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from .ir import (Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr, NullTest,
                 BooleanTest, CaseExpr, CoalesceExpr, Aggref, SubPlan)
from .catalog import entry_for_funcexpr


def eval_expr_cpu(e: Expr, row: Callable[[int], Any],
                  params: Sequence[Any] = ()) -> Any:
    """Evaluate e for one row.  `row(slot)` returns the bound column value."""
    if isinstance(e, Const):
        return e.value
    if isinstance(e, Param):
        return params[e.index]
    if isinstance(e, ColumnRef):
        if e.index < 0:
            raise RuntimeError(f"unbound column ref {e.name}")
        return row(e.index)
    if isinstance(e, FuncExpr):
        entry = entry_for_funcexpr(e)
        args = [eval_expr_cpu(a, row, params) for a in e.args]
        if entry.strict and any(a is None for a in args):
            return None
        return entry.cpu(*args)
    if isinstance(e, BoolExpr):
        if e.op == "not":
            v = eval_expr_cpu(e.args[0], row, params)
            return None if v is None else (not v)
        if e.op == "and":
            saw_null = False
            for a in e.args:
                v = eval_expr_cpu(a, row, params)
                if v is False:
                    return False
                if v is None:
                    saw_null = True
            return None if saw_null else True
        if e.op == "or":
            saw_null = False
            for a in e.args:
                v = eval_expr_cpu(a, row, params)
                if v is True:
                    return True
                if v is None:
                    saw_null = True
            return None if saw_null else False
        raise ValueError(e.op)
    if isinstance(e, NullTest):
        v = eval_expr_cpu(e.arg, row, params)
        return (v is None) if e.isnull else (v is not None)
    if isinstance(e, BooleanTest):
        v = eval_expr_cpu(e.arg, row, params)
        return {
            "is_true": v is True,
            "is_not_true": v is not True,
            "is_false": v is False,
            "is_not_false": v is not False,
            "is_unknown": v is None,
            "is_not_unknown": v is not None,
        }[e.test]
    if isinstance(e, CaseExpr):
        for cond, res in e.whens:
            if eval_expr_cpu(cond, row, params) is True:
                return eval_expr_cpu(res, row, params)
        if e.orelse is not None:
            return eval_expr_cpu(e.orelse, row, params)
        return None
    if isinstance(e, CoalesceExpr):
        for a in e.args:
            v = eval_expr_cpu(a, row, params)
            if v is not None:
                return v
        return None
    if isinstance(e, SubPlan):
        # correlated subquery: outer args evaluate on THIS row, then the
        # runner re-plans the carried template with the values (memoized
        # on the canonical tuple — plan/correlated.py)
        vals = [eval_expr_cpu(a, row, params) for a in e.outer_args]
        return e.runner(e.kind, vals)
    if isinstance(e, Aggref):
        raise RuntimeError("Aggref must be rewritten by the preagg planner "
                           "before evaluation")
    raise TypeError(f"unknown expression node {type(e)}")
