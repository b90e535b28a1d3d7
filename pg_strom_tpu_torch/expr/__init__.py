"""Expression engine: typed IR, function catalog and exact host evaluation.

The device lowering of the reference (expr/lower_jax.py) is
expr/lower_torch.py: the Lowerer evaluates a typed tree with torch ops on
the planes' device, with the reference's error lanes and numeric window.
"""

from .ir import (  # noqa: F401
    Expr, Const, ColumnRef, Param, FuncExpr, BoolExpr, NullTest, BooleanTest,
    CaseExpr, Aggref, CoalesceExpr, resolve_function, implicit_cast, bind_columns,
)
from .catalog import FUNCTION_CATALOG, device_expression_supported  # noqa: F401
from .eval_cpu import eval_expr_cpu  # noqa: F401
