"""Host-exact aggregation transitions and chunk replay.

This is the CPU fallback tier: the same slot/partial model as the device
kernel (ops/preagg.py) computed with unbounded python arithmetic — python
ints, Decimal, f64 — so a replayed chunk merges seamlessly with device
partials and finalizes identically.  The analog of the reference's
gpupreagg_next_tuple_fallback host re-aggregation (gpupreagg.c:2507-2608).

PG accumulation-precision quirks reproduced:
  sum(float4) accumulates stepwise in float4 (float4pl);
  every other float aggregate accumulates in float8 (float4_accum widens).
"""

from __future__ import annotations

import math
from decimal import Decimal
from typing import Any, Callable, Sequence

import numpy as np

from ..sqltypes import T
from ..datastore import Chunk
from ..errors import SqlError
from .. import pgnumeric as pgn
from ..expr.ir import Expr
from ..expr.eval_cpu import eval_expr_cpu
from ..ops.preagg import AggInstance


class _NaNKey:
    """Canonical grouping key for NaN (SQL groups all NaNs together)."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "NaN"


def canon_group_key(v: Any) -> Any:
    """Hashable canonical form with SQL grouping equality."""
    if v is None:
        return None
    if isinstance(v, float):
        if math.isnan(v):
            return _NaNKey()
        if v == 0.0:
            return 0.0
    if isinstance(v, Decimal):
        if v.is_nan():
            return _NaNKey()
        return ("num", v.normalize())  # 1.5 == 1.50
    return v


def new_state(inst: AggInstance) -> dict[str, Any]:
    s: dict[str, Any] = {}
    for kind in inst.slots:
        if kind in ("nrows", "count"):
            s[kind] = 0
        elif kind in ("sum_i", "sumsq_i"):
            s[kind] = 0
        elif kind in ("sum_f", "sumsq_f", "sum_x", "sum_y", "sum_xy",
                      "sumsq_x", "sumsq_y"):
            s[kind] = 0.0
        elif kind in ("sum_num", "sumsq_num"):
            s[kind] = Decimal(0)
        elif kind == "maxdscale":
            s[kind] = 0
        elif kind in ("min", "max"):
            s[kind] = None
    return s


def _ckf(result: float, *inputs: float) -> float:
    """PG CHECKFLOATVAL: raise when a float transition overflows to inf
    from finite inputs (float4pl / float8_accum / float8_regr_accum all
    apply this — the overflow_agg corpus checks the error text)."""
    if math.isinf(result) and not any(math.isinf(v) for v in inputs):
        from ..errors import ERR_FLOAT_OVERFLOW
        raise SqlError("value out of range: overflow", ERR_FLOAT_OVERFLOW)
    return result


def update_state(inst: AggInstance, s: dict[str, Any], args: Sequence[Any]) -> None:
    """One row's exact transition."""
    if "nrows" in s:
        s["nrows"] += 1
    if any(a is None for a in args):
        return  # strict aggregates skip rows with NULL in any argument
    if getattr(inst, "distinct", False):
        # agg(DISTINCT x): one transition per distinct argument tuple
        seen = s.setdefault("__distinct_seen__", set())
        key = tuple(canon_group_key(a) for a in args)
        if key in seen:
            return
        seen.add(key)
    if "count" in s:
        s["count"] += 1
    for kind in inst.slots:
        if kind in ("nrows", "count"):
            continue
        if kind == "sum_i":
            s[kind] += int(args[0])
        elif kind == "sumsq_i":
            s[kind] += int(args[0]) * int(args[0])
        elif kind == "sum_f":
            if inst.family == "f4" and inst.aggname == "sum":
                # PG float4pl: stepwise float4 accumulation with overflow
                # check; overflow->inf is intended (explicit errstate — _ckf
                # raises the PG error, numpy's warning path is noise)
                with np.errstate(over="ignore"):
                    r = float(np.float32(np.float32(s[kind])
                                         + np.float32(args[0])))
                s[kind] = _ckf(r, s[kind], float(args[0]))
            else:
                s[kind] = _ckf(s[kind] + float(args[0]), s[kind], float(args[0]))
        elif kind == "sumsq_f":
            v = float(args[0])
            s[kind] = _ckf(s[kind] + _ckf(v * v, v), v)
        elif kind == "sum_x":
            s[kind] = _ckf(s[kind] + float(args[0]), float(args[0]))
        elif kind == "sum_y":
            s[kind] = _ckf(s[kind] + float(args[1]), float(args[1]))
        elif kind == "sum_xy":
            x, y = float(args[0]), float(args[1])
            s[kind] = _ckf(s[kind] + _ckf(x * y, x, y), x, y)
        elif kind == "sumsq_x":
            v = float(args[0])
            s[kind] = _ckf(s[kind] + _ckf(v * v, v), v)
        elif kind == "sumsq_y":
            v = float(args[1])
            s[kind] = _ckf(s[kind] + _ckf(v * v, v), v)
        elif kind == "sum_num":
            s[kind] += _as_decimal(args[0])
        elif kind == "sumsq_num":
            d = _as_decimal(args[0])
            s[kind] += d * d
        elif kind == "maxdscale":
            s[kind] = max(s[kind], pgn.dscale_of(_as_decimal(args[0])))
        elif kind in ("min", "max"):
            from ..ops.preagg import _merge_minmax
            s[kind] = _merge_minmax(kind, s[kind], args[0])


def _as_decimal(v: Any) -> Decimal:
    if isinstance(v, Decimal):
        return v
    return Decimal(int(v)) if isinstance(v, (int, np.integer)) else Decimal(repr(float(v)))


def replay_chunk_preagg(chunk: Chunk, layout_names: Sequence[str],
                        pred: Expr | None, group_exprs: Sequence[Expr],
                        aggs: Sequence[AggInstance],
                        states: dict, displays: dict) -> None:
    """Aggregate one chunk's rows host-exactly into (states, displays).

    states[canon_key_tuple] = [state dict per agg instance]
    displays[canon_key_tuple] = first-seen display values of the group keys.
    Expressions must already be bound to `layout_names` slots."""
    cols = [chunk.columns[nm] for nm in layout_names]

    def row_get(i: int) -> Callable[[int], Any]:
        return lambda slot: cols[slot].get(i)

    for i in range(chunk.nrows):
        row = row_get(i)
        if pred is not None:
            if eval_expr_cpu(pred, row) is not True:
                continue
        kvals = tuple(eval_expr_cpu(g, row) for g in group_exprs)
        ck = tuple(canon_group_key(v) for v in kvals)
        if ck not in states:
            states[ck] = [new_state(inst) for inst in aggs]
            displays[ck] = kvals
        st = states[ck]
        for inst, s in zip(aggs, st):
            args = [eval_expr_cpu(a, row) for a in inst.args]
            update_state(inst, s, args)
