"""Grouped partial aggregation: the aggregate catalog and the host half.

The reference's ops/preagg.py computes chunk partials on the device with
XLA (scatter / sort / one-hot matmul strategies) and finalizes them
exactly on the host, reproducing PostgreSQL's results (the gpupreagg.c
aggfunc_catalog rewrite into NROWS/PSUM/PSUM_X2 partials with host
finalization).  This slice of the PyTorch port carries the catalog, the
aggregate instances and the host extraction / merge; on the device it
builds only the v2 raw-plane kernel (ops/preagg_fused2.py).  The XLA
strategies are ROADMAP queue 1, "Pre-aggregation XLA strategies".
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..sqltypes import T
from .. import pgnumeric as pgn
from ..expr.ir import Expr
from ..expr.lower_torch import ColMeta

# ---------------------------------------------------------------------------
# aggregate definitions: (aggname, family) -> slots + finalizer + rettype
# family: 'i2','i4','i8','f4','f8','num','any'(count), pair aggs use 'f8f8'
# ---------------------------------------------------------------------------

_FAMILY = {T.INT2: "i2", T.INT4: "i4", T.INT8: "i8",
           T.FLOAT4: "f4", T.FLOAT8: "f8", T.NUMERIC: "num"}


@dataclasses.dataclass(frozen=True)
class AggDef:
    slots: tuple[str, ...]
    final: Callable[..., Any]          # final(merged: dict) -> python value
    rettype: T
    nargs: int = 1


def _final_count(m):
    return m["count"]


def _final_nrows(m):
    return m["nrows"]


def _final_sum_small_int(m):
    # sum(int2/int4) -> bigint
    if m["count"] == 0:
        return None
    from ..pgops import check_int_range
    return check_int_range(T.INT8, m["sum_i"])


def _final_sum_int8(m):
    # sum(int8) -> numeric
    if m["count"] == 0:
        return None
    return Decimal(m["sum_i"])


def _final_sum_f4(m):
    if m["count"] == 0:
        return None
    return float(np.float32(m["sum_f"]))


def _final_sum_f8(m):
    if m["count"] == 0:
        return None
    return float(m["sum_f"])


def _final_sum_num(m):
    if m["count"] == 0:
        return None
    return pgn.round_to_scale(m["sum_num"], m["maxdscale"])


def _final_avg_int(m):
    if m["count"] == 0:
        return None
    return pgn.int_avg(m["sum_i"], m["count"])


def _final_avg_f(m):
    if m["count"] == 0:
        return None
    return float(m["sum_f"]) / float(m["count"])


def _final_avg_num(m):
    if m["count"] == 0:
        return None
    return pgn.num_div(pgn.round_to_scale(m["sum_num"], m["maxdscale"]),
                       Decimal(m["count"]))


def _final_max(m):
    return m["max"]


def _final_min(m):
    return m["min"]


def _stddev_int_like(variance: bool, sample: bool):
    def f(m):
        return pgn.numeric_stddev_internal(
            m["count"], Decimal(m["sum_i"]), Decimal(m["sumsq_i"]),
            variance, sample)
    return f


def _stddev_num(variance: bool, sample: bool):
    def f(m):
        if m["count"] == 0 or (sample and m["count"] == 1):
            return None
        return pgn.numeric_stddev_internal(
            m["count"], pgn.round_to_scale(m["sum_num"], m["maxdscale"]),
            m["sumsq_num"], variance, sample)
    return f


def _stddev_float(variance: bool, sample: bool):
    def f(m):
        n = m["count"]
        if n == 0 or (sample and n <= 1):
            return None
        sx, sx2 = float(m["sum_f"]), float(m["sumsq_f"])
        numerator = n * sx2 - sx * sx
        if numerator <= 0.0:
            return 0.0
        denom = n * (n - 1) if sample else n * n
        v = numerator / denom
        return v if variance else float(np.sqrt(v))
    return f


def _final_corr(m):
    n = m["count"]
    if n < 1:
        return None
    sx, sy = float(m["sum_x"]), float(m["sum_y"])
    sxx = n * float(m["sumsq_x"]) - sx * sx
    syy = n * float(m["sumsq_y"]) - sy * sy
    sxy = n * float(m["sum_xy"]) - sx * sy
    if sxx <= 0.0 or syy <= 0.0:
        return None
    return sxy / float(np.sqrt(sxx * syy))


def _final_covar(sample: bool):
    def f(m):
        n = m["count"]
        if n < (2 if sample else 1):
            return None
        sxy = n * float(m["sum_xy"]) - float(m["sum_x"]) * float(m["sum_y"])
        return sxy / (n * (n - 1) if sample else n * n)
    return f


AGG_CATALOG: dict[tuple[str, str], AggDef] = {}


def _adef(name: str, fam: str, slots: tuple[str, ...], final, ret: T, nargs=1):
    AGG_CATALOG[(name, fam)] = AggDef(slots, final, ret, nargs)


for fam in ("i2", "i4", "i8", "f4", "f8", "num", "any"):
    _adef("count", fam, ("count",), _final_count, T.INT8)
_adef("count", "star", ("nrows",), _final_nrows, T.INT8, nargs=0)

for fam in ("i2", "i4"):
    _adef("sum", fam, ("count", "sum_i"), _final_sum_small_int, T.INT8)
    _adef("avg", fam, ("count", "sum_i"), _final_avg_int, T.NUMERIC)
_adef("sum", "i8", ("count", "sum_i"), _final_sum_int8, T.NUMERIC)
_adef("avg", "i8", ("count", "sum_i"), _final_avg_int, T.NUMERIC)
_adef("sum", "f4", ("count", "sum_f"), _final_sum_f4, T.FLOAT4)
_adef("sum", "f8", ("count", "sum_f"), _final_sum_f8, T.FLOAT8)
_adef("avg", "f4", ("count", "sum_f"), _final_avg_f, T.FLOAT8)
_adef("avg", "f8", ("count", "sum_f"), _final_avg_f, T.FLOAT8)
_adef("sum", "num", ("count", "sum_num", "maxdscale"), _final_sum_num, T.NUMERIC)
_adef("avg", "num", ("count", "sum_num", "maxdscale"), _final_avg_num, T.NUMERIC)

_MINMAX_RET = {"i2": T.INT2, "i4": T.INT4, "i8": T.INT8,
               "f4": T.FLOAT4, "f8": T.FLOAT8, "num": T.NUMERIC}
for fam, ret in _MINMAX_RET.items():
    _adef("max", fam, ("max",), _final_max, ret)
    _adef("min", fam, ("min",), _final_min, ret)
# text/date/time/timestamp/bool min-max share the sentinel path
for fam, ret in (("text", T.TEXT), ("date", T.DATE), ("time", T.TIME),
                 ("timestamp", T.TIMESTAMP), ("bool", T.BOOL)):
    _FAMILY.setdefault({"text": T.TEXT, "date": T.DATE, "time": T.TIME,
                        "timestamp": T.TIMESTAMP, "bool": T.BOOL}[fam], fam)
    _adef("max", fam, ("max",), _final_max, ret)
    _adef("min", fam, ("min",), _final_min, ret)

for sname, variance, sample in (("stddev", False, True),
                                ("stddev_samp", False, True),
                                ("stddev_pop", False, False),
                                ("variance", True, True),
                                ("var_samp", True, True),
                                ("var_pop", True, False)):
    for fam in ("i2", "i4", "i8"):
        _adef(sname, fam, ("count", "sum_i", "sumsq_i"),
              _stddev_int_like(variance, sample), T.NUMERIC)
    for fam in ("f4", "f8"):
        _adef(sname, fam, ("count", "sum_f", "sumsq_f"),
              _stddev_float(variance, sample), T.FLOAT8)
    _adef(sname, "num", ("count", "sum_num", "maxdscale", "sumsq_num"),
          _stddev_num(variance, sample), T.NUMERIC)

_PAIR_SLOTS = ("count", "sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y")
_adef("corr", "f8f8", _PAIR_SLOTS, _final_corr, T.FLOAT8, nargs=2)
_adef("covar_pop", "f8f8", _PAIR_SLOTS, _final_covar(False), T.FLOAT8, nargs=2)
_adef("covar_samp", "f8f8", _PAIR_SLOTS, _final_covar(True), T.FLOAT8, nargs=2)


def agg_family(t: T) -> str:
    return _FAMILY.get(t, "any")


def lookup_agg(aggname: str, argtypes: Sequence[T], star: bool = False) -> tuple[AggDef, str]:
    """Resolve an Aggref to its AggDef (+ canonical family key).

    corr/covar cast args to float8 (like PG); count accepts anything."""
    if aggname == "count":
        fam = "star" if star else agg_family(argtypes[0]) if argtypes else "star"
        if star or not argtypes:
            return AGG_CATALOG[("count", "star")], "star"
        use = fam if ("count", fam) in AGG_CATALOG else "any"
        return AGG_CATALOG[("count", use)], use
    if aggname in ("corr", "covar_pop", "covar_samp"):
        return AGG_CATALOG[(aggname, "f8f8")], "f8f8"
    fam = agg_family(argtypes[0])
    key = (aggname, fam)
    if key not in AGG_CATALOG:
        raise TypeError(f"function {aggname}({argtypes[0].value}) does not exist")
    return AGG_CATALOG[key], fam




@dataclasses.dataclass(frozen=True)
class AggInstance:
    """One aggregate in the target list, bound to lowered arg expressions."""
    aggname: str
    family: str
    slots: tuple[str, ...]
    args: tuple[Expr, ...]   # bound arg expressions (cast already applied)
    distinct: bool = False   # agg(DISTINCT x): runs on the host-exact tier


def build_preagg_fn(schema: Sequence[ColMeta], group_exprs: Sequence[Expr],
                    aggs: Sequence[AggInstance], pred: Optional[Expr],
                    G: int, strategy: str = "mxu_dense",
                    v2sig=None) -> Callable:
    """Build f(cols, nrows, salt, scal) -> chunk partials in the mxu output
    contract (mxu_sums / mxu_fsums / mxu_f4exps + dense_* fields).

    Only the v2 raw-plane kernel is ported (v2sig from
    preagg_fused2.derive_v2_plan); the reference's XLA strategies
    (scatter, sort, mxu, mxu_dense without a v2 plan) are not."""
    if v2sig is None:
        raise NotImplementedError(
            f"preagg strategy {strategy!r} without a v2 plan: not ported yet "
            "(ROADMAP queue 1: Pre-aggregation XLA strategies)")
    from .preagg_fused2 import build_fused2_fn
    return build_fused2_fn(schema, list(group_exprs), list(aggs), pred, G,
                           v2sig)


# ---------------------------------------------------------------------------
# host: partial extraction, merge, finalize
# ---------------------------------------------------------------------------

def extract_partials(inst: AggInstance, arrays: dict[str, np.ndarray],
                     g: int, skip: tuple = (),
                     text_dict: tuple | None = None) -> dict[str, Any]:
    """python partial dict for group g from device slot arrays.

    `skip` names slot kinds computed elsewhere (the MXU matmul path).
    `text_dict` is the arg column's sorted dictionary for min/max over
    TEXT/BPCHAR: the device aggregates int32 dict CODES (the dictionary is
    order-preserving, datastore.py:138, so code order == C-collation
    order), and the code decodes to its string HERE so device partials
    merge type-consistently with host-replay partials (which hold
    strings, hostexec.update_state)."""
    out: dict[str, Any] = {}
    for kind in inst.slots:
        if kind in skip:
            continue
        if kind == "nrows":
            out["nrows"] = int(arrays["nrows"][g])
        elif kind == "count":
            out["count"] = int(arrays["count"][g])
        elif kind == "sum_i":
            out["sum_i"] = int(arrays["sum_i"][g])
        elif kind == "sumsq_i":
            out["sumsq_i"] = (int(arrays["sumsq_i_hi"][g]) << 30) + \
                int(arrays["sumsq_i_lo"][g])
        elif kind in ("sum_f", "sumsq_f", "sum_x", "sum_y", "sum_xy",
                      "sumsq_x", "sumsq_y"):
            out[kind] = float(arrays[kind][g])
        elif kind == "maxdscale":
            out["maxdscale"] = int(arrays["maxdscale"][g])
        elif kind in ("sum_num", "sumsq_num"):
            out[kind] = Decimal(int(arrays[f"{kind}_mant"][g])).scaleb(
                int(arrays[f"{kind}_exp"][g]))
        elif kind in ("min", "max"):
            out[kind] = _extract_minmax(kind, inst, arrays, g, text_dict)
        else:
            raise ValueError(kind)
    return out


def unflip_f64_orderkey(k: int) -> float:
    """Invert _f64_orderkey: int64 key -> exact float64 value."""
    if k < 0:
        bits = (-1 - k) + (-(1 << 63))
    else:
        bits = k
    return float(np.int64(bits).view(np.float64))


def _extract_minmax(kind: str, inst: AggInstance, arrays, g: int,
                    text_dict: tuple | None = None):
    if f"{kind}_okey" in arrays:  # float8 via exact bit order keys
        if not bool(arrays[f"{kind}_has"][g]):
            return None
        return unflip_f64_orderkey(int(arrays[f"{kind}_okey"][g]))
    if f"{kind}_mant" in arrays:  # numeric
        if not bool(arrays[f"{kind}_has"][g]):
            return None
        from ..sqltypes import numeric_to_decimal
        return numeric_to_decimal(int(arrays[f"{kind}_mant"][g]),
                                  int(arrays[f"{kind}_exp"][g]),
                                  int(arrays[f"{kind}_dscale"][g]))
    if not bool(arrays[f"{kind}_has"][g]):
        return None
    v = arrays[kind][g]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if text_dict is not None:
        return text_dict[int(v)]
    return int(v)


def merge_partials(inst: AggInstance, a: dict[str, Any],
                   b: dict[str, Any]) -> dict[str, Any]:
    out = dict(a)
    for kind in inst.slots:
        if kind in ("nrows", "count", "sum_i", "sumsq_i"):
            out[kind] = a[kind] + b[kind]
        elif kind in ("sum_f", "sumsq_f", "sum_x", "sum_y", "sum_xy",
                      "sumsq_x", "sumsq_y"):
            out[kind] = a[kind] + b[kind]
        elif kind in ("sum_num", "sumsq_num"):
            out[kind] = a[kind] + b[kind]
        elif kind == "maxdscale":
            out[kind] = max(a[kind], b[kind])
        elif kind in ("min", "max"):
            out[kind] = _merge_minmax(kind, a[kind], b[kind])
    return out


def _merge_minmax(kind: str, x, y):
    from ..pgops import cmp_values
    if x is None:
        return y
    if y is None:
        return x
    c = cmp_values(y, x)
    # first-seen (x) wins ties, matching PG's {min,max}_larger transition
    if kind == "max":
        return y if c > 0 else x
    return y if c < 0 else x
