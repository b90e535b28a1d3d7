"""Grouped partial aggregation on the device + exact host finalization.

The reference (pg_strom_tpu/ops/preagg.py) computes chunk partials on the
device with XLA and finalizes them exactly on the host, reproducing
PostgreSQL's results (the gpupreagg.c aggfunc_catalog rewrite into
NROWS/PSUM/PSUM_X2 partials with host finalization).  The port keeps the
catalog, the strategies and the output contract and computes the partials
with torch on the planes' device: the expression lowering
(expr/lower_torch.py), the bucket hashes (ops/hashing.py), segmented
reductions (index_add_ / scatter_reduce_, with the identity fill of
jax.ops.segment_min/max), and the kernels K1 (v2 plans), K2 and K4 for the
column-sum strategies.

Exactness per slot kind, as in the reference: int64 sums with an f64
shadow (|shadow| > 2^62 => CPU_RECHECK); int squares as hi/lo limbs;
numeric sums aligned to the per-group minimum exponent (rescale overflow
=> CPU_RECHECK); float sums in f64 with inf => CPU_RECHECK; min/max with
sentinel-masked reductions (numeric via a two-pass lexicographic key and a
first-seen row gather).
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Callable, Optional, Sequence

import numpy as np

import torch

from ..sqltypes import T
from ..errors import ERR_CPU_RECHECK
from .. import pgnumeric as pgn
from ..expr.ir import Expr
from ..expr.lower_torch import (ColMeta, DVal, Lowerer, INT64_MIN,
                                INT64_MAX, _f64_orderkey, f64_bits)
from .hashing import (hash_column32, combine_hashes32, canonical_f64_bits,
                      _mix32, M32)
from .preagg_mxu import f64_out_of_domain
from ..utils.perfmon import span

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


# ---------------------------------------------------------------------------
# device side: segmented reductions over bucket ids
# ---------------------------------------------------------------------------

_BIG = 1 << 62
_SHADOW_LIMIT = float(1 << 62)


def _identity(dtype: torch.dtype, how: str):
    """The reduction identity jax.ops.segment_{min,max} fill an empty
    segment with."""
    if dtype.is_floating_point:
        return float("inf") if how == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if how == "min" else info.min


def _seg(vals: torch.Tensor, seg_id, G: int, how: str) -> torch.Tensor:
    """Per-bucket sum/min/max of a row lane; seg_id == G drops the row.
    seg_id None: one group in slot 0 (a direct reduction), the rest zero."""
    if seg_id is None:
        r = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[how](vals)
        return torch.cat([r.reshape(1), torch.zeros(G - 1, dtype=r.dtype,
                                                    device=r.device)])
    idx = seg_id.to(torch.int64).clamp(0, G)
    if how == "sum":
        out = torch.zeros(G + 1, dtype=vals.dtype, device=vals.device)
        out.index_add_(0, idx, vals)
    else:
        out = torch.full((G + 1,), _identity(vals.dtype, how),
                         dtype=vals.dtype, device=vals.device)
        out.scatter_reduce_(0, idx, vals, "amin" if how == "min" else "amax",
                            include_self=True)
    return out[:G]


def _gref(garr: torch.Tensor, seg_id) -> torch.Tensor:
    """Broadcast per-group array back to rows (group 0 when ungrouped); a
    dropped row (seg_id == G) reads the last group, as XLA's clamped
    gather does."""
    if seg_id is None:
        return garr[0]
    return garr[seg_id.to(torch.int64).clamp(0, garr.shape[0] - 1)]


_DENSE_KEY_TYPES = (T.BOOL, T.INT2, T.INT4, T.DATE, T.TEXT, T.BPCHAR,
                    T.INT8, T.TIME, T.TIMESTAMP)


def _bucket_ids(keys, mask: torch.Tensor, salt: int, G: int) -> torch.Tensor:
    """Per-row bucket id in [0, G); rows outside `mask` get G (dropped).

    A single narrow int-lane key whose chunk value range fits the bucket
    count uses DENSE range bucketing (bucket = key - min(key); NULL keys at
    range+1) — collision-free by construction.  Everything else uses
    salted-hash buckets with host-verified key constancy."""
    hs = [hash_column32(k.t, k.data, k.valid,
                        k.exp if k.t is T.NUMERIC else None)
          for k in keys]
    h = _mix32(combine_hashes32(hs) ^ (int(salt) & M32))
    bucket = (h & (G - 1)).to(torch.int32)
    if len(keys) == 1 and keys[0].t in _DENSE_KEY_TYPES:
        k = keys[0]
        okk = mask & k.valid
        kd = k.data.to(torch.int64)
        # int64 extremes: an int8 key >= 2^62 must not lose to the sentinel
        kmin = torch.where(okk, kd, torch.full_like(kd, INT64_MAX)).min()
        kmax = torch.where(okk, kd, torch.full_like(kd, INT64_MIN)).max()
        # int64 wrap on a huge range flips rng negative -> dense_ok False
        rng = kmax - kmin
        # <= G-2 leaves bucket rng+1 free for the NULL-key group
        dense_ok = (rng >= 0) & (rng <= G - 2)
        dense = torch.where(k.valid, (kd - kmin).to(torch.int32),
                            (rng + 1).to(torch.int32))
        bucket = torch.where(dense_ok, dense, bucket)
    return torch.where(mask, bucket, torch.full_like(bucket, G))


def _ndigits(m_abs: torch.Tensor) -> torch.Tensor:
    """decimal digit count of |mant| lanes (0 -> 0)."""
    nd = torch.zeros_like(m_abs, dtype=torch.int32)
    for k in range(19):
        nd = nd + (m_abs >= 10 ** k).to(torch.int32)
    return nd


_P10 = np.array([10 ** k for k in range(19)], dtype=np.int64)
_POW10_LIMIT_NP = np.array([((1 << 63) - 1) // (10 ** k) for k in range(19)],
                           dtype=np.int64)


def _tab(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, device=like.device)


def _num_sort_keys(mant: torch.Tensor, exp: torch.Tensor):
    """(primary, secondary) int64 keys ordering numeric values exactly.

    primary  = sign * (decimal_magnitude + 64)   (0 for zero)
    secondary= sign * mantissa_normalized_to_18_digits"""
    m_abs = mant.abs()
    sign = torch.sign(mant)
    nd = _ndigits(m_abs)
    E = nd + exp.to(torch.int32)
    zero = torch.zeros_like(mant)
    p = torch.where(mant == 0, zero, sign * (E.to(torch.int64) + 64))
    shift = (18 - nd).clamp(0, 18).to(torch.int64)
    m18 = m_abs * _tab(_P10, mant)[shift]
    s = torch.where(mant == 0, zero, sign * m18)
    return p, s


def _recheck_if(lw: Lowerer, bad: torch.Tensor) -> None:
    lw.err = torch.maximum(lw.err, torch.where(
        bad.any(), torch.tensor(ERR_CPU_RECHECK, dtype=torch.uint8,
                                device=bad.device),
        torch.tensor(0, dtype=torch.uint8, device=bad.device)))


def _slot_compute(kind: str, inst_args: list[DVal], mask: torch.Tensor,
                  seg_id, G: int, lw: Lowerer,
                  row_idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """Compute one partial slot over segments (lanes in the strategy's row
    order)."""
    a = inst_args[0] if inst_args else None
    ok = mask if a is None else (mask & a.valid)
    if len(inst_args) == 2:
        ok = mask & inst_args[0].valid & inst_args[1].valid
    zero64 = torch.zeros((), dtype=torch.int64, device=mask.device)
    zerof = torch.zeros((), dtype=torch.float64, device=mask.device)

    if kind == "nrows":
        return {"nrows": _seg(mask.to(torch.int64), seg_id, G, "sum")}
    if kind == "count":
        return {"count": _seg(ok.to(torch.int64), seg_id, G, "sum")}

    if kind == "sum_i":
        x = torch.where(ok, a.data.to(torch.int64), zero64)
        s = _seg(x, seg_id, G, "sum")
        shadow = _seg(torch.where(ok, a.data.to(torch.float64), zerof),
                      seg_id, G, "sum")
        _recheck_if(lw, shadow.abs() > _SHADOW_LIMIT)
        return {"sum_i": s}

    if kind == "sumsq_i":
        x = torch.where(ok, a.data.to(torch.int64), zero64)
        if a.t is T.INT2:
            x2 = x * x  # <= 2^30/row: direct int64 sum is safe to 2^32 rows
            return {"sumsq_i_lo": _seg(x2, seg_id, G, "sum"),
                    "sumsq_i_hi": _seg(torch.zeros_like(x2), seg_id, G,
                                       "sum")}
        if a.t is T.INT8:
            # rows with |x| >= 2^31 square out of int64: defer to host
            _recheck_if(lw, ok & (x.abs() >= (1 << 31)))
        x2 = x * x  # < 2^62 given |x| < 2^31
        return {"sumsq_i_hi": _seg(x2 >> 30, seg_id, G, "sum"),
                "sumsq_i_lo": _seg(x2 & ((1 << 30) - 1), seg_id, G, "sum")}

    if kind in ("sum_f", "sumsq_f"):
        x = torch.where(ok, a.data.to(torch.float64), zerof)
        v = x * x if kind == "sumsq_f" else x
        out = _seg(v, seg_id, G, "sum")
        # any inf in the partial (or per-row square): the host replay
        # decides whether PostgreSQL raises or the value is representable
        bad = torch.isinf(out).any()
        if kind == "sum_f" and a.t is T.FLOAT4:
            # PG sums float4 stepwise in f32: a sequential prefix can
            # overflow even when the total is finite; if the absolute mass
            # could reach f32-inf territory, replay sequentially on host
            absmass = _seg(x.abs(), seg_id, G, "sum")
            bad = (bad | torch.isinf(v).any() | (absmass > 3.0e38).any()
                   | torch.isinf(absmass).any())
        else:
            # the double-float lanes' domain (inf included): the chunk
            # replays whichever strategy runs it
            bad = bad | f64_out_of_domain(v).any()
        _recheck_if(lw, bad)
        return {kind: out}

    if kind in ("sum_x", "sum_y", "sum_xy", "sumsq_x", "sumsq_y"):
        x = torch.where(ok, inst_args[0].data.to(torch.float64), zerof)
        y = torch.where(ok, inst_args[1].data.to(torch.float64), zerof)
        v = {"sum_x": x, "sum_y": y, "sum_xy": x * y,
             "sumsq_x": x * x, "sumsq_y": y * y}[kind]
        out = _seg(v, seg_id, G, "sum")
        _recheck_if(lw, torch.isinf(out).any() | f64_out_of_domain(v).any())
        return {kind: out}

    if kind in ("sum_num", "maxdscale", "sumsq_num"):
        return _slot_num_sum(kind, a, ok, seg_id, G, lw)

    if kind in ("min", "max"):
        return _slot_minmax(kind, a, ok, seg_id, G, lw, row_idx)

    raise ValueError(f"unknown slot kind {kind}")


def _slot_num_sum(kind: str, a: DVal, ok: torch.Tensor, seg_id,
                  G: int, lw: Lowerer) -> dict[str, torch.Tensor]:
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=ok.device)  # noqa
    mant = torch.where(ok, a.data, torch.zeros_like(a.data))
    exp = torch.where(ok, a.exp.to(torch.int32), i32(127))
    if kind == "maxdscale":
        return {"maxdscale": _seg(torch.where(ok, a.dscale_lane, i32(0)),
                                  seg_id, G, "max")}
    if kind == "sumsq_num":
        _recheck_if(lw, ok & (mant.abs() > 3_000_000_000))
        mant = mant * mant
        exp = torch.where(ok, (a.exp * 2).to(torch.int32), i32(127))
    # per-group min exponent, then align mantissas to it
    gexp = _seg(exp, seg_id, G, "min")           # invalid rows carry +127
    gexp = torch.where(gexp == 127, i32(0), gexp)
    delta = (exp - _gref(gexp, seg_id)).clamp(0, 127)
    d18 = delta.clamp(0, 18).to(torch.int64)
    p = _tab(_P10, mant)[d18]
    lim = _tab(_POW10_LIMIT_NP, mant)[d18]
    ovf = ok & ((delta > 18) | (mant.abs() > lim))
    _recheck_if(lw, ovf)
    aligned = torch.where(ok, mant * torch.where(ovf, torch.ones_like(p), p),
                          torch.zeros_like(mant))
    s = _seg(aligned, seg_id, G, "sum")
    shadow = _seg(torch.where(ok, mant.to(torch.float64),
                              torch.zeros((), dtype=torch.float64,
                                          device=ok.device))
                  * _tab(_P10, mant).to(torch.float64)[d18],
                  seg_id, G, "sum")
    _recheck_if(lw, shadow.abs() > _SHADOW_LIMIT)
    pre = "sumsq_num" if kind == "sumsq_num" else "sum_num"
    return {f"{pre}_mant": s, f"{pre}_exp": gexp}


def _slot_minmax(kind: str, a: DVal, ok: torch.Tensor, seg_id,
                 G: int, lw: Lowerer,
                 row_idx: torch.Tensor) -> dict[str, torch.Tensor]:
    how = "min" if kind == "min" else "max"

    def has() -> torch.Tensor:
        return _seg(ok.to(torch.int32), seg_id, G, "max") > 0

    if a.t is T.NUMERIC:
        n = a.data.shape[0]
        p, s = _num_sort_keys(a.data, a.exp)
        sent = torch.full_like(p, _BIG if kind == "min" else -_BIG)
        big = torch.full_like(p, _BIG)
        gp = _seg(torch.where(ok, p, sent), seg_id, G, how)
        on_p = ok & (p == _gref(gp, seg_id))
        gs = _seg(torch.where(on_p, s, sent), seg_id, G, how)
        on_s = on_p & (s == _gref(gs, seg_id))
        # winners all share (mant,exp); only dscale can differ — PG keeps
        # the FIRST-seen value, so pick the winner with the smallest
        # original row index, then map it to its position in these lanes
        ridx = row_idx.to(torch.int64)
        gmin_orig = _seg(torch.where(on_s, ridx, big), seg_id, G, "min")
        pos = torch.arange(n, dtype=torch.int64, device=ok.device)
        sel = on_s & (ridx == _gref(gmin_orig, seg_id))
        gpos = _seg(torch.where(sel, pos, big), seg_id, G, "min")
        gi_c = gpos.clamp(0, max(n - 1, 0))
        hv = gmin_orig < _BIG
        return {f"{kind}_mant": torch.where(hv, a.data[gi_c],
                                            torch.zeros_like(gpos)),
                f"{kind}_exp": torch.where(hv, a.exp[gi_c],
                                           torch.zeros_like(a.exp[gi_c])),
                f"{kind}_dscale": torch.where(
                    hv, a.dscale_lane[gi_c],
                    torch.zeros_like(a.dscale_lane[gi_c])),
                f"{kind}_has": hv}
    if a.t is T.FLOAT8:
        key = _f64_orderkey(f64_bits(a.data))
        # the sentinel must beat EVERY real order key (int64 extremes are
        # unreachable; the has-lane guards empty groups)
        sent = torch.full_like(key, INT64_MAX if kind == "min" else INT64_MIN)
        g = _seg(torch.where(ok, key, sent), seg_id, G, how)
        return {f"{kind}_okey": g, f"{kind}_has": has()}
    if a.t is T.FLOAT4:
        sent = torch.full_like(a.data, float("inf") if kind == "min"
                               else float("-inf"))
        g = _seg(torch.where(ok, a.data, sent), seg_id, G, how)
        return {kind: g, f"{kind}_has": has()}
    if a.data.dtype == torch.bool:
        x = torch.where(ok, a.data, torch.full_like(a.data, kind == "min"))
        g = _seg(x.to(torch.int32), seg_id, G, how).to(torch.bool)
    else:
        info = torch.iinfo(a.data.dtype)
        sent = torch.full_like(a.data, info.max if kind == "min" else info.min)
        g = _seg(torch.where(ok, a.data, sent), seg_id, G, how)
    return {kind: g, f"{kind}_has": has()}


def build_preagg_fn(schema: Sequence[ColMeta], group_exprs: Sequence[Expr],
                    aggs: Sequence[AggInstance], pred: Optional[Expr],
                    G: int, strategy: str = "scatter",
                    v2sig=None) -> Callable:
    """Build f(cols, nrows, salt) -> chunk partials (a dict of tensors on
    the planes' device).

    v2sig (a preagg_fused2.V2Sig from derive_v2_plan): the raw-plane kernel
    K1 replaces the whole lowering+encode+reduce pipeline; the returned f
    takes a 4th `scal` argument and emits the same mxu output contract.

    Grouping strategies (the reference's, same outputs):
      mxu / mxu_dense — every additive partial as per-bucket column sums
                (K2 when the plan fits its envelope, else build_mxu_columns
                + mxu_reduce); keys recovered and collisions detected on the
                host (preagg_mxu).  mxu_dense: one int-lane key, bucket =
                key - min, `dense_fail` when the range exceeds G-2.
                Non-additive slots (min/max, numeric, f64 on the CPU) run
                segmented reductions over the same buckets.
      scatter — salted-hash buckets, segment reductions in row order; a
                bucket holding two distinct keys raises `collision`.
      sort    — stable hash sort, segments by exact key comparison; exact
                for any group count up to G (more raises CPU_RECHECK).
      (no GROUP BY) — direct reductions into slot 0.

    Output dict:
      err      : uint8 scalar (max over rows; nonzero => host replays chunk)
      collision: bool scalar (scatter)
      ngroups  : int32
      gmask    : bool[G] — which group slots are populated
      keys     : tuple per group expr of plane tuple
                 (data, valid) or (mant, valid, exp, dscale) for numeric
      slots    : tuple per agg of dict name->array[G]
    """
    group_exprs = list(group_exprs)
    aggs = list(aggs)

    if v2sig is not None:
        from .preagg_fused2 import build_fused2_fn
        return build_fused2_fn(schema, group_exprs, aggs, pred, G, v2sig)

    def f(cols: tuple, nrows, salt=0):
        with span("lower"):
            n = cols[0][0].shape[0] if cols else 0
            dev = cols[0][0].device if cols else torch.device("cpu")
            live = torch.arange(n, dtype=torch.int32, device=dev) < int(nrows)
            lw = Lowerer(schema, cols, live)

            mask = live
            if pred is not None:
                pv = lw.lower(pred, live)
                mask = live & pv.valid & pv.data.to(torch.bool)

            keys = [lw.lower(g, mask) for g in group_exprs]

            # numeric DVals need a display-scale lane; plain column refs
            # carry it from the store, computed numeric expressions default
            # to 0
            def _attach_dscale(v: DVal):
                if v.t is T.NUMERIC and v.dscale_lane is None:
                    v.dscale_lane = torch.zeros(n, dtype=torch.int32,
                                                device=dev)
                return v

            for k in keys:
                _attach_dscale(k)
            arg_vals: list[list[DVal]] = []
            for inst in aggs:
                arg_vals.append([_attach_dscale(lw.lower(aexp, mask))
                                 for aexp in inst.args])
        with span("reduce"):
            return reduce_chunk(n, dev, lw, mask, keys, arg_vals, salt)

    def reduce_chunk(n, dev, lw, mask, keys, arg_vals, salt):
        def err_out():
            return lw.err.max() if n else torch.tensor(0, dtype=torch.uint8)

        collision = torch.tensor(False, device=dev)
        if group_exprs and strategy in ("mxu", "mxu_dense"):
            from .preagg_mxu import (build_mxu_columns, mxu_reduce,
                                     mxu_recipes, mxu_shadow_cols,
                                     _kind_mxu_ok)
            dense_key = strategy == "mxu_dense"
            if dense_key:
                k = keys[0]
                okk = mask & k.valid
                kd = k.data.to(torch.int64)
                any_ok = okk.any()
                zero = torch.zeros((), dtype=torch.int64, device=dev)
                kmin = torch.where(any_ok, torch.where(
                    okk, kd, torch.full_like(kd, INT64_MAX)).min(), zero)
                kmax = torch.where(any_ok, torch.where(
                    okk, kd, torch.full_like(kd, INT64_MIN)).max(), zero)
                rng = kmax - kmin          # int64 wrap => negative => fail
                dense_fail = ~((rng >= 0) & (rng <= G - 2))
                seg = torch.where(okk, (kd - kmin).clamp(0, G - 1),
                                  (rng + 1).clamp(0, G - 1)).to(torch.int32)
                seg_id = torch.where(mask, seg, torch.full_like(seg, G))
            else:
                seg_id = _bucket_ids(keys, mask, salt, G)
            key_ts = [g.type for g in group_exprs]
            arg_ts = [tuple(a.type for a in inst.args) for inst in aggs]
            fused = None
            from ..config import config as _cfg
            if _cfg.use_fused_preagg and G <= 2048:
                # K2: the value matrix is never materialized
                from .preagg_fused import fused_supported, fused_mxu_reduce
                if fused_supported(key_ts, aggs, arg_ts):
                    fused = fused_mxu_reduce(keys, aggs, arg_vals, mask,
                                             seg_id, G, n, key_ts, arg_ts,
                                             dense_key=dense_key)
            if fused is not None:
                sums, fsums, f4exps = fused
            else:
                V, f4exps = build_mxu_columns(keys, aggs, arg_vals, mask, n,
                                              dense_key=dense_key)
                _, slotr_static, _ = mxu_recipes(key_ts, aggs, arg_ts,
                                                 dense_key=dense_key)
                sums, fsums = mxu_reduce(
                    V, seg_id, G, n, fsum_cols=mxu_shadow_cols(slotr_static))
                del V
            row_idx = torch.arange(n, dtype=torch.int64, device=dev)
            slot_out = []
            for inst, vs in zip(aggs, arg_vals):
                d: dict[str, torch.Tensor] = {}
                a_t = vs[0].t if vs else None
                for kind in inst.slots:
                    if _kind_mxu_ok(kind, a_t):
                        continue
                    d.update(_slot_compute(kind, vs, mask, seg_id, G, lw,
                                           row_idx))
                slot_out.append(d)
            out = {"err": err_out(), "mxu_sums": sums, "mxu_fsums": fsums,
                   "mxu_f4exps": f4exps, "slots": tuple(slot_out)}
            if dense_key:
                out["dense_kmin"] = kmin
                out["dense_rng"] = rng.clamp(0, (1 << 31) - 1).to(torch.int32)
                out["dense_fail"] = dense_fail
            return out
        if group_exprs and strategy == "scatter":
            seg_id = _bucket_ids(keys, mask, salt, G)
            # lanes stay in row order: no sort, no gathers
            mask_s = mask
            args_s = arg_vals
            row_idx = torch.arange(n, dtype=torch.int64, device=dev)
            nonempty = _seg(mask.to(torch.int32), seg_id, G, "max") > 0
            ngroups = nonempty.to(torch.int32).sum().to(torch.int32)
            # exactness: every key plane must be constant within its bucket
            for k in keys:
                collision = collision | _bucket_mixed(k, mask, seg_id, G,
                                                      nonempty)
            # representative = first row per bucket (PG shows first-seen)
            frow = _seg(torch.where(mask, row_idx, torch.full_like(
                row_idx, _BIG)), seg_id, G, "min").clamp(0, max(n - 1, 0))
            key_out = []
            for k in keys:
                kd = k.data[frow]
                planes = [torch.where(nonempty, kd, torch.zeros_like(kd)),
                          k.valid[frow] & nonempty]
                if k.t is T.NUMERIC:
                    planes.append(k.exp[frow])
                    planes.append(k.dscale_lane[frow])
                key_out.append(tuple(planes))
            gmask = nonempty
        elif group_exprs:
            hs = [hash_column32(k.t, k.data, k.valid,
                                k.exp if k.t is T.NUMERIC else None)
                  for k in keys]
            h = (combine_hashes32(hs) >> 2).to(torch.int32)
            hkey = torch.where(mask, h, torch.full_like(h, 1 << 30))
            from .sort import argsort_i32
            order = argsort_i32(hkey)
            mask_s = mask[order]
            keys_s = [_gather_dval(k, order) for k in keys]
            args_s = [[_gather_dval(v, order) for v in vs] for vs in arg_vals]
            same = mask_s & torch.cat(
                [torch.zeros(1, dtype=torch.bool, device=dev),
                 _rows_equal(keys_s, slice(1, None), slice(0, -1))])
            new_seg = mask_s & ~same
            seg_id = (torch.cumsum(new_seg.to(torch.int32), 0) - 1).clamp(
                0, G - 1).to(torch.int32)
            ngroups = new_seg.to(torch.int32).sum().to(torch.int32)
            _recheck_if(lw, ngroups > G)
            row_idx = order
            # representative (first) row per group for key output
            pos = torch.where(new_seg, torch.arange(n, dtype=torch.int64,
                                                    device=dev),
                              torch.full((n,), _BIG, dtype=torch.int64,
                                         device=dev))
            first_pos = _seg(pos, seg_id, G, "min").clamp(0, max(n - 1, 0))
            key_out = []
            gvalid = torch.arange(G, dtype=torch.int32, device=dev) < ngroups
            for k in keys_s:
                planes = [k.data[first_pos], k.valid[first_pos] & gvalid]
                if k.t is T.NUMERIC:
                    planes.append(k.exp[first_pos])
                    planes.append(k.dscale_lane[first_pos])
                key_out.append(tuple(planes))
            gmask = gvalid
        else:
            mask_s = mask
            args_s = arg_vals
            # seg_id None => _seg uses direct reductions into slot 0
            seg_id = None
            ngroups = torch.tensor(1, dtype=torch.int32, device=dev)
            row_idx = torch.arange(n, dtype=torch.int64, device=dev)
            key_out = []
            gmask = torch.arange(G, device=dev) == 0

        slot_out = []
        for inst, vs in zip(aggs, args_s):
            d: dict[str, torch.Tensor] = {}
            for kind in inst.slots:
                d.update(_slot_compute(kind, vs, mask_s, seg_id, G, lw,
                                       row_idx))
            slot_out.append(d)

        return {"err": err_out(),
                "collision": collision,
                "ngroups": ngroups,
                "gmask": gmask,
                "keys": tuple(key_out),
                "slots": tuple(slot_out)}

    return f


def _bucket_mixed(k: DVal, mask: torch.Tensor, seg_id: torch.Tensor,
                  G: int, nonempty: torch.Tensor) -> torch.Tensor:
    """True if any bucket holds two SQL-distinct values of key column k.
    (Rows with NULL keys group together; a NULL/value mix in one bucket
    shows up via the validity lane.)"""
    lanes = []
    if k.t is T.FLOAT8:
        lanes.append(canonical_f64_bits(f64_bits(k.data)))
    elif k.t is T.FLOAT4:
        d = k.data.to(torch.float32)
        d = torch.where(d == 0, torch.zeros_like(d), d)          # -0 == +0
        d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        lanes.append(d.view(torch.int32).to(torch.int64))
    else:
        lanes.append(k.data.to(torch.int64))
        if k.t is T.NUMERIC:
            lanes.append(k.exp.to(torch.int64))
    # NULL rows carry zeroed data lanes; the validity lane distinguishes them
    lanes.append(k.valid.to(torch.int64))
    mixed = torch.tensor(False, device=mask.device)
    for lane in lanes:
        lane = lane.expand(mask.shape[0])
        lo = _seg(lane, seg_id, G, "min")   # dead rows (seg G) are dropped
        hi = _seg(lane, seg_id, G, "max")
        mixed = mixed | (nonempty & (lo != hi)).any()
    return mixed


def _gather_dval(v: DVal, order: torch.Tensor) -> DVal:
    return DVal(v.t, v.data[order], v.valid[order],
                v.exp[order] if v.exp is not None else None,
                dscale_lane=(v.dscale_lane[order]
                             if v.dscale_lane is not None else None))


def _rows_equal(keys_s: list[DVal], i, j) -> torch.Tensor:
    """lane-wise: row[i] keys equal row[j] keys (NULLs equal for grouping)."""
    eq = None
    for k in keys_s:
        va, vb = k.valid[i], k.valid[j]
        da, db = k.data[i], k.data[j]
        if k.t is T.FLOAT8:
            bits = canonical_f64_bits(f64_bits(k.data))
            same_val = bits[i] == bits[j]
        elif k.t is T.FLOAT4:
            da = torch.where(da == 0, torch.zeros_like(da), da)
            db = torch.where(db == 0, torch.zeros_like(db), db)
            same_val = (da == db) | (torch.isnan(da) & torch.isnan(db))
        else:
            same_val = da == db
        if k.t is T.NUMERIC:
            same_val = same_val & (k.exp[i] == k.exp[j])
        e = (va & vb & same_val) | (~va & ~vb)
        eq = e if eq is None else (eq & e)
    return eq


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
