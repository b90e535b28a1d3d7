"""The port's ORDER BY sorts (pg_strom_tpu_torch/ops/sort.py) against the
reference's (pg_strom_tpu/ops/sort.py); mirrors tests/test_sort.py.

The same seeded columns go through both packages: the reference's
functions under jax.jit on the CPU, the port's on CPU tensors.  The
permutations of `build_sort_fn` (tiers 0, 1 and 2) and the outputs of
`build_sort_topk_fn` (packed, threshold, adaptive and exact routes: top
rows, the key lanes at them, nqual, err and ovf) must be equal element for
element, `fits` and `ovf` included, and equal to a PostgreSQL-semantics
sort in python.  At the SQL boundary, ORDER BY ... LIMIT runs through
both planners over several chunks and the rows must be equal as
PostgreSQL text at extra_float_digits=-3."""

from __future__ import annotations

import contextlib
import functools
from decimal import Decimal

import jax
import numpy as np
import pytest
import torch

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.expr.ir import ColumnRef as RColumnRef
from pg_strom_tpu.expr.lower_jax import (
    schema_from_chunk_columns as r_schema, planes_of_column as r_planes)
from pg_strom_tpu.ops import sort as rsort
from pg_strom_tpu.pgops import cmp_values
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.expr.ir import ColumnRef as PColumnRef
from pg_strom_tpu_torch.expr.lower_torch import (
    schema_from_chunk_columns as p_schema, planes_of_column as p_planes)
from pg_strom_tpu_torch.ops import sort as psort
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.utils.perfmon import Perfmon, active


# ---------------------------------------------------------------------------
# the same columns in both packages
# ---------------------------------------------------------------------------

class Cols:
    """Columns built in the reference and carried into the port, with the
    plane tuples each package's functions take (padded to `cap` rows)."""

    def __init__(self, defs, cap=None):
        self.rt = R.Table.from_columns("s", {
            nm: R.column_from_values(getattr(R.T, t), vals)
            for nm, t, vals in defs})
        self.pt = from_reference(self.rt)
        self.names = [nm for nm, _, _ in defs]
        self.n = len(defs[0][2])
        self.cap = cap or self.n
        rcols = [self.rt.columns[nm] for nm in self.names]
        pcols = [self.pt.columns[nm] for nm in self.names]
        self.rschema = r_schema(self.names, rcols)
        self.pschema = p_schema(self.names, pcols)
        self.rplanes = tuple(tuple(self._pad(p) for p in r_planes(c))
                             for c in rcols)
        self.pplanes = tuple(tuple(torch.from_numpy(self._pad(p))
                                   for p in p_planes(c)) for c in pcols)
        self.values = {nm: [self.rt.columns[nm].get(i) for i in range(self.n)]
                       for nm in self.names}

    def _pad(self, p):
        p = np.asarray(p)
        if self.cap == len(p):
            return np.ascontiguousarray(p)
        out = np.zeros((self.cap,) + p.shape[1:], p.dtype)
        out[:len(p)] = p
        return out

    def specs(self, defs):
        """[(name, desc, nulls_first)] -> (reference specs, port specs)."""
        rs, ps = [], []
        for nm, desc, nf in defs:
            i = self.names.index(nm)
            rt = self.rt.columns[nm].type
            rs.append(rsort.SortSpec(RColumnRef(type=rt, name=nm, index=i),
                                     desc, nf))
            ps.append(psort.SortSpec(PColumnRef(
                type=getattr(P.T, rt.name), name=nm, index=i), desc, nf))
        return rs, ps


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _pg_order(cols, defs, rows=None):
    """Row ids in PostgreSQL order (ties by row id: the stable answer)."""
    def cmp(a, b):
        for nm, desc, nf in defs:
            va, vb = cols.values[nm][a], cols.values[nm][b]
            first = desc if nf is None else nf
            if va is None and vb is None:
                continue
            if va is None:
                return -1 if first else 1
            if vb is None:
                return 1 if first else -1
            c = cmp_values(va, vb)
            if c:
                return -c if desc else c
        return 0
    ids = range(cols.n) if rows is None else rows
    return sorted(ids, key=functools.cmp_to_key(cmp))


def sort_both(cols, defs, adaptive=True):
    """(reference (perm, err, fits), port (perm, err, fits)) as numpy."""
    rs, ps = cols.specs(defs)
    r = jax.jit(rsort.build_sort_fn(cols.rschema, rs, adaptive))(
        cols.rplanes, np.int32(cols.n))
    p = psort.build_sort_fn(cols.pschema, ps, adaptive)(cols.pplanes,
                                                        cols.n)
    return tuple(_np(a) for a in r), tuple(_np(a) for a in p)


def check_sort(cols, defs, tiers=(0, 1, 2)):
    """Every tier's permutation and fits equal the reference's; each tier
    that fits orders the live rows as PostgreSQL does."""
    want = _pg_order(cols, defs)
    for tier in tiers:
        r, p = sort_both(cols, defs, tier)
        assert p[0].dtype == np.int32
        assert np.array_equal(p[0], r[0]), (tier, p[0][:12], r[0][:12])
        assert int(p[1]) == int(r[1]) == 0
        assert bool(p[2]) == bool(r[2]), tier
        if bool(p[2]):
            assert list(p[0][:cols.n]) == want, tier


def topk_both(cols, defs, k, exact=False, pred=None):
    rs, ps = cols.specs(defs)
    rpred = ppred = None
    if pred is not None:
        rpred, ppred = pred
    r = jax.jit(rsort.build_sort_topk_fn(cols.rschema, rs, rpred, k,
                                         exact=exact))(
        cols.rplanes, np.int32(cols.n))
    pm = Perfmon()
    with active(pm):
        p = psort.build_sort_topk_fn(cols.pschema, ps, ppred, k,
                                     exact=exact)(cols.pplanes, cols.n)
    return r, p, dict(pm.counts)


def check_topk(cols, defs, k, route, exact=False, ovf=False):
    """top, key lanes, nqual, err and ovf equal the reference's; the port
    took `route`; without ovf the top rows are PostgreSQL's first k."""
    r, p, counts = topk_both(cols, defs, k, exact)
    assert counts == {f"topk_{route}": 1}, counts
    rtop, rlanes, rnq, rerr, rovf = r
    ptop, planes, pnq, perr, povf = p
    assert ptop.dtype == torch.int32
    assert np.array_equal(_np(ptop), _np(rtop))
    assert len(planes) == len(rlanes)
    for a, b in zip(planes, rlanes):
        assert np.array_equal(_np(a), _np(b).astype(np.int64))
    assert int(pnq) == int(rnq) == cols.n
    assert int(perr) == int(rerr) == 0
    assert bool(povf) == bool(rovf) == ovf
    if not ovf:
        assert list(_np(ptop)) == _pg_order(cols, defs)[:min(k, cols.n)]


def _ints(rng, n, lo, hi, null=0.0):
    return [int(v) if rng.random() >= null else None
            for v in rng.integers(lo, hi, n)]


# ---------------------------------------------------------------------------
# build_sort_fn: every type, every tier
# ---------------------------------------------------------------------------

SORT_CASES = {
    "int_asc_nulls_last": ([("a", "INT4", [5, None, 3, 3, -7, None, 0])],
                           [("a", False, None)]),
    "int_desc_nulls_first": ([("a", "INT4", [5, None, 3, 3, -7, None, 0])],
                             [("a", True, None)]),
    "float8_nan_and_zeros": (
        [("x", "FLOAT8", [1.5, -0.0, 0.0, float("nan"), -2.5, None,
                          float("inf"), float("-inf"), 1e-300])],
        [("x", False, None)]),
    "float8_desc_nulls_last": (
        [("x", "FLOAT8", [1.5, -0.0, 0.0, float("nan"), -2.5, None,
                          float("inf"), float("-inf"), None, 0.0])],
        [("x", True, False)]),
    "numeric": (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("-22"), None,
                           Decimal("0.0001"), Decimal("1.50"),
                           Decimal("1e10"), Decimal("-1e10"), Decimal("0")])],
        [("x", False, None)]),
    "text": ([("s", "TEXT", ["pear", "apple", None, "Apple", "apple2", ""])],
             [("s", False, None)]),
    "float4_desc": (
        [("x", "FLOAT4", [1.5, -0.0, 0.0, -2.5, None, 3.25, float("nan")])],
        [("x", True, None)]),
    "int2_bool_date": (
        [("a", "INT2", [3, -3, None, 32767, -32768, 0, 3]),
         ("b", "BOOL", [True, False, None, True, False, True, None]),
         ("d", "DATE", [9000, 9001, 9000, None, 8000, 9000, 9000])],
        [("b", False, True), ("a", True, None), ("d", False, None)]),
}


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_sort_tiers_match_reference(name):
    defs, specs = SORT_CASES[name]
    check_sort(Cols(defs), specs)


def test_sort_multikey_mixed_direction():
    rng = np.random.default_rng(5)
    a = [int(rng.integers(0, 4)) if rng.random() > 0.1 else None
         for _ in range(200)]
    b = [float(rng.random()) if rng.random() > 0.1 else None
         for _ in range(200)]
    check_sort(Cols([("a", "INT4", a), ("b", "FLOAT8", b)]),
               [("a", False, None), ("b", True, None)])


def test_sort_dead_rows_sort_last():
    """Padding rows past nrows carry the dead bit: the live rows come
    first in every tier, in the reference's order."""
    rng = np.random.default_rng(6)
    cols = Cols([("a", "INT8", _ints(rng, 300, -50, 50, 0.1)),
                 ("x", "FLOAT8", [float(v) for v in rng.random(300)])],
                cap=512)
    check_sort(cols, [("a", True, None), ("x", False, None)])


# the reference's TestHybridAdaptiveSort and TestTwoWordAdaptive shapes
HYBRID = {
    "narrow_two_key_single_pass": (
        [("a", "INT4", 0, 1000, 0.05), ("b", "INT8", -500, 500, 0.05)],
        [("a", False, None), ("b", True, None)]),
    "small_range_int8_keys_fit": (
        [("a", "INT8", 10**15, 10**15 + 300, 0.0),
         ("b", "INT8", -(10**17), -(10**17) + 99, 0.1)],
        [("a", False, None), ("b", False, None)]),
    "wide_keys_force_multipass": (
        [("a", "INT8", -(2**62), 2**62, 0.02),
         ("b", "INT8", -(2**62), 2**62, 0.02)],
        [("a", False, None), ("b", True, True)]),
    "three_keys_mixed_float": (
        [("a", "INT4", 0, 50, 0.1), ("x", "FLOAT8", -1e6, 1e6, 0.1),
         ("b", "INT2", -100, 100, 0.0)],
        [("a", True, False), ("x", False, None), ("b", True, None)]),
    "two_word_wide_three_keys": (
        [("a", "INT8", 0, 1 << 32, 0.1), ("b", "INT8", -(1 << 31), 1 << 31, 0),
         ("c", "INT8", 0, 1 << 30, 0.1)],
        [("a", True, None), ("b", False, None), ("c", False, None)]),
    "two_word_too_wide": (
        [("a", "INT8", 0, 1 << 62, 0), ("b", "INT8", 0, 1 << 62, 0),
         ("c", "INT8", 0, 1 << 62, 0)],
        [("a", False, None), ("b", False, None), ("c", False, None)]),
}


def _hybrid_cols(coldefs, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    defs = []
    for nm, t, lo, hi, nullfrac in coldefs:
        if t == "FLOAT8":
            data = [float(v) for v in rng.random(n) * (hi - lo) + lo]
        else:
            data = [int(v) for v in rng.integers(lo, hi, n)]
        valid = rng.random(n) >= nullfrac
        defs.append((nm, t, [d if ok else None for d, ok in zip(data, valid)]))
    return Cols(defs)


@pytest.mark.parametrize("name", list(HYBRID))
def test_adaptive_tiers_match_reference(name):
    coldefs, specs = HYBRID[name]
    check_sort(_hybrid_cols(coldefs), specs)


def test_fits_reports_the_widths():
    """The one-word tier fits narrow keys, not two full-range int8 keys;
    the two-word tier fits three 32-bit keys, not three 62-bit ones."""
    for name, tier, fits in (("narrow_two_key_single_pass", 1, True),
                             ("wide_keys_force_multipass", 1, False),
                             ("two_word_wide_three_keys", 2, True),
                             ("two_word_too_wide", 2, False)):
        coldefs, specs = HYBRID[name]
        r, p = sort_both(_hybrid_cols(coldefs), specs, tier)
        assert bool(p[2]) == bool(r[2]) == fits, name


def test_width_64_range_does_not_fit():
    """A range of 2^63 or more reports width 64 (an unsigned compare, not a
    signed max), so one key of int8 extremes never fits one word."""
    vals = [-(1 << 63), (1 << 63) - 1, 0, 5, -5, None, 1 << 62]
    cols = Cols([("a", "INT8", vals)])
    for tier in (1, 2):
        r, p = sort_both(cols, [("a", False, None)], tier)
        assert bool(p[2]) == bool(r[2]) == (tier == 2)
        assert np.array_equal(p[0], r[0])
    check_sort(cols, [("a", True, None)])
    x = torch.tensor([(1 << 63) - 1, -(1 << 63), -1, 0, 1, 255],
                     dtype=torch.int64)
    assert [int(psort._bit_width_u64(v)) for v in x] == [63, 64, 64, 0, 1, 8]


# ---------------------------------------------------------------------------
# build_sort_topk_fn: the four routes
# ---------------------------------------------------------------------------

def test_packed_topk_int4():
    # 1 (qual) + 1 (null) + 32 key bits + rbits fit one word
    rng = np.random.default_rng(11)
    cols = Cols([("a", "INT4", _ints(rng, 4096, -1000, 1000, 0.05))])
    check_topk(cols, [("a", False, None)], 37, "packed")


def test_threshold_topk_float8():
    # 66 key bits: the threshold route; continuous data, few prefix ties
    rng = np.random.default_rng(12)
    vals = [float(v) if rng.random() > 0.05 else None
            for v in rng.standard_normal(4096)]
    check_topk(Cols([("x", "FLOAT8", vals)]), [("x", True, None)], 50,
               "threshold")


def test_threshold_topk_multikey():
    rng = np.random.default_rng(13)
    n = 4096
    a = [int(v) for v in rng.integers(0, 8, n)]
    b = [float(v) if rng.random() > 0.1 else None
         for v in rng.standard_normal(n)]
    check_topk(Cols([("a", "INT4", a), ("b", "FLOAT8", b)]),
               [("a", True, None), ("b", False, None)], 64, "threshold")


def test_threshold_overflow_flags_and_exact_matches():
    # a constant key ties every row at the threshold prefix: ovf; the
    # exact variant (what the planner re-runs) must be right
    cols = Cols([("x", "FLOAT8", [1.0] * 4096)])
    check_topk(cols, [("x", False, None)], 50, "threshold", ovf=True)
    check_topk(cols, [("x", False, None)], 50, "exact", exact=True)


def test_adaptive_topk_fits_and_overflows():
    """k >= n/4 takes the adaptive single word: narrow keys fit; a full
    float8 key with a wide int8 key does not, and flags ovf."""
    rng = np.random.default_rng(14)
    n = 2048
    cols = Cols([("a", "INT4", _ints(rng, n, 0, 300, 0.1)),
                 ("b", "INT4", _ints(rng, n, -40, 40))])
    check_topk(cols, [("a", False, None), ("b", True, None)], 600,
               "adaptive")
    wide = Cols([("x", "FLOAT8", [float(v) for v in
                                  rng.standard_normal(n) * 1e300]),
                 ("q", "INT8", _ints(rng, n, -(1 << 62), 1 << 62))])
    check_topk(wide, [("x", False, None), ("q", True, None)], 600,
               "adaptive", ovf=True)
    check_topk(wide, [("x", False, None), ("q", True, None)], 600,
               "exact", exact=True)


def test_topk_with_qual():
    """Rows failing the qual never win: nqual counts the passing rows and
    the top rows are the passing rows' first k."""
    rng = np.random.default_rng(15)
    n = 4096
    vals = [float(v) for v in rng.standard_normal(n)]
    cols = Cols([("x", "FLOAT8", vals), ("q", "INT4", _ints(rng, n, 0, 10))])
    rs, ps = cols.specs([("x", False, None)])
    rq = RColumnRef(type=R.T.INT4, name="q", index=1)
    pq_ = PColumnRef(type=P.T.INT4, name="q", index=1)
    from pg_strom_tpu.expr.ir import FuncExpr as RF, Const as RC
    from pg_strom_tpu_torch.expr.ir import FuncExpr as PF, Const as PC
    rpred = RF(type=R.T.BOOL, fname="<::int4,int4", args=(
        rq, RC(type=R.T.INT4, value=3)))
    ppred = PF(type=P.T.BOOL, fname="<::int4,int4", args=(
        pq_, PC(type=P.T.INT4, value=3)))
    for k in (40, 3000):
        r, p, _ = topk_both(cols, [("x", False, None)], k,
                            pred=(rpred, ppred))
        assert np.array_equal(_np(p[0]), _np(r[0]))
        assert int(p[2]) == int(r[2])
        assert bool(p[4]) == bool(r[4])
        passing = [i for i in range(n) if cols.values["q"][i] < 3]
        if not bool(p[4]):
            want = _pg_order(cols, [("x", False, None)], passing)
            assert list(_np(p[0]))[:min(k, len(passing))] == \
                want[:min(k, len(passing))]


# ---------------------------------------------------------------------------
# ORDER BY ... LIMIT through both planners, over several chunks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(16)
    n = 6000
    rdb = R.Database()
    rdb.create(R.Table.from_columns("t", {
        "id": R.column_from_numpy(R.T.INT4, np.arange(n, dtype=np.int32)),
        "a": R.column_from_values(R.T.INT4, _ints(rng, n, 0, 200, 0.05)),
        "b": R.column_from_values(R.T.INT8, _ints(rng, n, -1000, 1000)),
        "x": R.column_from_values(R.T.FLOAT8, [
            None if v < 0.03 else (float("nan") if v < 0.05 else
                                   (-0.0 if v < 0.07 else float(v - 0.5)))
            for v in rng.random(n)]),
        "y": R.column_from_numpy(R.T.FLOAT8, rng.random(n)),
        "c": R.column_from_numpy(R.T.FLOAT8, np.ones(n)),
        "s": R.column_from_values(R.T.TEXT, [
            None if v < 0.1 else f"s{int(v * 50)}" for v in rng.random(n)]),
        "m": R.column_from_values(R.T.NUMERIC, [
            None if v < 0.05 else Decimal(f"{v * 1000 - 500:.3f}")
            for v in rng.random(n)]),
        "f": R.column_from_values(R.T.FLOAT4, [
            None if v < 0.05 else float(np.float32(v * 8 - 4))
            for v in rng.random(n)]),
    }))
    return rdb, from_reference(rdb)


# name -> (sql, the port's top-k routes it must take)
LIMIT_QUERIES = {
    "threshold_desc": ("select id, x from t order by x desc limit 100",
                       {"threshold"}),
    "packed_int": ("select id, a from t order by a limit 50", {"packed"}),
    "packed_nulls_first_offset": (
        "select id, a from t order by a nulls first limit 20 offset 5",
        {"packed"}),
    "adaptive_two_keys": ("select id, a, b from t order by a, b desc "
                          "limit 1000", {"adaptive"}),
    "adaptive_ovf_exact": ("select id, x from t where y < 0.5 "
                           "order by x, id limit 1500",
                           {"adaptive", "exact"}),
    "threshold_ties_exact": ("select id, c from t order by c limit 10",
                             {"threshold", "exact"}),
    "text_desc": ("select id, s from t order by s desc, id limit 30",
                  {"threshold"}),
    "numeric": ("select id, m from t order by m limit 25", {"threshold"}),
    "float4_pred": ("select id, f, a from t where a > 50 order by f desc "
                    "limit 40", {"packed"}),
    "expression_key": ("select id, b from t order by b * 2 + a limit 15",
                       {"threshold"}),
}


@contextlib.contextmanager
def _both_cfg(chunk_rows):
    with R.override(debug_force_offload=True, chunk_rows=chunk_rows), \
            P.override(device="cpu", debug_force_offload=True,
                       chunk_rows=chunk_rows, perfmon=True):
        yield


def _rows(ast, plan_query, Result, sql, db):
    pq = plan_query(ast.parse(sql), db)
    rows = pq.execute()
    res = Result(columns=pq.out_names, rows=rows, types=pq.out_types)
    return res.formatted(-3), dict(pq.perfmon.counts)


@pytest.mark.parametrize("name", list(LIMIT_QUERIES))
def test_order_by_limit_matches_reference(dbs, name):
    rdb, pdb = dbs
    sql, routes = LIMIT_QUERIES[name]
    with _both_cfg(1 << 11):
        want, _ = _rows(r_ast, r_plan_query, RResult, sql, rdb)
        got, counts = _rows(p_ast, p_plan_query, PResult, sql, pdb)
    with P.override(device="cpu", enabled=False):
        host, _ = _rows(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want
    assert got == host
    assert len(got) > 0
    took = {k[len("topk_"):] for k in counts if k.startswith("topk_")}
    assert took == routes, counts
    assert counts.get("unported_host_exact", 0) == 0, counts


@pytest.mark.parametrize("order", [
    "i", "i desc", "f", "f desc nulls last", "s desc", "m", "m desc",
    "i desc, f", "s, m desc", "f nulls first, i"])
def test_vectorized_order_by_matches_reference(order):
    """The plain-column ORDER BY without LIMIT (the host's np.lexsort over
    encoded planes) orders as the reference does."""
    rng = np.random.default_rng(17)
    n = 2000
    rdb = R.Database()
    rdb.create(R.Table.from_columns("t", {
        "i": R.column_from_values(R.T.INT4, [
            int(v) if v < 90 else None for v in rng.integers(0, 100, n)]),
        "f": R.column_from_values(R.T.FLOAT8, [
            None if v < 0.02 else (float("nan") if v < 0.05 else
                                   (0.0 if v < 0.08 else float(v - 0.5)))
            for v in rng.random(n)]),
        "s": R.column_from_values(R.T.TEXT, [
            None if v < 0.1 else f"s{int(v*8)}" for v in rng.random(n)]),
        "m": R.column_from_values(R.T.NUMERIC, [
            None if v < 0.05 else Decimal(f"{v*1000-500:.3f}")
            for v in rng.random(n)]),
    }))
    pdb = from_reference(rdb)
    q = f"select i, f, s, m from t order by {order}"
    with _both_cfg(1 << 11):
        want, _ = _rows(r_ast, r_plan_query, RResult, q, rdb)
        got, _ = _rows(p_ast, p_plan_query, PResult, q, pdb)
    assert got == want


@pytest.mark.parametrize("name", list(LIMIT_QUERIES))
def test_distributed_topk_matches_reference(dbs, name, monkeypatch):
    """ORDER BY ... LIMIT under pg_strom.distributed: the reference shards
    the rows over its 8 CPU devices (_topk_rows_dist), the port over an
    8-shard mesh, one top-k a shard and a host merge; both take the
    distributed route (or both fall back) and give the same rows."""
    from pg_strom_tpu.plan import planner as r_planner
    from pg_strom_tpu_torch.plan import planner as p_planner
    rdb, pdb = dbs
    sql, _routes = LIMIT_QUERIES[name]
    engaged = {}
    for tag, mod in (("ref", r_planner), ("port", p_planner)):
        orig = mod._topk_rows_dist

        def spy(*a, _orig=orig, _tag=tag, **kw):
            r = _orig(*a, **kw)
            engaged[_tag] = r is not None
            return r
        monkeypatch.setattr(mod, "_topk_rows_dist", spy)
    with R.override(debug_force_offload=True, distributed=True), \
            P.override(device="cpu", debug_force_offload=True,
                       distributed=True, mesh_shards=8, perfmon=True):
        want, _ = _rows(r_ast, r_plan_query, RResult, sql, rdb)
        got, _ = _rows(p_ast, p_plan_query, PResult, sql, pdb)
    assert got == want
    assert engaged.get("port") == engaged.get("ref") is not None, engaged
