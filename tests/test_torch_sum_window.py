"""Float sums whose groups sit far apart in scale: the digit-window check of
the column-sum lanes (pg_strom_tpu_torch/ops/preagg_mxu.window_lossy).

A float sum slot of the column-sum strategies turns each value into signed
digits inside a 72-bit window whose top follows the largest |value| of the
chunk (of the column, on K1's v2 plan), so a group whose values lie some
2^48 below another group's loses them.  The host replays a chunk where a
bucket's row count times the window's resolution could reach 2^-(p + 8) of
its shadow mass (p = 24 for sum(float4), 53 for a float8 answer).

Every case runs one aggregate through one strategy on the port's device
path (the kernels' plain versions on the CPU, the float8 lanes on as on
the card) and on its host tier, which gives PostgreSQL's answer: the rows
must be equal as PostgreSQL text at extra_float_digits=-3, with the
expected `recheck_chunks`.  The reference runs the same query and
strategy; where it gives the known wrong answer (ROADMAP section 3) the
answer stands in REFERENCE_WINDOW_FAULTS, elsewhere it must equal
PostgreSQL's too.  The strategies are K1 (v2), K2 (fused), the plain
`mxu_reduce` (mxu, two keys, and mxu_dense) and K4 (`use_pallas_reduce`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.ops import preagg_mxu as r_mxu
from pg_strom_tpu.sql import parser as r_ast
from pg_strom_tpu.sql.api import Result as RResult
from pg_strom_tpu.plan.planner import plan_query as r_plan_query
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.ops import preagg_fused as p_fused
from pg_strom_tpu_torch.ops import preagg_fused2 as p_f2
from pg_strom_tpu_torch.ops import preagg_mxu as p_mxu
from pg_strom_tpu_torch.ops import preagg_pallas as p_pallas
from pg_strom_tpu_torch.sql import parser as p_ast
from pg_strom_tpu_torch.sql.api import Result as PResult
from pg_strom_tpu_torch.plan.planner import plan_query as p_plan_query

N = 2048                 # rows of a case table, groups interleaved
CHUNK = 512              # four chunks, each holding every group
NCHUNKS = N // CHUNK
F4_MIN_SUB = float(np.float32(1.4e-45))
M = p_mxu.WINDOW_MARGIN_BITS

# strategy -> (settings, GROUP BY list, the kernel whose plain version runs)
STRATEGIES = {
    "v2": ({}, "k", "K1"),
    "fused": ({"use_fused_preagg2": False}, "k", "K2"),
    "mxu": ({"use_fused_preagg": False}, "k, j", "mxu_reduce"),
    "pallas": ({"use_fused_preagg": False, "use_pallas_reduce": True},
               "k, j", "K4"),
    "mxu_dense": ({"use_fused_preagg": False}, "k", "mxu_reduce"),
}
# aggregate -> (SQL, bits of the answer)
AGGS = {"sum_x": ("sum(x)", 24), "avg_x": ("avg(x)", 53),
        "sum_y": ("sum(y)", 53), "avg_y": ("avg(y)", 53)}


def _margin_value(agg: str, outside: bool) -> float:
    """A value a quarter inside or outside the check's threshold for a
    group beside a group of 1.0: the window's LSB is then 2^-71, and the
    chunk replays when a group's mean |v| falls below 2^(-71 + p + M)."""
    t = 2.0 ** (-71 + AGGS[agg][1] + M)
    return t * (0.75 if outside else 1.25)


def _groups(case: str, agg: str, rng):
    """Per group, its rows' values in row order (x and y alike)."""
    half = N // 2
    if case == "far_below":
        return ([1.0] * half, [1e30] * half) if agg.endswith("x") else \
            ([1e-30] * half, [1.0] * half)
    if case == "subnormal":
        return ([F4_MIN_SUB, 1e-40, 3e-39, F4_MIN_SUB] * (half // 4),
                [1.0] * half)
    if case == "zeros":
        return ([0.0, -0.0] * (half // 2), [1e30] * half)
    if case == "cancelling":
        # PostgreSQL's stepwise sum of 1e30, -1e30, 1e20 in this order is
        # exact; the group's mass is 2e30, far above 3 * 2^28 (its LSB)
        return ([1e30, -1e30, 1e20], list(1e29 + rng.random(N - 3) * 9e29))
    if case in ("margin_inside", "margin_outside"):
        v = _margin_value(agg, case == "margin_outside")
        return ([v] * half, [1.0] * half)
    if case == "sweep":
        # 32 groups, each at its own scale over 2^-60 ... 2^60, random
        # signs; rows shuffled, so every chunk holds every scale
        out = []
        for g in range(32):
            e = -60 + (120 * g) // 31
            sign = np.where(rng.random(N // 32) < 0.5, -1.0, 1.0)
            out.append(list(sign * (1.0 + rng.random(N // 32)) * 2.0 ** e))
        return tuple(out)
    raise KeyError(case)


def _expected_recheck(case: str, strategy: str) -> int:
    if case in ("zeros", "cancelling", "margin_inside"):
        return 0
    if case == "margin_outside":
        # the v2 plan's statistics prove the column's range fits the
        # window (no shadow: every row's bits are inside it)
        return 0 if strategy == "v2" else NCHUNKS
    return NCHUNKS                     # far_below, subnormal, sweep


def _table(case: str, agg: str):
    rng = np.random.default_rng(12)
    groups = _groups(case, agg, rng)
    if case == "sweep":
        k = np.repeat(np.arange(len(groups), dtype=np.int32), N // 32)
        v = np.concatenate([np.asarray(g) for g in groups])
        order = rng.permutation(N)
        k, v = k[order], v[order]
    elif case == "cancelling":         # the three rows, then group 1
        k = np.concatenate([[0, 0, 0], np.ones(N - 3, np.int32)])
        v = np.concatenate([groups[0], groups[1]])
    else:
        # interleaved, each group's rows in its own order
        k = np.tile(np.asarray([0, 1], np.int32), N // 2)
        v = np.zeros(N, np.float64)
        v[0::2] = groups[0]
        v[1::2] = groups[1]
    return R.Table.from_columns("t", {
        "k": R.column_from_numpy(R.T.INT4, k.astype(np.int32)),
        "j": R.column_from_numpy(R.T.INT4, k.astype(np.int32)),
        "x": R.column_from_numpy(R.T.FLOAT4, v.astype(np.float32)),
        "y": R.column_from_numpy(R.T.FLOAT8, v),
    })


_CFG = {"debug_force_offload": True, "debug_force_tpupreagg": True,
        "perfmon": True, "chunk_rows": CHUNK}


@contextlib.contextmanager
def _lanes():
    """The float8 lanes on in both packages, as on the card."""
    saved = p_mxu.F64_BLOCKS_ON_CPU, r_mxu.F64_BLOCKS_ON_CPU
    p_mxu.F64_BLOCKS_ON_CPU = r_mxu.F64_BLOCKS_ON_CPU = True
    try:
        yield
    finally:
        p_mxu.F64_BLOCKS_ON_CPU, r_mxu.F64_BLOCKS_ON_CPU = saved


def _port(sql: str, db, cfg: dict):
    with P.override(device="cpu", **_CFG), P.override(**cfg):
        pq = p_plan_query(p_ast.parse(sql), db)
        rows = pq.execute()
    return (tuple(PResult(columns=pq.out_names, rows=rows,
                          types=pq.out_types).formatted(-3)),
            dict(pq.perfmon.counts))


def _reference(sql: str, db, cfg: dict):
    with R.override(**_CFG), R.override(**cfg):
        pq = r_plan_query(r_ast.parse(sql), db)
        rows = pq.execute()
    return tuple(RResult(columns=pq.out_names, rows=rows,
                         types=pq.out_types).formatted(-3))


@pytest.fixture
def routes(monkeypatch):
    """Calls of each kernel's plain version, of the plain mxu_reduce path
    and of the generic and dense-key group recoveries during a query."""
    calls = {"K1": 0, "K2": 0, "K4": 0, "mxu_reduce": 0, "generic": 0,
             "dense": 0}

    def counted(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counted(p_f2, "fused2_reference", "K1")
    counted(p_fused, "fused_reference", "K2")
    counted(p_pallas, "pallas_reduce_reference", "K4")
    counted(p_mxu, "build_mxu_columns", "mxu_reduce")
    counted(p_mxu, "mxu_host_groups", "generic")
    counted(p_mxu, "mxu_dense_groups", "dense")
    return calls


# The reference's answers where its window drops a group's rows (the port
# replays these chunks and answers PostgreSQL's rows): (case, aggregate) ->
# the rows it gives, on every one of its strategies.  Its subnormal float4
# rows replay under its chunk range rule, so only far_below differs.
REFERENCE_WINDOW_FAULTS = {
    ("far_below", "sum_x"): ("0|0", "1|1.02e+33"),
    ("far_below", "avg_x"): ("0|0", "1|1.00000001505e+30"),
    ("far_below", "sum_y"): ("0|0", "1|1024"),
    ("far_below", "avg_y"): ("0|0", "1|1"),
}

CASES = ("far_below", "subnormal", "zeros", "cancelling", "margin_inside",
         "margin_outside", "sweep")
GRID = [(c, s, a) for c in CASES for s in STRATEGIES for a in AGGS
        # K1 sums float4 only: a float8 sum has no v2 plan
        if not (s == "v2" and a.endswith("y"))]


@pytest.mark.parametrize("case,strategy,agg", GRID)
def test_window_replays_exactly_the_hazard(case, strategy, agg, routes):
    cfg, keys, kernel = STRATEGIES[strategy]
    rt = _table(case, agg)
    rdb = R.Database()
    rdb.create(rt)
    pdb = from_reference(rdb)
    sql = (f"SELECT k, {AGGS[agg][0]} FROM t GROUP BY {keys} ORDER BY k")
    with _lanes():
        host, _ = _port(sql, pdb, {"enabled": False})
        got, counts = _port(sql, pdb, cfg)
        assert routes[kernel] > 0, (routes, counts)
        if kernel == "mxu_reduce":
            assert routes["K2"] == routes["K4"] == 0, routes
        assert routes["generic" if "," in keys else "dense"] > 0, routes
        assert got == host, f"{sql}\nport: {got}\nhost: {host}"
        assert counts.get("recheck_chunks", 0) == \
            _expected_recheck(case, strategy), counts
        assert counts.get("recheck_chunks", 0) + counts.get(
            "device_chunks", 0) == NCHUNKS, counts
        if case == "sweep":
            return                     # held to the host tier only
        ref = _reference(sql, rdb, dict(
            cfg, force_fused_preagg_cpu=strategy in ("v2", "fused")))
    assert ref == REFERENCE_WINDOW_FAULTS.get((case, agg), host), ref


def test_margin_pair_falls_on_either_side():
    """The threshold itself: a group at 1.25x the margin's value keeps its
    device answer, one at 0.75x replays."""
    for agg, (_, bits) in AGGS.items():
        lsb = 2.0 ** -71
        for outside in (False, True):
            v = _margin_value(agg, outside)
            n = np.asarray([N // 2, N // 2], np.float64)
            mass = n * np.asarray([v, 1.0])
            assert p_mxu.window_lossy(n, lsb, mass, bits) is outside, agg
    # A_g = 0 (every row +-0) never replays; nor does an empty bucket
    assert not p_mxu.window_lossy([5, 0], 1.0, [0.0, 0.0], 24)


def test_shadow_cell_reads_subnormals_as_the_smallest_normal():
    import torch
    x = torch.tensor([0.0, -0.0, F4_MIN_SUB, -1e-40, 1e-30, float("nan"),
                      float("inf")], dtype=torch.float32)
    out = p_mxu.shadow_cell(x)
    m = p_mxu.SHADOW_MIN
    assert out[:5].tolist() == [0.0, -0.0, m, -m, float(np.float32(1e-30))]
    assert torch.isnan(out[5]) and torch.isinf(out[6])


# (max |v|, smallest nonzero |v|, window bits) -> the v2 plan keeps the
# shadow: the window's top is 2^1 above 1.0, and a value in [2^(e-1), 2^e)
# may hold bits down to 2^(e-24), so 2^-48 (e = -47) takes 1 + 47 + 24 =
# 72 bits and 2^-49 one more
@pytest.mark.parametrize("mx,minabs,bits,shadow", [
    (1.0, 2.0 ** -48, 72, False),
    (1.0, 2.0 ** -49, 72, True),
    (1.0, 2.0 ** -49, 77, False),      # int8 mode's 11 x 7-bit window
    (1e30, 1e20, 72, False),
    (1e30, 1.0, 72, True),
    (1.0, F4_MIN_SUB, 77, True),
    (1.0, None, 72, True),             # no minabs proves no range
    (0.0, None, 72, False),            # only zeros
])
def test_v2_plan_keeps_the_shadow_where_the_range_leaves_the_window(
        mx, minabs, bits, shadow):
    from pg_strom_tpu_torch.datastore import ColumnStats
    st = ColumnStats(nrows=100, null_count=0, min_val=-mx, max_val=mx,
                     minabs=minabs)
    assert p_f2._f4_stats(st, bits) == (mx, shadow)


# ---------------------------------------------------------------------------
# a float8 sum's extraction rounds once
# ---------------------------------------------------------------------------

# (head digit sum, tail digit sum, head and tail window exponents) -> the
# reference's sum, where it rounds twice: M = mh * 2^28 + ml = 2^80 + 2^27
# + 1 at 2^-100, whose top 63 bits sit exactly halfway between two floats
# (its dropped low bit is 1), so rounding them to even lands one ulp low.
REFERENCE_DOUBLE_ROUNDING = {(1 << 52, (1 << 27) + 1, 0, -28): 2.0 ** -20}


def _f8_sum_slot(M, mh: int, ml: int, eh: int, el: int):
    """(recipe, fetched output) of one float8 sum bucket whose head and
    tail digit sums are mh and ml, in package M."""
    inst = M.preagg.AggInstance("sum", "f8", ("count", "sum_f"), (None,))
    _, slotr, S = M.mxu.mxu_recipes([M.T.INT4], [inst], [(M.T.FLOAT8,)])
    r = slotr[0]["sum_f"]
    sums = np.zeros((1, S), np.int64)
    for limbs, v in ((r.limbs, mh), (r.lo_limbs, ml)):
        for j, c in enumerate(limbs):
            sums[0, c] = (v >> (8 * j)) & 0xFF
    return r, {"mxu_sums": sums, "mxu_f4exps": np.asarray([eh, el], np.int32)}


def test_float8_sum_extraction_rounds_once():
    from fractions import Fraction
    from pg_strom_tpu.ops import preagg as r_preagg
    from pg_strom_tpu_torch.ops import preagg as p_preagg

    class Pkg:
        def __init__(self, T, preagg, mxu):
            self.T, self.preagg, self.mxu = T, preagg, mxu

    RP, PP = Pkg(R.T, r_preagg, r_mxu), Pkg(P.T, p_preagg, p_mxu)
    with _lanes():
        for (mh, ml, eh, el), ref in REFERENCE_DOUBLE_ROUNDING.items():
            exact = Fraction((mh << (eh - el)) + ml) * Fraction(2) ** (
                el - p_mxu.F4_WINDOW)
            r, out = _f8_sum_slot(PP, mh, ml, eh, el)
            got = p_mxu.mxu_extract_slot(r, out, 0)["sum_f"]
            assert got == float(exact) == 2.0 ** -20 + 2.0 ** -72
            r, out = _f8_sum_slot(RP, mh, ml, eh, el)
            assert r_mxu.mxu_extract_slot(r, out, 0)["sum_f"] == ref != got
    rng = np.random.default_rng(5)
    for _ in range(2000):
        m = int(rng.integers(1, 1 << 62)) << int(rng.integers(0, 70))
        m = m * int(rng.choice([-1, 1])) + int(rng.integers(0, 1 << 20))
        e = int(rng.integers(-250, 40))
        assert p_mxu._dyadic_float(m, e) == float(Fraction(m) * Fraction(2) ** e)


# ---------------------------------------------------------------------------
# the same hazard under a join and a star join
# ---------------------------------------------------------------------------

def _fact(n: int, cols: dict):
    k = np.arange(n, dtype=np.int32) % 2
    x = np.where(k == 0, 1.0, 1e30)
    y = np.where(k == 0, 1e-30, 1.0)
    cols = {name: R.column_from_numpy(R.T.INT4, f(k))
            for name, f in cols.items()}
    cols["x"] = R.column_from_numpy(R.T.FLOAT4, x.astype(np.float32))
    cols["y"] = R.column_from_numpy(R.T.FLOAT8, y)
    return R.Table.from_columns("f", cols)


def _dim(name: str, key: str, n: int):
    kk = np.arange(n, dtype=np.int32)
    return R.Table.from_columns(name, {
        key: R.column_from_numpy(R.T.INT4, kk),
        "g": R.column_from_numpy(R.T.INT4, kk * 10)})


JOIN_SQL = {
    "join_agg": ("SELECT d.g, sum(f.x), avg(f.y) FROM f JOIN d ON f.k = d.k "
                 "GROUP BY d.g ORDER BY 1", "kernel tpujoinagg"),
    "star": ("SELECT d1.g, sum(f.x), sum(f.y) FROM f, d1, d2 "
             "WHERE f.a = d1.a AND f.b = d2.b GROUP BY d1.g ORDER BY 1",
             "kernel tpustarjoinagg"),
}


@pytest.mark.parametrize("name", list(JOIN_SQL))
def test_join_and_star_replay_the_hazard(name):
    rdb = R.Database()
    if name == "join_agg":
        rdb.create(_fact(N, {"k": lambda k: k}))
        rdb.create(_dim("d", "k", 2))
    else:
        rdb.create(_fact(N, {"a": lambda k: k, "b": lambda k: 1 - k}))
        rdb.create(_dim("d1", "a", 2))
        rdb.create(_dim("d2", "b", 2))
    pdb = from_reference(rdb)
    sql, kernel = JOIN_SQL[name]
    with _lanes():
        host, _ = _port(sql, pdb, {"enabled": False})
        got, counts = _port(sql, pdb, {})
        ref = _reference(sql, rdb, {})
    assert any(c.startswith(kernel) for c in counts), counts
    assert got == host, f"port: {got}\nhost: {host}"
    assert host[0].startswith("0|1.02e+03|"), host
    assert counts.get("recheck_chunks", 0) == NCHUNKS, counts
    # the reference sums group 0 to 0
    assert ref != host and ref[0].startswith("0|0|"), ref


# ---------------------------------------------------------------------------
# the main path did not move
# ---------------------------------------------------------------------------

def test_flagship_plan_keeps_no_shadow():
    """bench.py's flagship (float4 x in [0, 1), int8 y, WHERE x > 0.25):
    the v2 plan needs no shadow and keeps its 15 columns (int8 mode; at
    2^20 rows x's smallest value already takes the seventh float digit, as
    at the card's 2^27)."""
    import chip_smoke as cs
    t = cs._case_table("flagship", np.random.default_rng(0), 1 << 20)
    pred, groups, aggs = cs._case_query("flagship", cs._cols(t))
    plan = cs._k1_plan(t, "flagship", pred, groups, aggs)
    assert plan.sig.shadow_map == ()
    assert plan.sig.i8 and plan.sig.ncols == 15


def test_t0_agg_group_replays_nothing():
    import chip_smoke as cs
    db, _ = cs._t0_db(3, 1 << 14)
    with _lanes():
        got, counts = _port(cs.T0_SQL["agg_group"], db,
                            {"chunk_rows": 1 << 12})
        host, _ = _port(cs.T0_SQL["agg_group"], db, {"enabled": False})
    assert got == host
    assert counts.get("device_chunks", 0) == 4, counts
    assert counts.get("recheck_chunks", 0) == 0, counts
