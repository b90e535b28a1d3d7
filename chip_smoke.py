#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_strom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--rows-log2 27] [--kernel-rows-log2 20]

Phases, in order; any failure raises, exits non-zero and prints no `ok`:

1. require a CUDA device; print the card's name and power limit
   (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
2. build the K1 kernel library from ops/cuda/preagg_fused2.cu (nvcc,
   sm_90a) and print the build time and the ptxas report;
3. hold the kernel against its plain PyTorch version on the card, at
   2^20 rows with nrows = 2^20 - 37, over the cases listed in
   KERNEL_CASES: `ints` bit-equal and the same host-replay decision;
4. the slice: a port Database holding the flagship table (2^27 rows: two
   2^26-row chunks, int4 key in 0..29, float4 x with 5% NULL, int8 y in
   [0, 2^40) with 5% NULL), then
   SELECT key, sum(x), count(x), sum(y) FROM t WHERE x > 0.25 GROUP BY key
   through the planner: every chunk on the kernel (device_chunks == 2,
   recheck_chunks == 0, unported_host_exact == 0, K1 launched), count and
   sum(y) exact against numpy int64, sum(x) to rel 1e-5;
5. a 2^14-row table with NULLs and NaN through the device path and the
   host-exact tier: equal rows;
6. timings (cold and warm query, the kernel alone and its plain version at
   the main path's chunk shape), each beside the card's name and power
   limit; then the kernels' JSON line and, last, the `ok` line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time


def _log(msg: str) -> None:
    print(msg, flush=True)


def _gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# expression helpers over the port's IR
# ---------------------------------------------------------------------------

def _cols(table):
    from pg_strom_tpu_torch.expr.ir import ColumnRef
    names = table.column_names
    return {nm: ColumnRef(type=table.columns[nm].type, name=nm,
                          index=names.index(nm)) for nm in names}


def _agg(name, col):
    from pg_strom_tpu_torch.ops.preagg import AggInstance, lookup_agg
    d, fam = lookup_agg(name, (col.type,) if col is not None else ())
    return AggInstance(aggname=name, family=fam, slots=d.slots,
                       args=(col,) if col is not None else ())


def _flagship_columns(rng, n: int):
    """bench.py's flagship data: int4 key 0..29, float4 x (5% NULL), int8 y
    in [0, 2^40) (5% NULL)."""
    import numpy as np
    key = rng.integers(0, 30, n, dtype=np.int32)
    x = rng.random(n, dtype=np.float32)
    xv = rng.random(n, dtype=np.float32) > 0.05
    y = rng.integers(0, 1 << 40, n, dtype=np.int64)
    yv = rng.random(n, dtype=np.float32) > 0.05
    return key, x, xv, y, yv


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def _case_table(name: str, rng, n: int):
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import Table, column_from_numpy as cn

    def nulls(p):
        return rng.random(n, dtype=np.float32) > p

    if name in ("flagship", "flagship_int8_off"):
        key, x, xv, y, yv = _flagship_columns(rng, n)
        return Table.from_columns("t", {
            "k": cn(T.INT4, key), "x": cn(T.FLOAT4, x, xv),
            "y": cn(T.INT8, y, yv)})
    if name == "wide_g":
        return Table.from_columns("t", {
            "k": cn(T.INT4, rng.integers(-2000, 2000, n, dtype=np.int32),
                    nulls(0.02)),
            "z": cn(T.INT4, rng.integers(-5000, 5000, n, dtype=np.int32),
                    nulls(0.1))})
    x = ((rng.random(n, dtype=np.float32) - np.float32(0.3))
         * np.float32(10.0)).astype(np.float32)
    if name == "nan_or_not_isnull":
        x[rng.random(n) < 0.01] = np.float32("nan")
    cols = {
        "k": cn(T.INT4, rng.integers(5, 21, n, dtype=np.int32), nulls(0.1)),
        "x": cn(T.FLOAT4, x, nulls(0.15)),
        "z": cn(T.INT4, rng.integers(-5000, 5000, n, dtype=np.int32),
                nulls(0.05)),
        "zb": cn(T.INT4, rng.integers(-(1 << 30), 1 << 30, n,
                                      dtype=np.int32), nulls(0.05)),
    }
    if name == "wide_negative_int8":
        w = rng.choice(np.asarray([-(1 << 62), (1 << 62) - 7, 0, 12345,
                                   -987654321], np.int64), n)
        cols["y"] = cn(T.INT8, w, nulls(0.2))
    elif name == "int8_single_limb":
        cols["y"] = cn(T.INT8, rng.integers(0, 200, n) + 10 ** 15,
                       nulls(0.0))
    else:
        cols["y"] = cn(T.INT8, rng.integers(-(1 << 40), 1 << 40, n),
                       nulls(0.2))
    return Table.from_columns("t", cols)


def _case_query(name: str, c):
    """(pred, group_exprs, aggs) of one kernel case over _case_table."""
    import math as _m
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.expr.ir import (Const, BoolExpr, NullTest,
                                            resolve_function)
    if name in ("flagship", "flagship_int8_off"):
        pred = resolve_function(">", (c["x"], Const(type=T.FLOAT4,
                                                     value=0.25)))
        return pred, [c["k"]], [_agg("sum", c["x"]), _agg("count", c["x"]),
                                _agg("sum", c["y"])]
    if name == "all_kinds":
        return None, [c["k"]], [
            _agg("sum", c["z"]), _agg("avg", c["z"]), _agg("stddev", c["z"]),
            _agg("stddev", c["zb"]), _agg("count", None),
            _agg("count", c["y"]), _agg("sum", c["x"])]
    if name in ("wide_negative_int8", "int8_single_limb"):
        return None, [c["k"]], [_agg("sum", c["y"]), _agg("count", c["y"])]
    if name == "nan_or_not_isnull":
        nan_ge = resolve_function(">=", (c["x"], Const(type=T.FLOAT4,
                                                       value=_m.nan)))
        not_neg = BoolExpr(type=T.BOOL, op="not", args=(resolve_function(
            "<", (c["z"], Const(type=T.INT4, value=0))),))
        y_null = NullTest(type=T.BOOL, arg=c["y"], isnull=True)
        pred = BoolExpr(type=T.BOOL, op="or", args=(
            nan_ge, BoolExpr(type=T.BOOL, op="and", args=(not_neg, y_null))))
        return pred, [c["k"]], [_agg("sum", c["x"]), _agg("count", None),
                                _agg("sum", c["z"])]
    if name == "wide_g":
        return None, [c["k"]], [_agg("sum", c["z"]), _agg("count", c["z"])]
    if name == "in_list_or_chain":
        # z IN (40 values): an OR of 40 compares, folded left two at a time
        eqs = tuple(resolve_function("=", (c["z"], Const(type=T.INT4,
                                                         value=v)))
                    for v in range(-2000, 2000, 100))
        pred = BoolExpr(type=T.BOOL, op="or", args=eqs)
        return pred, [c["k"]], [_agg("sum", c["y"]), _agg("count", None)]
    raise ValueError(name)


KERNEL_CASES = ("flagship", "flagship_int8_off", "all_kinds",
                "wide_negative_int8", "int8_single_limb", "nan_or_not_isnull",
                "wide_g", "in_list_or_chain")


def _device_cols(table, dev):
    import torch
    return tuple((torch.from_numpy(c.data).to(dev),
                  torch.from_numpy(c.valid).to(dev))
                 for c in table.columns.values())


def _run_both(plan, kpred, cols, nrows):
    """(kernel ints, shadow), (plain ints, shadow) on the same planes."""
    from pg_strom_tpu_torch.ops.preagg_fused2 import (
        _kernel_planes, fused2_cuda, fused2_reference)
    scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
            "f4e": plan.f4e}
    planes = _kernel_planes(plan.sig, cols)
    k = fused2_cuda(plan.sig, planes, nrows, scal, plan.G, kpred)
    p = fused2_reference(plan.sig, planes, nrows, scal, plan.G, kpred)
    return k, p, planes, scal


def _overflow(plan, shadow) -> bool:
    import numpy as np
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_overflow
    pcs = [pc for _, pc in plan.sig.shadow_map]
    fs = (shadow[:, pcs].double().cpu().numpy() if pcs
          else np.zeros((plan.G, 0)))
    return mxu_overflow({"mxu_fsums": fs}, plan.recipes)


def _compare(plan, kpred, cols, nrows) -> int:
    """max |kernel - plain| over ints (0 required) after checking the
    host-replay decision; raises on disagreement."""
    import torch
    (ki, ks), (pi, ps), _, _ = _run_both(plan, kpred, cols, nrows)
    torch.cuda.synchronize()
    err = int((ki - pi).abs().max().item()) if ki.numel() else 0
    if not torch.equal(ki, pi):
        raise AssertionError(f"K1 ints differ from the plain version "
                             f"(max abs diff {err})")
    if _overflow(plan, ks) != _overflow(plan, ps):
        raise AssertionError("K1 and the plain version disagree on host "
                             "replay")
    return err


def phase_kernels(seed: int, log2n: int) -> int:
    import numpy as np
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.datastore import column_stats
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.preagg_fused2 import (derive_v2_plan,
                                                       lower_program)
    N = 1 << log2n
    nrows = N - 37
    dev = torch.device("cuda")
    worst = 0
    for i, name in enumerate(KERNEL_CASES):
        rng = np.random.default_rng(seed * 1000 + i)
        t = _case_table(name, rng, N)
        c = _cols(t)
        pred, groups, aggs = _case_query(name, c)
        cols_host = [t.columns[nm] for nm in t.column_names]
        for col in cols_host:
            column_stats(col)
        schema = schema_from_chunk_columns(t.column_names, cols_host)
        with override(use_preagg_int8=(name != "flagship_int8_off")):
            plan = derive_v2_plan(cols_host, schema, groups, aggs, pred,
                                  max_g=4096)
        if plan is None:
            raise AssertionError(f"case {name}: no v2 plan")
        prog = lower_program(plan.sig, pred)
        err = _compare(plan, pred, _device_cols(t, dev), nrows)
        worst = max(worst, err)
        _log(f"kernel case {name}: G={plan.G} K={plan.sig.ncols} "
             f"ops={len(prog.ops)} pred_ops={len(prog.pred)} "
             f"i8={plan.sig.i8} shadow={bool(plan.sig.shadow_map)} "
             f"ints bit-equal to the plain version")
        del t
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

FLAGSHIP_SQL = ("SELECT key, sum(x), count(x), sum(y) FROM t "
                "WHERE x > 0.25 GROUP BY key ORDER BY key")


def _flagship_db(seed: int, n: int):
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    key, x, xv, y, yv = _flagship_columns(np.random.default_rng(seed), n)
    db = Database()
    db.create(Table.from_columns("t", {
        "key": cn(T.INT4, key), "x": cn(T.FLOAT4, x, xv),
        "y": cn(T.INT8, y, yv)}))
    return db, (key, x, xv, y, yv)


def _flagship_expected(data):
    """Per key (count(x), sum(y), sum(x) as float64), exact for the ints:
    sum(y) is taken as two 20-bit halves whose float64 bincounts stay below
    2^53."""
    import numpy as np
    key, x, xv, y, yv = data
    m = xv & (x > np.float32(0.25))
    k = key[m]
    cnt = np.bincount(k, minlength=30).astype(np.int64)
    my = m & yv
    ky, yy = key[my], y[my]
    lo = np.bincount(ky, weights=(yy & 0xFFFFF).astype(np.float64),
                     minlength=30)
    hi = np.bincount(ky, weights=(yy >> 20).astype(np.float64), minlength=30)
    sy = [(int(h) << 20) + int(lo_) for h, lo_ in zip(hi, lo)]
    sx = np.bincount(k, weights=x[m].astype(np.float64), minlength=30)
    return cnt, sy, sx


def _check_flagship(rows, expected) -> None:
    cnt, sy, sx = expected
    if len(rows) != 30:
        raise AssertionError(f"{len(rows)} groups, expected 30")
    for kv, sumx, cntx, sumy in rows:
        if cntx != int(cnt[kv]):
            raise AssertionError(f"key {kv}: count(x) {cntx} != {cnt[kv]}")
        if int(sumy) != sy[kv]:
            raise AssertionError(f"key {kv}: sum(y) {sumy} != {sy[kv]}")
        if not math.isclose(sumx, sx[kv], rel_tol=1e-5):
            raise AssertionError(f"key {kv}: sum(x) {sumx} vs {sx[kv]}")


def phase_slice(seed: int, log2n: int, gpu: str) -> dict:
    import torch
    from pg_strom_tpu_torch import execute, override
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.ops.preagg_fused2 import fused2_cuda
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    n = 1 << log2n
    t0 = time.perf_counter()
    db, data = _flagship_db(seed, n)
    expected = _flagship_expected(data)
    _log(f"slice: {n} rows generated and checked on the host in "
         f"{time.perf_counter() - t0:.1f} s")

    TCACHE.clear()
    fused2_cuda.launches = 0
    t0 = time.perf_counter()
    pq = plan_query(ast.parse(FLAGSHIP_SQL), db)
    rows = pq.execute()
    cold = time.perf_counter() - t0
    launches = fused2_cuda.launches
    counts = dict(pq.perfmon.counts)
    _log(f"slice: cold query {cold * 1e3:.3f} ms, perfmon {counts}, "
         f"K1 launches {launches}")
    if launches < 1:
        raise AssertionError("the slice never launched K1")
    for ctr, want in (("device_chunks", n >> 26 if n >= 1 << 26 else 1),
                      ("recheck_chunks", 0), ("unported_host_exact", 0)):
        if counts.get(ctr, 0) != want:
            raise AssertionError(f"perfmon {ctr} = {counts.get(ctr, 0)}, "
                                 f"expected {want}")
    _check_flagship(rows, expected)
    _log("slice: count(x), sum(y) exact and sum(x) within rel 1e-5 of numpy")
    with override(perfmon=True):
        text = "\n".join(r[0] for r in execute("EXPLAIN ANALYZE " +
                                               FLAGSHIP_SQL, db).rows)
    _log(text)

    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = execute(FLAGSHIP_SQL, db)
        warm.append(time.perf_counter() - t0)
        _check_flagship(res.rows, expected)
    med = statistics.median(warm)
    timing = {"cold_ms": cold * 1e3, "warm_ms": med * 1e3,
              "warm_all_ms": [w * 1e3 for w in warm],
              "rows_per_s": n / med, "launches": launches}
    _log(f"slice timing [{gpu}]: cold {cold * 1e3:.3f} ms, warm median "
         f"{med * 1e3:.3f} ms of {[round(w * 1e3, 3) for w in warm]}, "
         f"{n / med:.6e} rows/s")

    # the kernel alone and its plain version at the main path's chunk shape
    timing.update(_time_chunk(db, gpu))
    return timing


def _time_chunk(db, gpu: str) -> dict:
    """K1 and its plain version on the first resident flagship chunk."""
    import torch
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.expr.ir import Const, resolve_function
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.preagg_fused2 import (
        derive_v2_plan, fused2_cuda, fused2_reference, _kernel_planes)
    t = db.get("t")
    names = t.column_names
    c = _cols(t)
    # the kernel's form of the SQL predicate (narrow_exact_casts)
    pred = resolve_function(">", (c["x"], Const(type=T.FLOAT4, value=0.25)))
    cols_host = [t.columns[nm] for nm in names]
    plan = derive_v2_plan(cols_host, schema_from_chunk_columns(names,
                                                               cols_host),
                          [c["key"]], [_agg("sum", c["x"]),
                                       _agg("count", c["x"]),
                                       _agg("sum", c["y"])], pred, 4096)
    cc = next(iter(TCACHE.chunks_for(t, names, chunk_capacity(t.nrows))))
    scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
            "f4e": plan.f4e}
    planes = _kernel_planes(plan.sig, cc.planes)
    err = _compare(plan, pred, cc.planes, cc.nrows)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def kern():
        return fused2_cuda(plan.sig, planes, cc.nrows, scal, plan.G, pred)

    def plain():
        return fused2_reference(plan.sig, planes, cc.nrows, scal, plan.G,
                                pred)

    # plain, kernel, kernel, plain on one card
    p1 = timed(plain, 2)
    k1 = timed(kern, 20)
    k2 = timed(kern, 20)
    p2 = timed(plain, 2)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    _log(f"K1 at the main-path chunk ({cc.nrows} rows, G={plan.G}, "
         f"K={plan.sig.ncols}) [{gpu}]: kernel {k1:.4f} / {k2:.4f} ms, "
         f"plain PyTorch {p1:.4f} / {p2:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "chunk_err": err}


# ---------------------------------------------------------------------------
# phase 5: device path vs host-exact tier
# ---------------------------------------------------------------------------

SMALL_SQL = (
    "SELECT k, sum(x), count(x), sum(y), avg(z), stddev(z), count(*) FROM s "
    "WHERE x > 0.25 OR y IS NULL GROUP BY k ORDER BY k",
    "SELECT k, count(x), sum(y), sum(z), count(*) FROM s "
    "WHERE NOT (z < 0) OR x IS NULL GROUP BY k ORDER BY k",
)


def _rows_equal(got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows vs {len(want)}")
    for rg, rw in zip(got, want):
        for vg, vw in zip(rg, rw):
            if isinstance(vg, float) and isinstance(vw, float):
                if not (vg == vw or math.isclose(vg, vw, rel_tol=1e-5,
                                                 abs_tol=1e-30)
                        or (math.isnan(vg) and math.isnan(vw))):
                    raise AssertionError((rg, rw))
            elif vg != vw:
                raise AssertionError((rg, rw))


def phase_small(seed: int) -> None:
    import numpy as np
    from pg_strom_tpu_torch import T, execute, override
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    from pg_strom_tpu_torch.ops.preagg_fused2 import fused2_cuda
    n = 1 << 14
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) < 0.01] = np.float32("nan")
    db = Database()
    db.create(Table.from_columns("s", {
        "k": cn(T.INT4, rng.integers(0, 50, n, dtype=np.int32),
                rng.random(n) > 0.05),
        "x": cn(T.FLOAT4, x, rng.random(n) > 0.1),
        "y": cn(T.INT8, rng.integers(-(1 << 50), 1 << 50, n),
                rng.random(n) > 0.1),
        "z": cn(T.INT4, rng.integers(-100000, 100000, n, dtype=np.int32),
                rng.random(n) > 0.1)}))
    for sql in SMALL_SQL:
        before = fused2_cuda.launches
        with override(debug_force_tpupreagg=True):
            dev_rows = execute(sql, db).rows
        if fused2_cuda.launches == before:
            raise AssertionError(f"device run did not launch K1: {sql}")
        with override(enable_tpupreagg=False):
            host_rows = execute(sql, db).rows
        _rows_equal(dev_rows, host_rows)
    _log(f"small table ({n} rows, NULLs and NaN): device path == host-exact "
         f"tier for {len(SMALL_SQL)} queries")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-log2", type=int, default=27,
                    help="flagship table size (2^N rows; default 27)")
    ap.add_argument("--kernel-rows-log2", type=int, default=20,
                    help="rows of the kernel-vs-plain cases (default 20)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pg_strom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gpu = _gpu_line()
    print(gpu, flush=True)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
         f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    from pg_strom_tpu_torch.ops import cuda as kc
    t0 = time.perf_counter()
    kc.k1_library()
    how = (f"nvcc {kc.build_seconds:.2f} s" if kc.build_seconds is not None
           else "already built from this source")
    _log(f"K1 build: {time.perf_counter() - t0:.2f} s ({how}) -> "
         f"{os.path.relpath(kc.library_path())}")
    for line in (kc.build_log or "").splitlines():
        if "ptxas" in line:
            _log(f"  {line.strip()}")

    err = phase_kernels(args.seed, args.kernel_rows_log2)
    timing = phase_slice(args.seed, args.rows_log2, gpu)
    phase_small(args.seed)
    _log(f"total {time.perf_counter() - t_start:.1f} s [{gpu}]")

    print(json.dumps({"kernels": [{
        "name": "preagg_fused2 (K1)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/preagg_fused2.cu",
        "replaces": "pg_strom_tpu/ops/preagg_fused2.py:625",
        "launches": timing["launches"],
        "max_abs_err": max(err, timing["chunk_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
