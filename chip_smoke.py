#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_strom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--rows-log2 27] [--kernel-rows-log2 20]
                          [--window-rows-log2 25] [--k4-parent DIR]

Phases, in order; any failure raises, exits non-zero and prints no `ok`:

1. require a CUDA device; print the card's name and power limit
   (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
2. build the kernel library (K1 ops/cuda/preagg_fused2.cu, K2
   preagg_fused.cu, both on the accumulation core onehot_accum.cuh; K4
   preagg_pallas.cu, K3 mxu_lookup.cu; one nvcc per source, in parallel,
   sm_90a), print the build time and the ptxas reports, and the atomic
   instructions each kernel compiled to (cuobjdump -sass; K4's digit adds
   must be native ATOMS.ADD, with no 64-bit compare-and-swap loop);
3. hold each kernel against its plain PyTorch version on the card, at
   2^20 rows with nrows = 2^20 - 37: K1 over KERNEL_CASES and
   KERNEL_EDGE_CASES (G = 8, 128, 256), K2 over K2_CASES (dense text key
   with float8 blocks, hashed int4 keys, int8/timestamp keys, float4 with
   NaN/inf/NULL, corr/covar, G = 2048 with column tiling, an all-NULL
   group) and K2_EDGE_CASES (G = 40, 128, 256, corr's K = 114 at G = 32
   and 2048); the exactness windows (2^24 + 3 rows in one bucket at digit
   255 on one and two blocks: past the 2^23-row s32 flush of one block);
   K4 over the value matrices of two of those cases at G = 32 and 2048
   and over K4_EDGE_CASES (G = 40 with NaN and inf in the shadows, 256,
   1024, corr's wide matrix in column tiles at 2048, twelve float8 sums'
   255 columns at G = 1 and in column tiles at 2048), its exactness window
   and a matrix with inf, NaN and digits past [-255, 255] in integer
   columns: `ints` bit-equal and the same host-replay decision; then K4's
   shape gate: mxu_reduce under use_pallas_reduce at G = 2048 with 25
   float shadows (no K4 plan) takes the plain path, bit-equal, K4 not
   launched, `k4_shape_routed` 1; with 24 shadows K4 launches;
3c. K3 against its plain version: 2^20 lookups at D in {100, 2048, 40960,
   65536} and K in {1, 2, 4}, with the edge, padding and out-of-range
   indexes: bit-equal;
3d. K5 against its plain version over K5_CASES (SSB Q1.1's four int4
   columns joined to the dates of 1993; the same with an int4 overflow on
   a joined row; NULLs, int2, float4 and bool columns with OR, NOT and IS
   NULL; merged ranges over a nullable column and keys near both ends
   of int4) at 1, 4099 and 2^26 rows: the output bit-equal, the err lane as
   expected, each launch counted; K5Batch (the launch plan's K5) over
   two chunks of 4100 and of 2^24 rows through four steps of constants
   (ranges alone, a predicate clause, another year), bit-equal chunk by
   chunk; then K5 and its plain version timed
   with CUDA events on a 2^26-row chunk of Q1.1's columns beside its
   bound (1.07 GB at 3.35 TB/s);
4. the flagship slice: a port Database holding the flagship table (2^27
   rows: two 2^26-row chunks, int4 key in 0..29, float4 x with 5% NULL,
   int8 y in [0, 2^40) with 5% NULL), then
   SELECT key, sum(x), count(x), sum(y) FROM t WHERE x > 0.25 GROUP BY key
   through the planner: every chunk on K1, count and sum(y) exact against numpy int64, sum(x) to rel 1e-5; K1 launches
   counted over the cold and the five warm runs;
4a. SSB Q1.1's shape through the planner: lineorder (2^27 rows: two
   2^26-row chunks of lo_orderdate, lo_quantity, lo_discount and
   lo_extendedprice, int4 with no NULL) joined to SSB's date dimension
   (d_datekey yyyymmdd, 1992-1998) and to qty (q_key 1..40 in order):
   Q1.1 (d_year = 1993) on K3's table, Q1.1 with join_mxu_lookup off on
   the plain table, and a count and int4 sum over qty on the identity,
   each cold and 3 warm: the membership table built from that variant,
   every chunk on K5 (joinagg_scalar_chunks and K5's launches equal the
   chunk count a run, nothing replayed), K5's launch plan made by the
   cold run (k5_plan_builds 1) and hit by each warm run with one read
   from the device (k5_plan_hits 1, d2h_reads 1), the answer exact
   against numpy int64; K5's launches here are the kernels line's;
4b. general grouped aggregation: t0 of models/testdb.py at 2^27 rows at
   the default cache budget (tcache_size_mb 0: 40% of the card's memory;
   the budget and t0's resident plane bytes logged, 53 B a row with two
   planes a float8 column) and its queries agg_group, rollup, filter and
   agg_nogrp through the planner: every chunk on the device, none
   replayed, K2 launched (agg_group cold at G = 1024 and warm at G = 32,
   rollup on its first rung), counts exact
   and float8 sums / averages to rel 1e-9 against numpy; every warm run
   on the resident planes (no cache miss, 0 H2D bytes);
4d. joins in 4b's database: the dimensions t1..t4 (int4 keys 1..40000)
   and t6 (the same keys in a seeded random order), then join_agg,
   star_group and t0 x t6 cold and warm: every probe chunk on the
   device, K3 launched on each, counts and joined ints exact and float8
   sums to rel 1e-9 against numpy; a torch.profiler pass over 3 warm
   join_agg runs; K3 alone, its plain version and torch.take on a 2^26-row
   probe chunk;
4e. in the same database, with t7(gid, v) added (each key twice): the
   N-way star join+aggregate (TpuStarJoinAgg) star4way (identity probes),
   star_k3 (a K3 probe of t6, grouped: K2) and star_fanout (two slices a
   chunk), then ORDER BY ... LIMIT on each top-k route (sort: threshold,
   sort_packed, sort_adaptive, sort_exact: ovf and the exact rerun), each
   cold and 5 warm: every chunk on the device, none replayed, counts and
   integer sums exact and float8 sums to rel 1e-9 against numpy, the
   sorted rows equal to a stable numpy lexsort, K3 and K2 on every chunk
   of star_k3, every route used; a torch.profiler pass over 3 warm
   star_k3 runs;
4f. the SQL and plan surface in the same database: window_rank
   (models/testdb.py's text) cold and warm over a separate t0 of
   2^--window-rows-log2 rows (2^25 by default: at 2^27 one run spends
   more than 150 s on the host; 27 runs it over 4b's t0), exact against
   numpy without a sort, the
   inner scan on the device, the tier's split logged (scan, mask
   read-back, row indexes, gather, key encoding, frame lexsort, ranker,
   POST stage, outer aggregate); window_sum (sum(y) over (partition by
   cat order by id) where x < 1.0) cold and 3 warm, each cat to rel 1e-9
   against a sequential numpy sum; two correlated subqueries over tcat
   (t0's 26 codes and 4 absent ones: a scalar count and an EXISTS) cold
   and 3 warm, exact, every instantiation planned and run on the device;
   pgstrom_device_info / program_info / tcache_info; EXPLAIN's device
   kernel a traced graph; `python -m pg_strom_tpu_torch script.sql`
   (\\demo 100000, agg_group, window_rank) exits 0 and prints the rows of
   the same queries run in this process;
4g. COPY and the distributed mesh in the same database: copy_t0 writes
   a 2^24-row CSV of t0's schema, COPYs it into t0c through the native
   loader (the native path asserted; every plane exact against numpy;
   rows/s and the arena tables logged) and runs agg_group over it on K2
   (exact); a 2^16-row COPY of int4, float8, date, text and numeric
   columns (load_csv2) equals the exact python path; then, with
   pg_strom.distributed on a 4-shard mesh (round-robin over the visible
   devices: a virtual mesh of cuda:0 on one card; again one shard a
   device when that differs), dist_join_agg (join_agg),
   dist_agg_group (agg_group), dist_star (star_k3 over t0c: K3 and K2 on
   every shard), dist_topk (sort) and dist_distinct (count(DISTINCT aid)
   by cat), each cold and 3 warm, exact against numpy, its dist_*
   counter asserted (a DistFallback fails), the warm runs on resident
   shards with 0 H2D bytes; dist_distinct once more under device_distinct
   without distributed; dryrun_multichip(4), flat and (2, 2);
4h. float8 across the whole double range (after 4b-4g, a new database):
   f8(k int4 0..31, v and w float8 with 5% NULL; v holds 0 and -0.0, NaN,
   +-inf, 5e-324, 1e-310, 1e-300, 1e-38, 1e37, 3.5e38, 1e300, 1.7e308 and
   normal values, as in tests/test_torch_float8_native.py) at 2^(N-1)
   rows, about 1.5 GB of planes, and d8(v, label): compares, ORDER BY ...
   LIMIT both ways, GROUP BY v, min / max / count, count(DISTINCT v), a
   join+aggregate on the float8 key and sum(w) where v < -1e37, each cold
   and 3 warm under perfmon, exact against numpy, none replayed
   (recheck_chunks 0), K2 launched; then f8 at 2^16 rows: the same
   queries and sum / avg / stddev over only-tiny and only-huge groups
   (cold and 3 warm: each replays) equal to the port's host tier as
   PostgreSQL text, recheck_chunks and replayed rows logged;
4i. float sums whose groups sit far apart in scale (after 4h, a new
   database): sw(k int4, a float4, b float8) of 64 groups, 62 at their
   own scale over 2^-60 ... 2^60, one of zeros, one of float4
   subnormals; 2^(N-1) bulk rows of the five top groups (about 1.1 GB of
   planes) in 2^(N-5)-row chunks, then a 2^16-row tail chunk of the other
   59: sum and avg of a on K1, K2 and K4 and of b on K2 and K4, each cold
   and 3 warm, every group against numpy (the device's exact sums, the
   tail's stepwise host sums), recheck_chunks 1 (the tail: its window
   check trips) and the kernel launched on every chunk; warm times and
   the replay's host time logged; then at 2^16 + 2^12 rows each route
   equal to the port's host tier as PostgreSQL text;
4c. the K4 path in 4b's database: agg_group with the fused kernel off
   and use_pallas_reduce on, cold and 5 warm runs: K4 launched on every
   chunk of each run, rows equal to the K2 path's as PostgreSQL text;
   then K4 alone on a chunk's value matrix (with --k4-parent, beside the
   K4 of another checkout, ints bit-equal for both);
5. a 2^14-row table, a 2^14-row t0 with NULLs and NaN, and small join
   tables (inner, left, full, residual ON, a non-unique build, nloops, a
   post-join qual, fused and pregrouped aggregates) through the device
   path and the host-exact tier: equal rows;
6. timings (cold and warm queries, each kernel alone, its plain version,
   its bound and, where one exists, the single PyTorch call computing
   the same function, at the main path's shapes; K1 at the flagship chunk,
   K2 at the agg_group chunk for G in K2_TIMED_G and K4 at that chunk's
   value matrix for G in K4_TIMED_G and at corr's value matrix of as many
   rows at G = 2048, each with its launch plan), each
   beside the card's name and power limit; then the card line, the
   kernels' JSON line and, last, the `ok` line.
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


def _log_sass_atomics(so: str) -> dict:
    """The atomic instructions each kernel of the library compiled to
    (cuobjdump -sass), by kernel: a 64-bit or float shared-memory add that
    is a compare-and-swap loop shows as ATOMS.CAS / ATOMS.CAST.SPIN, a
    native one as ATOMS.ADD; the global flushes as REDG (a float one
    with .FTZ flushes subnormals: onehot_accum.cuh's shadow adds)."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("SASS atomics: cuobjdump not found")
    r = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                       timeout=300)
    fn, found = None, collections.OrderedDict()
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            found.setdefault(fn, collections.Counter())
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)",
                      line)
        if m and fn is not None:
            found[fn][m.group(1)] += 1
    out = {}
    for fn, ops in found.items():   # a template's instances: summed
        short = next((k for k in ("k1_kernel", "k2_kernel", "k3_kernel",
                                  "k4_kernel") if k in fn), fn)
        out.setdefault(short, collections.Counter()).update(ops)
    for short, ops in out.items():
        _log(f"SASS atomics {short}: "
             f"{dict(sorted(ops.items())) if ops else 'none'}")
    return {k: dict(v) for k, v in out.items()}


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
    if name in ("nan_or_not_isnull", "g8_nan"):
        x[rng.random(n) < 0.01] = np.float32("nan")
    lo, hi = KEY_SPAN.get(name, (5, 21))
    cols = {
        "k": cn(T.INT4, rng.integers(lo, hi, n, dtype=np.int32), nulls(0.1)),
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
    if name == "all_kinds" or name in KEY_SPAN:
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
# K1 at the edges of its launch plan: all_kinds' aggregates over key spans
# that give G = 8 (not a multiple of 16, NaN in the float shadow), 128 and
# 256
KEY_SPAN = {"g8_nan": (-3, 3), "g128": (0, 100), "g256": (-60, 150)}
KERNEL_EDGE_CASES = tuple(KEY_SPAN)


def _device_cols(table, dev):
    import torch
    return tuple((torch.from_numpy(c.data).to(dev),
                  torch.from_numpy(c.valid).to(dev))
                 for c in table.columns.values())


def _run_both(plan, kpred, cols, nrows, grid=None):
    """(kernel ints, shadow), (plain ints, shadow) on the same planes."""
    from pg_strom_tpu_torch.ops.preagg_fused2 import (
        _kernel_planes, fused2_cuda, fused2_reference)
    scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
            "f4e": plan.f4e}
    planes = _kernel_planes(plan.sig, cols)
    k = fused2_cuda(plan.sig, planes, nrows, scal, plan.G, kpred, grid=grid)
    p = fused2_reference(plan.sig, planes, nrows, scal, plan.G, kpred)
    return k, p, planes, scal


def _replay(aggs, slotr, exps, shadow_cols, int_map=None, S=0):
    """f(ints, shadow) -> the host's replay decision (mxu_overflow) on one
    kernel output: ints in recipe order, or physical columns that int_map
    ((recipe col, physical col, multiplier)) maps into S recipe columns;
    shadow_cols picks the shadow columns in recipe order."""
    import numpy as np
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_overflow
    exps = np.asarray(exps.cpu() if hasattr(exps, "cpu") else exps)

    def decide(ints, shadow) -> bool:
        iv = ints.cpu().numpy()
        if int_map is not None:
            sums = np.zeros((iv.shape[0], S), np.int64)
            for rc, pc, m in int_map:
                sums[:, rc] += iv[:, pc] * m
            iv = sums
        fs = shadow[:, list(shadow_cols)].double().cpu().numpy()
        return mxu_overflow({"mxu_sums": iv, "mxu_fsums": fs,
                             "mxu_f4exps": exps}, slotr, aggs)
    return decide


def _compare(plan, aggs, kpred, cols, nrows, grid=None) -> int:
    """max |kernel - plain| over ints (0 required) after checking the
    host-replay decision; raises on disagreement."""
    import torch
    (ki, ks), (pi, ps), _, _ = _run_both(plan, kpred, cols, nrows, grid)
    torch.cuda.synchronize()
    err = int((ki - pi).abs().max().item()) if ki.numel() else 0
    if not torch.equal(ki, pi):
        raise AssertionError(f"K1 ints differ from the plain version (max "
                             f"abs diff {err})")
    decide = _replay(aggs, plan.recipes, plan.f4e,
                     [pc for _, pc in plan.sig.shadow_map], plan.sig.int_map,
                     plan.sig.S)
    if decide(ki, ks) != decide(pi, ps):
        raise AssertionError("K1 and the plain version disagree on host "
                             "replay")
    return err


def _k1_plan(t, name, pred, groups, aggs):
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.datastore import column_stats
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.preagg_fused2 import derive_v2_plan
    cols_host = [t.columns[nm] for nm in t.column_names]
    for col in cols_host:
        column_stats(col)
    schema = schema_from_chunk_columns(t.column_names, cols_host)
    with override(use_preagg_int8=(name != "flagship_int8_off")):
        plan = derive_v2_plan(cols_host, schema, groups, aggs, pred,
                              max_g=4096)
    if plan is None:
        raise AssertionError(f"case {name}: no v2 plan")
    return plan


def phase_kernels(seed: int, log2n: int) -> int:
    import numpy as np
    import torch
    from pg_strom_tpu_torch.ops.launch_plan import plan_launch
    from pg_strom_tpu_torch.ops.preagg_fused2 import lower_program
    N = 1 << log2n
    nrows = N - 37
    dev = torch.device("cuda")
    worst = 0
    for i, name in enumerate(KERNEL_CASES + KERNEL_EDGE_CASES):
        rng = np.random.default_rng(seed * 1000 + i)
        t = _case_table(name, rng, N)
        pred, groups, aggs = _case_query(name, _cols(t))
        plan = _k1_plan(t, name, pred, groups, aggs)
        prog = lower_program(plan.sig, pred)
        n_sh = len(plan.sig.shadow_map)
        cols = _device_cols(t, dev)
        worst = max(worst, _compare(plan, aggs, pred, cols, nrows))
        lp = plan_launch(plan.G, plan.sig.ncols, n_sh, 0)
        _log(f"kernel case {name}: G={plan.G} K={plan.sig.ncols} "
             f"ops={len(prog.ops)} pred_ops={len(prog.pred)} "
             f"i8={plan.sig.i8} shadow={bool(plan.sig.shadow_map)} "
             f"block={lp.block} column_tiles={lp.ntiles} smem~{lp.smem} B: "
             "ints bit-equal to the plain version")
        del t, cols
        torch.cuda.empty_cache()
    worst = max(worst, k1_exact_window(dev, log2n))
    return worst


def _exact_window_rows(log2n: int) -> int:
    """Rows of the exactness-window cases: past the s32 flush of one
    block (2^23 rows) at full size."""
    return (1 << 24) + 3 if log2n >= 20 else (1 << log2n) + 3


def k1_exact_window(dev, log2n: int) -> int:
    """K1 with every row in one bucket and u32 limbs of 0xFFFFFFFF (digit
    255) on a grid of 1 and 2 blocks: at full size one block sums more
    rows than an s32 cell holds (2^23) and must flush it."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import Table, column_from_numpy as cn
    n = _exact_window_rows(log2n)
    z = np.full(n, (1 << 31) - 1, np.int32)
    z[0] = -(1 << 31)                       # v - min = 2^32 - 1 elsewhere
    t = Table.from_columns("t", {"k": cn(T.INT4, np.full(n, 7, np.int32)),
                                 "z": cn(T.INT4, z)})
    c = _cols(t)
    aggs = [_agg("sum", c["z"]), _agg("count", None)]
    plan = _k1_plan(t, "exact_window", None, [c["k"]], aggs)
    cols = _device_cols(t, dev)
    worst = 0
    for grid in (1, 2):
        worst = max(worst, _compare(plan, aggs, None, cols, n, grid))
    _log(f"kernel case exact_window: {n} rows in one bucket, digits 255, "
         f"G={plan.G} K={plan.sig.ncols}, grids 1 and 2: ints bit-equal to "
         "the plain version")
    return worst


# ---------------------------------------------------------------------------
# phase 3b: K2 and K4 against their plain versions
# ---------------------------------------------------------------------------

K2_CASES = ("agg_group", "two_hashed_int4", "int8_timestamp_keys",
            "float4_nan_inf_null", "corr_covar", "g2048_tiling",
            "all_null_group")
# K2 at the edges of its launch plan: (name, K2_CASES data, G).  G = 40 is
# no multiple of 16 (NaN and inf in the shadows), 128 is star_group's G,
# corr's K = 114 fits one column tile at G = 32 and takes column tiles at
# G = 2048
K2_EDGE_CASES = (("g40_nan_inf", "float4_nan_inf_null", 40),
                 ("g128", "two_hashed_int4", 128),
                 ("g256", "two_hashed_int4", 256),
                 ("g32_corr", "corr_covar", 32),
                 ("g2048_corr_tiles", "corr_covar", 2048))


# K4 at the edges of its launch plan: (name, _k2_case data, G).  G = 40 is
# no multiple of 16 (NaN and inf in the shadows), 256 and 1024 one column
# tile each, corr's wide value matrix in column tiles at G = 2048, and a
# matrix wider than K2 takes (twelve float8 sums) at G = 1 and 2048
K4_EDGE_CASES = (("g40_nan_inf", "float4_nan_inf_null", 40),
                 ("g256", "two_hashed_int4", 256),
                 ("g1024", "two_hashed_int4", 1024),
                 ("g2048_corr_tiles", "corr_covar", 2048),
                 ("g1_wide", "twelve_float8_sums", 1),
                 ("g2048_wide_tiles", "twelve_float8_sums", 2048))


def _dval(t, data, valid, dev):
    import torch
    from pg_strom_tpu_torch.expr.lower_torch import DVal
    return DVal(t, torch.from_numpy(data).to(dev),
                torch.from_numpy(valid).to(dev))


def _inst(name, *types):
    from pg_strom_tpu_torch.expr.ir import ColumnRef
    from pg_strom_tpu_torch.ops.preagg import AggInstance, lookup_agg
    d, fam = lookup_agg(name, types)
    return AggInstance(aggname=name, family=fam, slots=d.slots,
                       args=tuple(ColumnRef(type=t, name=f"a{i}", index=i)
                                  for i, t in enumerate(types)))


def _k2_case(name: str, rng, N: int, dev, G_to=None):
    """(keys, aggs, arg vals, mask, seg ids, G, dense) of one K2 case:
    DVals on the card, bucket ids as the strategy computes them; `G_to`
    folds the buckets into G_to of them (seg % G_to)."""
    import torch
    case = _k2_case_at(name, rng, N, dev)
    if G_to is None:
        return case
    keys, aggs, vals, mask, seg, G, dense = case
    seg = torch.where(seg < G, seg % G_to, torch.full_like(seg, G_to))
    return keys, aggs, vals, mask, seg, G_to, dense


def _k2_case_at(name: str, rng, N: int, dev):
    import numpy as np
    import torch
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.ops.preagg import _bucket_ids

    def nulls(p):
        return rng.random(N) > p

    def f8(scale=100.0, p=0.0):
        return _dval(T.FLOAT8, rng.random(N) * scale, nulls(p), dev)

    mask = torch.from_numpy(nulls(0.01)).to(dev)
    if name in ("agg_group", "g2048_tiling"):
        G = 32 if name == "agg_group" else 2048
        span = 26 if name == "agg_group" else 2000
        key = _dval(T.TEXT, rng.integers(0, span, N, dtype=np.int32),
                    np.ones(N, np.bool_), dev)
        x, y = f8(), f8()
        aggs = [_inst("count"), _inst("sum", T.FLOAT8),
                _inst("avg", T.FLOAT8)]
        kd = key.data.to(torch.int64)
        seg = torch.where(mask, (kd - kd.min()).to(torch.int32),
                          torch.full_like(key.data, G))
        return [key], aggs, [[], [x], [y]], mask, seg, G, True
    G = 1024
    if name == "two_hashed_int4":
        keys = [_dval(T.INT4, rng.integers(-3, 40, N, dtype=np.int32),
                      nulls(0.05), dev),
                _dval(T.INT4, rng.integers(1, 9, N, dtype=np.int32) * 1000003,
                      np.ones(N, np.bool_), dev)]
        z = _dval(T.INT4, rng.integers(-(1 << 31), (1 << 31) - 1, N,
                                       dtype=np.int32), nulls(0.1), dev)
        aggs, vals = [_inst("sum", T.INT4), _inst("stddev", T.INT4)], [[z], [z]]
    elif name == "int8_timestamp_keys":
        base = np.asarray([0, -1, 1 << 62, -(1 << 62), 123456789012345678],
                          np.int64)
        keys = [_dval(T.INT8, base[rng.integers(0, 5, N)], nulls(0.05), dev),
                _dval(T.TIMESTAMP, rng.integers(0, 4, N) * 86400_000_000 * 30,
                      np.ones(N, np.bool_), dev)]
        y = _dval(T.INT8, rng.integers(-(1 << 40), 1 << 40, N), nulls(0.1),
                  dev)
        aggs, vals = [_inst("sum", T.INT8), _inst("count", T.INT8)], [[y], [y]]
    elif name == "float4_nan_inf_null":
        x = ((rng.random(N) - 0.5) * 1e3).astype(np.float32)
        x[rng.random(N) < 0.001] = np.nan
        x[rng.random(N) < 0.001] = np.inf
        keys = [_dval(T.INT4, rng.integers(0, 50, N, dtype=np.int32),
                      np.ones(N, np.bool_), dev)]
        xv = _dval(T.FLOAT4, x, nulls(0.2), dev)
        aggs, vals = [_inst("sum", T.FLOAT4), _inst("count", T.FLOAT4)], \
            [[xv], [xv]]
    elif name == "corr_covar":
        keys = [_dval(T.INT4, rng.integers(0, 50, N, dtype=np.int32),
                      np.ones(N, np.bool_), dev)]
        # corr: five float8 blocks (sum_x, sum_y, sum_xy, sumsq_x,
        # sumsq_y), 114 columns, the widest plan K2 takes
        x, y = f8(10.0, 0.1), f8(-50.0, 0.1)
        aggs, vals = [_inst("corr", T.FLOAT8, T.FLOAT8)], [[x, y]]
    elif name == "twelve_float8_sums":
        # K4 only: a value matrix of 12 float8 sum blocks (12 shadows),
        # wider than the 128 columns K2 takes
        keys = [_dval(T.INT4, rng.integers(0, 50, N, dtype=np.int32),
                      np.ones(N, np.bool_), dev)]
        vals = [[f8(10.0 ** (i % 4), 0.1)] for i in range(12)]
        aggs = [_inst("sum", T.FLOAT8) for _ in vals]
    else:                                            # all_null_group
        k = rng.integers(0, 20, N, dtype=np.int32)
        keys = [_dval(T.INT4, k, np.ones(N, np.bool_), dev)]
        y = _dval(T.INT8, rng.integers(-(1 << 50), 1 << 50, N), k != 7, dev)
        aggs, vals = [_inst("sum", T.INT8), _inst("count", T.INT8)], [[y], [y]]
    seg = _bucket_ids(keys, mask, 0x9E3779B97F4A7C15, G)
    return keys, aggs, vals, mask, seg, G, False


def _k2_compare(name, keys, aggs, vals, mask, seg, G, n, dense,
                grid=None):
    """(max |kernel - plain| over ints, plan, lanes) after requiring
    bit-equal ints and the same replay decision."""
    import torch
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_recipes
    kts = [k.t for k in keys]
    ats = [tuple(v.t for v in vs) for vs in vals]
    plan, S = pf._plan_cached(tuple(kts), tuple(tuple(a.slots) for a in aggs),
                              tuple(ats), True, dense)
    if plan is None:
        raise AssertionError(f"K2 case {name}: no fused plan")
    inputs, scales, exps = pf.encode_lanes(keys, aggs, vals, mask, plan,
                                           dense)
    sc = torch.stack(scales).float() if scales else torch.zeros(
        1, device=mask.device)
    seg = seg.to(torch.int32).contiguous()
    ki, ks = pf.fused_cuda(plan, seg, inputs, sc, G, n, grid=grid)
    ri, rs = pf.fused_reference(plan, seg, inputs, sc, G, n)
    torch.cuda.synchronize()
    err = int((ki - ri).abs().max().item())
    if not torch.equal(ki, ri):
        raise AssertionError(f"K2 case {name}: ints differ from the plain "
                             f"version (max abs diff {err})")
    _, slotr, _ = mxu_recipes(kts, aggs, ats, dense_key=dense)
    decide = _replay(aggs, slotr, torch.stack(exps) if exps else
                     torch.zeros(0, dtype=torch.int32),
                     [pc for _, pc in plan.shadow_map], plan.int_map, S)
    dec = [decide(ki, ks), decide(ri, rs)]
    if dec[0] != dec[1]:
        raise AssertionError(f"K2 case {name}: replay decisions differ")
    return err, plan, (inputs, sc, seg), dec[0]


def _k4_inputs(keys, aggs, vals, mask, dense):
    """(V, shadow columns, replay decision) of one case's value matrix."""
    from pg_strom_tpu_torch.ops.preagg_mxu import (build_mxu_columns,
                                                   mxu_recipes,
                                                   mxu_shadow_cols)
    V, exps = build_mxu_columns(keys, aggs, vals, mask, mask.shape[0],
                                dense_key=dense)
    _, slotr, _ = mxu_recipes([k.t for k in keys], aggs,
                              [tuple(v.t for v in vs) for vs in vals],
                              dense_key=dense)
    fc = mxu_shadow_cols(slotr)
    return V, fc, _replay(aggs, slotr, exps, fc)


def _k4_check(name, V, seg, G, n, fc, decide, grid=None) -> int:
    """max |kernel - plain| over ints after requiring bit-equal ints and
    the same replay decision (`decide` None: shadows to rel 1e-4 instead,
    NaN and inf in place)."""
    import torch
    from pg_strom_tpu_torch.ops import preagg_pallas as pp
    seg = seg.to(torch.int32).contiguous()
    ki, ks = pp.pallas_cuda(V, seg, G, n, fc, grid=grid)
    ri, rs = pp.pallas_reduce_reference(V, seg, G, n, fc)
    torch.cuda.synchronize()
    err = int((ki - ri).abs().max().item())
    if not torch.equal(ki, ri):
        raise AssertionError(f"K4 case {name} G={G}: ints differ from the "
                             f"plain version (max abs diff {err})")
    if decide is None:
        same = torch.allclose(ks, rs, rtol=1e-4, atol=1e-3, equal_nan=True)
    else:
        same = decide(ki, ks) == decide(ri, rs)
    if not same:
        raise AssertionError(f"K4 case {name} G={G}: shadows differ")
    return err


def _k4_compare(name, keys, aggs, vals, mask, seg, G, n, dense, grid=None):
    """(max |kernel - plain| over ints, S) of K4 on one case's value
    matrix: ints bit-equal, the same replay decision."""
    V, fc, decide = _k4_inputs(keys, aggs, vals, mask, dense)
    return _k4_check(name, V, seg, G, n, fc, decide, grid), V.shape[1]


def _k4_log_plan(name: str, G: int, S: int, n_sh: int, extra: str) -> None:
    from pg_strom_tpu_torch.ops.preagg_pallas import k4_plan
    lp = k4_plan(G, S, n_sh)
    _log(f"K4 case {name}: G={G} S={S} shadows={n_sh} block={lp.block} "
         f"column_tiles={lp.ntiles} smem~{lp.smem} B: {extra}")


def k4_exact_window(dev, log2n: int) -> int:
    """K4 with every row in one bucket of G = 32 at digits 255 and -255
    (and a float shadow) on a grid of 1 and 2 blocks: at full size one
    block sums more rows than an s32 cell holds (2^23) and must flush it."""
    import torch
    n = _exact_window_rows(log2n)
    row = torch.tensor([255.0, -255.0, 1.0, 0.5, 255.0], dtype=torch.bfloat16,
                       device=dev)
    V = row.expand(n, -1).contiguous()
    seg = torch.full((n,), 3, dtype=torch.int32, device=dev)
    worst = 0
    for grid in (1, 2):
        worst = max(worst, _k4_check("exact_window", V, seg, 32, n, [3],
                                     None, grid))
    _k4_log_plan("exact_window", 32, 5, 1, f"{n} rows in one bucket, digits "
                 "+-255, grids 1 and 2: ints bit-equal to the plain version")
    return worst


def k4_nonfinite(dev, rng, n: int) -> int:
    """K4 on a value matrix with inf, -inf, NaN and digits past [-255, 255]
    in its integer columns (build_mxu_columns makes such cells for an inf
    input): ints bit-equal to the plain version's saturating int64 sums."""
    import numpy as np
    import torch
    S, G = 12, 40
    V = rng.integers(-255, 256, (n, S)).astype(np.float32)
    fc = [3, 9]
    V[:, fc] = rng.random((n, 2)) * 100.0
    V[rng.random(n) < 0.001, 9] = np.nan
    V[rng.random(n) < 0.001, 3] = np.inf
    icol = [c for c in range(S) if c not in fc]
    for v in (np.inf, -np.inf, np.nan, 300.0, -1000.0):
        hit = rng.random((n, len(icol))) < 0.0005
        V[:, icol] = np.where(hit, v, V[:, icol])
    Vt = torch.from_numpy(V).to(dev).to(torch.bfloat16)
    seg = torch.from_numpy(rng.integers(0, G + 1, n).astype(np.int32)).to(dev)
    err = _k4_check("nonfinite_ints", Vt, seg, G, n - 37, fc, None)
    _k4_log_plan("nonfinite_ints", G, S, 2, f"{n - 37} rows, inf/NaN/+-1000 "
                 "in integer cells: ints bit-equal to the plain version")
    return err


def k4_shape_gate(dev, n: int) -> None:
    """mxu_reduce under use_pallas_reduce at G = 2048: with 25 float
    shadows K4 cannot plan the shape (k4_fits), so the call takes the
    plain path, bit-equal to the flag off, K4 launches no time and
    `k4_shape_routed` counts 1; with 24 shadows K4 launches once."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.ops import preagg_pallas as pp
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_reduce
    from pg_strom_tpu_torch.utils.perfmon import Perfmon, active
    G = 2048
    g = torch.Generator(device=dev).manual_seed(2048)
    for n_sh in (25, 24):
        S = 20 * n_sh + 1
        fc = list(range(0, S - 1, 20))
        V = torch.randint(-255, 256, (n, S), device=dev, generator=g,
                          dtype=torch.int32).to(torch.bfloat16)
        V[:, fc] = (torch.rand(n, n_sh, device=dev, generator=g)
                    * 1e4).to(torch.bfloat16)
        seg = torch.randint(0, G + 1, (n,), device=dev, generator=g,
                            dtype=torch.int32)
        with override(use_pallas_reduce=False):
            want = mxu_reduce(V, seg, G, n, fc)
        pm = Perfmon()
        before = pp.pallas_cuda.launches
        with override(use_pallas_reduce=True), active(pm):
            got = mxu_reduce(V, seg, G, n, fc)
        torch.cuda.synchronize()
        k4 = pp.pallas_cuda.launches - before
        routed = pm.counts.get("k4_shape_routed", 0)
        ints = [c for c in range(S) if c not in fc]
        if not torch.equal(got[0][:, ints], want[0][:, ints]):
            raise AssertionError(f"K4 gate, {n_sh} shadows: ints differ "
                                 "from the plain path")
        if n_sh == 25 and (k4 or routed != 1 or not torch.equal(got[1],
                                                                 want[1])):
            raise AssertionError(f"K4 gate, 25 shadows: K4 launched {k4}, "
                                 f"k4_shape_routed {routed}")
        if n_sh == 24 and (k4 != 1 or routed):
            raise AssertionError(f"K4 gate, 24 shadows: K4 launched {k4}, "
                                 f"k4_shape_routed {routed}")
        _log(f"K4 gate: mxu_reduce with use_pallas_reduce, G={G} S={S} "
             f"shadows={n_sh}, {n} rows: K4 launches {k4}, "
             f"k4_shape_routed {routed}, ints bit-equal to the plain path")
        del V, want, got


def _k2_shadows(plan) -> int:
    return sum(op[0] in ("fabs", "f32") for op in plan.ops)


def phase_kernels_k2k4(seed: int, log2n: int) -> int:
    import numpy as np
    import torch
    from pg_strom_tpu_torch.ops.launch_plan import plan_launch
    N = 1 << log2n
    n = N - 37
    dev = torch.device("cuda")
    worst = 0
    cases = [(nm, nm, None) for nm in K2_CASES] + list(K2_EDGE_CASES)
    for i, (name, data, G_to) in enumerate(cases):
        case = _k2_case(data, np.random.default_rng(seed * 1000 + 100 + i),
                        N, dev, G_to)
        G = case[5]
        err, plan, _, replay = _k2_compare(name, *case[:6], n, case[6])
        worst = max(worst, err)
        lp = plan_launch(G, plan.ncols, _k2_shadows(plan), 0)
        _log(f"K2 case {name}: G={G} K={plan.ncols} inputs={plan.n_inputs} "
             f"block={lp.block} column_tiles={lp.ntiles} smem~{lp.smem} B "
             f"replay={replay} ints bit-equal to the plain version")
        del case
    worst = max(worst, k2_exact_window(dev, log2n))
    cases = [(f"{nm}_g{g}", nm, g) for nm in ("agg_group", "two_hashed_int4")
             for g in (32, 2048)] + list(K4_EDGE_CASES)
    for i, (name, data, G) in enumerate(cases):
        keys, aggs, vals, mask, seg, G, dense = _k2_case(
            data, np.random.default_rng(seed * 1000 + 300 + i), N, dev, G)
        V, fc, decide = _k4_inputs(keys, aggs, vals, mask, dense)
        worst = max(worst, _k4_check(name, V, seg, G, n, fc, decide))
        _k4_log_plan(name, G, V.shape[1], len(fc), "ints bit-equal to the "
                     "plain version, the same replay decision")
        del V
    worst = max(worst, k4_exact_window(dev, log2n))
    worst = max(worst, k4_nonfinite(dev, np.random.default_rng(seed + 9), N))
    k4_shape_gate(dev, min(N, 1 << 18))
    torch.cuda.empty_cache()
    return worst


def k2_exact_window(dev, log2n: int) -> int:
    """K2 with every row in one bucket of G = 32: a hashed int4 key of
    2^31 - 1 (key word 0xFFFFFFFF) and sum(int8) of -1 (limb words
    0xFFFFFFFF and 0x7FFFFFFF), digits 255, on a grid of 1 and 2 blocks
    (see k1_exact_window)."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch import T
    n = _exact_window_rows(log2n)
    ones = np.ones(n, np.bool_)
    keys = [_dval(T.INT4, np.full(n, (1 << 31) - 1, np.int32), ones, dev)]
    y = _dval(T.INT8, np.full(n, -1, np.int64), ones, dev)
    aggs, vals = [_inst("sum", T.INT8), _inst("count", T.INT8)], [[y], [y]]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    seg = torch.full((n,), 3, dtype=torch.int32, device=dev)
    worst = 0
    for grid in (1, 2):
        err, plan, _, _ = _k2_compare("exact_window", keys, aggs, vals, mask,
                                      seg, 32, n, False, grid)
        worst = max(worst, err)
    _log(f"K2 case exact_window: {n} rows in one bucket, digits 255, G=32 "
         f"K={plan.ncols}, grids 1 and 2: ints bit-equal to the plain "
         "version")
    return worst


# ---------------------------------------------------------------------------
# phase 3c: K3 against its plain version
# ---------------------------------------------------------------------------

K3_CASES = tuple((D, K) for D in (100, 2048, 40960, 65536) for K in (1, 2, 4))


def k3_compare(rng, D: int, K: int, n: int) -> int:
    """K3 on a random D-slot table of K-digit values (padded with a
    sentinel) against its plain version, over n indexes that include 0,
    D-1, the padding slots and indexes outside the table; returns the max
    |kernel - plain| and raises unless it is 0."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    dev = torch.device("cuda")
    sent = (1 << min(8 * K, 31)) - 1
    vals = torch.from_numpy(rng.integers(0, 1 << (8 * K), D,
                                         dtype=np.int64)).to(dev)
    table = ml.encode_table_torch(vals, D, K, pad_value=sent)
    slots = table.shape[0]
    idx = rng.integers(0, D, n).astype(np.int32)
    edge = np.asarray([0, D - 1, D, slots - 1, -1, slots, 1 << 30],
                      np.int32)
    idx[:edge.shape[0]] = edge
    idx = torch.from_numpy(idx).to(dev)
    k = ml.mxu_lookup_cuda(idx, table, n, sent)
    p = ml.mxu_lookup_reference(idx, table, n, sent)
    torch.cuda.synchronize()
    err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max().item())
    if not torch.equal(k, p):
        raise AssertionError(f"K3 D={D} K={K}: differs from the plain "
                             f"version (max abs diff {err})")
    return err


def phase_kernels_k3(seed: int, log2n: int) -> int:
    import numpy as np
    worst = 0
    for i, (D, K) in enumerate(K3_CASES):
        worst = max(worst, k3_compare(
            np.random.default_rng(seed * 1000 + 200 + i), D, K, 1 << log2n))
        _log(f"K3 case D={D} K={K}: {1 << log2n} lookups bit-equal to the "
             "plain version (edges, padding and out-of-range included)")
    return worst


K5_CASES = ("q1_1", "mixed", "q1_1_overflow", "ranges_wide_key")
K5_ROWS = (1, 4099, 1 << 26)
K5_ERR = {"q1_1": 0, "mixed": 0, "q1_1_overflow": 4,   # ERR_INT4_OVERFLOW
          "ranges_wide_key": 0}


def _ssb_datekeys():
    """SSB's date table: yyyymmdd keys of the 2556 days from 1992-01-01."""
    import numpy as np
    day = np.datetime64("1992-01-01") + np.arange(2556)
    y = day.astype("datetime64[Y]").astype(np.int64) + 1970
    m = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (day - day.astype("datetime64[M]")).astype(np.int64) + 1
    return (y * 10000 + m * 100 + d).astype(np.int32), y


def _k5_case(name: str, rng, n: int, cap: int, dev):
    """(program, planes, membership table) of one K5 case over `cap`-row
    planes whose first n rows are live (the rows past n are drawn like
    the rest, so counting one would show).

    q1_1: SSB Q1.1 on lineorder's four int4 columns (orderdate over 7
    years, discount 0..10, quantity 1..50, extendedprice up to 10.5M)
    joined to the dates of 1993 (a 16384-slot window, as the executor
    sizes it for the 2556-row date table): discount between 1 and 3 and
    quantity < 25, sum(extendedprice * discount).  q1_1_overflow: row 0
    joins and passes with extendedprice 2^30 (the product leaves int4).
    mixed: NULLs in the key, an int2 and an int4 argument column, a
    float4 predicate column with NaN and a bool column: (f > 0.5 or bl)
    and not (a is null); count(*), sum(s * s2 + a), sum(a - 3),
    count(a).  ranges_wide_key: keys up to 2^31 - 1 with kmin above
    2^31 - dcap (the 64-bit offset test) and keys near -2^31, a nullable
    range column: a between 10 and 500 and 7 = b and a <> 300 and
    -5 < b; sum(a), sum(b)."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch.expr.ir import (BoolExpr, ColumnRef, Const,
                                            FuncExpr, NullTest)
    from pg_strom_tpu_torch.expr.lower_torch import ColMeta
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    from pg_strom_tpu_torch.ops.preagg import AggInstance
    from pg_strom_tpu_torch.sqltypes import T

    def col(t, name, i):
        return ColumnRef(t, name, i)

    def fn(name, t, *args):
        return FuncExpr(t, name, tuple(args))

    def dev_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if name in ("q1_1", "q1_1_overflow"):
        keys, year = _ssb_datekeys()
        od = keys[rng.integers(0, keys.shape[0], cap)]
        disc = rng.integers(0, 11, cap).astype(np.int32)
        qty = rng.integers(1, 51, cap).astype(np.int32)
        ext = (qty * rng.integers(90000, 209901, cap)).astype(np.int32)
        if name == "q1_1_overflow":
            od[0], disc[0], qty[0], ext[0] = keys[year == 1993][5], 2, 10, \
                1 << 30
        schema = [ColMeta(c, T.INT4) for c in ("od", "disc", "qty", "ext")]
        od_, disc_, qty_, ext_ = (col(T.INT4, c.name, i)
                                  for i, c in enumerate(schema))
        pred = BoolExpr(T.BOOL, "and", (
            fn(">=::int4,int4", T.BOOL, disc_, Const(T.INT4, 1)),
            fn("<=::int4,int4", T.BOOL, disc_, Const(T.INT4, 3)),
            fn("<::int4,int4", T.BOOL, qty_, Const(T.INT4, 25))))
        aggs = [AggInstance("sum", "i4", ("count", "sum_i"),
                            (fn("*::int4,int4", T.INT4, ext_, disc_),))]
        cols = [(od, None), (disc, None), (qty, None), (ext, None)]
        build = keys[year == 1993]
        kmin, dcap = int(build.min()), 16384
    elif name == "ranges_wide_key":
        kmin, dcap = (1 << 31) - 700, 1024
        k = rng.integers(kmin - 300, 1 << 31, cap, dtype=np.int64)
        k[rng.random(cap) < 0.1] = -(1 << 31)
        k = k.astype(np.int32)
        a = rng.integers(0, 600, cap).astype(np.int32)
        b = rng.integers(0, 12, cap).astype(np.int32)
        schema = [ColMeta("k", T.INT4), ColMeta("a", T.INT4),
                  ColMeta("b", T.INT4)]
        k_, a_, b_ = (col(T.INT4, c.name, i) for i, c in enumerate(schema))
        pred = BoolExpr(T.BOOL, "and", (
            fn(">=::int4,int4", T.BOOL, a_, Const(T.INT4, 10)),
            fn("<=::int4,int4", T.BOOL, a_, Const(T.INT4, 500)),
            fn("=::int4,int4", T.BOOL, Const(T.INT4, 7), b_),
            fn("<>::int4,int4", T.BOOL, a_, Const(T.INT4, 300)),
            fn("<::int4,int4", T.BOOL, Const(T.INT4, -5), b_)))
        aggs = [AggInstance("sum", "i4", ("count", "sum_i"), (a_,)),
                AggInstance("sum", "i4", ("count", "sum_i"), (b_,))]
        cols = [(k, rng.random(cap) > 0.05), (a, rng.random(cap) > 0.1),
                (b, None)]
        build = kmin + np.flatnonzero(rng.random(700) < 0.6)
    else:
        k = rng.integers(0, 100, cap).astype(np.int32)
        s = rng.integers(-150, 151, cap).astype(np.int16)
        s2 = rng.integers(-200, 201, cap).astype(np.int16)
        f = rng.random(cap).astype(np.float32)
        f[rng.random(cap) < 0.05] = np.nan
        bl = rng.random(cap) < 0.3
        a = rng.integers(0, 1001, cap).astype(np.int32)
        schema = [ColMeta("k", T.INT4), ColMeta("s", T.INT2),
                  ColMeta("s2", T.INT2), ColMeta("f", T.FLOAT4),
                  ColMeta("bl", T.BOOL), ColMeta("a", T.INT4)]
        k_, s_, s2_, f_, bl_, a_ = (col(c.type, c.name, i)
                                    for i, c in enumerate(schema))
        pred = BoolExpr(T.BOOL, "and", (
            BoolExpr(T.BOOL, "or", (
                fn(">::float4,float4", T.BOOL, f_, Const(T.FLOAT4, 0.5)),
                bl_)),
            BoolExpr(T.BOOL, "not", (NullTest(T.BOOL, a_, True),))))
        e1 = fn("+::int4,int4", T.INT4,
                fn("cast::int4", T.INT4, fn("*::int2,int2", T.INT2, s_, s2_)),
                a_)
        aggs = [AggInstance("count", "star", ("nrows",), ()),
                AggInstance("sum", "i4", ("count", "sum_i"), (e1,)),
                AggInstance("sum", "i4", ("count", "sum_i"),
                            (fn("-::int4,int4", T.INT4, a_,
                                Const(T.INT4, 3)),)),
                AggInstance("count", "i4", ("count",), (a_,))]
        cols = [(k, rng.random(cap) > 0.05), (s, rng.random(cap) > 0.1),
                (s2, None), (f, None), (bl, None),
                (a, rng.random(cap) > 0.1)]
        build = np.flatnonzero(rng.random(100) < 0.5).astype(np.int32)
        kmin, dcap = 0, 1024
    nullable = {i for i, (_, v) in enumerate(cols) if v is not None}
    key = ColumnRef(schema[0].type, schema[0].name, 0)
    prog = js.scalar_program(schema, [key], pred, aggs,
                             list(range(len(schema))), nullable.__contains__)
    if prog is None:
        raise AssertionError(f"K5 case {name} is outside the kernel's "
                             "envelope")
    hit = np.zeros(dcap, bool)
    hit[build - kmin] = True
    member = js.member_from_mask(dev_(hit), kmin)
    planes = [dev_(cols[i][0] if plane == "data" else cols[i][1])
              for i, plane in prog.inputs]
    return prog, planes, member


def k5_compare(rng, name: str, n: int, cap: int, dev=None) -> int:
    """K5 against its plain version on the card over one case: the output
    (err, count(*), per argument count and sum) bit-equal, err as the case
    expects, one launch counted; returns the max |kernel - plain|."""
    import torch
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    prog, planes, member = _k5_case(name, rng, n, cap,
                                    dev or torch.device("cuda"))
    before = js.joinagg_scalar_cuda.launches
    k = js.joinagg_scalar_cuda(prog, planes, member, n)
    p = js.joinagg_scalar_reference(prog, planes, member, n)
    torch.cuda.synchronize()
    err = int((k - p).abs().max().item())
    if not torch.equal(k, p):
        raise AssertionError(f"K5 {name} n={n}: {k.tolist()} differs from "
                             f"the plain version's {p.tolist()}")
    if int(k[0]) != K5_ERR[name]:
        raise AssertionError(f"K5 {name} n={n}: err lane {int(k[0])}, "
                             f"expected {K5_ERR[name]}")
    if js.joinagg_scalar_cuda.launches != before + 1:
        raise AssertionError("K5's launch counter did not count the launch")
    return err


def k5_batch_compare(rng, n: int, dev=None) -> int:
    """K5Batch (a launch plan's K5: one parameter block a chunk, one output
    buffer, one read back) over two chunks of Q1.1's four int4 columns,
    against the plain version chunk by chunk, through a run of constants:
    the ranges alone rewritten, a program whose empty `between` keeps a
    predicate clause (in a batch of its own, as the executor makes for
    such a query), the ranges again in the first batch, another year's
    membership table.  Each output bit-equal, each chunk's launch
    counted; returns the number of steps compared."""
    import dataclasses
    import numpy as np
    import torch
    from pg_strom_tpu_torch.expr.ir import BoolExpr, ColumnRef, Const, \
        FuncExpr
    from pg_strom_tpu_torch.expr.lower_torch import ColMeta
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    from pg_strom_tpu_torch.ops.preagg import AggInstance
    from pg_strom_tpu_torch.sqltypes import T
    dev = dev or torch.device("cuda")
    keys, year = _ssb_datekeys()
    rows = [n, n - 3]
    schema = [ColMeta(c, T.INT4) for c in ("od", "disc", "qty", "ext")]
    od_, disc_, qty_, ext_ = (ColumnRef(T.INT4, c.name, i)
                              for i, c in enumerate(schema))

    def program(lo, hi, q):
        pred = BoolExpr(T.BOOL, "and", tuple(
            FuncExpr(T.BOOL, f"{op}::int4,int4", (c, Const(T.INT4, v)))
            for op, c, v in ((">=", disc_, lo), ("<=", disc_, hi),
                             ("<", qty_, q))))
        aggs = [AggInstance("sum", "i4", ("count", "sum_i"), (FuncExpr(
            T.INT4, "*::int4,int4", (ext_, disc_)),))]
        return js.scalar_program(schema, [od_], pred, aggs, [0, 1, 2, 3],
                                 lambda i: False)

    def member(y):
        build = keys[year == y]
        hit = np.zeros(16384, bool)
        hit[build - build.min()] = True
        return js.member_from_mask(torch.from_numpy(hit).to(dev),
                                   int(build.min()))

    p0 = program(1, 3, 25)
    chunks = []                      # each chunk's planes in p0.inputs order
    for _ in rows:
        qty = rng.integers(1, 51, n).astype(np.int32)
        cols = (keys[rng.integers(0, keys.shape[0], n)],
                rng.integers(0, 11, n).astype(np.int32), qty,
                (qty * rng.integers(90000, 209901, n)).astype(np.int32))
        chunks.append([torch.from_numpy(cols[i]).to(dev)
                       for i, _ in p0.inputs])
    batch = js.K5Batch(p0, member(1993), chunks, rows)
    steps = [(p0, 1993),
             (dataclasses.replace(p0, ranges=program(2, 4, 24).ranges), 1993),
             (program(5, 3, 25), 1994),
             (dataclasses.replace(p0, ranges=program(0, 9, 50).ranges), 1998)]
    for prog, y in steps:
        m = member(y)
        if prog.pred.shape == p0.pred.shape:
            batch.set_member(m)
            batch.set_ranges(prog.ranges)
            b = batch
        else:                    # a program of its own: a batch of its own
            b = js.K5Batch(prog, m, chunks, rows)
        before = js.joinagg_scalar_cuda.launches
        b.launch()
        got = b.fetch()
        want = np.stack([js.joinagg_scalar_reference(prog, c, m, r).cpu()
                         .numpy() for c, r in zip(chunks, rows)])
        if not np.array_equal(got, want):
            raise AssertionError(f"K5Batch at {y}, ranges "
                                 f"{prog.ranges.tolist()}: {got.tolist()} "
                                 f"differs from the plain version's "
                                 f"{want.tolist()}")
        if dev.type == "cuda" and \
                js.joinagg_scalar_cuda.launches != before + len(rows):
            raise AssertionError("K5Batch's launches were not counted")
    return len(steps)


def phase_kernels_k5(seed: int, gpu: str) -> dict:
    """K5 against its plain version over K5_CASES at 1, 4099 (in 8192-row
    planes) and 2^26 rows, then timed on a 2^26-row chunk of Q1.1's four
    int4 columns beside its bound and its plain version."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    worst = 0
    for i, name in enumerate(K5_CASES):
        for n in K5_ROWS:
            cap = 8192 if n == 4099 else n
            worst = max(worst, k5_compare(
                np.random.default_rng(seed * 1000 + 300 + i), name, n, cap))
            _log(f"K5 case {name}: {n} rows of {cap} bit-equal to the plain "
                 "version")
    for n in (4100, 1 << 24):
        steps = k5_batch_compare(np.random.default_rng(seed * 1000 + 350),
                                 n)
        _log(f"K5Batch: two chunks of {n} rows, {steps} steps of constants "
             "bit-equal to the plain version")
    n = 1 << 26
    prog, planes, member = _k5_case("q1_1", np.random.default_rng(seed), n,
                                    n, torch.device("cuda"))
    args = js.k5_args(prog, member)
    out = js.joinagg_scalar_cuda(prog, planes, member, n, args)
    launches0 = js.joinagg_scalar_cuda.launches
    p1 = _time(lambda: js.joinagg_scalar_reference(prog, planes, member, n), 3)
    k1 = _time(lambda: js.joinagg_scalar_cuda(prog, planes, member, n, args),
               20)
    k2 = _time(lambda: js.joinagg_scalar_cuda(prog, planes, member, n, args),
               20)
    p2 = _time(lambda: js.joinagg_scalar_reference(prog, planes, member, n), 3)
    if not torch.equal(out, js.joinagg_scalar_reference(prog, planes,
                                                        member, n)):
        raise AssertionError("K5 at the Q1.1 chunk differs from its plain "
                             "version")
    b = _bound(_tensor_bytes(planes), n)
    _log(f"K5 at the Q1.1 chunk ({n} rows, 4 int4 planes, "
         f"{js.joinagg_scalar_cuda.launches - launches0} timed launches) "
         f"[{gpu}]: kernel {k1:.4f} / {k2:.4f} ms, plain PyTorch {p1:.4f} / "
         f"{p2:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
         f"{b['bound_bytes']:.0f} B at 3.35 TB/s; share "
         f"{b['bound_ms'] / min(k1, k2):.3f}); rows {int(out[1])}, sum "
         f"{int(out[3])}")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "err": worst, **b,
            "library_ms": None}


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
    counts = dict(pq.perfmon.counts)
    _log(f"slice: cold query {cold * 1e3:.3f} ms, perfmon {counts}, "
         f"K1 launches {fused2_cuda.launches}")
    if fused2_cuda.launches < 1:
        raise AssertionError("the slice never launched K1")
    for ctr, want in (("device_chunks", n >> 26 if n >= 1 << 26 else 1),
                      ("recheck_chunks", 0), ("unported_host_exact", 0)):
        if counts.get(ctr, 0) != want:
            raise AssertionError(f"perfmon {ctr} = {counts.get(ctr, 0)}, "
                                 f"expected {want}")
    _check_flagship(rows, expected)
    _log("slice: count(x), sum(y) exact and sum(x) within rel 1e-5 of numpy")
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = execute(FLAGSHIP_SQL, db)
        warm.append(time.perf_counter() - t0)
        _check_flagship(res.rows, expected)
    med = statistics.median(warm)
    # the main path's launches: the cold query and the five warm ones
    launches = fused2_cuda.launches
    with override(perfmon=True):
        text = "\n".join(r[0] for r in execute("EXPLAIN ANALYZE " +
                                               FLAGSHIP_SQL, db).rows)
    _log(text)
    timing = {"cold_ms": cold * 1e3, "warm_ms": med * 1e3,
              "warm_all_ms": [w * 1e3 for w in warm],
              "rows_per_s": n / med, "launches": launches}
    _log(f"slice timing [{gpu}]: cold {cold * 1e3:.3f} ms, warm median "
         f"{med * 1e3:.3f} ms of {[round(w * 1e3, 3) for w in warm]}, "
         f"{n / med:.6e} rows/s; K1 launches {launches} (cold and warm "
         "runs)")

    # the kernel alone and its plain version at the main path's chunk shape
    timing.update(_time_chunk(db, gpu))
    return timing


# ---------------------------------------------------------------------------
# phase 4a: SSB Q1.1's shape through the planner
# ---------------------------------------------------------------------------

Q11_SQL = ("select sum(lo_extendedprice * lo_discount) as revenue "
           "from lineorder, date where lo_orderdate = d_datekey "
           "and d_year = 1993 and lo_discount between 1 and 3 "
           "and lo_quantity < 25")
QTY_SQL = ("select count(*), sum(lo_extendedprice) from lineorder, qty "
           "where lo_quantity = q_key and lo_discount between 4 and 6")
# name -> (sql, config, the dense variant its membership table reads)
Q11_CASES = {"q1_1": (Q11_SQL, {}, "K3"),
             "q1_1_plain": (Q11_SQL, {"join_mxu_lookup": False}, "plain"),
             "qty_identity": (QTY_SQL, {}, "identity")}


def q11_db(seed: int, n: int):
    """(Database, numpy columns) of lineorder's four Q1.1 columns at n rows
    with SSB's ranges, SSB's date dimension and qty (q_key 1..40)."""
    import datetime
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    d0 = datetime.date(1992, 1, 1)
    days = [d0 + datetime.timedelta(i)
            for i in range((datetime.date(1999, 1, 1) - d0).days)]
    datekey = np.array([d.year * 10000 + d.month * 100 + d.day
                        for d in days], np.int32)
    year = np.array([d.year for d in days], np.int32)
    rng = np.random.default_rng(seed)
    day = rng.integers(0, len(days), n)
    qty = rng.integers(1, 51, n, dtype=np.int32)
    cols = {"lo_orderdate": datekey[day], "lo_quantity": qty,
            "lo_discount": rng.integers(0, 11, n, dtype=np.int32),
            "lo_extendedprice": (qty * rng.integers(
                90000, 210000, n, dtype=np.int32)).astype(np.int32)}
    db = Database()
    db.create(Table.from_columns("lineorder", {
        c: cn(T.INT4, v) for c, v in cols.items()}))
    db.create(Table.from_columns("date", {"d_datekey": cn(T.INT4, datekey),
                                          "d_year": cn(T.INT4, year)}))
    db.create(Table.from_columns("qty", {
        "q_key": cn(T.INT4, np.arange(1, 41, dtype=np.int32))}))
    return db, dict(cols, d_year=year[day])


def q11_expected(name: str, c) -> list:
    """The rows of Q11_CASES[name] from numpy int64."""
    import numpy as np
    disc, price = c["lo_discount"], c["lo_extendedprice"].astype(np.int64)
    if name == "qty_identity":
        m = (c["lo_quantity"] <= 40) & (disc >= 4) & (disc <= 6)
        return [(int(m.sum()), int(price[m].sum()))]
    m = ((c["d_year"] == 1993) & (disc >= 1) & (disc <= 3)
         & (c["lo_quantity"] < 25))
    return [(int((price[m] * disc[m]).sum()),)]


def q11_run(db, name: str, c, nchunks: int, runs: int) -> dict:
    """Q11_CASES[name] cold and runs - 1 warm through the planner: the
    answer against numpy, every chunk on K5, the membership table built
    from the expected dense variant, K5's launch plan made by the cold
    run and hit by each warm run with one read from the device.  Times,
    launches and the variant seen."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.exec import joinagg_exec as je
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    sql, cfg, variant = Q11_CASES[name]
    want = q11_expected(name, c)
    seen = []
    member_table = je.member_table

    def spy(ht, dcap, use_mxu, row_bits):
        seen.append("identity" if bool(ht["dense_ident"])
                    else "K3" if use_mxu else "plain")
        return member_table(ht, dcap, use_mxu, row_bits)

    TCACHE.clear()
    ms, launches = [], []
    je.member_table = spy
    try:
        for _ in range(runs):
            before = js.joinagg_scalar_cuda.launches
            t0 = time.perf_counter()
            with override(perfmon=True, **cfg):
                pq = plan_query(ast.parse(sql), db)
                rows = pq.execute()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(js.joinagg_scalar_cuda.launches - before)
            counts = dict(pq.perfmon.counts)
            got = [tuple(int(v) for v in r) for r in rows]
            if got != want:
                raise AssertionError(f"4a {name}: {got} != numpy {want}")
            # the cold run makes K5's launch plan, each warm run hits it
            # and reads the device once
            plan = ((("k5_plan_builds", 1), ("k5_plan_hits", 0))
                    if len(ms) == 1 else
                    (("k5_plan_hits", 1), ("d2h_reads", 1)))
            for ctr, n_want in (("joinagg_scalar_chunks", nchunks),
                                ("device_chunks", nchunks),
                                ("recheck_chunks", 0),
                                ("unported_host_exact", 0)) + plan:
                if counts.get(ctr, 0) != n_want:
                    raise AssertionError(
                        f"4a {name}: perfmon {ctr} = {counts.get(ctr, 0)}, "
                        f"expected {n_want}: {counts}")
    finally:
        je.member_table = member_table
    if seen != [variant]:
        raise AssertionError(f"4a {name}: membership tables built from "
                             f"{seen}, expected one from {variant}")
    return {"ms": ms, "launches": launches, "variant": seen[0],
            "rows": want}


def phase_join_scalar(seed: int, log2n: int, gpu: str) -> dict:
    """Q11_CASES through the planner over a 2^log2n-row lineorder."""
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    n = 1 << log2n
    t0 = time.perf_counter()
    db, c = q11_db(seed, n)
    nchunks = -(-n // chunk_capacity(n))
    _log(f"4a: lineorder of {n} rows ({nchunks} chunks) generated in "
         f"{time.perf_counter() - t0:.1f} s")
    kernels = _zero_launches()
    out = {}
    for name in Q11_CASES:
        r = q11_run(db, name, c, nchunks, 4)
        if r["launches"] != [nchunks] * 4:
            raise AssertionError(f"4a {name}: K5 launches {r['launches']} "
                                 f"a run, expected {nchunks}")
        out[name] = r
        _log(f"4a {name} [{gpu}]: {r['rows']} exact against numpy int64; "
             f"membership from the {r['variant']} table; K5 launches "
             f"{r['launches']} and joinagg_scalar_chunks {nchunks} a run; "
             f"cold {r['ms'][0]:.3f} ms, warm "
             f"{[round(m, 3) for m in r['ms'][1:]]} ms")
    out["launches"] = kernels["K5"].launches
    TCACHE.clear()
    return out


def _time_chunk(db, gpu: str) -> dict:
    """K1 and its plain version on the first resident flagship chunk."""
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.expr.ir import Const, resolve_function
    from pg_strom_tpu_torch.expr.lower_torch import schema_from_chunk_columns
    from pg_strom_tpu_torch.ops.launch_plan import plan_launch
    from pg_strom_tpu_torch.ops.preagg_fused2 import (
        derive_v2_plan, fused2_cuda, fused2_reference, _kernel_planes)
    t = db.get("t")
    names = t.column_names
    c = _cols(t)
    # the kernel's form of the SQL predicate (narrow_exact_casts)
    pred = resolve_function(">", (c["x"], Const(type=T.FLOAT4, value=0.25)))
    cols_host = [t.columns[nm] for nm in names]
    aggs = [_agg("sum", c["x"]), _agg("count", c["x"]), _agg("sum", c["y"])]
    plan = derive_v2_plan(cols_host, schema_from_chunk_columns(names,
                                                               cols_host),
                          [c["key"]], aggs, pred, 4096)
    cc = next(iter(TCACHE.chunks_for(t, names, chunk_capacity(t.nrows))))
    scal = {"i": plan.scal_i, "u": plan.scal_u, "f4sc": plan.f4sc,
            "f4e": plan.f4e}
    planes = _kernel_planes(plan.sig, cc.planes)
    G, K = plan.G, plan.sig.ncols
    n_sh = len(plan.sig.shadow_map)
    err = _compare(plan, aggs, pred, cc.planes, cc.nrows)

    def kern():
        return fused2_cuda(plan.sig, planes, cc.nrows, scal, G, pred)

    def plain():
        return fused2_reference(plan.sig, planes, cc.nrows, scal, G, pred)

    # K1 reads its planes once and writes [G, K] int64 sums and the shadow
    # float sums; it does one add per row and column
    b = _bound(_tensor_bytes(planes) + G * K * 12, cc.nrows * K)
    # plain, kernel, kernel, plain on one card
    p1 = _time(plain, 2)
    k1, k2 = _time(kern, 20), _time(kern, 20)
    p2 = _time(plain, 2)
    lp = plan_launch(G, K, n_sh, 0)
    _log(f"K1 at the main-path chunk ({cc.nrows} rows, G={G}, K={K}), block "
         f"{lp.block}, {lp.ntiles} column tile(s), ~{lp.smem} B shared "
         f"memory [{gpu}]: kernel {k1:.4f} / {k2:.4f} ms, plain PyTorch "
         f"{p1:.4f} / {p2:.4f} ms, bound {b['bound_ms']:.4f} ms "
         f"({b['bound_by']}: {b['bound_bytes']:.0f} B, "
         f"{b['bound_ops']:.0f} ops), no single PyTorch call")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "chunk_err": err,
            **b, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 4b: general grouped aggregation over the star-schema fact table t0
# ---------------------------------------------------------------------------

CATS = [c * 3 for c in "abcdefghijklmnopqrstuvwxyz"]
T0_SQL = {
    "agg_group": "select cat, count(*), sum(x), avg(y) from t0 group by cat "
                 "order by cat",
    "rollup": "select cat, cid % 8, count(*), sum(x) from t0 "
              "group by rollup(cat, cid % 8)",
    "filter": "select count(*), sum(x) from t0 where x < 25.0 and y > 10.0",
    "agg_nogrp": "select count(*), sum(x), avg(y) from t0",
}


def _t0_db(seed: int, n: int, nulls: bool = False):
    """A port Database holding t0 as models/testdb.py builds it (26-value
    text code, five int4 FKs in 1..40000, float8 x and y in [0, 100)),
    made in bulk from `seed`; returns (db, numpy columns)."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Column, Database, Table,
                                              column_from_numpy as cn)
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 26, n, dtype=np.int32)
    fks = {f: rng.integers(1, 40001, n, dtype=np.int32)
           for f in ("aid", "bid", "cid", "did", "eid")}
    x = rng.random(n) * 100.0
    y = rng.random(n) * 100.0
    xv = yv = None
    if nulls:
        x[rng.random(n) < 0.01] = np.nan
        xv = rng.random(n) > 0.05
        yv = rng.random(n) > 0.05
    ones = np.ones(n, np.bool_)
    cols = {"id": cn(T.INT4, np.arange(1, n + 1, dtype=np.int32)),
            "cat": Column(type=T.TEXT, data=cat, valid=ones,
                          dictionary=list(CATS))}
    cols.update({f: cn(T.INT4, v) for f, v in fks.items()})
    cols["x"] = cn(T.FLOAT8, x, xv)
    cols["y"] = cn(T.FLOAT8, y, yv)
    db = Database()
    db.create(Table.from_columns("t0", cols))
    return db, (cat, fks["cid"], x, y)


def _close(a, b, rel=1e-9) -> bool:
    return a == b or math.isclose(a, b, rel_tol=rel, abs_tol=1e-9)


def _check_t0(name: str, rows, data) -> None:
    """Counts exact against numpy int64; float8 sums and averages to rel
    1e-9 against numpy bincount."""
    import numpy as np
    cat, cid, x, y = data
    if name == "agg_group":
        cnt = np.bincount(cat, minlength=26)
        sx = np.bincount(cat, weights=x, minlength=26)
        sy = np.bincount(cat, weights=y, minlength=26)
        if len(rows) != 26:
            raise AssertionError(f"agg_group: {len(rows)} groups")
        for (c, n_, s, a), k in zip(rows, range(26)):
            if (c != CATS[k] or n_ != int(cnt[k]) or not _close(s, sx[k])
                    or not _close(a, sy[k] / cnt[k])):
                raise AssertionError(f"agg_group {c}: {(n_, s, a)} vs "
                                     f"{(int(cnt[k]), sx[k], sy[k] / cnt[k])}")
        return
    if name == "rollup":
        g = cat.astype(np.int64) * 8 + cid % 8
        cnt = np.bincount(g, minlength=208)
        sx = np.bincount(g, weights=x, minlength=208)
        want = {}
        for k in range(208):
            want[(CATS[k // 8], k % 8)] = (int(cnt[k]), sx[k])
        for c in range(26):
            want[(CATS[c], None)] = (int(cnt[c * 8:c * 8 + 8].sum()),
                                     float(sx[c * 8:c * 8 + 8].sum()))
        want[(None, None)] = (len(cat), float(x.sum()))
        if len(rows) != len(want):
            raise AssertionError(f"rollup: {len(rows)} rows, expected "
                                 f"{len(want)}")
        for c, m, n_, s in rows:
            wn, ws = want[(c, m)]
            if n_ != wn or not _close(s, ws):
                raise AssertionError(f"rollup {(c, m)}: {(n_, s)} vs "
                                     f"{(wn, ws)}")
        return
    if name == "filter":
        m = (x < 25.0) & (y > 10.0)
        want = (int(m.sum()), float(x[m].sum()))
    else:
        want = (len(x), float(x.sum()), float(y.mean()))
    got = rows[0]
    if got[0] != want[0] or not all(_close(a, b) for a, b in
                                    zip(got[1:], want[1:])):
        raise AssertionError(f"{name}: {got} vs {want}")


def _run_t0(db, name: str, force: bool = False):
    """(rows, perfmon counts, seconds) of one query through the planner;
    `force` overrides the cost model (debug_force_tpupreagg)."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    t0 = time.perf_counter()
    with override(debug_force_tpupreagg=force):
        pq = plan_query(ast.parse(T0_SQL[name]), db)
        rows = pq.execute()
    torch.cuda.synchronize()
    return rows, dict(pq.perfmon.counts), time.perf_counter() - t0


def _t0_plane_bytes(db, n: int, cap: int, nchunks: int) -> dict:
    """t0's resident planes after its first query: the cache entry's bytes
    must be the chunks' padded rows times the bytes a row of
    planes_of_column (two planes a float8 column, no bits plane)."""
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.expr.lower_torch import planes_of_column
    cols = db.tables["t0"].columns
    row = sum(p.dtype.itemsize for c in cols.values()
              for p in planes_of_column(c))
    for name, c in cols.items():
        if c.type is T.FLOAT8 and len(planes_of_column(c)) != 2:
            raise AssertionError(f"t0.{name}: float8 with "
                                 f"{len(planes_of_column(c))} planes")
    ent = [r for r in TCACHE.info_rows()
           if r["table_name"] == "t0" and r["kind"] == "chunks"]
    if not ent or ent[0]["nbytes"] != nchunks * cap * row:
        raise AssertionError(f"t0's cache entry {ent}: expected "
                             f"{nchunks} x {cap} rows x {row} B")
    _log(f"t0 planes: {ent[0]['nbytes']} B resident ({row} B a row over "
         f"{nchunks} x {cap} padded rows, {n} rows)")
    return {"nbytes": ent[0]["nbytes"], "bytes_per_row": row}


def _t0_resident_h2d(db, name: str, force: bool, data) -> int:
    """H2D bytes of one more warm run of `name` under perfmon (the timed
    runs keep perfmon off)."""
    rows, counts, nbytes, _ = _run_qp(db, T0_SQL[name],
                                      {"debug_force_tpupreagg": force})
    _check_t0(name, rows, data)
    return int(nbytes.get("h2d", 0))


def phase_testdb(seed: int, log2n: int, gpu: str,
                 k4_parent: str | None = None,
                 window_rows_log2: int = 27) -> dict:
    """agg_group, rollup, filter and agg_nogrp over a 2^log2n-row t0."""
    import torch
    from pg_strom_tpu_torch.config import config
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    n = 1 << log2n
    t0 = time.perf_counter()
    db, data = _t0_db(seed + 1, n)
    _log(f"t0: {n} rows generated in {time.perf_counter() - t0:.1f} s")
    cap = chunk_capacity(n)
    nchunks = -(-n // cap)
    out = {"timing": {}}
    TCACHE.clear()
    budget = TCACHE.budget_bytes()
    _log(f"t0: tcache_size_mb={config.tcache_size_mb} (0: from the device) "
         f"-> budget {budget} B ({budget >> 20} MiB) of the card's "
         f"{torch.cuda.get_device_properties(0).total_memory} B; "
         f"chunk_rows={config.chunk_rows} chunks={nchunks}")
    if config.tcache_size_mb != 0:
        raise AssertionError("phase 4b runs at the default cache budget")
    pf.fused_cuda.launches = 0
    for name in ("agg_group", "rollup", "filter", "agg_nogrp"):
        before = pf.fused_cuda.launches
        force = False
        rows, counts, cold = _run_t0(db, name)
        if not (counts.get("device_chunks", 0)
                or counts.get("recheck_chunks", 0)):
            _log(f"t0 {name}: the cost model kept the query on the host "
                 f"({cold * 1e3:.3f} ms); rerun with "
                 "debug_force_tpupreagg")
            force = True
            rows, counts, cold = _run_t0(db, name, force)
        k2 = pf.fused_cuda.launches - before
        _log(f"t0 {name}: cold {cold * 1e3:.3f} ms [{gpu}], K2 launches "
             f"{k2}, perfmon {counts}")
        if name == "agg_group":
            out["planes"] = _t0_plane_bytes(db, n, cap, nchunks)
        dev = counts.get("device_chunks", 0)
        if (counts.get("recheck_chunks", 0) or
                counts.get("unported_host_exact", 0) or dev != nchunks):
            raise AssertionError(f"t0 {name}: perfmon {counts}, "
                                 f"expected {nchunks} device chunks and "
                                 "no replay")
        if name in ("agg_group", "rollup") and k2 < 1:
            raise AssertionError(f"t0 {name}: K2 never launched")
        _check_t0(name, rows, data)
        ladder = {c: counts.get(c, 0) for c in
                  ("salt_retries", "sort_fallbacks", "dense_fallbacks")}
        warm, k2w = [], []
        loads = (TCACHE.misses, TCACHE.streamed)
        for _ in range(5 if name in ("agg_group", "rollup") else 1):
            before = pf.fused_cuda.launches
            rows, counts, dt = _run_t0(db, name, force)
            _check_t0(name, rows, data)
            warm.append(dt)
            k2w.append(pf.fused_cuda.launches - before)
            if counts.get("tcache_misses", 0) or not counts.get("tcache_hits"):
                raise AssertionError(f"t0 {name}: a warm run missed the "
                                     f"table cache: perfmon {counts}")
        h2d = _t0_resident_h2d(db, name, force, data)
        if (TCACHE.misses, TCACHE.streamed) != loads or h2d:
            raise AssertionError(f"t0 {name}: t0 did not stay resident "
                                 f"(cache misses / streamed chunks "
                                 f"{loads} -> {(TCACHE.misses, TCACHE.streamed)}"
                                 f", H2D {h2d} B)")
        if name == "agg_group" and min(k2w) < 1:
            raise AssertionError("t0 agg_group: the warm run skipped K2")
        med = statistics.median(warm)
        out["timing"][name] = {"cold_ms": cold * 1e3, "forced": force,
                               "warm_ms": med * 1e3,
                               "warm_all_ms": [w * 1e3 for w in warm]}
        _log(f"t0 {name} [{gpu}]: exact vs numpy; ladder {ladder}; "
             f"cold {cold * 1e3:.3f} ms, warm median {med * 1e3:.3f} ms "
             f"of {[round(w * 1e3, 3) for w in warm]} "
             f"(K2 launches per warm run {k2w}, warm perfmon {counts}); "
             f"resident: no cache miss, 0 H2D bytes")
    out["k2_launches"] = pf.fused_cuda.launches
    _log(f"t0: K2 launches {pf.fused_cuda.launches}")
    out["chunk"] = _time_k2_chunk(db, gpu)
    out["k4"] = phase_k4_path(db, data, nchunks, gpu, k4_parent)
    # 4d, 4e and 4f run inside this database so that t0 is built and
    # uploaded once
    out["joins"] = phase_joins(db, seed, gpu, window_rows_log2)
    out["k2_launches"] += out["joins"]["star_sort"]["k2_launches"]
    out["k2_launches"] += out["joins"]["dist"]["launches"]["K2"]
    del db
    TCACHE.clear()
    torch.cuda.empty_cache()
    return out


# H100 SXM5 published peaks (NVIDIA data sheet, dense, 700 W): HBM3 and
# float32 outside the tensor cores.  The kernels' integer adds run on the
# same CUDA cores, so their operation bound uses the float32 rate.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def _bound(nbytes: float, ops: float) -> dict:
    """The least time for `nbytes` moved (each input read once, each output
    written once) and `ops` operations: the larger of the two times."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / CORE_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def _tensor_bytes(ts) -> int:
    """Bytes of distinct tensors (a plane passed twice counts once)."""
    seen = {}
    for t in ts:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def _time(fn, reps):
    import torch
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


def _t0_chunk_lanes(db, G: int):
    """agg_group's K2 inputs on the first resident t0 chunk at G buckets
    (the cold run's G = 1024, the warm run's G = 32; below 26 buckets the
    26 codes fold, cat % G)."""
    import torch
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.expr.lower_torch import DVal
    t = db.get("t0")
    names = t.column_names
    cc = next(iter(TCACHE.chunks_for(t, names, chunk_capacity(t.nrows))))
    pl = dict(zip(names, cc.planes))
    dev = pl["cat"][0].device
    mask = torch.arange(pl["cat"][0].shape[0], device=dev) < cc.nrows
    key = DVal(T.TEXT, pl["cat"][0], pl["cat"][1])
    x = DVal(T.FLOAT8, pl["x"][0], pl["x"][1])
    y = DVal(T.FLOAT8, pl["y"][0], pl["y"][1])
    aggs = [_inst("count"), _inst("sum", T.FLOAT8), _inst("avg", T.FLOAT8)]
    kd = key.data.to(torch.int64)
    seg = torch.where(mask, (kd % G).to(torch.int32),
                      torch.full_like(key.data, G))
    return [key], aggs, [[], [x], [y]], mask, seg, cc.nrows


# G of K2's chunk timings: agg_group's warm 32 and cold 1024, star_group's
# 128
K2_TIMED_G = (32, 128, 1024)


def _time_k2_chunk(db, gpu: str) -> dict:
    """K2 alone and its plain version on the 2^26-row agg_group chunk at
    each G of K2_TIMED_G (plain, kernel, kernel, plain)."""
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.ops.launch_plan import plan_launch
    res = {}
    for G in K2_TIMED_G:
        keys, aggs, vals, mask, seg, n = _t0_chunk_lanes(db, G)
        err, plan, (inputs, sc, seg), _ = _k2_compare(
            f"t0 chunk G={G}", keys, aggs, vals, mask, seg, G, n, True)

        def kern():
            return pf.fused_cuda(plan, seg, inputs, sc, G, n)

        def plain():
            return pf.fused_reference(plan, seg, inputs, sc, G, n)
        p1 = _time(plain, 1)
        k1, k2 = _time(kern, 10), _time(kern, 10)
        p2 = _time(plain, 1)
        b = _bound(_tensor_bytes(list(inputs) + [seg])
                   + G * plan.ncols * 12, n * plan.ncols)
        res[G] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "err": err,
                  **b, "library_ms": None}
        lp = plan_launch(G, plan.ncols, _k2_shadows(plan), 0)
        _log(f"K2 at the agg_group chunk ({n} rows, G={G}, K={plan.ncols}), "
             f"block {lp.block}, {lp.ntiles} column tile(s), ~{lp.smem} B "
             f"shared memory [{gpu}]: kernel {k1:.4f} / {k2:.4f} ms, plain "
             f"PyTorch {p1:.4f} / {p2:.4f} ms, bound {b['bound_ms']:.4f} ms "
             f"({b['bound_by']}), no single PyTorch call")
    return res


# ---------------------------------------------------------------------------
# phase 4d: joins over t0 at full width
# ---------------------------------------------------------------------------

DIM_ROWS = 40000
JOIN_SQL = {
    # fused join+aggregate: K3 probe of the dense t1 table, ungrouped agg
    "join_agg": "select count(*), sum(t0.x) from t0 join t1 "
                "on t0.aid = t1.aid where t0.x < 50.0",
    # pregrouped: K3 maps the probe key to its group, then K2
    "star_group": "select t1.aid % 40, count(*), sum(t0.x) from t0 "
                  "join t1 on t0.aid = t1.aid group by t1.aid % 40 "
                  "order by t1.aid % 40",
    # pairwise HashJoinExecutor over a dimension loaded unsorted (unique,
    # not serial): a K3 probe, not the identity branch
    "t6_join": "select t0.id, t6.w from t0 join t6 on t0.aid = t6.fid "
               "where t0.x < 0.01",
}


def _add_dims(db, seed: int):
    """t1..t4 of models/testdb.py (int4 keys 1..40000, no md5 text) and
    t6(fid, w) with the same keys in a seeded random order; returns w by
    key."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import Table, column_from_numpy as cn
    keys = np.arange(1, DIM_ROWS + 1, dtype=np.int32)
    for i, c in enumerate("abcd", 1):
        db.create(Table.from_columns(f"t{i}", {f"{c}id": cn(T.INT4, keys)}))
    rng = np.random.default_rng(seed + 40)
    fid = rng.permutation(keys)
    w = rng.integers(-(1 << 30), 1 << 30, DIM_ROWS, dtype=np.int32)
    db.create(Table.from_columns("t6", {"fid": cn(T.INT4, fid),
                                        "w": cn(T.INT4, w)}))
    w_by_key = np.zeros(DIM_ROWS + 1, np.int64)
    w_by_key[fid] = w
    return w_by_key


def _check_join(name: str, rows, t0cols, w_by_key) -> None:
    """Counts and the joined ints exact against numpy; float8 sums to rel
    1e-9."""
    import numpy as np
    aid, x = t0cols["aid"], t0cols["x"]
    if name == "join_agg":
        m = x < 50.0
        want = (int(m.sum()), float(x[m].sum()))
        if len(rows) != 1 or rows[0][0] != want[0] or \
                not _close(rows[0][1], want[1]):
            raise AssertionError(f"join_agg: {rows} vs {want}")
        return
    if name == "star_group":
        g = aid % 40
        cnt = np.bincount(g, minlength=40)
        sx = np.bincount(g, weights=x, minlength=40)
        if [r[0] for r in rows] != list(range(40)):
            raise AssertionError(f"star_group groups {[r[0] for r in rows]}")
        for k, n_, s_ in rows:
            if n_ != int(cnt[k]) or not _close(s_, sx[k]):
                raise AssertionError(f"star_group {k}: {(n_, s_)} vs "
                                     f"{(int(cnt[k]), sx[k])}")
        return
    m = np.flatnonzero(x < 0.01)
    want = np.stack([m + 1, w_by_key[aid[m]]], axis=1)
    got = np.asarray(sorted(rows), dtype=np.int64).reshape(-1, 2)
    if not np.array_equal(got, want):
        raise AssertionError(f"t6_join: {got.shape[0]} rows vs "
                             f"{want.shape[0]}, first {got[:3]} vs {want[:3]}")


def _plan_on_host(node) -> bool:
    """Any join or aggregate node the cost model kept on the host."""
    if node.kind in ("HashJoin", "HashAggregate"):
        return True
    return any(_plan_on_host(c) for c in node.children)


def _run_join(db, name: str, force: bool):
    return _run_q(db, JOIN_SQL[name], force)[:3]


def phase_joins(db, seed: int, gpu: str, window_rows_log2: int) -> dict:
    """join_agg, star_group and the t6 join over the resident t0; then
    phases 4e and 4f in the same database."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.exec.devcache import chunk_capacity
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    w_by_key = _add_dims(db, seed)
    t0 = db.get("t0")
    t0cols = {c: t0.columns[c].data for c in ("aid", "x")}
    nchunks = -(-t0.nrows // chunk_capacity(t0.nrows))
    out = {"timing": {}}
    ml.mxu_lookup_cuda.launches = 0
    for name in JOIN_SQL:
        force = _plan_on_host(plan_query(ast.parse(JOIN_SQL[name]), db).root)
        if force:
            _log(f"join {name}: the cost model keeps part of the query on "
                 "the host; run it with debug_force_offload")
        k3_0, k2_0 = ml.mxu_lookup_cuda.launches, pf.fused_cuda.launches
        rows, counts, cold = _run_join(db, name, force)
        k3, k2 = ml.mxu_lookup_cuda.launches - k3_0, \
            pf.fused_cuda.launches - k2_0
        _log(f"join {name}: cold {cold * 1e3:.3f} ms [{gpu}], K3 launches "
             f"{k3}, K2 launches {k2}, perfmon {counts}")
        if (counts.get("device_chunks", 0) != nchunks
                or counts.get("recheck_chunks", 0)
                or counts.get("unported_host_exact", 0)):
            raise AssertionError(f"join {name}: perfmon {counts}, expected "
                                 f"{nchunks} device chunks and no replay")
        if k3 < nchunks:
            raise AssertionError(f"join {name}: K3 launched {k3} times for "
                                 f"{nchunks} probe chunks")
        if name == "star_group" and k2 < nchunks:
            raise AssertionError(f"join star_group: K2 launched {k2} times")
        _check_join(name, rows, t0cols, w_by_key)
        warm, k3w = [], []
        for _ in range(5 if name != "t6_join" else 3):
            before = ml.mxu_lookup_cuda.launches
            rows, counts, dt = _run_join(db, name, force)
            _check_join(name, rows, t0cols, w_by_key)
            warm.append(dt)
            k3w.append(ml.mxu_lookup_cuda.launches - before)
        if min(k3w) < nchunks:
            raise AssertionError(f"join {name}: a warm run skipped K3 {k3w}")
        med = statistics.median(warm)
        out["timing"][name] = {"cold_ms": cold * 1e3, "forced": force,
                               "warm_ms": med * 1e3,
                               "warm_all_ms": [w * 1e3 for w in warm],
                               "rows": len(rows)}
        _log(f"join {name} [{gpu}]: exact vs numpy ({len(rows)} rows); cold "
             f"{cold * 1e3:.3f} ms, warm median {med * 1e3:.3f} ms of "
             f"{[round(w * 1e3, 3) for w in warm]} (K3 launches per warm "
             f"run {k3w}, warm perfmon {counts})")
    out["k3_launches"] = ml.mxu_lookup_cuda.launches
    # perfmon phases (dispatch, device_wait, materialize) of one warm run
    from pg_strom_tpu_torch import execute
    for name in ("join_agg", "t6_join"):
        with override(perfmon=True,
                      debug_force_offload=out["timing"][name]["forced"]):
            text = "\n".join(r[0] for r in execute(
                "EXPLAIN ANALYZE " + JOIN_SQL[name], db).rows)
        _log(f"join {name}, EXPLAIN ANALYZE [{gpu}]:\n{text}")
    out["profile"] = _profile("join_agg",
                              lambda: _run_join(db, "join_agg", False), gpu)
    out["chunk"] = _time_k3_chunk(db, gpu)
    # 4e runs here, while t1..t3 and t6 are loaded
    out["star_sort"] = phase_star_sort(db, seed, gpu, w_by_key)
    out["k3_launches"] += out["star_sort"]["k3_launches"]
    # 4f runs here too, while t1..t7 are loaded
    out["surface"] = phase_surface(db, seed, gpu, window_rows_log2)
    # and 4g, whose star probes t2, t3 and t6
    out["dist"] = phase_dist(db, seed, gpu)
    for nm in ("t1", "t2", "t3", "t4", "t6", "t7"):
        db.drop(nm)
    torch.cuda.empty_cache()
    return out


def _profile(name: str, run, gpu: str) -> dict:
    """torch.profiler over 3 warm runs of `run`: device time by kernel
    (CUDA kernel events only: an op's own entry repeats its kernels' time),
    the device's busy share of the runs' wall time, and the PyTorch op
    that holds the most device time (its kernels' time included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        for _ in range(3):
            run()
        wall = (time.perf_counter() - wall0) * 1e3
    rows, ops = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            rows.append((ev.self_device_time_total / 1e3, ev.key, ev.count))
        elif (ev.device_type == DeviceType.CPU and ev.key.startswith("aten::")
              and ev.device_time_total):
            ops.append((ev.device_time_total / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    top_op = ops[0] if ops else (0.0, "none", 0)
    _log(f"{name} profile, 3 warm runs [{gpu}]: wall {wall:.3f} ms, "
         f"device kernels {busy:.3f} ms, busy share {busy / wall:.4f}; the "
         f"PyTorch op with the most device time: {top_op[1]} "
         f"({top_op[0]:.3f} ms, {top_op[2]} calls)")
    for ms, key, cnt in rows[:12]:
        _log(f"  {ms:10.3f} ms  {cnt:5d}x  {key[:90]}")
    return {"wall_ms": wall, "device_ms": busy, "top_op": top_op,
            "top": [(k[:90], ms, c) for ms, k, c in rows[:12]]}


# ---------------------------------------------------------------------------
# phase 4e: the N-way star join+aggregate and ORDER BY ... LIMIT over t0
# ---------------------------------------------------------------------------

STAR_SQL = {
    # the reference's manual benchmark shape (models/testdb.py:101): three
    # serial-key dimensions, identity probes, ungrouped
    "star4way": "select count(*), sum(t0.x), sum(t0.y) from t0, t1, t2, t3 "
                "where t0.aid = t1.aid and t0.bid = t2.bid "
                "and t0.cid = t3.cid",
    # t6 is unique but not serial: its probe is K3; grouped by a text code
    # (K2), a dimension-side predicate
    "star_k3": "select t0.cat, count(*), sum(t0.x), sum(t6.w) "
               "from t0, t6, t2, t3 where t0.aid = t6.fid "
               "and t0.bid = t2.bid and t0.cid = t3.cid and t6.w > 0 "
               "group by t0.cat order by t0.cat",
    # t7 holds each key twice: the bounded-fanout probe, two slices a chunk
    "star_fanout": "select count(*), sum(t0.x), sum(t7.v) from t0, t7, t2 "
                   "where t0.did = t7.gid and t0.bid = t2.bid",
}
SORT_SQL = {
    # models/testdb.py:104; 66 key bits: the threshold top-k
    "sort": "select id, x from t0 order by x desc limit 100",
    # 34 key bits + 26 row-id bits: the packed top-k
    "sort_packed": "select id, aid from t0 order by aid limit 1000",
    # k > 8192: the adaptive single word, which fits
    "sort_adaptive": "select id, eid, aid from t0 order by eid, aid desc "
                     "limit 20000",
    # a float8 key and the id do not fit one word: ovf, the exact rerun
    "sort_exact": "select id, x from t0 where y < 50.0 order by x, id "
                  "limit 100000",
}
SORT_ROUTES = {"sort": {"threshold"}, "sort_packed": {"packed"},
               "sort_adaptive": {"adaptive"},
               "sort_exact": {"adaptive", "exact"}}


def _add_t7(db, seed: int):
    """t7(gid, v): each key of 1..DIM_ROWS twice, in a seeded order; returns
    the sum of v by key."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import Table, column_from_numpy as cn
    rng = np.random.default_rng(seed + 70)
    gid = rng.permutation(np.tile(np.arange(1, DIM_ROWS + 1,
                                            dtype=np.int32), 2))
    v = rng.integers(-(1 << 20), 1 << 20, 2 * DIM_ROWS, dtype=np.int32)
    db.create(Table.from_columns("t7", {"gid": cn(T.INT4, gid),
                                        "v": cn(T.INT4, v)}))
    v_by_key = np.zeros(DIM_ROWS + 1, np.int64)
    np.add.at(v_by_key, gid, v.astype(np.int64))
    return v_by_key


def _has_node(node, kind: str) -> bool:
    return node.kind == kind or any(_has_node(c, kind)
                                    for c in node.children)


def _run_q(db, sql: str, force: bool):
    """(rows, perfmon counts, seconds, plan root) of one query."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    t0 = time.perf_counter()
    with override(debug_force_offload=force):
        pq = plan_query(ast.parse(sql), db)
        rows = pq.execute()
    torch.cuda.synchronize()
    return rows, dict(pq.perfmon.counts), time.perf_counter() - t0, pq.root


def _exact_int_bincount(keys, vals, minlength: int):
    """Per-key int64 sums of an int32 lane, exact: np.bincount's float64
    weights over its 16-bit halves (each partial sum < 2^53)."""
    import numpy as np
    v = vals.astype(np.int64)
    lo = np.bincount(keys, weights=v & 0xFFFF, minlength=minlength)
    hi = np.bincount(keys, weights=v >> 16, minlength=minlength)
    return np.rint(hi).astype(np.int64) * 65536 + np.rint(lo).astype(np.int64)


def _star_expected(name: str, t0cols, w_by_key, v_by_key) -> list:
    """The rows of a STAR_SQL query from numpy: counts and integer sums
    exact, float8 sums as numpy adds them."""
    import numpy as np
    x, y = t0cols["x"], t0cols["y"]
    if name == "star4way":
        return [(len(x), float(x.sum()), float(y.sum()))]
    if name == "star_k3":
        cat, aid = t0cols["cat"], t0cols["aid"]
        w = w_by_key[aid]
        m = w > 0
        cnt = np.bincount(cat[m], minlength=26)
        sx = np.bincount(cat[m], weights=x[m], minlength=26)
        sw = _exact_int_bincount(cat[m], w[m], 26)
        return [(CATS[k], int(cnt[k]), float(sx[k]), int(sw[k]))
                for k in range(26) if cnt[k]]
    did = t0cols["did"]
    return [(2 * len(x), 2 * float(x.sum()), int(v_by_key[did].sum()))]


def _check_star(name: str, rows, want) -> None:
    """Equal to the numpy rows: ints and text exactly, floats to rel
    1e-9."""
    same = len(rows) == len(want) and all(
        len(g) == len(w) and all(
            _close(a, b) if isinstance(b, float) else a == b
            for a, b in zip(g, w))
        for g, w in zip(rows, want))
    if not same:
        raise AssertionError(f"{name}: {rows[:4]} vs {want[:4]}")


def _sort_expected(name: str, t0cols):
    """The rows of a SORT_SQL query from numpy: a stable lexsort (ties by
    ascending row id, as the packed row id breaks them) over the
    candidates at or before the k-th key."""
    import numpy as np
    x, y = t0cols["x"], t0cols["y"]
    aid, eid = t0cols["aid"], t0cols["eid"]
    ids = np.arange(len(x), dtype=np.int64)

    def first_k(key, k, rows=ids):
        k = min(k, len(rows))
        kth = np.partition(key[rows], k - 1)[k - 1]
        cand = rows[key[rows] <= kth]
        return cand[np.lexsort((cand, key[cand]))][:k]
    if name == "sort":
        sel = first_k(-x, 100)
        return [(int(i) + 1, float(x[i])) for i in sel]
    if name == "sort_packed":
        sel = first_k(aid.astype(np.int64), 1000)
        return [(int(i) + 1, int(aid[i])) for i in sel]
    if name == "sort_adaptive":
        key = eid.astype(np.int64) * (1 << 17) + (1 << 16) - aid
        sel = first_k(key, 20000)
        return [(int(i) + 1, int(eid[i]), int(aid[i])) for i in sel]
    sel = first_k(x, 100000, np.flatnonzero(y < 50.0))
    return [(int(i) + 1, float(x[i])) for i in sel]


def _time_runs(db, sql, force, check, n_warm=5):
    cold_rows, counts, cold, root = _run_q(db, sql, force)
    check(cold_rows)
    warm = []
    for _ in range(n_warm):
        rows, wcounts, dt, _ = _run_q(db, sql, force)
        check(rows)
        warm.append(dt)
    return counts, wcounts, cold, warm, root


def phase_star_sort(db, seed: int, gpu: str, w_by_key) -> dict:
    """star4way, star_k3 and star_fanout, then the four ORDER BY ... LIMIT
    routes, cold and 5 warm, over the resident t0 and its dimensions."""
    from pg_strom_tpu_torch.exec.devcache import chunk_capacity
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    v_by_key = _add_t7(db, seed)
    t0 = db.get("t0")
    t0cols = {c: t0.columns[c].data for c in
              ("cat", "aid", "did", "eid", "x", "y")}
    nchunks = -(-t0.nrows // chunk_capacity(t0.nrows))
    out = {"timing": {}}
    k3_start, k2_start = ml.mxu_lookup_cuda.launches, pf.fused_cuda.launches
    for name, sql in STAR_SQL.items():
        force = _plan_on_host(plan_query(ast.parse(sql), db).root)
        if force:
            _log(f"star {name}: the cost model keeps part of the query on "
                 "the host; run it with debug_force_offload")
        want = _star_expected(name, t0cols, w_by_key, v_by_key)
        k3_0, k2_0 = ml.mxu_lookup_cuda.launches, pf.fused_cuda.launches
        counts, wcounts, cold, warm, root = _time_runs(
            db, sql, force, lambda r: _check_star(name, r, want))
        k3 = ml.mxu_lookup_cuda.launches - k3_0
        k2 = pf.fused_cuda.launches - k2_0
        for c in (counts, wcounts):
            if (c.get("device_chunks", 0) != nchunks
                    or c.get("recheck_chunks", 0)
                    or c.get("unported_host_exact", 0)):
                raise AssertionError(f"star {name}: perfmon {c}, expected "
                                     f"{nchunks} device chunks, no replay")
        if not _has_node(root, "TpuStarJoinAgg"):
            raise AssertionError(f"star {name}: no TpuStarJoinAgg node")
        if name == "star_k3" and (k3 < 6 * nchunks or k2 < 6 * nchunks):
            raise AssertionError(f"star_k3: K3 launched {k3}, K2 {k2} times "
                                 f"over 6 runs of {nchunks} chunks")
        med = statistics.median(warm)
        out["timing"][name] = {"cold_ms": cold * 1e3, "forced": force,
                               "warm_ms": med * 1e3,
                               "warm_all_ms": [w * 1e3 for w in warm],
                               "k3_launches": k3, "k2_launches": k2}
        _log(f"star {name} [{gpu}]: exact vs numpy; cold {cold * 1e3:.3f} "
             f"ms, warm median {med * 1e3:.3f} ms of "
             f"{[round(w * 1e3, 3) for w in warm]} (6 runs: K3 launches "
             f"{k3}, K2 launches {k2}; cold perfmon {counts})")
    out["profile"] = _profile(
        "star_k3", lambda: _run_q(db, STAR_SQL["star_k3"],
                                  out["timing"]["star_k3"]["forced"]), gpu)
    used = set()
    for name, sql in SORT_SQL.items():
        want = _sort_expected(name, t0cols)

        def check(rows, name=name, want=want):
            if [tuple(r) for r in rows] != want:
                bad = next(i for i, (a, b) in enumerate(zip(rows, want))
                           if tuple(a) != b) if len(rows) == len(want) \
                    else min(len(rows), len(want))
                raise AssertionError(f"{name}: {len(rows)} rows vs "
                                     f"{len(want)}, first difference at "
                                     f"{bad}")
        counts, _, cold, warm, _ = _time_runs(db, sql, False, check)
        routes = {k[len("topk_"):]: v for k, v in counts.items()
                  if k.startswith("topk_")}
        if set(routes) != SORT_ROUTES[name] or \
                any(v != nchunks for v in routes.values()):
            raise AssertionError(f"{name}: top-k routes {routes}, expected "
                                 f"{SORT_ROUTES[name]} on each of "
                                 f"{nchunks} chunks")
        if counts.get("unported_host_exact", 0):
            raise AssertionError(f"{name}: perfmon {counts}")
        used |= set(routes)
        med = statistics.median(warm)
        out["timing"][name] = {"cold_ms": cold * 1e3, "warm_ms": med * 1e3,
                               "warm_all_ms": [w * 1e3 for w in warm],
                               "routes": routes}
        _log(f"sort {name} [{gpu}]: {len(want)} rows exact vs a numpy "
             f"lexsort; routes per chunk {routes}; cold {cold * 1e3:.3f} "
             f"ms, warm median {med * 1e3:.3f} ms of "
             f"{[round(w * 1e3, 3) for w in warm]}")
    if used != {"packed", "threshold", "adaptive", "exact"}:
        raise AssertionError(f"top-k routes used: {sorted(used)}")
    out["k3_launches"] = ml.mxu_lookup_cuda.launches - k3_start
    out["k2_launches"] = pf.fused_cuda.launches - k2_start
    _log(f"phase 4e: K3 launches {out['k3_launches']}, K2 launches "
         f"{out['k2_launches']}")
    return out


def _time_k3_chunk(db, gpu: str) -> dict:
    """K3 alone, its plain version and torch.take at join_agg's shape: the
    2^26 probe keys of the first resident t0 chunk into a D = 65536, K = 2
    table (t1's 40000 rows padded with the sentinel 2^16 - 1)."""
    import torch
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    t = db.get("t0")
    names = t.column_names
    cc = next(iter(TCACHE.chunks_for(t, names, chunk_capacity(t.nrows))))
    aid = cc.planes[names.index("aid")][0]
    n = cc.nrows
    D, K, sent = 1 << 16, 2, (1 << 16) - 1
    idx = (aid.to(torch.int64) - 1).clamp(0, D - 1).to(torch.int32)
    vals = torch.randperm(DIM_ROWS, device=aid.device,
                          generator=torch.Generator(device=aid.device).manual_seed(7)
                          ).to(torch.int32)
    table = ml.encode_table_torch(
        torch.cat([vals, torch.full((D - DIM_ROWS,), sent, dtype=torch.int32,
                                    device=aid.device)]), D, K, sent)
    k = ml.mxu_lookup_cuda(idx, table, n, sent)
    p = ml.mxu_lookup_reference(idx, table, n, sent)
    idx64 = idx[:n].to(torch.int64)
    lib_out = torch.take(table, idx64)
    torch.cuda.synchronize()
    if not (torch.equal(k, p) and torch.equal(k, lib_out)):
        raise AssertionError("K3 at the join_agg chunk differs from its "
                             "plain version or torch.take")
    p1 = _time(lambda: ml.mxu_lookup_reference(idx, table, n, sent), 3)
    k1 = _time(lambda: ml.mxu_lookup_cuda(idx, table, n, sent), 20)
    k2 = _time(lambda: ml.mxu_lookup_cuda(idx, table, n, sent), 20)
    p2 = _time(lambda: ml.mxu_lookup_reference(idx, table, n, sent), 3)
    conv = _time(lambda: idx[:n].to(torch.int64), 5)
    lib = _time(lambda: torch.take(table, idx64), 20)
    # device-to-device copy of the same 8 bytes per lookup, for scale
    src = torch.empty(2 * n, dtype=torch.int32, device=aid.device)
    dst = torch.empty_like(src)
    cp = _time(lambda: dst.copy_(src), 10)
    copy_bytes = 2 * src.numel() * 4
    copy_rate = copy_bytes / (cp / 1e3)
    del src, dst
    b = _bound(4 * n + 4 * n + table.numel() * 4, n)
    _log(f"K3 at the join_agg chunk ({n} lookups, D={D}, K={K}) [{gpu}]: "
         f"kernel {k1:.4f} / {k2:.4f} ms, plain PyTorch {p1:.4f} / {p2:.4f} "
         f"ms, torch.take {lib:.4f} ms (+ {conv:.4f} ms int64 index "
         f"conversion), bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
         f"{b['bound_bytes']:.0f} B at 3.35 TB/s; a device copy of "
         f"{copy_bytes:.0f} B moves {copy_rate / 1e12:.3f} TB/s)")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "err": 0, **b,
            "library_ms": lib, "convert_ms": conv,
            "copy_tb_s": copy_rate / 1e12}


# ---------------------------------------------------------------------------
# phase 4f: the SQL and plan surface over t0
# ---------------------------------------------------------------------------

WINDOW_SUM_SQL = ("select cat, max(rs) from (select cat, sum(y) over "
                  "(partition by cat order by id) rs from t0 "
                  "where x < 1.0) q group by cat order by cat")
CORR_SQL = {
    "corr_count": "select k, (select count(*) from t0 where t0.cat = c.k "
                  "and t0.x < 50.0) from tcat c order by k",
    # x > 99.99 keeps about 500 rows an instantiation
    "corr_exists": "select k from tcat c where exists (select 1 from t0 "
                   "where t0.cat = c.k and t0.x > 99.99) order by k",
}
# codes of tcat that t0.cat never takes
TCAT_ABSENT = ["aab", "abc", "zzy", "zzzz"]
# the window tier's split of one run: wrapped functions of the port
WINDOW_SPLIT = (("exec.scan_exec", "ScanExecutor.row_indexes", "row_indexes"),
                ("plan.window", "_inner_columns", "inner"),
                ("plan.planner", "_order_plane_keys", "keys"),
                ("plan.window", "_Frame.__init__", "frame"),
                ("plan.window", "_window_column", "ranker"),
                ("plan.window", "_run_columnar", "columnar"))


class _Split:
    """Wall time inside each WINDOW_SPLIT function, and the perfmon of
    every scan the window's inner stage ran, while active (the POST stage's
    scan without a qual is not the inner stage's)."""

    def __init__(self):
        import importlib
        self.secs, self.scans, self._undo = {}, [], []
        self._inner = False
        for mod, attr, key in WINDOW_SPLIT:
            owner = importlib.import_module(f"pg_strom_tpu_torch.{mod}")
            if "." in attr:
                cls, attr = attr.split(".")
                owner = getattr(owner, cls)
            self._wrap(owner, attr, key)

    def _wrap(self, owner, attr, key):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            if key == "row_indexes" and not self._inner:
                return fn(*a, **k)
            t = time.perf_counter()
            self._inner |= key == "inner"
            try:
                return fn(*a, **k)
            finally:
                self._inner &= key != "inner"
                self.secs[key] = (self.secs.get(key, 0.0)
                                  + time.perf_counter() - t)
                if key == "row_indexes":
                    self.scans.append(a[0].perfmon)
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def close(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)


def _window_rank_expected(cat, x, y):
    """(count(*), max(r), min(r)) of window_rank with no sort: rank() over
    x descending peaks at each cat's filtered count less the rows that tie
    its minimum x, plus 1."""
    import numpy as np
    keep = y > 5.0
    c, xv = cat[keep], x[keep]
    cnt = np.bincount(c, minlength=26)
    mn = np.full(26, np.inf)
    np.minimum.at(mn, c, xv)
    ties = np.bincount(c[xv == mn[c]], minlength=26)
    return int(keep.sum()), int((cnt - ties + 1)[cnt > 0].max()), 1


def _window_sum_expected(cat, x, y):
    """cat -> the last running sum of y in id (row) order over x < 1.0,
    summed sequentially (np.cumsum adds left to right)."""
    import numpy as np
    sel = x < 1.0
    c, yv = cat[sel], y[sel]
    return {CATS[k]: float(np.cumsum(yv[c == k])[-1])
            for k in range(26) if (c == k).any()}


def _zero_launches():
    from pg_strom_tpu_torch.ops import joinagg_scalar as js
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.ops import preagg_fused2 as pf2
    from pg_strom_tpu_torch.ops import preagg_pallas as pp
    kernels = {"K1": pf2.fused2_cuda, "K2": pf.fused_cuda,
               "K3": ml.mxu_lookup_cuda, "K4": pp.pallas_cuda,
               "K5": js.joinagg_scalar_cuda}
    for k in kernels.values():
        k.launches = 0
    return kernels


def _window_rank_cell(db, gpu: str, n_warm: int) -> dict:
    """window_rank cold and warm: exact against numpy, the inner scan on
    the device, and the tier's split of each run."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.exec.devcache import chunk_capacity
    from pg_strom_tpu_torch.models.testdb import BENCH_QUERIES
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    t0 = db.get("t0")
    cat, x, y = (t0.columns[c].data for c in ("cat", "x", "y"))
    nchunks = -(-t0.nrows // chunk_capacity(t0.nrows))
    want = _window_rank_expected(cat, x, y)
    runs = []
    for i in range(1 + n_warm):
        split = _Split()
        try:
            t = time.perf_counter()
            with override(perfmon=True):
                pq = plan_query(ast.parse(BENCH_QUERIES["window_rank"]), db)
                rows = pq.execute()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            split.close()
        counts = dict(pq.perfmon.counts)
        if [tuple(r) for r in rows] != [want]:
            raise AssertionError(f"window_rank: {rows} vs {want}")
        scans = [dict(pm.counts) for pm in split.scans]
        if (len(scans) != 1 or scans[0].get("device_chunks", 0) != nchunks
                or scans[0].get("recheck_chunks", 0)):
            raise AssertionError(f"window_rank: inner scans {scans}, "
                                 f"expected one on {nchunks} device chunks")
        pm = split.scans[0]
        s = {k: v * 1e3 for k, v in split.secs.items()}
        disp = pm.times.get("dispatch", 0.0) * 1e3
        wait = pm.times.get("device_wait", 0.0) * 1e3
        parts = {
            "scan launch": disp,
            "mask read-back": wait,
            "row indexes on the host": s["row_indexes"] - disp - wait,
            "column gather": s["inner"] - s["row_indexes"],
            "key encoding": s.get("keys", 0.0),
            "frame lexsort": s["frame"],
            "ranker": s["ranker"],
            "POST stage": (s["columnar"] - s["inner"] - s.get("keys", 0.0)
                           - s["frame"] - s["ranker"]),
            "outer aggregate": dt * 1e3 - s["columnar"],
        }
        runs.append(dt)
        # device time of the inner scan and the outer aggregate (CUDA
        # events around each launch: perfmon.device_call)
        kern = sum(v for p_ in (pm, pq.perfmon) for k, v in p_.times.items()
                   if k.startswith("kernel ")) * 1e3
        _log(f"window window_rank run {i} ({'cold' if i == 0 else 'warm'}) "
             f"[{gpu}]: {dt * 1e3:.3f} ms over {t0.nrows} rows, {want[0]} "
             f"reach the host; split ms "
             f"{ {k: round(v, 3) for k, v in parts.items()} }; device "
             f"kernels {kern:.3f} ms, busy share {kern / (dt * 1e3):.5f}; "
             f"inner scan perfmon {scans[0]}; query perfmon {counts}")
    return {"rows": t0.nrows, "cold_ms": runs[0] * 1e3,
            "warm_ms": statistics.median(runs[1:]) * 1e3,
            "warm_all_ms": [r * 1e3 for r in runs[1:]],
            "host_rows": want[0], "split_ms": parts, "device_ms": kern}


def _add_tcat(db):
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import Table, column_from_values
    db.create(Table.from_columns("tcat", {
        "k": column_from_values(T.TEXT, CATS + TCAT_ABSENT)}))


def _corr_cell(db, name: str, gpu: str, nchunks: int, want) -> dict:
    """One correlated query cold and 3 warm: exact rows, and every
    instantiation planned with typed constants and run on the device."""
    from pg_strom_tpu_torch.plan import correlated, planner
    rows_of, plan_query = correlated._Runner._rows, planner.plan_query
    runs, insts = [], []

    def counted(self, pvals):
        def plan(q, pdb):
            pq = plan_query(q, pdb)
            insts.append(pq)
            return pq
        planner.plan_query = plan
        try:
            return rows_of(self, pvals)
        finally:
            planner.plan_query = plan_query

    correlated._Runner._rows = counted
    force = False
    try:
        for i in range(4):
            insts.clear()
            rows, counts, dt, _ = _run_q(db, CORR_SQL[name], force)
            if i == 0 and not any(pq.perfmon.counts.get("device_chunks")
                                  for pq in insts):
                _log(f"corr {name}: the cost model keeps the "
                     "instantiations on the host; run with "
                     "debug_force_offload")
                force = True
                insts.clear()
                rows, counts, dt, _ = _run_q(db, CORR_SQL[name], force)
            if [tuple(r) for r in rows] != want:
                raise AssertionError(f"{name}: {rows} vs {want}")
            icounts = [dict(pq.perfmon.counts) for pq in insts]
            bad = [c for c in icounts
                   if c.get("device_chunks", 0) != nchunks
                   or c.get("recheck_chunks", 0)
                   or c.get("unported_host_exact", 0)]
            if len(insts) != len(CATS) + len(TCAT_ABSENT) or bad:
                raise AssertionError(f"{name}: {len(insts)} instantiations, "
                                     f"not on the device: {bad[:3]}")
            runs.append(dt)
            if i == 0:
                _log(f"corr {name}: {len(insts)} instantiations planned, "
                     f"each on {nchunks} device chunks (first: "
                     f"{icounts[0]}; outer perfmon {counts})")
    finally:
        correlated._Runner._rows = rows_of
    med = statistics.median(runs[1:])
    _log(f"corr {name} [{gpu}]: exact vs numpy; cold {runs[0] * 1e3:.3f} ms, "
         f"warm median {med * 1e3:.3f} ms of "
         f"{[round(r * 1e3, 3) for r in runs[1:]]}")
    return {"cold_ms": runs[0] * 1e3, "warm_ms": med * 1e3,
            "warm_all_ms": [r * 1e3 for r in runs[1:]], "forced": force,
            "instantiations": len(CATS) + len(TCAT_ABSENT)}


def _check_introspection(db, gpu: str) -> None:
    import torch
    from pg_strom_tpu_torch import execute
    from pg_strom_tpu_torch.ops import cuda as kc
    dev = execute("select device_kind from pgstrom_device_info "
                  "where id = 0", db).rows
    if dev != [(torch.cuda.get_device_name(0),)]:
        raise AssertionError(f"pgstrom_device_info: {dev}")
    prog = execute("select kind, plan_key from pgstrom_program_info", db).rows
    built = {r[1].split(" ")[0] for r in prog if r[0] == "kernel:built"}
    if built != set(kc.SOURCES):
        raise AssertionError(f"pgstrom_program_info: {prog[:6]}")
    tc = execute("select table_name, kind, nchunks, nbytes, hits from "
                 "pgstrom_tcache_info where table_name = 't0'", db).rows
    if not any(r[1] == "chunks" and r[3] > 0 for r in tc):
        raise AssertionError(f"pgstrom_tcache_info: t0 not resident ({tc})")
    _log(f"introspection [{gpu}]: device_kind {dev[0][0]}; program_info "
         f"{len(prog)} rows, kernel sources {sorted(built)} built; t0 "
         f"resident: {tc}")


def _check_explain(db, gpu: str) -> None:
    from pg_strom_tpu_torch import execute, override
    with override(show_device_kernel=True):
        text = "\n".join(r[0] for r in execute(
            "EXPLAIN select id from t0 where x < 1.0", db).rows)
    if "TpuScan on t0" not in text or "Device Kernel: " not in text:
        raise AssertionError(f"EXPLAIN: no TpuScan with a device kernel:\n"
                             f"{text[:800]}")
    kernel = text.split("Device Kernel: ", 1)[1]
    if not kernel.startswith("graph():") or "aten." not in kernel:
        raise AssertionError(f"EXPLAIN: device kernel {kernel[:300]}")
    _log(f"EXPLAIN with show_device_kernel [{gpu}]: a traced graph of "
         f"{len(kernel)} characters, {kernel.count('call_function')} calls")


def _check_shell(gpu: str) -> dict:
    """`python -m pg_strom_tpu_torch script.sql` on the card: exit code 0
    and the rows printed by the same queries run in this process."""
    import tempfile
    from pg_strom_tpu_torch import execute
    from pg_strom_tpu_torch.cli import _fmt_table
    from pg_strom_tpu_torch.datastore import Database
    from pg_strom_tpu_torch.models.testdb import BENCH_QUERIES, build_testdb
    queries = [BENCH_QUERIES["agg_group"], BENCH_QUERIES["window_rank"]]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "script.sql")
        with open(path, "w") as f:
            f.write("\\demo 100000\n" + "".join(q + ";\n" for q in queries))
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pg_strom_tpu_torch", path],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"shell exited {r.returncode}:\n"
                             f"{r.stderr[-2000:]}")
    db = Database()
    build_testdb(db, fact_rows=100000, dim_rows=40000)
    want = [_fmt_table(res.columns, res.rows, res.types) for res in
            (execute(q, db) for q in queries)]
    got = r.stdout
    pos = 0
    for w in want:
        i = got.find(w, pos)
        if i < 0:
            raise AssertionError(f"shell output lacks\n{w}\nin\n{got[-3000:]}")
        pos = i + len(w)
    if "ERROR" in got:
        raise AssertionError(f"shell printed an error:\n{got[-2000:]}")
    _log(f"shell [{gpu}]: python -m pg_strom_tpu_torch script.sql exited 0 "
         f"in {dt:.1f} s; its agg_group ({len(want[0].splitlines()) - 3} "
         f"rows) and window_rank tables equal the in-process ones")
    return {"seconds": dt}


def phase_surface(db, seed: int, gpu: str, window_rows_log2: int) -> dict:
    """window_rank, window_sum, two correlated subqueries, the pgstrom_*
    tables, EXPLAIN's device kernel and the shell, over the resident t0."""
    import torch
    from pg_strom_tpu_torch.exec.devcache import chunk_capacity
    t_phase = time.perf_counter()
    t0 = db.get("t0")
    nchunks = -(-t0.nrows // chunk_capacity(t0.nrows))
    cat, x, y = (t0.columns[c].data for c in ("cat", "x", "y"))
    kernels = _zero_launches()
    out = {"timing": {}}
    if (1 << window_rows_log2) < t0.nrows:
        wdb, _ = _t0_db(seed + 7, 1 << window_rows_log2)
        _log(f"window_rank runs over a separate t0 of 2^{window_rows_log2} "
             f"rows (--window-rows-log2)")
        out["timing"]["window_rank"] = _window_rank_cell(wdb, gpu, 1)
        wdb.drop("t0")
        del wdb
        torch.cuda.empty_cache()
    else:
        out["timing"]["window_rank"] = _window_rank_cell(db, gpu, 1)
    want = _window_sum_expected(cat, x, y)
    runs = []
    for i in range(4):
        rows, counts, dt, _ = _run_q(db, WINDOW_SUM_SQL, False)
        got = dict(rows)
        if set(got) != set(want) or not all(
                _close(got[k], want[k]) for k in want):
            raise AssertionError(f"window_sum: {rows[:3]} vs "
                                 f"{list(want.items())[:3]}")
        runs.append(dt)
    med = statistics.median(runs[1:])
    out["timing"]["window_sum"] = {"cold_ms": runs[0] * 1e3,
                                   "warm_ms": med * 1e3,
                                   "warm_all_ms": [r * 1e3 for r in runs[1:]]}
    _log(f"window window_sum [{gpu}]: {int((x < 1.0).sum())} rows reach the "
         f"host; per cat to rel 1e-9 vs numpy; cold {runs[0] * 1e3:.3f} ms, "
         f"warm median {med * 1e3:.3f} ms of "
         f"{[round(r * 1e3, 3) for r in runs[1:]]} (perfmon {counts})")
    _add_tcat(db)
    import numpy as np
    cnt = np.bincount(cat[x < 50.0], minlength=26)
    hit = np.bincount(cat[x > 99.99], minlength=26) > 0
    codes = sorted(CATS + TCAT_ABSENT)
    wants = {"corr_count": [(k, int(cnt[CATS.index(k)]) if k in CATS else 0)
                            for k in codes],
             "corr_exists": [(k,) for k in codes
                             if k in CATS and hit[CATS.index(k)]]}
    for name in CORR_SQL:
        out["timing"][name] = _corr_cell(db, name, gpu, nchunks, wants[name])
    db.drop("tcat")
    _check_introspection(db, gpu)
    _check_explain(db, gpu)
    out["shell"] = _check_shell(gpu)
    out["launches"] = {k: v.launches for k, v in kernels.items()}
    _log(f"phase 4f: kernel launches {out['launches']} (these paths reach "
         f"the device through the scan and aggregate executors); "
         f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return out


# ---------------------------------------------------------------------------
# phase 4g: COPY through the native loader, and the distributed mesh
# ---------------------------------------------------------------------------

COPY_ROWS_LOG2 = 24
DIST_SHARDS = 4
T0C_DDL = ("create table t0c (id int4, cat text, aid int4, bid int4, "
           "cid int4, did int4, eid int4, x float8, y float8)")
DIST_SQL = {
    # testdb.py:91 over the 2^27-row t0: the shuffle join+aggregate
    "dist_join_agg": JOIN_SQL["join_agg"],
    # DistPreAggExecutor: data-parallel grouped aggregation
    "dist_agg_group": T0_SQL["agg_group"],
    # the star over the 2^24-row t0c (the 2^28 staging cap of the
    # distributed star admits 2^24 rows of t0's nine columns): K3 probes
    # t6 and K2 groups by cat on every shard
    "dist_star": STAR_SQL["star_k3"].replace("t0.", "t0c.")
                                    .replace("from t0,", "from t0c,"),
    # the threshold top-k, one a shard
    "dist_topk": SORT_SQL["sort"],
    # count(DISTINCT) grouped: the dedup exchange
    "dist_distinct": "select cat, count(distinct aid), count(*) from t0 "
                     "group by cat order by cat",
}
DIST_COUNTER = {"dist_join_agg": "dist_steps", "dist_agg_group": "dist_steps",
                "dist_star": "dist_star_steps", "dist_topk": None,
                "dist_distinct": "dist_distinct_steps"}


def _csv_digits(v, width: int):
    """ASCII digits of non-negative ints, zero-padded to `width`: uint8
    [n, width]."""
    import numpy as np
    p10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((v.astype(np.int64)[:, None] // p10) % 10 + 48).astype(np.uint8)


def _write_t0_csv(path: str, seed: int, n: int) -> dict:
    """t0's schema (models/testdb.py:62-72) as CSV, built as a byte matrix
    in blocks: fixed-width zero-padded ints, the 26 three-letter codes and
    x, y = k / 10^4 with k in [0, 10^6) written as dd.dddd (strtod of that
    text and k / 10^4 are both the double nearest the exact quotient, so
    the planes compare bit for bit).  Returns the numpy columns."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(1, n + 1, dtype=np.int32),
            "cat": rng.integers(0, 26, n, dtype=np.int32)}
    for f in ("aid", "bid", "cid", "did", "eid"):
        cols[f] = rng.integers(1, 40001, n, dtype=np.int32)
    kx = rng.integers(0, 10 ** 6, n)
    ky = rng.integers(0, 10 ** 6, n)
    cols["x"], cols["y"] = kx / 1e4, ky / 1e4
    letters = np.frombuffer("".join(CATS).encode(), np.uint8).reshape(26, 3)
    comma = np.full((1, 1), ord(","), np.uint8)
    with open(path, "wb") as f:
        for lo in range(0, n, 1 << 20):
            hi = min(n, lo + (1 << 20))
            m = hi - lo
            c = np.broadcast_to(comma, (m, 1))
            parts = [_csv_digits(cols["id"][lo:hi], 8), c,
                     letters[cols["cat"][lo:hi]], c]
            for fk in ("aid", "bid", "cid", "did", "eid"):
                parts += [_csv_digits(cols[fk][lo:hi], 5), c]
            for k in (kx[lo:hi], ky[lo:hi]):
                parts += [_csv_digits(k // 10 ** 4, 2),
                          np.full((m, 1), ord("."), np.uint8),
                          _csv_digits(k % 10 ** 4, 4), c]
            parts[-1] = np.full((m, 1), ord("\n"), np.uint8)
            f.write(np.ascontiguousarray(np.hstack(parts)).tobytes())
    return cols


def _spy_copy():
    """Wrap the port's _copy_native: hit["native"] says whether it answered
    the COPY (the native loader), not the exact python path."""
    import pg_strom_tpu_torch.sql.api as api
    hit = {}
    orig = api._copy_native

    def wrapped(stmt, db, tbl):
        r = orig(stmt, db, tbl)
        hit["native"] = r is not None
        return r
    api._copy_native = wrapped
    return hit, lambda: setattr(api, "_copy_native", orig)


def _copy_t0(db, seed: int, gpu: str, log2n: int) -> dict:
    """COPY a 2^log2n-row CSV of t0's schema into t0c through the native
    loader: every plane exact, agg_group over it on K2 exact."""
    import numpy as np
    from pg_strom_tpu_torch import execute
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    n = 1 << log2n
    path = os.path.join(_workdir(), "t0c.csv")
    t0 = time.perf_counter()
    cols = _write_t0_csv(path, seed + 90, n)
    t_write = time.perf_counter() - t0
    size = os.path.getsize(path)
    _log(f"copy_t0: wrote {n} rows, {size} bytes of CSV in {t_write:.1f} s")
    if t_write > 60 and log2n > 22:
        raise AssertionError(f"copy_t0: the CSV took {t_write:.1f} s to "
                             "write; cut COPY_ROWS_LOG2 to 22")
    execute(T0C_DDL, db)
    hit, restore = _spy_copy()
    try:
        t0 = time.perf_counter()
        r = execute(f"copy t0c from '{path}' with (format csv)", db)
        t_copy = time.perf_counter() - t0
    finally:
        restore()
        os.unlink(path)
    if not hit.get("native") or r.command != f"COPY {n}":
        raise AssertionError(f"copy_t0: native path {hit}, {r.command}")
    t = db.get("t0c")
    for c, want in cols.items():
        col = t.columns[c]
        if c == "cat":
            if list(col.dictionary) != CATS or not np.array_equal(
                    col.data, want):
                raise AssertionError("copy_t0: cat codes differ")
        elif col.data.dtype != want.dtype or \
                col.data.tobytes() != want.tobytes():
            raise AssertionError(f"copy_t0: plane {c} differs")
        if not col.valid.all():
            raise AssertionError(f"copy_t0: NULLs in {c}")
    rate = n / t_copy
    _log(f"copy_t0 [{gpu}]: COPY {n} rows ({size} bytes) in {t_copy:.3f} s "
         f"= {rate:.0f} rows/s, {size / t_copy / 1e6:.1f} MB/s; every "
         f"plane exact vs numpy")
    for tbl in ("pgstrom_arena_info", "pgstrom_slab_info"):
        _log(f"copy_t0: {tbl} {execute(f'select * from {tbl}', db).rows}")
    before = pf.fused_cuda.launches
    sql = T0_SQL["agg_group"].replace("from t0", "from t0c")
    rows, counts, dt, _ = _run_q(db, sql, True)
    k2 = pf.fused_cuda.launches - before
    _check_t0("agg_group", rows, (cols["cat"], cols["cid"], cols["x"],
                                  cols["y"]))
    if k2 < 1 or counts.get("recheck_chunks", 0):
        raise AssertionError(f"copy_t0 agg_group: K2 {k2}, perfmon {counts}")
    _log(f"copy_t0 agg_group [{gpu}]: exact vs numpy, {dt * 1e3:.3f} ms, "
         f"K2 launches {k2}")
    return {"rows": n, "bytes": size, "write_s": t_write, "copy_s": t_copy,
            "rows_per_s": rate, "agg_group_ms": dt * 1e3, "k2_launches": k2,
            "cols": cols}


def _copy_mixed(db, gpu: str) -> dict:
    """A smaller COPY with date, text and numeric columns (load_csv2):
    native path taken, rows equal to the exact python path's."""
    from pg_strom_tpu_torch import execute
    import pg_strom_tpu_torch.sql.api as api
    from pg_strom_tpu_torch.sql import parser as ast
    n = 1 << 16
    path = os.path.join(_workdir(), "mix.csv")
    with open(path, "w") as f:
        f.write("".join(f"{i},{i * 0.25},2023-0{1 + i % 9}-1{i % 3},"
                        f"nm{i % 977},{i - 30000}.{i % 100:02d}\n"
                        for i in range(n)))
    ddl = "create table {} (id int4, x float8, d date, name text, n numeric)"
    execute(ddl.format("mixn"), db)
    execute(ddl.format("mixp"), db)
    hit, restore = _spy_copy()
    try:
        t0 = time.perf_counter()
        execute(f"copy mixn from '{path}' with (format csv)", db)
        dt = time.perf_counter() - t0
    finally:
        restore()
    api._copy_python(ast.parse(f"copy mixp from '{path}' with (format csv)"),
                     db, db.get("mixp"))
    os.unlink(path)
    q = "select id, x, d, name, n from {} order by id"
    a = execute(q.format("mixn"), db).formatted(-3)
    b = execute(q.format("mixp"), db).formatted(-3)
    db.drop("mixn")
    db.drop("mixp")
    if not hit.get("native") or a != b or len(a) != n:
        raise AssertionError(f"copy_mixed: native {hit}, equal {a == b}")
    _log(f"copy_mixed [{gpu}]: {n} rows of int4, float8, date, text and "
         f"numeric through load_csv2 in {dt * 1e3:.3f} ms, equal to the "
         f"python path")
    return {"rows": n, "copy_ms": dt * 1e3}


def _workdir() -> str:
    """Scratch files of phase 4g: _chipwork/ of the checkout (listed in
    .gitignore, not copied back from a chip run)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_chipwork")
    os.makedirs(d, exist_ok=True)
    return d


def _run_qp(db, sql: str, cfg: dict):
    """(rows, perfmon counts, perfmon bytes and phase seconds, seconds) of
    one query under perfmon and `cfg`."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    t0 = time.perf_counter()
    with override(perfmon=True, **cfg):
        pq = plan_query(ast.parse(sql), db)
        rows = pq.execute()
    torch.cuda.synchronize()
    return (rows, dict(pq.perfmon.counts),
            dict(pq.perfmon.bytes, **{f"{k}_s": round(v, 4) for k, v in
                                      pq.perfmon.times.items()}),
            time.perf_counter() - t0)


def _distinct_expected(t0cols):
    import numpy as np
    cat, aid = t0cols["cat"], t0cols["aid"]
    seen = np.bincount(cat.astype(np.int64) * 40001 + aid,
                       minlength=26 * 40001) > 0
    nd = seen.reshape(26, 40001).sum(axis=1)
    cnt = np.bincount(cat, minlength=26)
    return [(CATS[k], int(nd[k]), int(cnt[k])) for k in range(26) if cnt[k]]


def _dist_cell(db, name: str, sql: str, check, gpu: str, kernels,
               shards: int, n_warm: int = 3, cfg=None) -> dict:
    """One distributed cell: cold, then n_warm warm runs, each checked
    exactly and asserting its counter (so a DistFallback fails); the warm
    runs hit the resident shards and upload 0 bytes."""
    import torch
    cfg = dict({"distributed": True, "debug_force_offload": True,
                "mesh_shards": shards}, **(cfg or {}))
    counter = DIST_COUNTER[name]
    times, launches = [], []
    for i in range(1 + n_warm):
        k0 = {k: v.launches for k, v in kernels.items()}
        rows, counts, nbytes, dt = _run_qp(db, sql, cfg)
        launches.append({k: v.launches - k0[k] for k, v in kernels.items()})
        check(rows)
        if counter is not None and counts.get(counter, 0) < 1:
            raise AssertionError(f"{name}: {counter} not counted (a "
                                 f"fallback?): perfmon {counts}")
        if name == "dist_topk" and not counts.get("topk_threshold", 0):
            raise AssertionError(f"{name}: perfmon {counts}")
        if i and (counts.get("dist_resident_hits", 0) < 1
                  or nbytes.get("h2d", 0) != 0):
            raise AssertionError(f"{name}: warm run without resident "
                                 f"shards: perfmon {counts}, bytes {nbytes}")
        times.append(dt)
        if i == 0:
            cold_counts, cold_bytes = counts, nbytes
    torch.cuda.empty_cache()
    med = statistics.median(times[1:])
    where = (f"{shards} shards" if shards
             else f"{torch.cuda.device_count()} device(s), one shard each")
    _log(f"{name} [{gpu}] on {where}: exact; cold "
         f"{times[0] * 1e3:.3f} ms (h2d {cold_bytes.get('h2d', 0)} bytes), "
         f"warm median {med * 1e3:.3f} ms of "
         f"{[round(t * 1e3, 3) for t in times[1:]]} (0 h2d bytes); kernel "
         f"launches per run {launches}; cold perfmon {cold_counts}, warm "
         f"{counts}; the last warm run's phases {nbytes}")
    return {"cold_ms": times[0] * 1e3, "warm_ms": med * 1e3,
            "warm_all_ms": [t * 1e3 for t in times[1:]],
            "launches": launches, "shards": shards, "warm_phases": nbytes}


def phase_dist(db, seed: int, gpu: str) -> dict:
    """copy_t0 and the small mixed COPY, then the distributed cells on a
    4-shard mesh (round-robin over the visible devices: all on cuda:0 on
    one card) and again one shard a device when that mesh differs, then
    dryrun_multichip(4), flat and (2, 2)."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels = _zero_launches()
    out = {"timing": {}}
    out["copy_t0"] = _copy_t0(db, seed, gpu, COPY_ROWS_LOG2)
    ccols = out["copy_t0"].pop("cols")
    out["copy_mixed"] = _copy_mixed(db, gpu)
    t0 = db.get("t0")
    t0cols = {c: t0.columns[c].data for c in
              ("cat", "aid", "cid", "eid", "x", "y")}
    w_by_key = np.zeros(DIM_ROWS + 1, np.int64)
    t6 = db.get("t6")
    w_by_key[t6.columns["fid"].data] = t6.columns["w"].data
    want = {
        "dist_agg_group": lambda r: _check_t0(
            "agg_group", r, (t0cols["cat"], t0cols["cid"], t0cols["x"],
                             t0cols["y"])),
        "dist_join_agg": lambda r: _check_join("join_agg", r, t0cols,
                                               w_by_key),
        "dist_star": lambda r, w=_star_expected("star_k3", ccols, w_by_key,
                                                None):
            _check_star("dist_star", r, w),
        "dist_topk": lambda r, w=_sort_expected("sort", t0cols): (
            None if [tuple(x) for x in r] == w
            else _fail(f"dist_topk: {r[:3]} vs {w[:3]}")),
        "dist_distinct": lambda r, w=_distinct_expected(t0cols): (
            None if [tuple(x) for x in r] == w
            else _fail(f"dist_distinct: {r[:3]} vs {w[:3]}")),
    }
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.parallel.mesh import mesh_for_config
    meshes = {}
    for shards in (DIST_SHARDS, 0):      # 0: one shard a visible device
        with override(mesh_shards=shards):
            devs = tuple(str(d) for d in mesh_for_config().devices)
        if len(devs) >= 2 and devs not in meshes.values():
            meshes[shards] = devs
    _log(f"phase 4g: {torch.cuda.device_count()} device(s); the cells run "
         f"on the meshes {list(meshes.values())} ({DIST_SHARDS} shards "
         "round-robin over the devices, then one shard a device when there "
         "are several and that mesh differs)")
    for shards in meshes:
        key = "mesh" if shards else "per_device"
        out["timing"][key] = {}
        for name, sql in DIST_SQL.items():
            out["timing"][key][name] = _dist_cell(
                db, name, sql, want[name], gpu, kernels, shards)
    star = out["timing"]["mesh"]["dist_star"]["launches"]
    if any(r["K3"] < DIST_SHARDS or r["K2"] < DIST_SHARDS for r in star):
        raise AssertionError(f"dist_star: K3 / K2 not launched on every "
                             f"shard: {star}")
    # the device DISTINCT tier without pg_strom.distributed: one shard
    out["timing"]["device_distinct"] = _dist_cell(
        db, "dist_distinct", DIST_SQL["dist_distinct"],
        want["dist_distinct"], gpu, kernels, 0, n_warm=1,
        cfg={"distributed": False})
    db.drop("t0c")
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(DIST_SHARDS)
    _log(f"dryrun_multichip({DIST_SHARDS}) [{gpu}], flat and "
         f"{out['dryrun']['mesh_2d']}: {out['dryrun']} in "
         f"{time.perf_counter() - t0:.1f} s")
    out["launches"] = {k: v.launches for k, v in kernels.items()}
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"phase 4g: kernel launches {out['launches']}; "
         f"{out['seconds']:.1f} s [{gpu}]")
    if out["launches"]["K2"] < 1 or out["launches"]["K3"] < 1:
        raise AssertionError(f"phase 4g: K2 / K3 never launched "
                             f"{out['launches']}")
    torch.cuda.empty_cache()
    return out


def _fail(msg: str):
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase 4c: the K4 path (use_pallas_reduce, the fused kernel off)
# ---------------------------------------------------------------------------

# G of K4's chunk timings: agg_group's warm 32 and cold 1024, 256, and
# MAX_G = 2048 (two column tiles)
K4_TIMED_G = (32, 256, 1024, 2048)


def _k4_parent(root: str):
    """pallas_cuda of another checkout's port (`root`, e.g. unpacked with
    `git archive <commit> | tar -x -C root`), loaded beside this tree's
    under a name of its own: its K4 builds from its own sources and is
    called through its entry point (V, seg, G, n, fsum_cols) -> (ints,
    shadow)."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "pg_strom_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "k4_parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("k4_parent_port.ops.preagg_pallas"
                                   ).pallas_cuda


def _time_k4_at(name, V, seg, G, n, fc, decide, parent, gpu) -> dict:
    """K4 and its plain version (plain, kernel, kernel, plain; with
    `parent`: plain, parent, kernel, kernel, parent, plain) on one value
    matrix, after requiring ints bit-equal to the plain version (the
    parent's too) and the same replay decision."""
    from pg_strom_tpu_torch.ops import preagg_pallas as pp
    import torch
    err = _k4_check(f"{name} G={G}", V, seg, G, n, fc, decide)
    if parent is not None and not torch.equal(
            parent(V, seg, G, n, fc)[0],
            pp.pallas_reduce_reference(V, seg, G, n, fc)[0]):
        raise AssertionError(f"the parent's K4 at {name} G={G}: ints differ "
                             "from the plain version")

    def kern():
        return pp.pallas_cuda(V, seg, G, n, fc)

    def plain():
        return pp.pallas_reduce_reference(V, seg, G, n, fc)
    S = V.shape[1]
    p1 = _time(plain, 1)
    q1 = _time(lambda: parent(V, seg, G, n, fc), 10) if parent else None
    k1, k2 = _time(kern, 10), _time(kern, 10)
    q2 = _time(lambda: parent(V, seg, G, n, fc), 10) if parent else None
    p2 = _time(plain, 1)
    lp = pp.k4_plan(G, S, len(fc))
    b = _bound(n * (2 * S + 4) + G * S * 12, n * S)
    par = f", parent {q1:.4f} / {q2:.4f} ms" if parent else ""
    _log(f"K4 at {name} ({n} rows, G={G}, S={S}, {len(fc)} shadows), block "
         f"{lp.block}, {lp.ntiles} column tile(s), {lp.smem} B shared memory "
         f"[{gpu}]: kernel {k1:.4f} / {k2:.4f} ms{par}, plain PyTorch "
         f"{p1:.4f} / {p2:.4f} ms, bound {b['bound_ms']:.4f} ms "
         f"({b['bound_by']}, share {b['bound_ms'] / min(k1, k2):.3f})")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "err": err, **b,
            "kernel_all_ms": [k1, k2], "plain_all_ms": [p1, p2],
            "parent_all_ms": [q1, q2] if parent else None,
            "block": lp.block, "column_tiles": lp.ntiles, "smem": lp.smem}


def phase_k4_path(db, data, nchunks: int, gpu: str,
                  parent_root: str | None = None) -> dict:
    """agg_group through build_mxu_columns + K4 on 4b's resident t0, cold
    and 5 warm runs: K4 launched on every chunk of each run, K2 never,
    rows equal to the K2 path's as PostgreSQL text; then K4 alone at the
    chunk (_time_k4), beside the K4 of the checkout at `parent_root` when
    it is given."""
    import torch
    from pg_strom_tpu_torch import execute, override
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    from pg_strom_tpu_torch.ops import preagg_pallas as pp
    sql = T0_SQL["agg_group"]
    k2 = execute(sql, db)
    _check_t0("agg_group", k2.rows, data)
    want = k2.formatted(-3)
    pp.pallas_cuda.launches = 0
    k2_before = pf.fused_cuda.launches
    times, per_run = [], []
    with override(use_fused_preagg=False, use_pallas_reduce=True,
                  debug_force_tpupreagg=True):
        for run in range(6):                     # cold, then 5 warm
            before = pp.pallas_cuda.launches
            t = time.perf_counter()
            rows = execute(sql, db)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_run.append(pp.pallas_cuda.launches - before)
            if rows.formatted(-3) != want:
                raise AssertionError(f"K4 path run {run}: rows differ from "
                                     "the K2 path's")
    launches = pp.pallas_cuda.launches
    if min(per_run) < nchunks or pf.fused_cuda.launches != k2_before:
        raise AssertionError(f"K4 path: K4 launches per run {per_run} over "
                             f"{nchunks} chunks, K2 launched "
                             f"{pf.fused_cuda.launches - k2_before} times")
    warm = [t * 1e3 for t in times[1:]]
    med = statistics.median(warm)
    _log(f"t0 agg_group on the K4 path [{gpu}]: rows equal to the K2 path's "
         f"as PostgreSQL text; cold {times[0] * 1e3:.3f} ms, warm median "
         f"{med:.3f} ms of {[round(w, 3) for w in warm]} (K4 launches per "
         f"run {per_run}, {launches} in all)")
    parent = _k4_parent(parent_root) if parent_root else None
    chunk, corr = _time_k4(db, gpu, parent)
    return {"launches": launches, "cold_ms": times[0] * 1e3, "warm_ms": med,
            "warm_all_ms": warm, "chunk": chunk, "corr": corr}


def _time_k4(db, gpu: str, parent=None) -> tuple[dict, dict]:
    """K4 alone and its plain version (_time_k4_at), index_add_ and
    mxu_reduce's default path (use_pallas_reduce off: what a shape that K2
    does not take runs) on the value matrix of the first 2^26-row
    agg_group chunk, at each G of K4_TIMED_G; then K4 and its plain
    version on corr's value matrix (int4 key hashed, S = 111, five
    shadows) of as many rows at G = 2048, in column tiles."""
    import numpy as np
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.ops.preagg_mxu import mxu_reduce
    res = {}
    keys, aggs, vals, mask, _, n = _t0_chunk_lanes(db, K4_TIMED_G[0])
    V, fc, decide = _k4_inputs(keys, aggs, vals, mask, True)
    S = V.shape[1]
    # one PyTorch call computing the same sums: index_add_ of the int64
    # value matrix into G+1 rows (row G takes the dropped rows); the int64
    # conversion is timed apart
    conv = _time(lambda: V[:n].to(torch.int64), 3)
    V64 = V[:n].to(torch.int64)
    for G in K4_TIMED_G:
        seg = _t0_chunk_lanes(db, G)[4].contiguous()
        res[G] = _time_k4_at("the agg_group chunk's value matrix", V, seg, G,
                             n, fc, decide, parent, gpu)
        seg64 = seg[:n].to(torch.int64)
        lib = _time(lambda: torch.zeros(G + 1, S, dtype=torch.int64,
                                        device=V.device).index_add_(
                                            0, seg64, V64), 3)
        with override(use_pallas_reduce=False):
            dflt = _time(lambda: mxu_reduce(V, seg, G, n, fsum_cols=fc), 1)
        res[G].update(library_ms=lib, convert_ms=conv,
                      mxu_reduce_default_ms=dflt)
        _log(f"K4 at the agg_group chunk's value matrix, G={G} [{gpu}]: "
             f"index_add_ {lib:.4f} ms (+ {conv:.4f} ms int64 conversion), "
             f"mxu_reduce without K4 {dflt:.4f} ms")
        del seg64
    dev = V.device
    del V64, V, keys, aggs, vals, mask
    torch.cuda.empty_cache()
    keys, aggs, vals, mask, seg, G, dense = _k2_case(
        "corr_covar", np.random.default_rng(17), n, dev, 2048)
    V, fc, decide = _k4_inputs(keys, aggs, vals, mask, dense)
    del keys, aggs, vals, mask
    corr = _time_k4_at("corr's value matrix", V, seg, G, n, fc, decide,
                       parent, gpu)
    del V, seg
    torch.cuda.empty_cache()
    return res, corr


# ---------------------------------------------------------------------------
# phase 4h: float8 across the whole double range, IEEE on the card
# ---------------------------------------------------------------------------

F8_TINY = (5e-324, 1e-310, 1e-300, 1e-38)
F8_HUGE = (1e37, 3.5e38, 1e300)
F8_SPECIAL = (0.0, -0.0, math.nan, math.inf, -math.inf, 1.7e308, -1.7e308,
              1e300, 5e-324, 1e-38)
# compares, ORDER BY ... LIMIT, GROUP BY the float8, min / max, DISTINCT and
# a join on a float8 key: none of them may replay a chunk on the host
F8_SQL = {
    "where_huge": "select k, v, w from f8 where v > 1e37 and w > 1500",
    "where_tiny": "select k, v, w from f8 where v < 0 and v > -1e-30 "
                  "and w > 1550",
    "count_subnormal": "select count(*) from f8 where v = 1e-310",
    "count_v_ge_w": "select count(*) from f8 where v >= w",
    "topk_asc": "select k, v, w from f8 order by v, k, w limit 25",
    "topk_desc": "select k, v, w from f8 order by v desc, k, w limit 25",
    "group_by_v": "select v, count(*) from f8 group by v order by v",
    "min_max": "select k, min(v), max(v), count(v) from f8 group by k "
               "order by k",
    "count_distinct": "select k, count(distinct v) from f8 group by k "
                      "order by k",
    "join_agg": "select d8.label, count(*) from f8 join d8 on f8.v = d8.v "
                "group by d8.label order by 1",
    "sum_w_where_huge": "select k, sum(w), avg(w), count(w) from f8 "
                        "where v < -1e37 group by k order by k",
}
# sums whose float8 quantity leaves the lanes' domain: each replays
F8_SUM_SQL = {
    f"{agg}_{grp}": f"select k, {agg}(v) from f8 where k % 4 = {m} "
                    "group by k order by k"
    for grp, m in (("tiny", 1), ("huge", 2))
    for agg in ("sum", "avg", "stddev")}
F8_CFG = {"debug_force_offload": True, "debug_force_tpupreagg": True}
# rows of the f8 that is held to the host tier (a host replay of 2^26 rows
# takes minutes)
F8_HOST_ROWS_LOG2 = 16


def _f8_values(rng, n: int, k):
    """v by k % 4: 0 normal (a discrete set), 1 tiny only, 2 huge only (both
    with random signs), 3 the specials, tiny, huge and normal mixed (the
    draw of tests/test_torch_float8_native.py)."""
    import numpy as np
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    normal = rng.integers(-2000, 2000, n) / 16.0
    tiny = sign * np.asarray(F8_TINY)[rng.integers(0, len(F8_TINY), n)]
    huge = sign * np.asarray(F8_HUGE)[rng.integers(0, len(F8_HUGE), n)]
    pool = np.concatenate([F8_SPECIAL, -np.asarray(F8_TINY), F8_HUGE,
                           -np.asarray(F8_HUGE), [1.5, -2.25, 100.0]])
    mixed = pool[rng.integers(0, len(pool), n)]
    return np.choose(k % 4, [normal, tiny, huge, mixed])


def _f8_db(seed: int, n: int):
    """A port Database with f8(k int4 0..31, v float8, w float8; 5% NULL
    each) and d8(v float8, label int4): one row per SQL-distinct value of
    v's specials, tiny and huge pools.  Returns (db, numpy columns)."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 32, n, dtype=np.int32)
    v = _f8_values(rng, n, k)
    w = rng.integers(-100000, 100000, n) / 64.0
    vv = rng.random(n) > 0.05
    wv = rng.random(n) > 0.05
    dv = np.asarray([0.0, math.nan, math.inf, -math.inf, 1.7e308, -1.7e308]
                    + [s * x for x in F8_TINY + F8_HUGE for s in (1.0, -1.0)]
                    + [1.5, -2.25])
    db = Database()
    db.create(Table.from_columns("f8", {"k": cn(T.INT4, k),
                                        "v": cn(T.FLOAT8, v, vv),
                                        "w": cn(T.FLOAT8, w, wv)}))
    db.create(Table.from_columns("d8", {
        "v": cn(T.FLOAT8, dv),
        "label": cn(T.INT4, np.arange(len(dv), dtype=np.int32) * 10)}))
    return db, {"k": k, "v": v, "vv": vv, "w": w, "wv": wv, "dv": dv}


def _f8_canon(a):
    """Float8 bits with PostgreSQL's equality: -0 is 0, one NaN."""
    import numpy as np
    a = np.asarray(a, np.float64)
    a = np.where(a == 0, 0.0, a)
    return np.where(np.isnan(a), np.nan, a).view(np.int64)


def _f8_okey(a):
    """int64 keys in PostgreSQL's float8 order (NaN above +inf)."""
    import numpy as np
    b = _f8_canon(a)
    return np.where(b < 0, -1 - (b & np.int64((1 << 63) - 1)), b)


def _f8_expected(name: str, c):
    """numpy's answer to F8_SQL[name]."""
    import numpy as np
    k, v, vv, w, wv = c["k"], c["v"], c["vv"], c["w"], c["wv"]
    nan = np.isnan(v)
    if name in ("where_huge", "where_tiny"):
        m = (vv & wv & (((v > 1e37) | nan) & (w > 1500)
                        if name == "where_huge" else
                        (v < 0) & (v > -1e-30) & (w > 1550)))
        o = np.lexsort((w[m], _f8_okey(v[m]), k[m]))
        return k[m][o], v[m][o], w[m][o]
    if name == "count_subnormal":
        return int((vv & (v == 1e-310)).sum())
    if name == "count_v_ge_w":
        return int((vv & wv & ((v >= w) | nan)).sum())
    if name in ("topk_asc", "topk_desc"):
        # ASC puts NULLs last, DESC (PostgreSQL's default) first; the ties
        # order by k, then w with its NULLs last.  The rows at or below the
        # 25th primary key are the only candidates.
        ok = _f8_okey(v)
        big = np.iinfo(np.int64)
        prim = (np.where(vv, ok, big.max) if name == "topk_asc"
                else np.where(vv, -ok, big.min))
        cand = np.flatnonzero(prim <= np.partition(prim, 24)[24])
        o = cand[np.lexsort((np.where(wv[cand], w[cand], 0.0), ~wv[cand],
                             k[cand], prim[cand]))][:25]
        return k[o], np.where(vv[o], v[o], math.nan), vv[o], \
            np.where(wv[o], w[o], math.nan), wv[o]
    if name == "group_by_v":
        keys, cnt = np.unique(_f8_okey(v[vv]), return_counts=True)
        return keys, cnt, int((~vv).sum())
    if name == "min_max":
        out = []
        for g in range(32):
            x = v[vv & (k == g)]
            fin = x[~np.isnan(x)]
            lo = fin.min() if len(fin) else math.nan
            hi = math.nan if np.isnan(x).any() else x.max()
            out.append((g, lo, hi, len(x)))
        return out
    if name == "count_distinct":
        return [(g, len(np.unique(_f8_canon(v[vv & (k == g)]))))
                for g in range(32)]
    if name == "join_agg":
        keys, cnt = np.unique(_f8_canon(v[vv]), return_counts=True)
        by = dict(zip(keys.tolist(), cnt.tolist()))
        return [(i * 10, by[b]) for i, b in enumerate(_f8_canon(c["dv"]))
                if b in by]
    if name == "sum_w_where_huge":
        m = vv & (v < -1e37)
        mw = m & wv
        n_ = np.bincount(k[m], minlength=32)
        cnt = np.bincount(k[mw], minlength=32)
        s = np.bincount(k[mw], weights=w[mw], minlength=32)
        return [(g, s[g], s[g] / cnt[g], int(cnt[g])) for g in range(32)
                if n_[g]]
    raise KeyError(name)


def _f8_same(a, b) -> bool:
    """Float8 values equal under PostgreSQL's equality (NaN = NaN)."""
    return bool(_f8_canon([a])[0] == _f8_canon([b])[0])


def _f8_check(name: str, rows, want) -> None:
    """rows of F8_SQL[name] against _f8_expected's answer."""
    import numpy as np
    bad = None
    if name in ("where_huge", "where_tiny"):
        # the WHERE keeps no NULL v or w
        gk, gv, gw = (np.asarray([r[i] for r in rows], np.float64)
                      for i in range(3))
        o = np.lexsort((gw, _f8_okey(gv), gk))
        got = (gk[o].astype(np.int64), gv[o], gw[o])
        if not (len(got[0]) == len(want[0])
                and np.array_equal(got[0], want[0])
                and np.array_equal(got[1].view(np.int64),
                                   want[1].view(np.int64))
                and np.array_equal(got[2], want[2])):
            bad = f"{len(rows)} rows vs {len(want[0])}"
    elif name in ("count_subnormal", "count_v_ge_w"):
        if rows != [(want,)]:
            bad = f"{rows} vs {want}"
    elif name in ("topk_asc", "topk_desc"):
        wk, wv_, wvv, ww, wwv = want
        exp = [(int(a), float(b) if n1 else None, float(d) if n2 else None)
               for a, b, n1, d, n2 in zip(wk, wv_, wvv, ww, wwv)]
        if len(rows) != len(exp) or any(
                r[0] != e[0] or (r[1] is None) != (e[1] is None)
                or (r[1] is not None and not _f8_same(r[1], e[1]))
                or r[2] != e[2] for r, e in zip(rows, exp)):
            bad = f"{rows[:3]} vs {exp[:3]}"
    elif name == "group_by_v":
        keys, cnt, nnull = want
        body = [r for r in rows if r[0] is not None]
        got = (_f8_okey([r[0] for r in body]), [r[1] for r in body])
        if not (np.array_equal(got[0], keys) and got[1] == cnt.tolist()
                and rows[-1] == (None, nnull)):
            bad = f"{len(rows)} groups vs {len(keys) + 1}"
    elif name == "min_max":
        if len(rows) != len(want) or any(
                r[0] != e[0] or not _f8_same(r[1], e[1])
                or not _f8_same(r[2], e[2]) or r[3] != e[3]
                for r, e in zip(rows, want)):
            bad = f"{rows[:3]} vs {want[:3]}"
    elif name == "sum_w_where_huge":
        if len(rows) != len(want) or any(
                r[0] != e[0] or r[3] != e[3] or not _close(r[1], e[1])
                or not _close(r[2], e[2]) for r, e in zip(rows, want)):
            bad = f"{rows[:3]} vs {want[:3]}"
    elif [tuple(r) for r in rows] != want:
        bad = f"{rows[:4]} vs {want[:4]}"
    if bad:
        raise AssertionError(f"4h {name}: differs from numpy: {bad}")


def _f8_sum_expected(name: str, c) -> list:
    """numpy's sums in PostgreSQL's row order (a sequential cumsum), avg
    as sum / count, stddev to rel 1e-9; stddev over huge values overflows
    in PostgreSQL (None: the query must fail with its error)."""
    import numpy as np
    agg, grp = name.split("_")
    if name == "stddev_huge":
        return None
    k, v, vv = c["k"], c["v"], c["vv"]
    out = []
    for g in range(1 if grp == "tiny" else 2, 32, 4):
        x = v[vv & (k == g)]
        s = float(np.cumsum(x)[-1])
        out.append((g, float(np.std(x, ddof=1)) if agg == "stddev"
                    else s / len(x) if agg == "avg" else s))
    return out


def _run_text(db, sql: str, cfg: dict):
    """(('rows', rows as text) or ('error', class, text), rows, counts,
    seconds) of one query under perfmon; rows of a query without ORDER BY
    are sorted."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    from pg_strom_tpu_torch.sql.api import Result
    t0 = time.perf_counter()
    try:
        with override(perfmon=True, **cfg):
            pq = plan_query(ast.parse(sql), db)
            rows = pq.execute()
    except Exception as e:              # compared with the host tier's
        return ("error", type(e).__name__, str(e)), None, {}, \
            time.perf_counter() - t0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    text = Result(columns=pq.out_names, rows=rows,
                  types=pq.out_types).formatted(-3)
    if " order by " not in sql:
        text = sorted(text)
    return ("rows", tuple(text)), rows, dict(pq.perfmon.counts), dt


def _device_launched(counts) -> int:
    return sum(v for c, v in counts.items()
               if c.startswith("kernel ") or c == "dist_steps")


def phase_float8(seed: int, log2n: int, host_log2n: int, gpu: str) -> dict:
    """f8 at 2^log2n rows: F8_SQL cold and 3 warm on the device, exact
    against numpy, none replayed; then a 2^host_log2n-row f8 of the same
    draw: F8_SQL and F8_SUM_SQL on the device equal to the port's host
    tier as PostgreSQL text, every F8_SUM_SQL query replayed (cold and 3
    warm; at 2^log2n rows one host replay would take minutes)."""
    import torch
    from pg_strom_tpu_torch.exec.devcache import TCACHE, chunk_capacity
    from pg_strom_tpu_torch.ops import preagg_fused as pf
    t_phase = time.perf_counter()
    n = 1 << log2n
    db, c = _f8_db(seed + 7, n)
    nchunks = -(-n // chunk_capacity(n))
    _log(f"4h: f8 {n} rows generated in {time.perf_counter() - t_phase:.1f}"
         f" s, {nchunks} chunk(s)")
    TCACHE.clear()
    out = {"queries": {}}
    k2 = pf.fused_cuda.launches
    for name, sql in F8_SQL.items():
        want = _f8_expected(name, c)
        runs = []
        for i in range(4):
            res, rows, counts, dt = _run_text(db, sql, F8_CFG)
            if res[0] != "rows":
                raise AssertionError(f"4h {name}: {res}")
            if (counts.get("recheck_chunks", 0) or counts.get("cpu_fallback")
                    or counts.get("unported_host_exact")
                    or not _device_launched(counts)):
                raise AssertionError(f"4h {name}: perfmon {counts}: "
                                     "expected the device and no replay")
            _f8_check(name, rows, want)
            runs.append(dt)
            if i == 0:
                cold_counts = counts
        ent = [r for r in TCACHE.info_rows() if r["table_name"] == "f8"
               and r["kind"] == "chunks"]
        out["queries"][name] = {"cold_ms": runs[0] * 1e3,
                                "warm_ms": statistics.median(runs[1:]) * 1e3,
                                "rows": len(rows)}
        _log(f"4h {name} [{gpu}]: {len(rows)} rows exact vs numpy; "
             f"recheck_chunks 0, replayed rows 0; cold {runs[0] * 1e3:.3f} "
             f"ms, warm median {statistics.median(runs[1:]) * 1e3:.3f} ms "
             f"of {[round(r * 1e3, 3) for r in runs[1:]]} (perfmon on; cold "
             f"perfmon {cold_counts})")
    out["k2_launches"] = pf.fused_cuda.launches - k2
    out["plane_bytes"] = ent[0]["nbytes"] if ent else None
    _log(f"4h: f8's planes {out['plane_bytes']} B resident "
         f"({(out['plane_bytes'] or 0) / (nchunks * chunk_capacity(n)):.0f} "
         f"B a row); K2 launches {out['k2_launches']}")
    if out["k2_launches"] < 1:
        raise AssertionError("4h: K2 never launched")
    del db
    TCACHE.clear()
    torch.cuda.empty_cache()

    m = 1 << host_log2n
    db, c = _f8_db(seed + 8, m)
    cap = chunk_capacity(m)
    for name, sql in list(F8_SQL.items()) + list(F8_SUM_SQL.items()):
        host, _, _, hdt = _run_text(db, sql, {"enabled": False})
        replay = name in F8_SUM_SQL
        runs = []
        for _ in range(4 if replay else 1):
            res, rows, counts, dt = _run_text(db, sql, F8_CFG)
            if res != host:
                raise AssertionError(f"4h {name} at {m} rows: device "
                                     f"{str(res)[:300]} vs host tier "
                                     f"{str(host)[:300]}")
            runs.append(dt)
        if replay:
            want = _f8_sum_expected(name, c)
            if want is None:
                if res != ("error", "SqlError",
                           "value out of range: overflow"):
                    raise AssertionError(f"4h {name}: {res}")
            else:
                if len(rows) != len(want) or any(
                        r[0] != e[0] or not _close(r[1], e[1])
                        for r, e in zip(rows, want)):
                    raise AssertionError(f"4h {name}: {rows} vs {want}")
                if not counts.get("recheck_chunks"):
                    raise AssertionError(f"4h {name}: not replayed: "
                                         f"perfmon {counts}")
        elif counts.get("recheck_chunks", 0) or counts.get("cpu_fallback"):
            raise AssertionError(f"4h {name} at {m} rows: perfmon {counts}")
        rc = counts.get("recheck_chunks", 0)
        out["queries"].setdefault(name, {})["host_check"] = {
            "recheck_chunks": rc, "replayed_rows": min(rc * cap, m),
            "device_ms": [r * 1e3 for r in runs], "host_ms": hdt * 1e3}
        how = (f"recheck_chunks {rc}, replayed rows {min(rc * cap, m)}"
               if res[0] == "rows" else
               f"{res[2]!r}, which only the host replay raises")
        _log(f"4h {name} at {m} rows [{gpu}]: device == host tier; {how}; "
             f"device {[round(r * 1e3, 3) for r in runs]} ms, host tier "
             f"{hdt * 1e3:.3f} ms")
    del db
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"phase 4h: {out['seconds']:.1f} s [{gpu}]")
    return out


# ---------------------------------------------------------------------------
# phase 4i: float sums whose groups sit far apart in scale
# ---------------------------------------------------------------------------

# groups 0..61 at scales 2^-60 ... 2^60, group 62 zeros, 63 float4
# subnormals.  The bulk rows belong to groups 57..61 (scales 2^52 ... 2^60,
# within 2^9 of the columns' largest |value|: no bucket's window check
# trips there, on K1's column-wide window either); the tail chunk holds
# every other group, so it is the one chunk with a hazard
SW_BULK = (57, 62)
SW_ZERO, SW_SUB = 62, 63
SW_SUBNORMALS = (1.4e-45, 1e-40, 3e-39)
SW_SQL = {"a": "select k, sum(a), avg(a) from sw group by k order by k",
          "b": "select k, sum(b), avg(b) from sw group by k order by k"}
# (name, query, settings, kernel): K1 sums float4 only
SW_RUNS = (("K1", "a", {}, "K1"),
           ("K2", "a", {"use_fused_preagg2": False}, "K2"),
           ("K2", "b", {}, "K2"),
           ("K4", "a", {"use_fused_preagg": False, "use_pallas_reduce": True},
            "K4"),
           ("K4", "b", {"use_fused_preagg": False, "use_pallas_reduce": True},
            "K4"))
SW_TAIL_LOG2 = 16


def _sw_exp(g: int) -> int:
    return -60 + (120 * g) // 61


def _sw_db(seed: int, bulk_log2: int, tail_log2: int):
    """A port Database holding sw(k int4, a float4, b float8): 2^bulk_log2
    rows of groups SW_BULK, then a 2^tail_log2-row tail of every other
    group in random order with random signs.  Returns (db, numpy
    columns)."""
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    rng = np.random.default_rng(seed)
    nb, nt = 1 << bulk_log2, 1 << tail_log2
    kt = rng.integers(0, 64 - (SW_BULK[1] - SW_BULK[0]), nt).astype(np.int32)
    kt = np.where(kt >= SW_BULK[0], kt + (SW_BULK[1] - SW_BULK[0]), kt)
    k = np.concatenate([rng.integers(*SW_BULK, nb, dtype=np.int32), kt])
    n = nb + nt
    scale = np.ldexp(1.0, np.asarray([_sw_exp(g) for g in range(62)]
                                     + [0, 0])[k])
    sign = np.ones(n)
    sign[nb:] = np.where(rng.random(nt) < 0.5, -1.0, 1.0)
    a = (sign * scale * (1.0 + rng.random(n))).astype(np.float32)
    b = sign * scale * (1.0 + rng.random(n))
    sub = np.asarray(SW_SUBNORMALS, np.float32)[rng.integers(0, 3, n)]
    a = np.where(k == SW_SUB, sub * sign.astype(np.float32), a)
    a = np.where(k == SW_ZERO, np.float32(0.0) * sign.astype(np.float32), a)
    b = np.where(k == SW_SUB, a.astype(np.float64), b)
    b = np.where(k == SW_ZERO, 0.0 * sign, b)
    db = Database()
    db.create(Table.from_columns("sw", {"k": cn(T.INT4, k),
                                        "a": cn(T.FLOAT4, a),
                                        "b": cn(T.FLOAT8, b)}))
    return db, {"k": k, "a": a, "b": b, "nb": nb}


def _sw_expected(col: str, c) -> dict:
    """k -> (sum, avg) in PostgreSQL's terms: a bulk group's device sum is
    exact (float64 bincount, rel 1e-9 of it), a tail group replays on the
    host and sums stepwise in row order (float4 sum in float32, the rest
    in float64)."""
    import numpy as np
    k, v, nb = c["k"], c[col], c["nb"]
    out = {}
    bulk = np.bincount(k[:nb], weights=v[:nb].astype(np.float64),
                       minlength=64)
    nbulk = np.bincount(k[:nb], minlength=64)
    for g in range(*SW_BULK):
        out[g] = (bulk[g], bulk[g] / nbulk[g])
    kt, vt = k[nb:], v[nb:]
    for g in np.unique(kt):
        x = vt[kt == g]
        s = float(np.cumsum(x, dtype=np.float32)[-1] if col == "a"
                  else np.cumsum(x)[-1])
        out[int(g)] = (s, float(np.cumsum(x.astype(np.float64))[-1])
                       / len(x))
    return out


def _sw_close(got, want, rel: float) -> bool:
    """Relative only: the point of this phase is values near 2^-60 and
    the subnormals, which any absolute tolerance would pass."""
    return got == want or math.isclose(got, want, rel_tol=rel, abs_tol=0.0)


def _sw_check(name: str, col: str, rows, want) -> None:
    if [r[0] for r in rows] != sorted(want):
        raise AssertionError(f"4i {name}({col}): groups {[r[0] for r in rows]}")
    for g, s, avg in rows:
        ws, wa = want[g]
        rel = 1e-6 if col == "a" else 1e-9     # float4 sum: one f32 rounding
        if not (_sw_close(s, ws, rel) and _sw_close(avg, wa, 1e-9)):
            raise AssertionError(f"4i {name}({col}) group {g} (scale "
                                 f"2^{_sw_exp(g) if g < 62 else 0}): "
                                 f"{(s, avg)} vs numpy {(ws, wa)}")


def _sw_run(db, sql: str, cfg: dict):
    """(rows, counts, host replay seconds, wall seconds, output types) of
    one query."""
    import torch
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    t0 = time.perf_counter()
    with override(perfmon=True, debug_force_offload=True,
                  debug_force_tpupreagg=True, **cfg):
        pq = plan_query(ast.parse(sql), db)
        rows = pq.execute()
    torch.cuda.synchronize()
    return (rows, dict(pq.perfmon.counts),
            pq.perfmon.times.get("cpu_fallback", 0.0),
            time.perf_counter() - t0, pq.out_types)


def _sw_launches() -> dict:
    from pg_strom_tpu_torch.ops import (preagg_fused as pf,
                                        preagg_fused2 as pf2,
                                        preagg_pallas as pp)
    return {"K1": pf2.fused2_cuda.launches, "K2": pf.fused_cuda.launches,
            "K4": pp.pallas_cuda.launches}


def phase_sum_window(seed: int, log2n: int, gpu: str) -> dict:
    """sw at 2^log2n bulk rows plus a 2^SW_TAIL_LOG2-row tail, in chunks
    of 2^(log2n - 4) rows: sum and avg of a (float4) and b (float8) through
    K1, K2 and K4, cold and 3 warm, each group against numpy, recheck_chunks
    1 (the tail chunk) on every run; then a 2^16-row bulk with a 2^12-row
    tail, each route equal to the port's host tier as PostgreSQL text."""
    import torch
    from pg_strom_tpu_torch.exec.devcache import TCACHE
    from pg_strom_tpu_torch.sql.api import Result
    t_phase = time.perf_counter()
    db, c = _sw_db(seed + 12, log2n, SW_TAIL_LOG2)
    cfg0 = {"chunk_rows": 1 << (log2n - 4)}
    nchunks = 16 + 1
    want = {col: _sw_expected(col, c) for col in SW_SQL}
    _log(f"4i: sw {c['nb']} + {1 << SW_TAIL_LOG2} rows generated, {nchunks} "
         f"chunks, expected sums in {time.perf_counter() - t_phase:.1f} s")
    TCACHE.clear()
    out = {"runs": {}, "launches": {"K1": 0, "K2": 0, "K4": 0}}
    for name, col, cfg, kern in SW_RUNS:
        runs, replay = [], []
        before = _sw_launches()
        for i in range(4):
            rows, counts, host_s, dt, _ = _sw_run(db, SW_SQL[col],
                                                  dict(cfg0, **cfg))
            _sw_check(name, col, rows, want[col])
            if (counts.get("recheck_chunks", 0) != 1
                    or counts.get("device_chunks", 0) != nchunks - 1):
                raise AssertionError(f"4i {name}({col}): perfmon {counts}: "
                                     "expected the tail chunk alone "
                                     "replayed")
            runs.append(dt)
            replay.append(host_s)
        n_l = {kk: v - before[kk] for kk, v in _sw_launches().items()}
        if n_l[kern] < 4 * (nchunks - 1):
            raise AssertionError(f"4i {name}({col}): {kern} launched "
                                 f"{n_l[kern]} times in 4 runs")
        for kk, v in n_l.items():
            out["launches"][kk] += v
        out["runs"][f"{name}_{col}"] = {
            "cold_ms": runs[0] * 1e3,
            "warm_ms": statistics.median(runs[1:]) * 1e3,
            "replay_ms": statistics.median(replay[1:]) * 1e3,
            "launches": n_l}
        _log(f"4i {name} {SW_SQL[col]!r} [{gpu}]: 64 groups against numpy; "
             f"recheck_chunks 1 (the {1 << SW_TAIL_LOG2}-row tail), "
             f"{nchunks - 1} device chunks; {kern} launches {n_l[kern]}; "
             f"cold {runs[0] * 1e3:.3f} ms, warm median "
             f"{statistics.median(runs[1:]) * 1e3:.3f} ms of "
             f"{[round(r * 1e3, 3) for r in runs[1:]]}, host replay median "
             f"{statistics.median(replay[1:]) * 1e3:.3f} ms (perfmon on)")
    del db
    TCACHE.clear()
    torch.cuda.empty_cache()

    db, c = _sw_db(seed + 13, 16, 12)
    for name, col, cfg, kern in SW_RUNS:
        def text(cfg_):
            rows, counts, _, _, types = _sw_run(db, SW_SQL[col], cfg_)
            return Result(columns=["k", "sum", "avg"], rows=rows,
                          types=types).formatted(-3), counts
        host, _ = text({"enabled": False})
        got, counts = text({"chunk_rows": 1 << 14, **cfg})
        if got != host or counts.get("recheck_chunks", 0) != 1:
            raise AssertionError(f"4i {name}({col}) at 2^16 + 2^12 rows: "
                                 f"perfmon {counts}; device {got[:4]} vs "
                                 f"host tier {host[:4]}")
    _log(f"4i at 2^16 + 2^12 rows [{gpu}]: K1, K2 and K4 equal to the host "
         "tier as PostgreSQL text, the tail chunk replayed")
    del db
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"phase 4i: {out['seconds']:.1f} s [{gpu}]")
    return out


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
    db, _ = _t0_db(seed + 3, n, nulls=True)
    for name, sql in T0_SQL.items():
        with override(debug_force_tpupreagg=True):
            dev_rows = _sorted(execute(sql, db).rows)
        with override(enable_tpupreagg=False):
            host_rows = _sorted(execute(sql, db).rows)
        _rows_equal(dev_rows, host_rows)
    _log(f"small t0 ({n} rows, NULLs and NaN): device path == host-exact "
         f"tier for {len(T0_SQL)} queries")
    phase_small_joins(seed, n)


SMALL_JOIN_SQL = {
    # unique shuffled dimension: the K3 probe
    "inner": ("select f.id, f.k, d.w from f join d on f.k = d.k "
              "where f.x < 0.3", {}),
    "left": ("select f.id, d.w from f left join d on f.k = d.k "
             "where d.w > 0 or d.w is null", {}),
    "full": ("select f.id, d.k from f full join d on f.k = d.k "
             "and d.w < 500", {}),
    "residual_on": ("select f.id, d.w from f left join d on f.k = d.k "
                    "and d.w > f.y", {}),
    "chained": ("select f.id, c.v from f join c on f.k = c.k "
                "where f.x < 0.5", {}),
    "nloops": ("select f.id, b.w from f join b on f.k = b.bk "
               "where f.x < 0.05", {"join_build_hbm_mb": 1}),
    "post_join_scan": ("select f.id, d.w from f join d on f.k = d.k "
                       "where f.y + d.w > 100", {}),
    "fused_agg": ("select f.k % 7, count(*), sum(d.w), avg(f.x) from f "
                  "join d on f.k = d.k group by f.k % 7", {}),
    "pregrouped_agg": ("select d.g, count(*), sum(f.x) from f "
                       "join d on f.k = d.k group by d.g", {}),
}


def _small_join_db(seed: int, n: int):
    import numpy as np
    from pg_strom_tpu_torch import T
    from pg_strom_tpu_torch.datastore import (Database, Table,
                                              column_from_numpy as cn)
    rng = np.random.default_rng(seed + 11)
    db = Database()
    db.create(Table.from_columns("f", {
        "id": cn(T.INT4, np.arange(n, dtype=np.int32)),
        "k": cn(T.INT4, rng.integers(0, 1200, n, dtype=np.int32),
                rng.random(n) > 0.05),
        "x": cn(T.FLOAT8, rng.random(n), rng.random(n) > 0.05),
        "y": cn(T.INT4, rng.integers(-1000, 1000, n, dtype=np.int32))}))
    db.create(Table.from_columns("d", {
        "k": cn(T.INT4, rng.permutation(1000).astype(np.int32)),
        "w": cn(T.INT4, rng.integers(-1000, 1000, 1000, dtype=np.int32)),
        "g": cn(T.INT4, rng.integers(0, 10, 1000, dtype=np.int32))}))
    db.create(Table.from_columns("c", {
        "k": cn(T.INT4, np.repeat(np.arange(300, dtype=np.int32), 3)),
        "v": cn(T.INT8, rng.integers(-(1 << 40), 1 << 40, 900))}))
    nb = 60000
    db.create(Table.from_columns("b", {
        "bk": cn(T.INT4, rng.integers(0, 20000, nb, dtype=np.int32)),
        "w": cn(T.INT8, np.arange(nb, dtype=np.int64))}))
    return db


def phase_small_joins(seed: int, n: int) -> None:
    """Small join tables through the device path and the host-exact tier
    (enabled=False): equal rows."""
    from pg_strom_tpu_torch import override
    from pg_strom_tpu_torch.ops import mxu_lookup as ml
    from pg_strom_tpu_torch.plan.planner import plan_query
    from pg_strom_tpu_torch.sql import parser as ast
    db = _small_join_db(seed, n)
    for name, (sql, ovr) in SMALL_JOIN_SQL.items():
        k3 = ml.mxu_lookup_cuda.launches
        with override(debug_force_offload=True, **ovr):
            pq = plan_query(ast.parse(sql), db)
            dev_rows = _sorted_all(pq.execute())
        counts = dict(pq.perfmon.counts)
        k3 = ml.mxu_lookup_cuda.launches - k3
        with override(enabled=False, **ovr):
            host_rows = _sorted_all(plan_query(ast.parse(sql), db).execute())
        if not counts.get("device_chunks") or counts.get("recheck_chunks"):
            raise AssertionError(f"small join {name}: perfmon {counts}")
        if name in ("inner", "fused_agg", "pregrouped_agg") and k3 < 1:
            raise AssertionError(f"small join {name}: K3 never launched")
        if name == "nloops" and counts.get("nloops_passes", 0) < 2:
            raise AssertionError(f"small join nloops: perfmon {counts}")
        _rows_equal(dev_rows, host_rows)
        _log(f"small join {name}: {len(dev_rows)} rows, device path == "
             f"host-exact tier (K3 launches {k3}, perfmon {counts})")


def _sorted_all(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             and v == v else 0)
                                            for v in r))


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             and v == v else 0)
                                            for v in r[:2]))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-log2", type=int, default=27,
                    help="flagship table size (2^N rows; default 27)")
    ap.add_argument("--kernel-rows-log2", type=int, default=20,
                    help="rows of the kernel-vs-plain cases (default 20)")
    ap.add_argument("--window-rows-log2", type=int, default=25,
                    help="rows of the t0 that phase 4f's window_rank runs "
                         "over (2^N; a separate t0 when below --rows-log2)")
    ap.add_argument("--k4-parent", metavar="DIR",
                    help="another checkout of the repo whose K4 is timed "
                         "beside this tree's in phase 4c (e.g. the parent "
                         "commit, unpacked with git archive)")
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
    kc.library()
    how = (f"nvcc {kc.build_seconds:.2f} s, one process per source"
           if kc.build_seconds is not None
           else "already built from these sources")
    _log(f"kernel build (K1-K5): {time.perf_counter() - t0:.2f} s "
         f"({how}) -> {os.path.relpath(kc.library_path())}")
    for line in (kc.build_log or "").splitlines():
        if "ptxas" in line or line.startswith("=="):
            _log(f"  {line.strip()}")
    sass = _log_sass_atomics(kc.library_path()).get("k4_kernel")
    if sass is None:
        raise AssertionError("k4_kernel is missing from the library's SASS")
    if not sass.get("ATOMS.ADD") or sass.get("ATOMS.CAST.SPIN.64"):
        raise AssertionError(f"K4's digit adds are not native 32-bit shared "
                             f"adds: {sass}")

    err = phase_kernels(args.seed, args.kernel_rows_log2)
    err = max(err, phase_kernels_k2k4(args.seed, args.kernel_rows_log2))
    k3_err = phase_kernels_k3(args.seed, args.kernel_rows_log2)
    k5 = phase_kernels_k5(args.seed, gpu)
    timing = phase_slice(args.seed, args.rows_log2, gpu)
    q11 = phase_join_scalar(args.seed, args.rows_log2, gpu)
    t0db = phase_testdb(args.seed, args.rows_log2, gpu, args.k4_parent,
                        min(args.window_rows_log2, args.rows_log2))
    f8 = phase_float8(args.seed, args.rows_log2 - 1,
                      min(F8_HOST_ROWS_LOG2, args.rows_log2 - 1), gpu)
    sw = phase_sum_window(args.seed, args.rows_log2 - 1, gpu)
    phase_small(args.seed)
    _log(f"total {time.perf_counter() - t_start:.1f} s [{gpu}]")

    print(gpu, flush=True)
    chunk = t0db["chunk"]
    joins = t0db["joins"]
    k4 = t0db["k4"]
    cols = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{
        "name": "preagg_fused2 (K1)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/preagg_fused2.cu",
        "replaces": "pg_strom_tpu/ops/preagg_fused2.py:625",
        "launches": timing["launches"] + sw["launches"]["K1"],
        "max_abs_err": max(err, timing["chunk_err"]),
        **{c: timing[c] for c in cols},
    }, {
        "name": "preagg_fused (K2)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/preagg_fused.cu",
        "replaces": "pg_strom_tpu/ops/preagg_fused.py:284",
        "launches": (t0db["k2_launches"] + f8["k2_launches"]
                     + sw["launches"]["K2"]),
        "max_abs_err": max([err] + [c["err"] for c in chunk.values()]),
        **{c: chunk[32][c] for c in cols},
    }, {
        "name": "mxu_lookup (K3)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/mxu_lookup.cu",
        "replaces": "pg_strom_tpu/ops/mxu_lookup.py:100",
        "launches": joins["k3_launches"] + joins["dist"]["launches"]["K3"],
        "max_abs_err": max(k3_err, joins["chunk"]["err"]),
        **{c: joins["chunk"][c] for c in cols},
    }, {
        "name": "preagg_pallas (K4)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/preagg_pallas.cu",
        "replaces": "pg_strom_tpu/ops/preagg_pallas.py:46",
        "launches": k4["launches"] + sw["launches"]["K4"],
        "max_abs_err": max([err, k4["corr"]["err"]]
                           + [c["err"] for c in k4["chunk"].values()]),
        **{c: k4["chunk"][32][c] for c in cols},
    }, {
        "name": "joinagg_scalar (K5)",
        "route": "cuda",
        "source": "pg_strom_tpu_torch/ops/cuda/joinagg_scalar.cu",
        "replaces": "none (XLA glue: a dense join under a scalar aggregate)",
        "launches": q11["launches"],
        "max_abs_err": k5["err"],
        **{c: k5[c] for c in cols},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
