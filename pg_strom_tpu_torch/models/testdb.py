"""Star-schema benchmark workload (testdb.sql analog).

The reference's manual benchmark/demo schema (testdb.sql): a fact table t0
(id, 26-category cat, five dimension FKs, two float measures, a text blob)
joined against dimensions t1..t4 (id + text payload) and t5 (id + measures +
date).  Sizes are parameters; the reference defaults are 20M fact rows and
40k rows per dimension.

Also defines the benchmark query set: filter / join / grouped aggregate /
sort / window / grouping sets.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..sqltypes import T
from ..datastore import Database, Table, column_from_numpy, column_from_values, Column


_CATS = ["aaa", "bbb", "ccc", "ddd", "eee", "fff", "ggg", "hhh", "iii",
         "jjj", "kkk", "lll", "mmm", "nnn", "ooo", "ppp", "qqq", "rrr",
         "sss", "ttt", "uuu", "vvv", "www", "xxx", "yyy", "zzz"]


def _md5_codes(n: int, salt: int) -> Column:
    """Dimension text payloads: md5((x+salt)::text).  Dictionary-encoded;
    the dictionary holds real md5 strings (hashes are unique so codes are a
    permutation of the sorted dictionary)."""
    texts = [hashlib.md5(str(x + salt).encode()).hexdigest()
             for x in range(1, n + 1)]
    return column_from_values(T.TEXT, texts)


def build_testdb(db: Database, fact_rows: int = 1_000_000,
                 dim_rows: int = 40_000, seed: int = 0,
                 with_text: bool = False) -> None:
    """Create t0..t5.  with_text=False skips md5 payload generation for the
    big fact table (python md5 of 20M rows is minutes; benches that don't
    touch z/atext can skip it)."""
    rng = np.random.default_rng(seed)

    for i, salt in ((1, 1), (2, 2), (3, 3), (4, 4)):
        cols = {
            f"{'abcd'[i-1]}id": column_from_numpy(
                T.INT4, np.arange(1, dim_rows + 1, dtype=np.int32)),
        }
        if with_text:
            cols[f"{'abcd'[i-1]}text"] = _md5_codes(dim_rows, salt)
        db.create(Table.from_columns(f"t{i}", cols))

    n = fact_rows
    # vectorized dictionary-encoded cat column (_CATS is already bytewise
    # sorted, so codes ARE the dictionary indexes — a 4M-row python loop
    # through column_from_values would dominate fixture build time)
    cat_codes = rng.integers(0, 26, n).astype(np.int32)
    cat_col = Column(type=T.TEXT, data=cat_codes,
                     valid=np.ones(n, dtype=np.bool_), dictionary=list(_CATS))
    t0 = {
        "id": column_from_numpy(T.INT4, np.arange(1, n + 1, dtype=np.int32)),
        "cat": cat_col,
        "aid": column_from_numpy(T.INT4, rng.integers(1, dim_rows + 1, n).astype(np.int32)),
        "bid": column_from_numpy(T.INT4, rng.integers(1, dim_rows + 1, n).astype(np.int32)),
        "cid": column_from_numpy(T.INT4, rng.integers(1, dim_rows + 1, n).astype(np.int32)),
        "did": column_from_numpy(T.INT4, rng.integers(1, dim_rows + 1, n).astype(np.int32)),
        "eid": column_from_numpy(T.INT4, rng.integers(1, dim_rows + 1, n).astype(np.int32)),
        "x": column_from_numpy(T.FLOAT8, rng.random(n) * 100.0),
        "y": column_from_numpy(T.FLOAT8, rng.random(n) * 100.0),
    }
    db.create(Table.from_columns("t0", t0))

    n5 = max(dim_rows // 10, 1) * 10
    db.create(Table.from_columns("t5", {
        "eid": column_from_numpy(
            T.INT4, (np.arange(n5, dtype=np.int32) % dim_rows)),
        "a": column_from_numpy(T.FLOAT4, (rng.random(n5) * 100).astype(np.float32)),
        "b": column_from_numpy(T.FLOAT4, (rng.random(n5) * 100).astype(np.float32)),
        "ymd": column_from_numpy(T.DATE, rng.integers(9000, 9020, n5).astype(np.int32)),
    }))


# the benchmark query set
BENCH_QUERIES = {
    "filter": "select count(*), sum(x) from t0 where x < 25.0 and y > 10.0",
    "agg_nogrp": "select count(*), sum(x), avg(y) from t0",
    "agg_group": "select cat, count(*), sum(x), avg(y) from t0 "
                 "group by cat order by cat",
    "join_agg": "select count(*), sum(t0.x) from t0 "
                "join t1 on t0.aid = t1.aid where t0.x < 50.0",
    # star shape: dim-only GROUP BY + fact-only aggs -> pregrouped path
    # (exec/joinagg_exec._compose_pregroup)
    "star_group": "select t1.aid % 40, count(*), sum(t0.x) from t0 "
                  "join t1 on t0.aid = t1.aid group by t1.aid % 40 "
                  "order by t1.aid % 40",
    # the reference's manual benchmark shape (testdb.sql:1-40: t0 joined
    # to several serial-PK dims at once) — the fused N-way TpuStarJoinAgg
    # chain, one device node per fact chunk
    "star4way": "select count(*), sum(t0.x), sum(t0.y) from t0, t1, t2, t3 "
                "where t0.aid = t1.aid and t0.bid = t2.bid "
                "and t0.cid = t3.cid",
    "sort": "select id, x from t0 order by x desc limit 100",
    # the plane-space window tier (plan/window.py
    # _run_columnar — device-filtered scan, numpy lexsort frame, fully
    # vectorized ranker); the outer aggregate keeps the measured cost on
    # the window computation, not on formatting fact_rows of output
    "window_rank": "select count(*), max(r), min(r) from (select rank() "
                   "over (partition by cat order by x desc) r from t0 "
                   "where y > 5.0) q",
    # single-pass grouping sets (one finest-grain device pass +
    # host state rollup, planner._gs_single_pass)
    "rollup": "select cat, cid % 8, count(*), sum(x) from t0 "
              "group by rollup(cat, cid % 8)",
}
