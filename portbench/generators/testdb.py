"""PG-Strom's testdb star schema, generated from a seed.

A frozen copy of the draws of `pg_strom_tpu_torch/models/testdb.py`
(`build_testdb`, with_text=True), so that a change to the program's own
model cannot change what the benchmark measures: a fact table t0 (id, a
26-value text `cat`, five int4 keys aid..eid uniform over the dimension
rows, float8 x and y uniform on [0, 100), text z = md5(id::text)),
dimensions t1..t4 (a serial key and its text payload md5((key + i)::text)
each) and t5 (eid, float4 a and b, date ymd).  The md5 payloads are the
same for every seed.
"""

from __future__ import annotations

import numpy as np

from portbench.lib.dataset import Col, Dataset, rng_of
from portbench.lib.md5text import md5_text_col

CATS = ["aaa", "bbb", "ccc", "ddd", "eee", "fff", "ggg", "hhh", "iii",
        "jjj", "kkk", "lll", "mmm", "nnn", "ooo", "ppp", "qqq", "rrr",
        "sss", "ttt", "uuu", "vvv", "www", "xxx", "yyy", "zzz"]


def generate(cfg: dict, seed: int) -> Dataset:
    n = int(cfg["fact_rows"])
    dim_rows = int(cfg["dim_rows"])
    rng = rng_of(seed, 0)
    tables: dict[str, dict[str, Col]] = {}
    for i in range(1, 5):
        key = np.arange(1, dim_rows + 1, dtype=np.int32)
        tables[f"t{i}"] = {f"{'abcd'[i - 1]}id": Col("int4", key),
                           f"{'abcd'[i - 1]}text": md5_text_col(key + i)}
    t0 = {"id": Col("int4", np.arange(1, n + 1, dtype=np.int32)),
          "cat": Col("text", rng.integers(0, 26, n).astype(np.int32),
                     list(CATS))}
    for k in ("aid", "bid", "cid", "did", "eid"):
        t0[k] = Col("int4",
                    rng.integers(1, dim_rows + 1, n).astype(np.int32))
    t0["x"] = Col("float8", rng.random(n) * 100.0)
    t0["y"] = Col("float8", rng.random(n) * 100.0)
    t0["z"] = md5_text_col(t0["id"].data)
    tables["t0"] = t0
    n5 = max(dim_rows // 10, 1) * 10
    tables["t5"] = {
        "eid": Col("int4", (np.arange(n5, dtype=np.int32) % dim_rows)),
        "a": Col("float4", (rng.random(n5) * 100).astype(np.float32)),
        "b": Col("float4", (rng.random(n5) * 100).astype(np.float32)),
        "ymd": Col("date", rng.integers(9000, 9020, n5).astype(np.int32)),
    }
    return Dataset(tables)
