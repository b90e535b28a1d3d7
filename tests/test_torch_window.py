"""Window functions in the port (pg_strom_tpu_torch/plan/window.py) against
the JAX reference; tests/test_window.py case for case.

The reference's test classes are imported and run here with their
`execute` / `explain` redirected through both packages
(tests/torch_differential.py): every statement must give the port the
reference's rows, or its error, exactly.  Each case runs on all three
window tiers: the columnar tier (`vectorized_windows` on) and the row
tiers with `vectorized_windows` off, numpy-fast and exact per-row.

Beyond the reference's cases, the e2e queries `window_rank` and
`window_sum` run over a 4096-row `models.testdb` build whose `x` has ties,
in both packages and against numpy.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_window as ref
from test_window import (  # noqa: F401  (collected here, port vs reference)
    db, TestRankers, TestAggregateWindows, TestOffsets, TestWindowPlacement,
    TestRejections, TestLagLeadDefaultTyping, TestFastSlowDifferential,
    TestWindowEdges)
from torch_differential import Differential, redirect

from pg_strom_tpu.config import config as r_config
from pg_strom_tpu.datastore import Database as RDatabase, \
    column_from_numpy as r_col
from pg_strom_tpu.models.testdb import build_testdb as r_build_testdb
from pg_strom_tpu.plan import window as r_window
from pg_strom_tpu.sqltypes import T as RT
from pg_strom_tpu_torch.models.testdb import BENCH_QUERIES

WINDOW_SUM = ("select cat, max(rs) from (select cat, sum(y) over "
              "(partition by cat order by id) rs from t0 where x < 1.0) q "
              "group by cat order by cat")


@pytest.fixture(params=["columnar", "rowfast", "rowslow"], autouse=True)
def _both_paths(request, monkeypatch):
    """The reference's three window tiers; the port mirrors the reference's
    `vectorized_windows` and `_FAST_MIN_ROWS` on every statement."""
    vectorized = request.param == "columnar"
    fast_min = 1 << 30 if request.param == "rowslow" else 0
    monkeypatch.setattr(r_config, "vectorized_windows", vectorized)
    monkeypatch.setattr(r_window, "_FAST_MIN_ROWS", fast_min)
    return request.param


@pytest.fixture(autouse=True)
def diff(monkeypatch):
    d = Differential()
    redirect(monkeypatch, ref, d)
    return d


@pytest.fixture(scope="module")
def testdb():
    """4096 fact rows of the star schema; x in [0, 100) rounded to a
    quarter, so rank() over x has ties in every partition, and x < 1.0
    keeps about 40 rows."""
    d = RDatabase()
    r_build_testdb(d, fact_rows=4096, dim_rows=64, seed=3)
    t0 = d.get("t0")
    x = np.floor(t0.columns["x"].data * 4.0) / 4.0
    cols = dict(t0.columns)
    cols["x"] = r_col(RT.FLOAT8, x)
    d.create(type(t0).from_columns("t0", cols))
    return d


def _numpy_window_rank(t0):
    cat = t0.columns["cat"].data
    x = t0.columns["x"].data
    keep = t0.columns["y"].data > 5.0
    c, xv = cat[keep], x[keep]
    cnt = np.bincount(c, minlength=26)
    mn = np.full(26, np.inf)
    np.minimum.at(mn, c, xv)
    ties = np.bincount(c[xv == mn[c]], minlength=26)
    present = cnt > 0
    return int(keep.sum()), int((cnt - ties + 1)[present].max())


def test_window_rank_testdb(testdb, diff):
    res = diff.execute(BENCH_QUERIES["window_rank"], testdb)
    n, max_r = _numpy_window_rank(testdb.get("t0"))
    assert res.rows == [(n, max_r, 1)]
    assert diff.statements == 1


def test_window_sum_testdb(testdb, diff):
    res = diff.execute(WINDOW_SUM, testdb)
    t0 = testdb.get("t0")
    cat, x = t0.columns["cat"].data, t0.columns["x"].data
    y, ids = t0.columns["y"].data, t0.columns["id"].data
    got = dict(res.rows)
    assert len(got) == len(np.unique(cat[x < 1.0])) > 0
    for code, total in got.items():
        sel = (x < 1.0) & (cat == t0.columns["cat"].dictionary.index(code))
        s = 0.0
        for v in y[sel][np.argsort(ids[sel], kind="stable")]:
            s += float(v)          # PostgreSQL's sequential float8 sum
        assert total == s, code
