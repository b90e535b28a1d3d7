"""Correlated subqueries (pg_strom_tpu_torch/plan/correlated.py) and WITH
RECURSIVE in the port against the JAX reference; tests/test_correlated.py
case for case.

The reference's test classes are imported and run here with their
`execute` / `explain` redirected through both packages
(tests/torch_differential.py): every statement, the UPDATE and DELETE with
a correlated subquery included, must give the port the reference's rows,
or its error, exactly, and leave both databases equal.  Beyond those, each
instantiation of a correlated subquery must be planned once per distinct
parameter tuple and run on the port's device path (plain versions on the
CPU).
"""

from __future__ import annotations

import pytest

import test_correlated as ref
from test_correlated import (  # noqa: F401  (collected here, port vs reference)
    db, TestCorrelatedScalar, TestCorrelatedExistsIn, TestWithRecursive,
    TestCorrelatedInDml, TestCorrelatedScoping, TestReviewFindings)
from torch_differential import Differential, redirect, mirrored_config

from pg_strom_tpu_torch import override as p_override
from pg_strom_tpu_torch.plan import correlated as p_correlated, \
    planner as p_planner
from pg_strom_tpu_torch.sql import parser as p_ast


@pytest.fixture(autouse=True)
def diff(monkeypatch):
    d = Differential()
    redirect(monkeypatch, ref, d)
    return d


def test_dml_leaves_both_databases_equal(diff):
    """After a correlated UPDATE, the port's table equals the reference's."""
    rdb = TestCorrelatedInDml.dmldb.__wrapped__(None)
    diff.execute("UPDATE emp SET sal = (select cap from lim where "
                 "name = emp.dept) WHERE id < 3", rdb)
    diff.execute("select * from emp", rdb)
    assert diff.statements == 2


@pytest.mark.parametrize("sql, ninst", [
    # emp.dept takes a, b and NULL: three parameter tuples
    ("select id, (select budget from dept where name = emp.dept) "
     "from emp order by id", 3),
    # (dept, sal) differs on every row
    ("select id from emp e where exists (select 1 from dept d where "
     "d.name = e.dept and d.budget > e.sal) order by id", 5),
    ("select id from emp e where sal in (select sal from emp e2 where "
     "e2.dept = e.dept and e2.id <> e.id) order by id", 5),
])
def test_instantiations_run_on_device(db, diff, monkeypatch, sql, ninst):
    """Each distinct parameter tuple plans its subquery once, with typed
    constants (the memo answers repeats), and every instantiation runs on
    the port's device path."""
    diff.execute(sql, db)
    plans = []
    rows_of = p_correlated._Runner._rows
    plan_query = p_planner.plan_query

    def counted(self, pvals):
        def plan(q, pdb):
            pq = plan_query(q, pdb)
            plans.append(pq)
            return pq
        monkeypatch.setattr(p_planner, "plan_query", plan)
        try:
            return rows_of(self, pvals)
        finally:
            monkeypatch.setattr(p_planner, "plan_query", plan_query)

    monkeypatch.setattr(p_correlated._Runner, "_rows", counted)
    with p_override(**dict(mirrored_config(), perfmon=True)):
        plan_query(p_ast.parse(sql), diff.port_db(db)).execute()
    assert len(plans) == ninst
    for pq in plans:
        assert pq.perfmon.counts.get("device_chunks", 0) >= 1, pq.root
        assert pq.perfmon.counts.get("unported_host_exact", 0) == 0
