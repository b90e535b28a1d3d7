"""The port's SQL surface and shell against the JAX reference.

- tests/test_sql_surface.py and tests/test_grouping_sets.py case for case,
  and tests/test_ddl_cli.py's TestDDL (DDL, DML and COPY): the reference's
  test classes run here with their `execute` / `explain` redirected
  through both packages (tests/torch_differential.py), so every statement
  must give the port the reference's rows, or its error, exactly.
- The shell (`pg_strom_tpu_torch.cli`): `run_stmt`, `\\d`, `run_file` and
  `\\demo` print what the reference's shell prints for the same input.
- The native COPY classes of test_ddl_cli.py: tests/test_torch_copy.py.
- EXPLAIN with pg_strom.show_device_kernel prints the scan qual's traced
  graph, and otherwise the reference's plan text.
"""

from __future__ import annotations

import re

import pytest

import test_ddl_cli as ref_ddl
import test_grouping_sets as ref_gs
import test_sql_surface as ref_surface
from test_sql_surface import (  # noqa: F401  (collected here, port vs reference)
    db, TestOuterJoins, TestDistinct, TestUnion, TestExceptIntersect,
    TestUpdateDelete, TestScalarFunctions, TestCtes, TestSubqueries,
    TestTopKPushdown, TestConditionalFunctions)
from torch_differential import Differential, redirect

import pg_strom_tpu.cli as r_cli
import pg_strom_tpu_torch.cli as p_cli
from pg_strom_tpu.config import override as r_override
from pg_strom_tpu.sql import explain as r_explain
from pg_strom_tpu_torch import override as p_override
from pg_strom_tpu_torch.sql import explain as p_explain
from pg_strom_tpu_torch.plan.planner import _kernel_text


@pytest.fixture(autouse=True)
def diff(monkeypatch):
    d = Differential()
    for module in (ref_surface, ref_gs, ref_ddl):
        redirect(monkeypatch, module, d)
    return d


# --- tests/test_grouping_sets.py (its own `db` fixture) -------------------

class _GroupingSetsDb:
    @pytest.fixture(scope="class")
    def db(self):
        return ref_gs.db.__wrapped__()


class TestRollup(_GroupingSetsDb, ref_gs.TestRollup):
    pass


class TestCube(_GroupingSetsDb, ref_gs.TestCube):
    pass


class TestGroupingSets(_GroupingSetsDb, ref_gs.TestGroupingSets):
    pass


class TestSinglePassRollup(_GroupingSetsDb, ref_gs.TestSinglePassRollup):
    pass


# --- tests/test_ddl_cli.py: DDL, DML and COPY ------------------------------

class TestDDL(ref_ddl.TestDDL):
    @pytest.fixture()
    def db(self):
        return ref_ddl.db.__wrapped__()


# --- the shell -------------------------------------------------------------

_TIMING = re.compile(r" \[[0-9.]+s\]$", re.M)


def _shells():
    with p_override(device="cpu"):
        return r_cli.Shell(), p_cli.Shell()


def _same_output(capsys, r_call, p_call):
    """Run one shell call in each package; their printed text must match
    (load times of \\demo aside).  Returns the text."""
    r_ret = r_call()
    r_out = capsys.readouterr().out
    with p_override(device="cpu", debug_force_offload=True):
        p_ret = p_call()
    p_out = capsys.readouterr().out
    assert _TIMING.sub("", p_out) == _TIMING.sub("", r_out)
    assert p_ret == r_ret
    return r_out


DDL_SCRIPT = [
    "create table emp (id int, name text, salary numeric(10,2), "
    "hired date, active boolean)",
    "insert into emp values (1, 'ada', 120000.50, '2020-01-15', true), "
    "(2, 'bob', 95000, '2021-06-01', true), "
    "(3, 'eve', 87000.25, '2019-03-10', false)",
    "select id, name from emp order by id limit 2",
    "select count(*), sum(salary), min(hired) from emp",
    "insert into emp (id, name) values (4, 'kim')",
    "select count(*), count(salary) from emp",
    "update emp set salary = salary + 1 where id = 2",
    "delete from emp where active = false",
    "select * from emp order by id",
    "insert into emp (id, name) values (9)",
    "drop table emp",
    "select 1 from emp",
]


def test_shell_run_stmt_and_describe(capsys):
    rs, ps = _shells()
    for sql in DDL_SCRIPT[:-2]:
        _same_output(capsys, lambda: rs.run_stmt(sql),
                     lambda: ps.run_stmt(sql))
    out = _same_output(capsys, lambda: rs.backslash("\\d emp"),
                       lambda: ps.backslash("\\d emp"))
    assert "salary" in out
    _same_output(capsys, lambda: rs.backslash("\\d"),
                 lambda: ps.backslash("\\d"))
    _same_output(capsys, lambda: rs.backslash("\\timing"),
                 lambda: ps.backslash("\\timing"))
    for sql in DDL_SCRIPT[-2:]:
        rs.timing = ps.timing = False
        out = _same_output(capsys, lambda: rs.run_stmt(sql),
                           lambda: ps.run_stmt(sql))
    assert "ERROR" in out
    assert not ps.backslash("\\q")


def test_shell_run_file(tmp_path, capsys):
    f = tmp_path / "s.sql"
    f.write_text("create table t (x int);\n"
                 "-- a comment line\n"
                 "insert into t values (1), (2), (3);\n"
                 "select sum(x), avg(x) from t;\n")
    rs, ps = _shells()
    out = _same_output(capsys, lambda: rs.run_file(str(f)),
                       lambda: ps.run_file(str(f)))
    assert "6" in out


def test_shell_run_file_meta_commands(tmp_path, capsys):
    """A reference fault the port repairs (ROADMAP §3): the reference's
    run_file hands a backslash line to the SQL parser, while psql -f runs
    meta-commands in a script.  The port runs them, so its output for this
    script is psql's: the demo schema loads and the query answers over it,
    as the same statements give in the reference shell one by one."""
    from pg_strom_tpu_torch.models.testdb import BENCH_QUERIES
    f = tmp_path / "demo.sql"
    f.write_text("\\demo 2000\n" + BENCH_QUERIES["agg_group"] + ";\n"
                 "\\d t1\n\\q\nselect 1;\n")
    rs, ps = _shells()
    rs.backslash("\\demo 2000")
    rs.run_stmt(BENCH_QUERIES["agg_group"])
    rs.backslash("\\d t1")
    want = _TIMING.sub("", capsys.readouterr().out)
    with p_override(device="cpu", debug_force_offload=True):
        ps.run_file(str(f))
    got = _TIMING.sub("", capsys.readouterr().out)
    assert got == want and "ERROR" not in got and "(26 rows)" in got
    rs.run_file(str(f))             # the reference's fault, for the record
    assert "ERROR:  syntax error" in capsys.readouterr().out


def test_shell_demo(capsys):
    from pg_strom_tpu_torch.models.testdb import BENCH_QUERIES
    rs, ps = _shells()
    _same_output(capsys, lambda: rs.backslash("\\demo 3000"),
                 lambda: ps.backslash("\\demo 3000"))
    assert sorted(ps.db.tables) == ["t0", "t1", "t2", "t3", "t4", "t5"]
    for q in ("agg_group", "window_rank", "star_group"):
        _same_output(capsys, lambda: rs.run_stmt(BENCH_QUERIES[q]),
                     lambda: ps.run_stmt(BENCH_QUERIES[q]))


def test_shell_needs_the_configured_device():
    """The shell starts on config.device: "cuda" without a GPU raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the shell starts on it")
    with p_override(device="cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            p_cli.Shell()


def test_main_runs_scripts(tmp_path, capsys):
    f = tmp_path / "m.sql"
    f.write_text("select 1 + 1;\n")
    with p_override(device="cpu"):
        p_cli.main([str(f)])
    assert "(1 row)" in capsys.readouterr().out


# --- EXPLAIN and the device kernel dump -------------------------------------

def _without_kernel(text: str) -> str:
    return re.sub(r"Device Kernel: .*", "Device Kernel: ...", text,
                  flags=re.S)


def test_explain_device_kernel_is_a_graph(db, diff):
    sql = "explain select k, x from big where x > 0.5 and k < 7"
    pdb = diff.port_db(db)
    with r_override(show_device_kernel=True):
        rtext = r_explain(sql, db)
    with p_override(device="cpu", debug_force_offload=True,
                    show_device_kernel=True):
        ptext = p_explain(sql, pdb)
    assert "TpuScan on big" in ptext
    kernel = ptext.split("Device Kernel: ", 1)[1]
    assert kernel.startswith("graph():"), kernel[:200]
    assert "call_function[target=torch.ops.aten." in kernel
    assert _without_kernel(ptext) == _without_kernel(rtext)


def test_kernel_text_never_breaks_explain(db, diff):
    pdb = diff.port_db(db)
    with p_override(device="cpu"):
        assert _kernel_text(None, "q", []) == "(subquery input)"
        bad = _kernel_text(pdb.get("big"), "big", [object()])
    assert bad.startswith("(unavailable: ")
