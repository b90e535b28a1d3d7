"""COPY through the port's native loader against the JAX reference.

tests/test_ddl_cli.py's TestNativeCopy and TestNativeCopyExtended case for
case: every statement runs in both packages through
tests/torch_differential.py (rows as text at extra_float_digits=-3, or the
same error), and where the reference test asserts which path COPY took
(the native loader or the exact python path), both packages must take it.
test_copy_csv runs with the rest of TestDDL in tests/test_torch_surface.py.
"""

from __future__ import annotations

import os
import tempfile

import pytest

import pg_strom_tpu.sql.api as r_api
import pg_strom_tpu_torch.sql.api as p_api
from pg_strom_tpu.datastore import Database as RDatabase
from pg_strom_tpu.errors import SqlError
from pg_strom_tpu_torch.config import override as p_override
from pg_strom_tpu_torch.datastore import Database as PDatabase
from torch_differential import Differential

APIS = (r_api, p_api)


@pytest.fixture()
def diff():
    return Differential()


def _mkfile(lines):
    fd, path = tempfile.mkstemp(suffix=".csv")
    os.close(fd)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _spy_native(monkeypatch):
    """Record, per package, whether _copy_native answered the COPY."""
    hit = {}
    for api in APIS:
        orig = api._copy_native

        def wrapped(stmt, db, tbl, _orig=orig, _api=api):
            r = _orig(stmt, db, tbl)
            hit[_api.__name__.split(".")[0]] = r is not None
            return r
        monkeypatch.setattr(api, "_copy_native", wrapped)
    return hit


class TestNativeCopy:
    """Int/float-only COPY targets ride the native parallel CSV loader and
    must match the python path exactly."""

    def _run_copy(self, diff, monkeypatch, body, force_python=False):
        db = RDatabase()
        diff.execute("create table nt (a int2, b int8, x float4, y float8)",
                     db)
        path = _mkfile(body)
        try:
            with monkeypatch.context() as m:
                if force_python:
                    for api in APIS:
                        m.setattr(api, "_copy_native", lambda *a: None)
                diff.execute(f"copy nt from '{path}'", db)
        finally:
            os.unlink(path)
        return diff.execute("select * from nt order by b", db).rows

    def test_matches_python_path(self, diff, monkeypatch):
        body = ["1,10,1.5,2.5", ",20,,-0.125", "-7,30,3.25,"]
        assert self._run_copy(diff, monkeypatch, body) == \
            self._run_copy(diff, monkeypatch, body, force_python=True)

    def test_fast_path_engaged(self, diff, monkeypatch):
        db = RDatabase()
        diff.execute("create table nt (a int4, b float8)", db)
        path = _mkfile(["1,2.5", "2,"])
        calls = {}
        for api in APIS:
            monkeypatch.setattr(
                api, "_copy_python",
                lambda *a, _n=api.__name__: calls.setdefault(_n, True) or 0)
        try:
            diff.execute(f"copy nt from '{path}'", db)
        finally:
            os.unlink(path)
        assert not calls, f"native COPY path did not engage: {calls}"
        assert diff.execute("select count(*), count(b) from nt",
                            db).rows == [(2, 1)]

    def test_overflow_falls_back_with_pg_error(self, diff, monkeypatch):
        hit = _spy_native(monkeypatch)
        db = RDatabase()
        diff.execute("create table nt (a int2)", db)
        path = _mkfile(["40000"])       # > int2 range
        try:
            with pytest.raises(SqlError):
                diff.execute(f"copy nt from '{path}'", db)
        finally:
            os.unlink(path)
        assert hit == {"pg_strom_tpu": False, "pg_strom_tpu_torch": False}


class TestNativeCopyExtended:
    """COPY via the native parallel loader for date/text/numeric columns."""

    def _db(self, diff):
        db = RDatabase()
        diff.execute("create table mix (id int4, x float8, d date, "
                     "name text, n numeric)", db)
        return db

    def _write(self, tmp_path, body):
        f = tmp_path / "data.csv"
        f.write_text(body)
        return str(f)

    def test_native_path_taken_and_exact(self, diff, tmp_path, monkeypatch):
        body = "".join(
            f"{i},{i * 0.25},2023-0{1 + i % 9}-1{i % 3},nm{i % 7},{i}.5\n"
            for i in range(500))
        fn = self._write(tmp_path, body)
        db = self._db(diff)
        hit = _spy_native(monkeypatch)
        r = diff.execute(f"copy mix from '{fn}' with (format csv)", db)
        assert hit == {"pg_strom_tpu": True, "pg_strom_tpu_torch": True}
        assert r.command == "COPY 500"
        # the python-path twin must agree value for value, in each package
        q = ("select mix.id, mix.x, mix.d, mix.name, mix.n from mix "
             "order by mix.id")
        native_rows = diff.execute(q, db).rows
        db2 = self._db(diff)
        monkeypatch.undo()
        with monkeypatch.context() as m:
            for api in APIS:
                m.setattr(api, "_copy_native", lambda *a: None)
            diff.execute(f"copy mix from '{fn}' with (format csv)", db2)
        assert diff.execute(q, db2).rows == native_rows

    def test_nulls_and_appends_merge_dictionaries(self, diff, tmp_path):
        from decimal import Decimal
        db = self._db(diff)
        diff.execute("insert into mix values "
                     "(1, 0.5, '2024-01-15', 'zed', 1.25)", db)
        fn = self._write(tmp_path, "2,,2020-06-09,alpha,-3.07\n3,1.5,,,\n")
        diff.execute(f"copy mix from '{fn}' with (format csv)", db)
        rows = diff.execute("select mix.id, mix.name, mix.n from mix "
                            "order by mix.id", db).rows
        assert rows == [(1, "zed", Decimal("1.25")),
                        (2, "alpha", Decimal("-3.07")),
                        (3, None, None)]

    def test_bad_date_falls_back_to_exact_errors(self, diff, tmp_path,
                                                 monkeypatch):
        hit = _spy_native(monkeypatch)
        db = self._db(diff)
        fn = self._write(tmp_path, "2,1.0,2023-02-31,x,1\n")
        with pytest.raises(Exception):
            diff.execute(f"copy mix from '{fn}' with (format csv)", db)
        assert hit == {"pg_strom_tpu": False, "pg_strom_tpu_torch": False}

    def test_arena_shows_live_planes(self, diff, tmp_path):
        """The loaded planes live in each package's own native arena."""
        body = "".join(f"{i},{i * 0.5}\n" for i in range(20000))
        fn = self._write(tmp_path, body)
        db = RDatabase()
        diff.execute("create table b2 (id int8, x float8)", db)
        diff.execute(f"copy b2 from '{fn}' with (format csv)", db)
        s = diff.execute("select sum(b2.x) from b2", db).scalar()
        assert s == sum(i * 0.5 for i in range(20000))
        for api, d in ((r_api, db), (p_api, diff.port_db(db))):
            with p_override(device="cpu"):
                live = api.execute("select * from pgstrom_arena_info",
                                   d).rows
            assert any(r[2] > 0 for r in live), (api.__name__, live)


def test_copy_into_fresh_table_adopts_arena_planes(tmp_path):
    """A bulk load into an empty table keeps the native arena's planes
    (no copy): the column's data lies inside the port's data arena."""
    import numpy as np
    from pg_strom_tpu_torch.native import data_arena
    f = tmp_path / "n.csv"
    f.write_text("".join(f"{i},{i * 0.25}\n" for i in range(5000)))
    pdb = PDatabase()
    with p_override(device="cpu"):
        p_api.execute("create table z (a int8, b float8)", pdb)
        before = data_arena().stats()["bytes_live"]
        p_api.execute(f"copy z from '{f}' with (format csv)", pdb)
        col = pdb.get("z").columns["a"]
        assert data_arena().stats()["bytes_live"] > before
        np.testing.assert_array_equal(col.data, np.arange(5000))
        assert p_api.execute("select sum(b) from z", pdb).scalar() == \
            sum(i * 0.25 for i in range(5000))
