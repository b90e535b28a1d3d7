"""Run the JAX reference's SQL-surface tests through both packages.

The port's surface tests (tests/test_torch_{window,correlated,surface}.py)
import the reference's own test classes and redirect the `execute` and
`explain` names of the reference test module through `Differential`: every
statement runs in the reference and in the port, on the same data, and
the outcomes must be equal before the reference's result goes back to the
reference's own assertion.

- The port's database mirrors the reference's: each reference table is
  carried over with `from_reference` when it first appears or when the
  test replaced it; a statement that changes tables (DDL, DML) runs in
  both, and the two results are paired from then on.
- The port runs on `device="cpu"` under every setting it shares with the
  reference's current config (the reference tests' own `override`s and
  monkeypatches included), with the reference's window tier cut-off, and
  on a mesh of as many shards as the reference has devices (8 on the
  rig of tests/conftest.py).
- Rows must be equal as PostgreSQL text at extra_float_digits=-3, with the
  same column names and command tag; a statement without a top-level
  ORDER BY compares as a sorted multiset.  An error must have the same
  class name and text.  EXPLAIN text must be equal.
"""

from __future__ import annotations

import weakref

import jax
from pg_strom_tpu.config import show_all as r_show_all
from pg_strom_tpu.plan import window as r_window
from pg_strom_tpu.sql import execute as r_execute, explain as r_explain
from pg_strom_tpu_torch.config import override as p_override, \
    show_all as p_show_all
from pg_strom_tpu_torch.datastore import Database as PDatabase, \
    from_reference
from pg_strom_tpu_torch.plan import window as p_window
from pg_strom_tpu_torch.sql import execute as p_execute, \
    explain as p_explain, parser as p_ast


def mirrored_config() -> dict:
    """The reference's current settings that the port shares, on the CPU."""
    shared = p_show_all()
    cfg = {k: v for k, v in r_show_all().items() if k in shared}
    cfg["device"] = "cpu"
    cfg["mesh_shards"] = len(jax.devices())
    return cfg


def is_ordered(sql: str) -> bool:
    """False only for a SELECT (or set operation) without a top-level
    ORDER BY, whose row order SQL leaves open."""
    try:
        stmt = p_ast.parse(sql)
    except Exception:
        return True
    if isinstance(stmt, (p_ast.SelectStmt, p_ast.SetOpStmt)):
        return bool(stmt.order_by)
    return True


def outcome(res, ordered: bool) -> tuple:
    rows = res.formatted(-3)
    return ("rows", tuple(res.columns), res.command,
            tuple(rows if ordered else sorted(rows)))


def explain_outcome(text: str) -> tuple:
    return ("explain", text)


def error_outcome(e: BaseException) -> tuple:
    return ("error", type(e).__name__, str(e))


class Differential:
    """`execute` / `explain` stand-ins that run both packages."""

    def __init__(self) -> None:
        # reference Database -> (port Database, {name: (ref, port) Table})
        self._dbs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.statements = 0

    def port_db(self, rdb) -> PDatabase:
        ent = self._dbs.get(rdb)
        if ent is None:
            ent = self._dbs[rdb] = (PDatabase(), {})
        pdb, pairs = ent
        for name, rt in rdb.tables.items():
            pr = pairs.get(name)
            if pr is None or pr[0] is not rt:
                pdb.create(from_reference(rt))
                pairs[name] = (rt, pdb.tables[name])
        for name in list(pdb.tables):
            if name not in rdb.tables:
                pdb.drop(name)
                pairs.pop(name, None)
        return pdb

    def _pair(self, rdb) -> None:
        pdb, pairs = self._dbs[rdb]
        pairs.clear()
        for name, rt in rdb.tables.items():
            if name in pdb.tables:
                pairs[name] = (rt, pdb.tables[name])

    def _run_port(self, fn, sql, pdb):
        saved = p_window._FAST_MIN_ROWS
        p_window._FAST_MIN_ROWS = r_window._FAST_MIN_ROWS
        try:
            with p_override(**mirrored_config()):
                return fn(sql, pdb)
        finally:
            p_window._FAST_MIN_ROWS = saved

    def _both(self, r_fn, p_fn, sql, rdb, shape):
        self.statements += 1
        pdb = self.port_db(rdb)
        try:
            rres, rerr = r_fn(sql, rdb), None
        except Exception as e:          # the outcome is compared below
            rres, rerr = None, e
        try:
            pres, perr = self._run_port(p_fn, sql, pdb), None
        except Exception as e:
            pres, perr = None, e
        self._pair(rdb)
        rout = error_outcome(rerr) if rerr is not None else shape(rres)
        pout = error_outcome(perr) if perr is not None else shape(pres)
        assert pout == rout, (f"port and reference differ\nSQL: {sql}\n"
                              f"reference: {str(rout)[:1500]}\n"
                              f"port:      {str(pout)[:1500]}")
        if rerr is not None:
            raise rerr
        return rres

    def execute(self, sql: str, rdb):
        ordered = is_ordered(sql)
        return self._both(r_execute, p_execute, sql, rdb,
                          lambda res: outcome(res, ordered))

    def explain(self, sql: str, rdb, *args, **kwargs):
        return self._both(
            lambda s, d: r_explain(s, d, *args, **kwargs),
            lambda s, d: p_explain(s, d, *args, **kwargs),
            sql, rdb, explain_outcome)


def redirect(monkeypatch, module, diff: Differential) -> None:
    """Point `module`'s execute/explain names at `diff`."""
    if hasattr(module, "execute"):
        monkeypatch.setattr(module, "execute", diff.execute)
    if hasattr(module, "explain"):
        monkeypatch.setattr(module, "explain", diff.explain)
