"""Top-level SQL API: execute / explain.

The psql-facing surface.  SET statements map PostgreSQL GUC names
(pg_strom.enabled, pg_strom.debug_force_gpupreagg, extra_float_digits, ...)
onto the config system, so the reference's regression scripts drive this
engine with their SET lines unchanged (input/sql/*.sql:3-7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..config import config, set_config
from ..datastore import Database
from ..plan.planner import plan_query, plan_select, PlannedQuery
from ..sql import parser as ast
from ..utils.pgformat import value_out


# session-level settings that aren't engine config
_SESSION = {"extra_float_digits": 0}

_GUC_MAP = {
    "pg_strom.enabled": "enabled",
    "pg_strom.enabled_global": "enabled_global",
    "pg_strom.enable_gpuscan": "enable_tpuscan",
    "pg_strom.enable_tpuscan": "enable_tpuscan",
    "pg_strom.enable_gpuhashjoin": "enable_tpuhashjoin",
    "pg_strom.enable_tpuhashjoin": "enable_tpuhashjoin",
    "pg_strom.enable_gpupreagg": "enable_tpupreagg",
    "pg_strom.enable_tpupreagg": "enable_tpupreagg",
    "pg_strom.enable_gpusort": "enable_tpusort",
    "pg_strom.debug_force_gpupreagg": "debug_force_tpupreagg",
    "pg_strom.debug_force_tpupreagg": "debug_force_tpupreagg",
    "pg_strom.perfmon": "perfmon",
    "pg_strom.show_device_kernel": "show_device_kernel",
    "pg_strom.chunk_size": "chunk_rows",
    "pg_strom.min_async_chunks": "min_async_chunks",
    "pg_strom.max_async_chunks": "max_async_chunks",
    "pg_strom.distributed": "distributed",
    "pg_strom.preagg_int8": "use_preagg_int8",
    "pg_strom.warmup_async": "warmup_async",
}


@dataclasses.dataclass
class Result:
    columns: list[str]
    rows: list[tuple]
    types: list
    command: str = "SELECT"

    def formatted(self, extra_float_digits: Optional[int] = None) -> list[str]:
        efd = (_SESSION["extra_float_digits"]
               if extra_float_digits is None else extra_float_digits)
        from ..utils.pgformat import row_out
        return [row_out(r, tuple(self.types), efd) for r in self.rows]

    def scalar(self) -> Any:
        return self.rows[0][0] if self.rows else None


def execute(sql: str, db: Database) -> Result:
    stmt = ast.parse(sql)
    if isinstance(stmt, ast.SetStmt):
        _apply_set(stmt)
        return Result(columns=[], rows=[], types=[], command="SET")
    if isinstance(stmt, ast.CreateStmt):
        return _exec_create(stmt, db)
    if isinstance(stmt, ast.DropStmt):
        db.drop(stmt.name, missing_ok=stmt.if_exists)
        return Result(columns=[], rows=[], types=[], command="DROP TABLE")
    if isinstance(stmt, ast.InsertStmt):
        return _exec_insert(stmt, db)
    if isinstance(stmt, ast.UpdateStmt):
        return _exec_update(stmt, db)
    if isinstance(stmt, ast.DeleteStmt):
        return _exec_delete(stmt, db)
    if isinstance(stmt, ast.CopyStmt):
        return _exec_copy(stmt, db)
    if isinstance(stmt, ast.ExplainStmt):
        pq = plan_query(stmt.query, db)
        text = pq.explain(verbose=stmt.verbose, costs=stmt.costs)
        from ..sqltypes import T
        if stmt.analyze:
            # EXPLAIN ANALYZE: run it and append perfmon phases (the
            # pg_strom.perfmon EXPLAIN output analog, main.c:504-660)
            import time as _time
            from ..config import override
            with override(perfmon=True):
                t0 = _time.perf_counter()
                rows = pq.execute()
                dt = (_time.perf_counter() - t0) * 1e3
            text += f"\n(actual rows={len(rows)})"
            for line in pq.perfmon.report_lines():
                text += f"\n  {line}"
            text += f"\nExecution Time: {dt:.3f} ms"
        return Result(columns=["QUERY PLAN"],
                      rows=[(line,) for line in text.splitlines()],
                      types=[T.TEXT], command="EXPLAIN")
    pq = plan_query(stmt, db)
    rows = pq.execute()
    return Result(columns=pq.out_names, rows=rows, types=pq.out_types)


def explain(sql: str, db: Database, verbose: bool = False) -> str:
    stmt = ast.parse(sql)
    if isinstance(stmt, ast.ExplainStmt):
        return plan_query(stmt.query, db).explain(verbose=stmt.verbose or verbose)
    return plan_query(stmt, db).explain(verbose=verbose)


def _apply_set(stmt: ast.SetStmt) -> None:
    name = stmt.name.lower()
    val = stmt.value.strip().strip("'")
    if name == "extra_float_digits":
        _SESSION["extra_float_digits"] = int(val.replace(" ", ""))
        return
    if name in ("client_min_messages",):
        set_config("client_min_messages", val)
        return
    if name in _GUC_MAP:
        set_config(_GUC_MAP[name], val)
        return
    if name.startswith("pg_strom."):
        key = name.split(".", 1)[1]
        try:
            set_config(key, val)
            return
        except KeyError:
            pass
        raise KeyError(f'unrecognized configuration parameter "{name}"')
    # unknown non-engine settings are accepted and ignored (psql compat)


# ---------------------------------------------------------------------------
# DDL / DML (the engine IS the database here; the reference delegated these
# to PostgreSQL)
# ---------------------------------------------------------------------------

def _value_in(t, v):
    """Coerce a python/SQL-literal value to a column type's host value."""
    import datetime
    from decimal import Decimal
    from ..sqltypes import T, type_from_sql  # noqa: F401
    from ..pgops import check_int_range
    from ..errors import SqlError
    if v is None:
        return None
    if t in (T.INT2, T.INT4, T.INT8):
        # PG assignment cast to integer rounds half-away-from-zero
        # (numeric) / half-even (float rint); unparseable strings raise
        # 22P02, not a bare ValueError.
        try:
            if isinstance(v, bool):
                raise ValueError("boolean")
            if isinstance(v, float):
                # PG float8->int4 is rint(): ties-to-even, like round()
                iv = round(v)
            elif isinstance(v, Decimal):
                # PG numeric->int4 rounds ties away from zero
                from decimal import ROUND_HALF_UP
                iv = int(v.to_integral_value(rounding=ROUND_HALF_UP))
            elif isinstance(v, str):
                s = v.strip()
                try:
                    iv = int(s)
                except ValueError:
                    # PG int4 input accepts no fraction; go through
                    # numeric semantics like a numeric literal would
                    from decimal import ROUND_HALF_UP
                    iv = int(Decimal(s).to_integral_value(
                        rounding=ROUND_HALF_UP))
            else:
                iv = int(v)
        except (ValueError, ArithmeticError):
            raise SqlError(
                f"invalid input syntax for type integer: {v!r}")
        return check_int_range(t, iv)
    if t in (T.FLOAT4, T.FLOAT8):
        try:
            return float(v)
        except (ValueError, TypeError):
            raise SqlError(
                f"invalid input syntax for type double precision: {v!r}")
    if t is T.NUMERIC:
        return v if isinstance(v, Decimal) else Decimal(str(v))
    if t is T.BOOL:
        if isinstance(v, str):
            return v.strip().lower() in ("t", "true", "yes", "on", "1")
        return bool(v)
    if t is T.DATE:
        if isinstance(v, (int,)):
            return int(v)
        d = datetime.date.fromisoformat(str(v).strip())
        return (d - datetime.date(2000, 1, 1)).days
    if t is T.TIME:
        if isinstance(v, int):
            return v
        tt = datetime.time.fromisoformat(str(v).strip())
        return ((tt.hour * 60 + tt.minute) * 60 + tt.second) * 1_000_000 \
            + tt.microsecond
    if t is T.TIMESTAMP:
        if isinstance(v, int):
            return v
        ts = datetime.datetime.fromisoformat(str(v).strip())
        return round((ts - datetime.datetime(2000, 1, 1)).total_seconds()
                     * 1_000_000)
    return str(v)


def _exec_create(stmt: ast.CreateStmt, db: Database) -> Result:
    from ..sqltypes import type_from_sql
    from ..datastore import Table, column_from_values
    if stmt.name in db and stmt.if_not_exists:
        return Result([], [], [], command="CREATE TABLE")
    cols = {cn: column_from_values(type_from_sql(tn), [])
            for cn, tn in stmt.columns}
    db.create(Table.from_columns(stmt.name, cols),
              replace=False if not stmt.if_not_exists else True)
    return Result([], [], [], command="CREATE TABLE")


def _exec_insert(stmt: ast.InsertStmt, db: Database) -> Result:
    from ..errors import SqlError
    from ..datastore import Table, column_from_values
    from ..plan.planner import plan_query
    from ..plan.binder import Scope, bind_expr
    from ..expr.eval_cpu import eval_expr_cpu
    tbl = db.get(stmt.name)
    names = list(tbl.column_names)
    tgt = stmt.columns or names
    unknown = [c for c in tgt if c not in names]
    if unknown:
        raise SqlError(f'column "{unknown[0]}" of relation '
                       f'"{stmt.name}" does not exist')
    if stmt.query is not None:
        rows = plan_query(stmt.query, db).execute()
    else:
        scope = Scope(rels=[])

        def norow(_):
            raise SqlError("INSERT VALUES may not reference columns")
        rows = []
        for r in stmt.values:
            vals = []
            for e in r:
                be = bind_expr(e, scope, allow_aggs=False)
                vals.append(eval_expr_cpu(be, norow))
            rows.append(vals)
    for r in rows:
        if len(r) != len(tgt):
            raise SqlError("INSERT has more or fewer expressions than "
                           "target columns")
    # rebuild columns (columns are immutable; acceptable for DML-scale
    # inserts — bulk ingest goes through COPY / the native CSV loader)
    per_tgt = {c: i for i, c in enumerate(tgt)}
    new_cols = {}
    for cn in names:
        c = tbl.columns[cn]
        old = [c.get(i) for i in range(tbl.nrows)]
        if cn in per_tgt:
            old.extend(_value_in(c.type, r[per_tgt[cn]]) for r in rows)
        else:
            old.extend(None for _ in rows)
        new_cols[cn] = column_from_values(c.type, old)
    db.create(Table.from_columns(stmt.name, new_cols))
    return Result([], [], [], command=f"INSERT 0 {len(rows)}")


def _dml_layout(name: str, tbl) -> dict:
    # the binder qualifies refs as "alias.col"; accept bare names too
    layout = {}
    for i, n in enumerate(tbl.column_names):
        layout[n] = i
        layout[f"{name}.{n}"] = i
    return layout


def _bound_where(where, name: str, tbl, db):
    """WHERE of UPDATE/DELETE bound to the table layout — the match set
    comes from ScanExecutor.row_indexes, so the filter kernel (and its
    CpuReCheck ladder) is the same one SELECT uses."""
    from ..plan.binder import Scope, bind_expr
    from ..expr.ir import bind_columns
    be = bind_expr(where, Scope(rels=[(name, tbl)], db=db),
                   allow_aggs=False)
    return bind_columns(be, _dml_layout(name, tbl))


def _exec_delete(stmt: "ast.DeleteStmt", db: Database) -> Result:
    import numpy as np
    from ..datastore import Table, column_gather
    from ..exec.scan_exec import ScanExecutor
    tbl = db.get(stmt.name)
    if stmt.where is None:
        hit = np.arange(tbl.nrows, dtype=np.int64)
    else:
        hit = np.asarray(ScanExecutor(
            tbl, _bound_where(stmt.where, stmt.name, tbl, db)).row_indexes(),
            dtype=np.int64)
    # plane-level rebuild (a python keep-list would rebuild every column
    # through per-value loops)
    keepmask = np.ones(tbl.nrows, dtype=bool)
    keepmask[hit] = False
    keep = np.flatnonzero(keepmask)
    db.create(Table.from_columns(stmt.name, {
        cn: column_gather(tbl.columns[cn], keep)
        for cn in tbl.column_names}))
    return Result([], [], [], command=f"DELETE {len(hit)}")


def _widening_cast(src, dst) -> bool:
    """Assignment casts that are a pure numpy astype: int widening, any
    int -> float (PG rounds exactly like IEEE conversion), float4 ->
    float8.  Narrowing needs range/rounding checks and stays per-value."""
    from ..sqltypes import T
    ints = (T.INT2, T.INT4, T.INT8)
    floats = (T.FLOAT4, T.FLOAT8)
    if src in ints and dst in ints:
        return ints.index(src) <= ints.index(dst)
    if src in ints and dst in floats:
        return True
    return src is T.FLOAT4 and dst is T.FLOAT8


def _exec_update(stmt: "ast.UpdateStmt", db: Database) -> Result:
    import numpy as np
    from ..errors import SqlError
    from ..exec.scan_exec import ScanExecutor
    from ..plan.binder import Scope, bind_expr
    from ..expr.ir import bind_columns
    from ..expr.eval_cpu import eval_expr_cpu
    from ..datastore import Table, column_from_values
    tbl = db.get(stmt.name)
    names = list(tbl.column_names)
    for cn, _e in stmt.sets:
        if cn not in names:
            raise SqlError(f'column "{cn}" of relation "{stmt.name}" '
                           "does not exist")
    if stmt.where is None:
        hit = np.arange(tbl.nrows, dtype=np.int64)
    else:
        hit = np.asarray(ScanExecutor(
            tbl, _bound_where(stmt.where, stmt.name, tbl, db)).row_indexes(),
            dtype=np.int64)
    scope = Scope(rels=[(stmt.name, tbl)], db=db)
    layout = _dml_layout(stmt.name, tbl)
    bsets = [(cn, bind_columns(bind_expr(e, scope, allow_aggs=False),
                               layout))
             for cn, e in stmt.sets]
    # SET exprs see the OLD row (PG semantics: all assignments evaluate
    # against the pre-update tuple).  Plane-level rebuild: untouched
    # columns are SHARED (same uid => the
    # device chunk cache keeps its buffers), updated columns scatter a
    # hit-sized sub-column into a plane copy; only complex SET
    # expressions evaluate per hit row.
    from ..expr.ir import ColumnRef, Const
    from ..datastore import column_gather, column_scatter
    from ..plan.planner import _column_values_at
    cols = [tbl.columns[n] for n in names]
    nhit = len(hit)
    subs: dict[str, object] = {}
    for cn, be in bsets:
        t = tbl.columns[cn].type
        if isinstance(be, Const):
            one = column_from_values(t, [_value_in(t, be.value)])
            subs[cn] = column_gather(one, np.zeros(nhit, np.int64))
        elif isinstance(be, ColumnRef) and cols[be.index].type == t:
            subs[cn] = column_gather(cols[be.index], hit)
        elif isinstance(be, ColumnRef) and _widening_cast(
                cols[be.index].type, t):
            # lossless-or-PG-rounding plane cast (int widening, int->float,
            # float4->float8): pure astype, no per-value loop
            from ..datastore import column_from_numpy
            src = cols[be.index]
            subs[cn] = column_from_numpy(t, src.data[hit], src.valid[hit])
        elif isinstance(be, ColumnRef):
            vals = _column_values_at(cols[be.index], hit)
            subs[cn] = column_from_values(
                t, [None if v is None else _value_in(t, v) for v in vals])
        else:
            def row_at(i):
                return lambda s: cols[s].get(i)
            vals = [eval_expr_cpu(be, row_at(int(i))) for i in hit]
            subs[cn] = column_from_values(
                t, [None if v is None else _value_in(t, v) for v in vals])
    new_cols = {}
    for cn in names:
        c = tbl.columns[cn]
        new_cols[cn] = column_scatter(c, hit, subs[cn]) if cn in subs \
            else c
    db.create(Table.from_columns(stmt.name, new_cols))
    return Result([], [], [], command=f"UPDATE {nhit}")


def _exec_copy(stmt: ast.CopyStmt, db: Database) -> Result:
    tbl = db.get(stmt.name)
    n = _copy_native(stmt, db, tbl)
    if n is None:
        n = _copy_python(stmt, db, tbl)
    return Result([], [], [], command=f"COPY {n}")


# COPY targets ride the native parallel loader for int/float/date/text/
# numeric columns (the multi-threaded ingest analog of the reference's
# opencl_num_threads worker pool; planes live in the native Arena);
# PG-exact error surfaces and other types use the python path
_NATIVE_COPY_T = None                  # the loader's worker Pool
_NATIVE_TMAP = None


def _native_tmap():
    global _NATIVE_TMAP
    if _NATIVE_TMAP is None:
        from ..sqltypes import T
        _NATIVE_TMAP = {T.INT2: "i", T.INT4: "i", T.INT8: "i",
                        T.FLOAT4: "f", T.FLOAT8: "f",
                        T.DATE: "d", T.TEXT: "t", T.NUMERIC: "n"}
    return _NATIVE_TMAP


def _copy_native(stmt: ast.CopyStmt, db: Database, tbl) -> int | None:
    from ..sqltypes import T, STORAGE_DTYPE, INT_BOUNDS
    from ..datastore import Table, Column
    import numpy as _np
    tmap = _native_tmap()
    names = list(tbl.column_names)
    ctypes_ = [tbl.columns[c].type for c in names]
    if stmt.delimiter != "," or not names or \
            any(t not in tmap for t in ctypes_):
        return None
    from ..native import load_csv2, Pool
    with open(stmt.filename, "rb") as f:
        data = f.read()
    if stmt.header:
        nl = data.find(b"\n")
        data = data[nl + 1:] if nl >= 0 else b""
    if b'"' in data or b"\\" in data:
        return None                      # quoted/escaped: exact python path
    global _NATIVE_COPY_T
    if _NATIVE_COPY_T is None:
        from ..config import config as _cfg
        _NATIVE_COPY_T = Pool(_cfg.loader_threads)
    planes, bad = load_csv2(data, [tmap[t] for t in ctypes_],
                            pool=_NATIVE_COPY_T)
    if bad:
        return None                      # malformed fields: PG-exact errors
    nrows_new = len(planes[0][0]) if planes and planes[0] else 0
    new_cols = {}
    for pl, cn, t in zip(planes, names, ctypes_):
        old = tbl.columns[cn]
        if t is T.NUMERIC:
            nc = _native_numeric_column(pl, old)
        elif t is T.TEXT:
            nc = _native_text_column(pl, old)
        else:
            d, v = pl
            if t in INT_BOUNDS and t is not T.INT8:
                lo, hi = INT_BOUNDS[t]
                if _np.any(v & ((d < lo) | (d > hi))):
                    return None          # out-of-range: PG-exact error path
            if t is T.INT8 and _np.any(v & ((d == _np.iinfo(_np.int64).max)
                                            | (d == _np.iinfo(_np.int64).min))):
                return None              # possible strtoll saturation
            if t in (T.FLOAT4, T.FLOAT8):
                f = d if t is T.FLOAT8 else d.astype(_np.float32)
                if _np.any(v & ~_np.isfinite(f)):
                    # legit 'Infinity'/'NaN' inputs AND silent overflow both
                    # route to the exact path (PG raises on the latter)
                    return None
            nc = Column(type=t, data=_cat(old.data, d, STORAGE_DTYPE[t]),
                        valid=_cat(old.valid, v, _np.bool_))
        if nc is None:
            return None
        new_cols[cn] = nc
    db.create(Table.from_columns(stmt.name, new_cols))
    return nrows_new


def _cat(old_arr, new_arr, dtype):
    """Append planes; a fresh (empty) table adopts the native Arena plane
    directly — bulk loads stay arena-resident (pgstrom_arena_info shows
    them live for the table's lifetime), matching the reference's
    shmem-resident data stores (shmem.c/datastore.c)."""
    import numpy as _np
    new_arr = _np.asarray(new_arr).astype(dtype, copy=False)
    if old_arr is None or len(old_arr) == 0:
        return new_arr
    return _np.concatenate([old_arr, new_arr])


def _native_numeric_column(pl, old):
    """Canonical (mant, exp, dscale) Column from native (mant, dscale)
    planes — replicating numeric_from_decimal's normalization exactly
    (strip trailing-zero factors into exp); out-of-window values return
    None => exact python fallback."""
    import numpy as _np
    from ..sqltypes import T
    from ..datastore import Column
    mant, dscale, v = pl
    mant = mant.copy()
    exp = -dscale.astype(_np.int64)
    for _ in range(18):                      # strip factors of 10
        m = v & (mant != 0) & (mant % 10 == 0)
        if not m.any():
            break
        mant = _np.where(m, mant // 10, mant)
        exp = _np.where(m, exp + 1, exp)
    exp = _np.where(v & (mant == 0), 0, exp)
    from ..config import config as _cfg
    if _np.any(v & ((_np.abs(mant) > _cfg.numeric_max_mantissa)
                    | (exp < _cfg.numeric_min_exponent)
                    | (exp > _cfg.numeric_max_exponent))):
        return None
    nc = Column(type=T.NUMERIC, data=_cat(old.data, mant, _np.int64),
                valid=_cat(old.valid, v, _np.bool_))
    old_exp = old.num_exp if old.num_exp is not None \
        else _np.zeros(0, _np.int32)
    old_ds = old.num_dscale if old.num_dscale is not None \
        else _np.zeros(0, _np.int32)
    old_rc = old.recheck if old.recheck is not None \
        else _np.zeros(0, bool)
    nc.num_exp = _np.concatenate([old_exp, exp.astype(_np.int32)])
    nc.num_dscale = _np.concatenate([old_ds, dscale.astype(_np.int32)])
    nc.recheck = _np.concatenate([old_rc, _np.zeros(len(mant), bool)])
    for i, d in getattr(old, "_exact_store", {}).items():
        nc._exact[i] = d
    return nc


def _native_text_column(pl, old):
    """Dictionary-encoded text Column from the native fixed-width bytes
    plane: np.unique gives the bytewise-sorted dictionary + codes in one
    vectorized pass; existing rows re-code into the merged dictionary."""
    import numpy as _np
    from ..sqltypes import T
    from ..datastore import Column
    d, v = pl
    W = d.shape[1] if d.ndim == 2 else 1
    sview = _np.ascontiguousarray(d).view(_np.dtype(f"S{max(W, 1)}")) \
        .reshape(-1)
    # one vectorized factorization over all rows; dictionary built from
    # VALID values only (NULL rows carry zeroed planes)
    uniq_all, inv = _np.unique(sview, return_inverse=True)
    try:
        uvals_all = [b.decode("utf-8") for b in uniq_all.tolist()]
        valid_vals = {b.decode("utf-8")
                      for b in _np.unique(sview[v]).tolist()} \
            if v.any() else set()
    except UnicodeDecodeError:
        return None
    if any("\x00" in s for s in valid_vals):
        return None                      # NUL padding ambiguity: fallback
    old_dict = list(old.dictionary or [])
    merged = sorted(set(old_dict) | valid_vals, key=lambda s: s.encode())
    code_of = {s: i for i, s in enumerate(merged)}
    lut = _np.array([code_of.get(s, 0) for s in uvals_all], _np.int32) \
        if len(uvals_all) else _np.zeros(0, _np.int32)
    new_codes = (lut[inv].astype(_np.int32) if len(sview)
                 else _np.zeros(0, _np.int32))
    remap = _np.array([code_of[s] for s in old_dict], _np.int32) \
        if old_dict else _np.zeros(0, _np.int32)
    old_codes = remap[old.data.astype(_np.int64)] if old_dict \
        else _np.zeros(len(old.data), _np.int32)
    nc = Column(type=T.TEXT,
                data=_np.concatenate([old_codes, new_codes]),
                valid=_np.concatenate([old.valid, v]),
                dictionary=merged)
    return nc


def _copy_python(stmt: ast.CopyStmt, db: Database, tbl) -> int:
    import csv as _csv
    from ..datastore import Table, column_from_values
    names = list(tbl.column_names)
    with open(stmt.filename, newline="") as f:
        rd = _csv.reader(f, delimiter=stmt.delimiter)
        rows = list(rd)
    if stmt.header and rows:
        rows = rows[1:]
    new_cols = {}
    for j, cn in enumerate(names):
        c = tbl.columns[cn]
        old = [c.get(i) for i in range(tbl.nrows)]
        old.extend(_value_in(c.type, r[j]) if j < len(r) and r[j] != ""
                   else None for r in rows)
        new_cols[cn] = column_from_values(c.type, old)
    db.create(Table.from_columns(stmt.name, new_cols))
    return len(rows)
