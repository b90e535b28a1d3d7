"""Plain NumPy reference of a filtered, grouped aggregation over a fact
table and the dimensions its keys name (a star), from a declarative spec.

It reads only the generated planes (`portbench.lib.dataset.Dataset`) and
imports nothing of the program.  Spec (in a mix file's template):

  "reference": {
    "family": "star_agg",
    "fact": "lineorder",
    "joins": [{"table": "date", "fk": "lo_orderdate", "pk": "d_datekey"}],
    "where": [["eq", ["col", "date", "d_year"], ["param", "year"]], ...],
    "select": [["key", expr], ["count"], ["sum", expr], ["avg", expr]],
    "ordered": true      # the SQL orders by the keys
  }

Expressions: ["col", table, column], ["param", name], ["lit", value],
["mul"|"mod", e, e].  Predicates: ["lt"|"gt"|"eq", e, e] and
["between", e, lo, hi]; text compares by its dictionary's
strings.  A join is an inner equi-join of the fact's key to a dimension's
unique key, by dense lookup.  Group keys are the select's "key" items, in
order; an ungrouped select gives one row.

Sums follow PostgreSQL: sum(int) is an exact integer (two float64 partial
sums of 16-bit halves), sum(float8) and avg(float8) accumulate in float64.
`precision="float32"` computes every sum in float32 instead: the control
that a comparison must reject.
"""

from __future__ import annotations

import threading

import numpy as np

from portbench.lib.dataset import Dataset

FLOAT_TYPES = ("float4", "float8")


class Env:
    """One reference run over one dataset: the dense join lookups and the
    gathered dimension columns, reused across its queries (which may run
    in threads: each is built once, under the lock)."""

    def __init__(self, data: Dataset):
        self.data = data
        self._rows: dict = {}
        self._cols: dict = {}
        self._mu = threading.RLock()

    def join_rows(self, fact: str, join: dict) -> np.ndarray:
        key = (fact, join["table"], join["fk"], join["pk"])
        with self._mu:
            return self._join_rows(key, fact, join)

    def _join_rows(self, key, fact: str, join: dict) -> np.ndarray:
        """Each fact row's dimension row, -1 where its key finds none."""
        if key not in self._rows:
            pk = self.data.col(join["table"], join["pk"]).data
            fk = self.data.col(fact, join["fk"]).data
            lo, hi = int(pk.min()), int(pk.max())
            look = np.full(hi - lo + 1, -1, dtype=np.int32)
            look[pk.astype(np.int64) - lo] = np.arange(len(pk),
                                                       dtype=np.int32)
            if len(fk) and int(fk.min()) >= lo and int(fk.max()) <= hi:
                rows = look[fk - fk.dtype.type(lo)]
            else:
                f64 = fk.astype(np.int64)
                inside = (f64 >= lo) & (f64 <= hi)
                rows = np.full(len(fk), -1, dtype=np.int32)
                rows[inside] = look[f64[inside] - lo]
            self._rows[key] = rows
        return self._rows[key]

    def inner(self, fact: str, join: dict):
        """Fact rows whose key finds a dimension row, or None for all."""
        key = ("inner", fact, join["table"], join["fk"])
        with self._mu:
            if key not in self._rows:
                found = self.join_rows(fact, join) >= 0
                self._rows[key] = None if found.all() else found
            return self._rows[key]

    def column(self, fact: str, joins: list, table: str, name: str):
        """(values aligned with the fact's rows, type, dictionary)."""
        c = self.data.col(table, name)
        if table == fact:
            return c.data, c.type, c.dictionary
        key = (fact, table, name)
        with self._mu:
            if key not in self._cols:
                j = next(j for j in joins if j["table"] == table)
                rows = self.join_rows(fact, j)
                if self.inner(fact, j) is not None:
                    rows = np.maximum(rows, 0)
                self._cols[key] = c.data[rows]
            return self._cols[key], c.type, c.dictionary


class _Val:
    """A column or scalar in a query: values, type, text dictionary."""

    def __init__(self, v, typ, dictionary=None):
        self.v, self.typ, self.dictionary = v, typ, dictionary


def _expr(e, env: Env, spec: dict, params: dict, sel) -> _Val:
    op = e[0]
    if op == "col":
        v, typ, d = env.column(spec["fact"], spec.get("joins", []), e[1], e[2])
        return _Val(v if sel is None else v[sel], typ, d)
    if op == "param":
        x = params[e[1]]
    elif op == "lit":
        x = e[1]
    else:
        a = _expr(e[1], env, spec, params, sel)
        b = _expr(e[2], env, spec, params, sel)
        typ = ("float8" if a.typ in FLOAT_TYPES or b.typ in FLOAT_TYPES
               else "int8" if "int8" in (a.typ, b.typ) else "int4")
        av, bv = _num(a), _num(b)
        if op == "mul":
            r = av * bv
        elif op == "mod":
            r = np.fmod(av, bv)
        else:
            raise ValueError(f"unknown operator {op}")
        if typ == "int4" and np.size(r) and (
                np.max(r) > 2**31 - 1 or np.min(r) < -2**31):
            raise OverflowError("integer out of range")
        return _Val(r, typ)
    typ = ("text" if isinstance(x, str) else
           "float8" if isinstance(x, float) else "int4")
    return _Val(x, typ)


def _num(a: _Val):
    if a.typ in FLOAT_TYPES:
        return np.asarray(a.v, dtype=np.float64)
    return np.asarray(a.v, dtype=np.int64)


_CMP = {"lt": np.less, "gt": np.greater, "eq": np.equal}


def _text_mask(col: _Val, test) -> np.ndarray:
    """Rows of a dictionary-coded column whose string passes `test`."""
    ok = np.array([bool(test(s)) for s in col.dictionary], dtype=np.bool_)
    return ok[col.v]


def _pred(p, env, spec, params) -> np.ndarray:
    op = p[0]
    if op == "between":
        x = _expr(p[1], env, spec, params, None)
        lo = _expr(p[2], env, spec, params, None)
        hi = _expr(p[3], env, spec, params, None)
        if x.typ == "text":
            return _text_mask(x, lambda s: lo.v <= s <= hi.v)
        m = x.v >= _scalar(lo)
        m &= x.v <= _scalar(hi)
        return m
    a = _expr(p[1], env, spec, params, None)
    b = _expr(p[2], env, spec, params, None)
    f = _CMP[op]
    if a.typ == "text":
        return _text_mask(a, lambda s: f(s, b.v))
    return f(a.v, _scalar(b))


def _scalar(v: _Val):
    """A compare's right side: a scalar constant, exact as Python gives it
    (NumPy compares an int32 or float64 column with it exactly)."""
    if np.ndim(v.v) != 0:
        raise ValueError("a compare's right side is a constant")
    return v.v


def _group_ids(keys: list[np.ndarray]) -> tuple[np.ndarray, int, list]:
    """Dense group ids of the selected rows' key tuples, the group count,
    and each group's key values (as arrays)."""
    if not keys:
        return None, 1, []
    lows = [int(k.min()) if len(k) else 0 for k in keys]
    spans = [int(k.max()) - lo + 1 if len(k) else 1
             for k, lo in zip(keys, lows)]
    if np.prod([float(s) for s in spans]) <= 1 << 26:
        gid = np.zeros(len(keys[0]), dtype=np.int64)
        for k, lo, s in zip(keys, lows, spans):
            gid = gid * s + (k.astype(np.int64) - lo)
        total = int(np.prod(spans))
        present = np.flatnonzero(np.bincount(gid, minlength=total))
        dense = np.zeros(total, dtype=np.int64)
        dense[present] = np.arange(len(present))
        gid = dense[gid]
        vals, rest = [], present
        for lo, s in reversed(list(zip(lows, spans))):
            vals.append(rest % s + lo)
            rest = rest // s
        return gid, len(present), vals[::-1]
    uniq, gid = np.unique(np.stack(keys, axis=1), axis=0, return_inverse=True)
    return gid.ravel(), len(uniq), [uniq[:, i] for i in range(len(keys))]


def _sum(v: np.ndarray, gid, n: int, typ: str, precision: str):
    if precision == "float32":
        v32 = v.astype(np.float32)
        if len(v32) == 0:
            return np.zeros(n, dtype=np.float32)
        if gid is None:
            return np.array([np.add.reduce(v32, dtype=np.float32)])
        order = np.argsort(gid, kind="stable")
        g = gid[order]
        starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
        return np.add.reduceat(v32[order], starts).astype(np.float32)
    g = np.zeros(len(v), dtype=np.int64) if gid is None else gid
    if typ in FLOAT_TYPES:
        return np.bincount(g, weights=v.astype(np.float64), minlength=n)
    iv = v.astype(np.int64)
    lo = (iv & 0xFFFF).astype(np.float64)
    hi = (iv >> 16).astype(np.float64)
    return (np.bincount(g, weights=hi, minlength=n).astype(np.int64) * 65536
            + np.bincount(g, weights=lo, minlength=n).astype(np.int64))


def evaluate(spec: dict, params: dict, env: Env,
             precision: str = "float64") -> list[tuple]:
    """The answer rows of one query, in the order the SQL gives them
    (sorted by the keys when `ordered`, else in key order too)."""
    mask = None
    for p in spec.get("where", []):
        m = _pred(p, env, spec, params)
        mask = m if mask is None else mask & m
    for j in spec.get("joins", []):
        inner = env.inner(spec["fact"], j)
        if inner is not None:
            mask = inner if mask is None else mask & inner
    sel = np.flatnonzero(mask) if mask is not None else None
    items = spec["select"]
    keys = [_expr(it[1], env, spec, params, sel) for it in items
            if it[0] == "key"]
    gid, n, key_vals = _group_ids([k.v for k in keys])
    nsel = len(sel) if sel is not None else env.data.nrows(spec["fact"])
    counts = (np.bincount(gid, minlength=n) if gid is not None
              else np.array([nsel]))
    cols = []
    ki = 0
    for it in items:
        if it[0] == "key":
            k = keys[ki]
            vals = key_vals[ki]
            ki += 1
            if k.typ == "text":
                cols.append([k.dictionary[int(c)] for c in vals])
            else:
                cols.append([int(c) for c in vals])
        elif it[0] == "count":
            cols.append([int(c) for c in counts])
        else:
            x = _expr(it[1], env, spec, params, sel)
            s = _sum(_num(x), gid, n, x.typ, precision)
            is_float = x.typ in FLOAT_TYPES
            out = []
            for g in range(n):
                if counts[g] == 0:
                    out.append(None)
                elif it[0] == "avg":
                    out.append(float(s[g]) / int(counts[g]))
                elif is_float:
                    out.append(float(s[g]))
                else:
                    out.append(int(round(float(s[g]))) if precision ==
                               "float32" else int(s[g]))
            cols.append(out)
    if gid is not None and n == 0:
        return []
    return list(zip(*cols))


def exact_columns(spec: dict, env: Env) -> list[bool]:
    """Which output columns compare exactly (keys, counts, integer sums);
    the others are floats, compared by their relative gap."""
    out = []
    for it in spec["select"]:
        if it[0] in ("key", "count"):
            out.append(True)
        elif it[0] == "avg":
            out.append(False)
        else:
            x = _expr(it[1], env, spec, {}, np.array([], dtype=np.int64))
            out.append(x.typ not in FLOAT_TYPES)
    return out
