"""Random SQL query generator for differential fuzzing.

The reference validates itself by running a fixed regression corpus twice —
once with the GPU path enabled and once disabled — and diffing the output
(SURVEY §4; pg_strom's enable.conf/disable.conf discipline over its
test/*.sql corpus).  This module generalizes that contract from a
fixed corpus to a seeded RANDOM corpus: `QueryGen` emits syntactically valid
SQL over a supplied schema, and the harness (tests/test_torch_fuzz_sql.py)
runs every query through the JAX reference and through BOTH the port's
device path and its host path, and requires identical results — including
identical errors.  For the same ``random.Random`` state it emits the
reference's statements string for string.

Design constraints that keep every generated query a *fair* differential:

* deterministic: driven entirely by a caller-supplied ``random.Random`` —
  a (seed, index) pair always reproduces the same statement.
* total comparability: queries either carry a total ORDER BY (unique id
  prefix) or are compared as sorted multisets of formatted rows by the
  harness; nothing depends on engine row order.
* errors are results: overflow ("smallint out of range") and the numeric
  device window are in scope — the harness asserts both paths raise the
  SAME SqlError text, mirroring how the reference's expected/*.out files
  embed ERROR lines.
* division appears only with provably nonzero divisors (PG raises on /0,
  and both paths must raise identically anyway, but a fuzz corpus drowning
  in division-by-zero errors exercises nothing else).
"""

from __future__ import annotations

import random
from typing import Optional

# column kind -> aggregate names PostgreSQL accepts for it (subset the
# engine's AGG_CATALOG covers; ops/preagg.py:196-231)
_AGGS = {
    "int": ["count", "sum", "avg", "min", "max", "stddev", "variance"],
    "float": ["count", "sum", "avg", "min", "max", "stddev", "variance"],
    "numeric": ["count", "sum", "avg", "min", "max"],
    "text": ["count", "min", "max"],
}
_DISTINCT_AGGS = {"count", "sum", "avg"}

_CMP = ["=", "<>", "<", "<=", ">", ">="]


class TableSpec:
    def __init__(self, name: str, cols: dict[str, str],
                 unique_col: Optional[str] = None):
        self.name = name
        self.cols = cols                    # col -> kind
        self.unique_col = unique_col        # a NOT NULL unique int column

    def of_kind(self, *kinds: str) -> list[str]:
        return [c for c, k in self.cols.items() if k in kinds]


class QueryGen:
    """Seeded random SELECT generator over a schema.

    ``gen()`` returns ``(sql, ordered)`` where ``ordered`` is True when the
    statement carries a total ORDER BY (compare as a list) and False when
    the harness must compare sorted multisets.
    """

    def __init__(self, rng: random.Random, tables: list[TableSpec],
                 join_pairs: list[tuple[str, str, str, str]]):
        # join_pairs: (left_table, left_col, right_table, right_col)
        self.rng = rng
        self.tables = {t.name: t for t in tables}
        self.join_pairs = join_pairs

    # -- scalar expressions --------------------------------------------------

    def _int_atom(self, t: TableSpec, q: str) -> str:
        r = self.rng
        cols = t.of_kind("int")
        if cols and r.random() < 0.75:
            return f"{q}{r.choice(cols)}"
        return str(r.randint(-30, 30))

    def _int_expr(self, t: TableSpec, q: str, depth: int = 0) -> str:
        r = self.rng
        if depth >= 2 or r.random() < 0.45:
            return self._int_atom(t, q)
        a = self._int_expr(t, q, depth + 1)
        b = self._int_expr(t, q, depth + 1)
        op = r.choice(["+", "-", "*", "/", "%"])
        if op in ("/", "%"):
            # provably nonzero divisor only
            b = str(r.choice([2, 3, 5, 7, -4, 11]))
        return f"({a} {op} {b})"

    def _float_expr(self, t: TableSpec, q: str) -> str:
        r = self.rng
        cols = t.of_kind("float")
        if not cols:
            return f"{r.uniform(-2, 2):.3f}"
        c = f"{q}{r.choice(cols)}"
        pick = r.random()
        if pick < 0.4:
            return c
        if pick < 0.6:
            return f"abs({c})"
        if pick < 0.8:
            return f"({c} + {r.uniform(-1, 1):.3f})"
        return f"({c} * {r.uniform(-2, 2):.3f})"

    def _pred_atom(self, t: TableSpec, q: str) -> str:
        r = self.rng
        pick = r.random()
        if pick < 0.35:
            return f"{self._int_expr(t, q)} {r.choice(_CMP)} " \
                   f"{self._int_expr(t, q)}"
        if pick < 0.55:
            cols = t.of_kind("float")
            if cols:
                return f"{q}{r.choice(cols)} {r.choice(_CMP)} " \
                       f"{r.uniform(-1, 1):.3f}"
        if pick < 0.7:
            c = r.choice(list(t.cols))
            return f"{q}{c} is {'not ' if r.random() < 0.5 else ''}null"
        if pick < 0.85:
            cols = t.of_kind("int")
            if cols:
                c = r.choice(cols)
                vals = sorted(r.sample(range(-5, 35), r.randint(1, 4)))
                return f"{q}{c} in ({', '.join(map(str, vals))})"
        cols = t.of_kind("int")
        if cols:
            c = r.choice(cols)
            lo = r.randint(-10, 15)
            return f"{q}{c} between {lo} and {lo + r.randint(0, 20)}"
        return "true"

    def _pred(self, t: TableSpec, q: str = "", depth: int = 0) -> str:
        r = self.rng
        if depth >= 2 or r.random() < 0.5:
            return self._pred_atom(t, q)
        a = self._pred(t, q, depth + 1)
        b = self._pred(t, q, depth + 1)
        conn = r.choice(["and", "or"])
        neg = "not " if r.random() < 0.15 else ""
        return f"{neg}({a} {conn} {b})"

    def _agg(self, t: TableSpec, q: str = "") -> str:
        r = self.rng
        if r.random() < 0.15:
            return "count(*)"
        kind = r.choice([k for k in ("int", "float", "numeric", "text")
                         if t.of_kind(k)])
        col = r.choice(t.of_kind(kind))
        name = r.choice(_AGGS[kind])
        if name in _DISTINCT_AGGS and kind in ("int", "float") \
                and r.random() < 0.25:
            return f"{name}(distinct {q}{col})"
        return f"{name}({q}{col})"

    # -- statement shapes ----------------------------------------------------

    def gen(self) -> tuple[str, bool]:
        r = self.rng
        shape = r.choices(
            ["project", "grouped", "ungrouped", "join", "distinct",
             "setop", "topk", "subquery_in", "window", "cte", "rollup",
             "starjoin", "snowflake", "correlated", "recursive"],
            weights=[12, 14, 8, 12, 6, 6, 6, 4, 7, 5, 7, 7, 5, 7, 4])[0]
        return getattr(self, "_gen_" + shape)()

    def gen_dml(self, tname: str) -> str:
        """One UPDATE/DELETE over `tname` (the harness runs it under both
        paths on separate database copies and diffs the table)."""
        r = self.rng
        t = self.tables[tname]
        if r.random() < 0.4:
            return f"delete from {tname} where {self._pred(t)}"
        ints = t.of_kind("int")
        col = r.choice(ints)
        rhs = r.choice([str(r.randint(-20, 20)), self._int_expr(t, ""),
                        "null"])
        sets = [f"{col} = {rhs}"]
        floats = t.of_kind("float")
        if floats and r.random() < 0.4:
            sets.append(f"{r.choice(floats)} = {r.uniform(-3, 3):.3f}")
        texts = t.of_kind("text")
        if texts and r.random() < 0.3:
            sets.append(f"{r.choice(texts)} = "
                        f"'u{r.randint(0, 9)}'")
        sql = f"update {tname} set {', '.join(sets)}"
        if r.random() < 0.85:
            sql += f" where {self._pred(t)}"
        return sql

    def _fact(self) -> TableSpec:
        # any table can anchor single-table shapes
        return self.rng.choice(list(self.tables.values()))

    def _gen_project(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        n = r.randint(1, 4)
        items = []
        for _ in range(n):
            pick = r.random()
            if pick < 0.4:
                items.append(self._int_expr(t, ""))
            elif pick < 0.7:
                items.append(self._float_expr(t, ""))
            elif t.of_kind("text") and pick < 0.85:
                c = r.choice(t.of_kind("text"))
                items.append(r.choice([
                    c, f"upper({c})", f"lower({c})", f"length({c})",
                    f"substr({c}, 1, {r.randint(1, 4)})",
                    f"left({c}, {r.randint(-2, 3)})",
                    f"{c} || '-t'",
                ]))
            else:
                c = r.choice(list(t.cols))
                items.append(f"case when {self._pred_atom(t, '')} "
                             f"then {c} else null end")
        sql = f"select {', '.join(items)} from {t.name}"
        if r.random() < 0.8:
            sql += f" where {self._pred(t)}"
        return sql, False

    def _gen_grouped(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        keys = r.sample(t.of_kind("int", "text"), r.randint(1, 2))
        aggs = [self._agg(t) for _ in range(r.randint(1, 3))]
        sql = f"select {', '.join(keys + aggs)} from {t.name}"
        if r.random() < 0.7:
            sql += f" where {self._pred(t)}"
        sql += f" group by {', '.join(keys)}"
        if r.random() < 0.3:
            sql += f" having count(*) > {r.randint(0, 3)}"
        return sql, False

    def _gen_ungrouped(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        aggs = [self._agg(t) for _ in range(r.randint(1, 4))]
        sql = f"select {', '.join(aggs)} from {t.name}"
        if r.random() < 0.6:
            sql += f" where {self._pred(t)}"
        return sql, False

    def _gen_join(self) -> tuple[str, bool]:
        r = self.rng
        lt, lc, rt, rc = r.choice(self.join_pairs)
        l, rr = self.tables[lt], self.tables[rt]
        jt = r.choice(["join", "join", "left join", "right join",
                       "full join"])
        grouped = r.random() < 0.5
        if grouped:
            key = f"{lt}.{r.choice(l.of_kind('int'))}"
            aggs = [self._agg(rr, rt + ".") for _ in range(r.randint(1, 2))]
            items = [key] + aggs
            tail = f" group by {key}"
        else:
            items = [f"{lt}.{r.choice(list(l.cols))}",
                     f"{rt}.{r.choice(list(rr.cols))}"]
            tail = ""
        sql = (f"select {', '.join(items)} from {lt} {jt} {rt} "
               f"on {lt}.{lc} = {rt}.{rc}")
        if r.random() < 0.5:
            # outer-join WHERE quals filter post-join (PG semantics) —
            # generate them only on the preserved side to stay interesting
            side = l if "right" not in jt else rr
            sq = (lt if side is l else rt) + "."
            sql += f" where {self._pred(side, sq)}"
        return sql + tail, False

    def _gen_distinct(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        cols = r.sample(list(t.cols), r.randint(1, 2))
        sql = f"select distinct {', '.join(cols)} from {t.name}"
        if r.random() < 0.6:
            sql += f" where {self._pred(t)}"
        return sql, False

    def _gen_setop(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        c = r.choice(t.of_kind("int"))
        op = r.choice(["union", "union all", "except", "except all",
                       "intersect", "intersect all"])
        a = f"select {c} from {t.name} where {self._pred(t)}"
        b = f"select {c} from {t.name} where {self._pred(t)}"
        return f"{a} {op} {b}", False

    def _gen_topk(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        if t.unique_col is None:
            return self._gen_project()
        n = r.randint(1, 3)
        items = [t.unique_col] + \
            [self._float_expr(t, "") for _ in range(n - 1)]
        sql = f"select {', '.join(items)} from {t.name}"
        if r.random() < 0.7:
            sql += f" where {self._pred(t)}"
        desc = r.choice(["", " desc"])
        sql += f" order by {t.unique_col}{desc} limit {r.randint(1, 40)}"
        return sql, True

    def _gen_window(self) -> tuple[str, bool]:
        """Window functions over a table with a unique column.

        Determinism contract: rank/dense_rank and aggregate windows are
        peer-stable (any enumeration order gives the same value), so they
        may order by any keys; row_number/lag/lead/first_value/last_value
        need a TOTAL order, so the unique column is appended to the
        window ORDER BY."""
        r = self.rng
        cands = [t for t in self.tables.values() if t.unique_col]
        if not cands:
            return self._gen_project()
        t = r.choice(cands)
        u = t.unique_col
        ints, floats = t.of_kind("int"), t.of_kind("float")
        kind = r.choice(["ranker", "agg", "offset"])
        part = f"partition by {r.choice(ints)} " if r.random() < 0.6 else ""
        okey = r.choice(ints + floats)
        desc = r.choice(["", " desc"])
        if kind == "ranker":
            fn = r.choice(["rank()", "dense_rank()"])
            over = f"({part}order by {okey}{desc})"
        elif kind == "agg":
            agg = r.choice(["sum", "avg", "min", "max", "count"])
            fn = f"{agg}({r.choice(ints + floats)})"
            over = f"({part}order by {okey}{desc})" if r.random() < 0.7 \
                else f"({part.rstrip()})" if part else "()"
        else:
            pick = r.random()
            if pick < 0.3:
                fn = (f"lag({r.choice(ints)}, {r.randint(1, 3)}, "
                      f"{r.randint(-5, 5)})")
            elif pick < 0.55:
                fn = f"lead({r.choice(ints + floats)})"
            elif pick < 0.7:
                fn = "row_number()"
            elif pick < 0.85:
                fn = f"first_value({r.choice(ints + floats)})"
            else:
                fn = f"last_value({r.choice(ints + floats)})"
            over = f"({part}order by {okey}{desc}, {u})"
        sql = f"select {u}, {fn} over {over} from {t.name}"
        if r.random() < 0.6:
            sql += f" where {self._pred(t)}"
        return sql, False

    def _gen_cte(self) -> tuple[str, bool]:
        """WITH c(a0..ak) AS (grouped query) SELECT ... FROM c."""
        r, t = self.rng, self._fact()
        ints = t.of_kind("int")
        keys = r.sample(ints, min(len(ints), r.randint(1, 2)))
        aggs = [self._agg(t) for _ in range(r.randint(1, 2))]
        names = [f"a{i}" for i in range(len(keys) + len(aggs))]
        inner = f"select {', '.join(keys + aggs)} from {t.name}"
        if r.random() < 0.6:
            inner += f" where {self._pred(t)}"
        inner += f" group by {', '.join(keys)}"
        outer = r.choice([
            f"select count(*) from c where a0 is not null",
            f"select a0, count(*) from c group by a0",
            f"select {', '.join(names)} from c",
        ])
        return f"with c({', '.join(names)}) as ({inner}) {outer}", False

    def _gen_rollup(self) -> tuple[str, bool]:
        r, t = self.rng, self._fact()
        pool = t.of_kind("int", "text")
        keys = r.sample(pool, min(len(pool), r.randint(1, 3)))
        aggs = [self._agg(t) for _ in range(r.randint(1, 2))]
        kind = r.choice(["rollup", "cube", "sets", "sets"])
        if kind == "sets":
            # random multi-key set list incl. the empty set sometimes;
            # every selected key must land in >= 1 set (PG rejects a
            # select-list key covered by no grouping set)
            nsets = r.randint(2, 4)
            picked = [r.sample(keys, r.randint(0, len(keys)))
                      for _ in range(nsets)]
            missing = [k for k in keys
                       if not any(k in s for s in picked)]
            if missing:
                picked.append(missing)
            sets = ["(" + ", ".join(s) + ")" for s in picked]
            grp = f"grouping sets ({', '.join(sets)})"
        else:
            grp = f"{kind} ({', '.join(keys)})"
        items = keys + [f"grouping({keys[0]})"] + aggs
        sql = f"select {', '.join(items)} from {t.name}"
        if r.random() < 0.6:
            sql += f" where {self._pred(t)}"
        sql += f" group by {grp}"
        if r.random() < 0.25:
            sql += f" having count(*) > {r.randint(0, 5)}"
        return sql, False

    def _gen_starjoin(self) -> tuple[str, bool]:
        """Fact joined to TWO dims (the N-way star chain path)."""
        r = self.rng
        by_fact: dict[str, list] = {}
        for p in self.join_pairs:
            by_fact.setdefault(p[0], []).append(p)
        cands = [(f, ps) for f, ps in by_fact.items()
                 if len({p[2] for p in ps}) >= 2]
        if not cands:
            return self._gen_join()
        f, ps = r.choice(cands)
        p1 = r.choice(ps)
        p2 = r.choice([p for p in ps if p[2] != p1[2]])
        ft = self.tables[f]
        d1 = self.tables[p1[2]]
        key = f"{p1[2]}.{r.choice(list(d1.cols))}"
        aggs = [self._agg(ft, f + ".") for _ in range(r.randint(1, 2))]
        sql = (f"select {key}, {', '.join(aggs)} from {f} "
               f"join {p1[2]} on {f}.{p1[1]} = {p1[2]}.{p1[3]} "
               f"join {p2[2]} on {f}.{p2[1]} = {p2[2]}.{p2[3]}")
        if r.random() < 0.5:
            sql += f" where {self._pred(ft, f + '.')}"
        return sql + f" group by {key}", False

    def _gen_snowflake(self) -> tuple[str, bool]:
        """Fact -> dim -> parent-dim chain (snowflake resolution order)."""
        r = self.rng
        chains = [(p1, p2) for p1 in self.join_pairs
                  for p2 in self.join_pairs
                  if p2[0] == p1[2] and p2[2] not in (p1[0], p1[2])]
        if not chains:
            return self._gen_join()
        p1, p2 = r.choice(chains)
        f, d, pp = p1[0], p1[2], p2[2]
        ft, pt = self.tables[f], self.tables[pp]
        key = f"{pp}.{r.choice(list(pt.cols))}"
        aggs = [self._agg(ft, f + ".") for _ in range(r.randint(1, 2))]
        sql = (f"select {key}, {', '.join(aggs)} from {f} "
               f"join {d} on {f}.{p1[1]} = {d}.{p1[3]} "
               f"join {pp} on {d}.{p2[1]} = {pp}.{p2[3]}")
        if r.random() < 0.4:
            sql += f" where {self._pred(ft, f + '.')}"
        return sql + f" group by {key}", False

    def _gen_correlated(self) -> tuple[str, bool]:
        """Correlated EXISTS / IN / scalar-aggregate subqueries."""
        r = self.rng
        lt, lc, rt, rc = r.choice(self.join_pairs)
        rr = self.tables[rt]
        kind = r.choice(["exists", "in", "scalar"])
        neg = "not " if r.random() < 0.3 else ""
        inner_pred = f"{rt}.{rc} = {lt}.{lc}"
        if r.random() < 0.5:
            inner_pred += f" and {self._pred(rr, rt + '.')}"
        if kind == "exists":
            sql = (f"select count(*) from {lt} where {neg}exists "
                   f"(select 1 from {rt} where {inner_pred})")
        elif kind == "in":
            c = r.choice(rr.of_kind("int"))
            sql = (f"select count(*) from {lt} where {lt}.{lc} {neg}in "
                   f"(select {rt}.{c} from {rt} where {inner_pred})")
        else:
            c = r.choice(rr.of_kind("int", "float"))
            agg = r.choice(["min", "max", "count", "sum"])
            sql = (f"select count(*) from {lt} where {lt}.{lc} > "
                   f"(select {agg}({rt}.{c}) from {rt} "
                   f"where {inner_pred})")
        return sql, False

    def _gen_recursive(self) -> tuple[str, bool]:
        """WITH RECURSIVE series folded against a real aggregate."""
        r, t = self.rng, self._fact()
        hi = r.randint(3, 25)
        step = r.choice(["n+1", "n+2"])
        agg = self._agg(t)
        return (f"with recursive s(n) as (select 1 union all select "
                f"{step} from s where n < {hi}) "
                f"select (select count(*) from s), {agg} from {t.name}",
                False)

    def _gen_subquery_in(self) -> tuple[str, bool]:
        r = self.rng
        lt, lc, rt, rc = r.choice(self.join_pairs)
        l, rr = self.tables[lt], self.tables[rt]
        neg = "not " if r.random() < 0.3 else ""
        # NOT IN over a NULL-producing subquery is three-valued and a
        # classic engine bug magnet — keep NULLs out of the subquery
        # output only for NOT IN with a 50% coin, in for the rest
        inner = f"select {rc} from {rt}"
        if neg or r.random() < 0.5:
            inner += f" where {rc} is not null"
        sql = (f"select count(*) from {lt} where {lc} {neg}in ({inner})")
        return sql, False
