"""SQL lexer + recursive-descent parser.

Produces an untyped AST (plain dataclasses); the binder (binder.py) resolves
names/types against the catalog into the typed expression IR.  Operator
precedence follows PostgreSQL:

  OR < AND < NOT < IS/ISNULL < comparison (= <> < <= > >=) <
  BETWEEN/IN/LIKE < + - < * / % < ^ < unary - < :: cast < . ( )
"""

from __future__ import annotations

import dataclasses
import re
from decimal import Decimal
from typing import Any, Optional

from ..utils.perfmon import span


class ParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*\n?|--[^\n]*$)
  | (?P<num>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<cast>::)
  | (?P<op><=|>=|<>|!=|\|\||<<|>>|[=<>+\-*/%(),.;#&|~^\[\]])
  | (?P<ident>[A-Za-z_][A-Za-z_0-9$]*|"(?:[^"]|"")*")
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "is", "null", "true", "false",
    "between", "in", "like", "case", "when", "then", "else", "end", "cast",
    "asc", "desc", "nulls", "first", "last", "distinct", "join", "inner",
    "left", "right", "full", "outer", "cross", "on", "using", "union",
    "except", "intersect",
    "all", "coalesce", "exists", "explain", "verbose", "costs", "analyze",
    "set", "to", "show", "isnull", "notnull",
    "create", "table", "drop", "insert", "into", "values", "copy",
    "update", "delete",
    "with", "recursive", "over", "partition",
}


@dataclasses.dataclass
class Tok:
    kind: str       # 'num' | 'str' | 'op' | 'ident' | 'kw' | 'cast' | 'eof'
    value: str
    pos: int


def tokenize(sql: str) -> list[Tok]:
    out: list[Tok] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"syntax error at or near {sql[i:i+12]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        v = m.group()
        if kind == "ident":
            if v.startswith('"'):
                out.append(Tok("ident", v[1:-1].replace('""', '"'), m.start()))
            elif v.lower() in KEYWORDS:
                out.append(Tok("kw", v.lower(), m.start()))
            else:
                out.append(Tok("ident", v.lower(), m.start()))
        else:
            out.append(Tok(kind, v, m.start()))
    out.append(Tok("eof", "", len(sql)))
    return out


# ---------------------------------------------------------------------------
# untyped AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ALiteral:
    value: Any          # int | Decimal | str | bool | None
    is_string: bool = False


@dataclasses.dataclass
class AName:
    parts: tuple[str, ...]      # ("t","col") or ("col",)


@dataclasses.dataclass
class AStar:
    rel: Optional[str] = None   # t.* has rel="t"


@dataclasses.dataclass
class AOp:
    op: str
    args: list


@dataclasses.dataclass
class AFunc:
    name: str
    args: list
    star: bool = False
    distinct: bool = False


@dataclasses.dataclass
class AWindow:
    """func(args) OVER (PARTITION BY ... ORDER BY ...) — default frame
    only (frame clauses are rejected at parse time)."""
    func: "AFunc"
    partition: list
    order: list


@dataclasses.dataclass
class ACast:
    arg: Any
    typename: str


@dataclasses.dataclass
class ACase:
    whens: list            # [(cond, result)]
    orelse: Optional[Any]


@dataclasses.dataclass
class ANullTest:
    arg: Any
    isnull: bool


@dataclasses.dataclass
class ABool:
    op: str                 # and/or/not
    args: list


@dataclasses.dataclass
class ADistinctFrom:
    a: Any
    b: Any
    negated: bool           # True => IS DISTINCT FROM; False => IS NOT ...


@dataclasses.dataclass
class ABetween:
    arg: Any
    lo: Any
    hi: Any
    negated: bool


@dataclasses.dataclass
class AIn:
    arg: Any
    items: Any                  # list of exprs, or ASubquery
    negated: bool


@dataclasses.dataclass
class ACorrParam:
    """Placeholder the correlated-subquery rewriter (plan/correlated.py)
    puts where an outer column reference stood; never produced by
    parsing."""
    index: int


@dataclasses.dataclass
class ABoundConst:
    """An already-typed constant value injected into a query template at
    SubPlan execution time (the parameter substitution); never produced
    by parsing."""
    value: Any
    vtype: Any          # sqltypes.T


@dataclasses.dataclass
class ASubquery:
    query: Any                  # SelectStmt | SetOpStmt (uncorrelated)


@dataclasses.dataclass
class AExists:
    query: Any
    negated: bool = False


@dataclasses.dataclass
class SelectItem:
    expr: Any               # expression or AStar
    alias: Optional[str]


@dataclasses.dataclass
class TableRef:
    name: Optional[str]             # base table
    subquery: Optional["SelectStmt"]
    alias: Optional[str]
    col_aliases: Optional[list] = None   # t(a, b, ...) output renames


@dataclasses.dataclass
class CteDef:
    """One WITH entry: name [(col, ...)] AS (query)."""
    name: str
    columns: Optional[list]
    query: Any                      # SelectStmt | SetOpStmt
    recursive: bool = False         # WITH RECURSIVE applies to the list


@dataclasses.dataclass
class ARecursive:
    """A planner-internal recursive CTE reference: base UNION [ALL] rec,
    where rec references `name` (bound to the working table per
    iteration).  Built by plan/planner._expand_ctes; never parsed."""
    name: str
    columns: Optional[list]
    base: Any
    rec: Any
    union_all: bool


@dataclasses.dataclass
class JoinClause:
    jointype: str                   # 'inner' | 'cross' | 'left' | 'right' | 'full'
    table: TableRef
    on: Optional[Any]


@dataclasses.dataclass
class OrderItem:
    expr: Any
    descending: bool = False
    nulls_first: Optional[bool] = None


@dataclasses.dataclass
class SelectStmt:
    items: list[SelectItem]
    frm: list[TableRef]             # comma-joined refs
    joins: list[JoinClause]
    where: Optional[Any]
    group_by: list
    having: Optional[Any]
    order_by: list[OrderItem]
    limit: Optional[int]
    offset: Optional[int]
    distinct: bool = False
    ctes: list = dataclasses.field(default_factory=list)   # WITH entries
    # GROUP BY ROLLUP/CUBE/GROUPING SETS: the expanded list of grouping
    # sets (group_by is [] when set); None for a plain GROUP BY
    grouping_sets: Optional[list] = None


@dataclasses.dataclass
class SetOpStmt:
    """UNION/EXCEPT/INTERSECT [ALL] chain; ORDER BY / LIMIT bind to the
    whole set op.  INTERSECT binds tighter than UNION/EXCEPT (PG
    precedence)."""
    op: str                         # 'union' | 'except' | 'intersect'
    all: bool
    left: Any                       # SelectStmt | SetOpStmt
    right: Any                      # SelectStmt
    order_by: list = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: list = dataclasses.field(default_factory=list)   # WITH entries


@dataclasses.dataclass
class ExplainStmt:
    query: SelectStmt
    verbose: bool = False
    costs: bool = True
    analyze: bool = False


@dataclasses.dataclass
class CreateStmt:
    name: str
    columns: list            # [(colname, typename)]
    if_not_exists: bool = False


@dataclasses.dataclass
class DropStmt:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class InsertStmt:
    name: str
    columns: Optional[list]          # explicit column list or None
    values: Optional[list]           # rows of expression ASTs
    query: Optional[Any] = None      # INSERT INTO ... SELECT


@dataclasses.dataclass
class UpdateStmt:
    name: str
    sets: list                      # [(column, expr)]
    where: Optional[Any] = None


@dataclasses.dataclass
class DeleteStmt:
    name: str
    where: Optional[Any] = None


@dataclasses.dataclass
class CopyStmt:
    name: str
    filename: str
    header: bool = False
    delimiter: str = ","


@dataclasses.dataclass
class SetStmt:
    name: str
    value: str


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- primitives ----------------------------------------------------------

    def peek(self, k: int = 0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            self.next()
            return t.value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ParseError(f'expected {kw.upper()} near {self.peek().value!r}')

    def accept_op(self, *ops: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            self.next()
            return t.value
        return None

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise ParseError(f'expected "{op}" near {self.peek().value!r}')

    # -- entry ---------------------------------------------------------------

    def parse_statement(self):
        if self.accept_kw("explain"):
            verbose = costs = False
            analyze = False
            costs = True
            if self.accept_op("("):
                while True:
                    opt = self.next().value
                    if opt == "verbose":
                        verbose = True
                    elif opt == "costs":
                        nv = self.peek()
                        if nv.kind in ("kw", "ident") and nv.value in ("off", "on", "false", "true"):
                            costs = self.next().value in ("on", "true")
                    elif opt == "analyze":
                        analyze = True
                    elif opt in ("timing",):
                        if self.peek().value in ("off", "on", "false", "true"):
                            self.next()
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            else:
                # bare option words, PostgreSQL pre-9.0 style:
                # EXPLAIN [ANALYZE] [VERBOSE] query
                while True:
                    if self.accept_kw("verbose"):
                        verbose = True
                    elif self._accept_word("analyze") \
                            or self._accept_word("analyse"):
                        analyze = True
                    else:
                        break
            return ExplainStmt(self.parse_select(), verbose=verbose,
                               costs=costs, analyze=analyze)
        if self.accept_kw("create"):
            self.expect_kw("table")
            ine = False
            if self._accept_word("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = ".".join(self._qualified_name())
            self.expect_op("(")
            cols = []
            while True:
                cname = self.next().value
                cols.append((cname, self._typename()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return CreateStmt(name, cols, if_not_exists=ine)
        if self.accept_kw("drop"):
            self.expect_kw("table")
            ife = False
            if self._accept_word("if"):
                self.expect_kw("exists")
                ife = True
            return DropStmt(".".join(self._qualified_name()), if_exists=ife)
        if self.accept_kw("update"):
            name = ".".join(self._qualified_name())
            self.expect_kw("set")

            def set_item():
                cname = self.next().value
                self.expect_op("=")
                return (cname, self.parse_expr())
            sets = [set_item()]
            while self.accept_op(","):
                sets.append(set_item())
            where = self.parse_expr() if self.accept_kw("where") else None
            return UpdateStmt(name, sets, where)
        if self.accept_kw("delete"):
            self.expect_kw("from")
            name = ".".join(self._qualified_name())
            where = self.parse_expr() if self.accept_kw("where") else None
            return DeleteStmt(name, where)
        if self.accept_kw("insert"):
            self.expect_kw("into")
            name = ".".join(self._qualified_name())
            cols = None
            if self.accept_op("("):
                cols = [self.next().value]
                while self.accept_op(","):
                    cols.append(self.next().value)
                self.expect_op(")")
            if self.accept_kw("values"):
                rows = []
                while True:
                    self.expect_op("(")
                    row = [self.parse_expr()]
                    while self.accept_op(","):
                        row.append(self.parse_expr())
                    self.expect_op(")")
                    rows.append(row)
                    if not self.accept_op(","):
                        break
                return InsertStmt(name, cols, rows)
            return InsertStmt(name, cols, None, query=self.parse_select())
        if self.accept_kw("copy"):
            name = ".".join(self._qualified_name())
            self.expect_kw("from")
            fname = self.next().value
            if fname.startswith("'"):
                fname = fname[1:-1].replace("''", "'")
            header = False
            delim = ","
            if self._accept_word("with") or self.peek().value == "(":
                if self.accept_op("("):
                    while True:
                        opt = self.next().value
                        if opt == "format":
                            self.next()            # csv
                        elif opt == "header":
                            if self.peek().value in ("true", "false", "on", "off"):
                                header = self.next().value in ("true", "on")
                            else:
                                header = True
                        elif opt == "delimiter":
                            delim = self.next().value.strip("'")
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
            return CopyStmt(name, fname, header=header, delimiter=delim)
        if self.accept_kw("set"):
            name = self._qualified_name()
            if not self.accept_kw("to"):
                self.expect_op("=")
            val_parts = []
            while self.peek().kind != "eof" and self.peek().value != ";":
                val_parts.append(self.next().value)
            return SetStmt(".".join(name), " ".join(val_parts))
        return self.parse_select()

    def _qualified_name(self) -> list[str]:
        parts = [self.next().value]
        while self.accept_op("."):
            parts.append(self.next().value)
        return parts

    def _accept_word(self, w: str) -> bool:
        t = self.peek()
        if t.kind in ("kw", "ident") and t.value == w:
            self.next()
            return True
        return False

    def _typename(self) -> str:
        """Type name with optional length/precision mods (discarded)."""
        base = self.next().value
        if base == "double" and self._accept_word("precision"):
            base = "double precision"
        elif base == "character" and self._accept_word("varying"):
            base = "character varying"
        if self.accept_op("("):
            self.next()
            if self.accept_op(","):
                self.next()
            self.expect_op(")")
        return base

    # -- select --------------------------------------------------------------

    def parse_select(self):
        """Full query expression:
        [WITH ctes] intersect-chain ((UNION|EXCEPT) [ALL] intersect-chain)*
        with ORDER BY / LIMIT / OFFSET binding to the whole chain.
        INTERSECT binds tighter than UNION/EXCEPT, both left-associative
        (PostgreSQL gram.y precedence).  WITH entries attach to the whole
        query expression; the planner desugars references into
        FROM-subqueries (plan/planner._expand_ctes)."""
        ctes: list[CteDef] = []
        if self.accept_kw("with"):
            recursive = bool(self.accept_kw("recursive"))
            ctes.append(self._cte_def(recursive))
            while self.accept_op(","):
                ctes.append(self._cte_def(recursive))
        node = self._intersect_chain()
        while True:
            op = self.accept_kw("union", "except")
            if not op:
                break
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")       # UNION DISTINCT == UNION
            rhs = self._intersect_chain()
            node = SetOpStmt(op, all_, node, rhs)
        order_by: list[OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self._order_item())
            while self.accept_op(","):
                order_by.append(self._order_item())
        limit = offset = None
        if self.accept_kw("limit"):
            limit = int(self.next().value)
        if self.accept_kw("offset"):
            offset = int(self.next().value)
        node.order_by = order_by
        node.limit = limit
        node.offset = offset
        node.ctes = ctes
        return node

    def _maybe_over(self, fn: AFunc):
        """fn OVER (window-spec) -> AWindow; plain fn otherwise."""
        if not self.accept_kw("over"):
            return fn
        self.expect_op("(")
        partition: list = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        order: list = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self._order_item())
            while self.accept_op(","):
                order.append(self._order_item())
        t = self.peek()
        if t.kind == "ident" and t.value in ("rows", "range", "groups"):
            raise ParseError("window frame clauses are not supported "
                             "(default frame only)")
        self.expect_op(")")
        return AWindow(fn, partition, order)

    def _cte_def(self, recursive: bool = False) -> CteDef:
        t = self.peek()
        if t.kind not in ("ident", "kw"):
            raise ParseError(f"expected CTE name near {t.value!r}")
        name = self.next().value
        columns = None
        if self.accept_op("("):
            columns = [self.next().value]
            while self.accept_op(","):
                columns.append(self.next().value)
            self.expect_op(")")
        self.expect_kw("as")
        self.expect_op("(")
        q = self.parse_select()
        self.expect_op(")")
        return CteDef(name, columns, q, recursive)

    def _intersect_chain(self):
        node = self._select_core()
        while self.accept_kw("intersect"):
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")       # INTERSECT DISTINCT == INTERSECT
            rhs = self._select_core()
            node = SetOpStmt("intersect", all_, node, rhs)
        return node

    def _select_core(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())

        frm: list[TableRef] = []
        joins: list[JoinClause] = []
        if self.accept_kw("from"):
            frm.append(self._table_ref())
            while True:
                if self.accept_op(","):
                    frm.append(self._table_ref())
                    continue
                jt = None
                if self.accept_kw("join"):
                    jt = "inner"
                elif self.accept_kw("inner"):
                    self.expect_kw("join")
                    jt = "inner"
                elif self.accept_kw("cross"):
                    self.expect_kw("join")
                    jt = "cross"
                else:
                    ojt = self.accept_kw("left", "right", "full")
                    if ojt:
                        self.accept_kw("outer")
                        self.expect_kw("join")
                        jt = ojt
                if jt is None:
                    break
                tr = self._table_ref()
                on = None
                if jt != "cross":
                    self.expect_kw("on")
                    on = self.parse_expr()
                joins.append(JoinClause(jt, tr, on))

        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: list = []
        grouping_sets = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            elems = [self._group_elem()]
            while self.accept_op(","):
                elems.append(self._group_elem())
            if all(len(sets) == 1 for sets in elems):
                group_by = [e for sets in elems for e in sets[0]]
            else:
                # PG gram: mixed elements cross-product their set lists
                # (GROUP BY a, ROLLUP(b, c) = sets (a,b,c), (a,b), (a))
                prod: list[list] = [[]]
                for sets in elems:
                    prod = [p + s for p in prod for s in sets]
                grouping_sets = prod
        having = self.parse_expr() if self.accept_kw("having") else None
        return SelectStmt(items, frm, joins, where, group_by, having,
                          [], None, None, distinct=distinct,
                          grouping_sets=grouping_sets)

    def _group_elem(self) -> list[list]:
        """One GROUP BY element -> its list of grouping sets.

        expr -> [[expr]]; ROLLUP(e1..ek) -> prefixes down to ();
        CUBE(e1..ek) -> all subsets; GROUPING SETS ((..), ..) -> as
        written (an unparenthesized element is a one-expr set)."""
        t = self.peek()
        if t.kind == "ident" and t.value in ("rollup", "cube"):
            kind = self.next().value
            self.expect_op("(")
            es = [self.parse_expr()]
            while self.accept_op(","):
                es.append(self.parse_expr())
            self.expect_op(")")
            if kind == "rollup":
                return [es[:k] for k in range(len(es), -1, -1)]
            return [[e for j, e in enumerate(es) if mask & (1 << j)]
                    for mask in range((1 << len(es)) - 1, -1, -1)]
        if t.kind == "ident" and t.value == "grouping":
            nxt = self.peek(1)
            if nxt.kind == "ident" and nxt.value == "sets":
                self.next()
                self.next()
                self.expect_op("(")
                sets: list[list] = [self._grouping_set()]
                while self.accept_op(","):
                    sets.append(self._grouping_set())
                self.expect_op(")")
                return sets
        return [[self.parse_expr()]]

    def _grouping_set(self) -> list:
        if self.accept_op("("):
            es: list = []
            if not self.accept_op(")"):
                es.append(self.parse_expr())
                while self.accept_op(","):
                    es.append(self.parse_expr())
                self.expect_op(")")
            return es
        return [self.parse_expr()]

    def _select_item(self) -> SelectItem:
        t = self.peek()
        if t.kind == "op" and t.value == "*":
            self.next()
            return SelectItem(AStar(), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return SelectItem(e, alias)

    def _table_ref(self) -> TableRef:
        if self.accept_op("("):
            sub = self.parse_select()
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.next().value
            elif self.peek().kind == "ident":
                alias = self.next().value
            col_aliases = None
            if alias is not None and self.accept_op("("):
                col_aliases = [self.next().value]
                while self.accept_op(","):
                    col_aliases.append(self.next().value)
                self.expect_op(")")
            return TableRef(None, sub, alias, col_aliases)
        name = ".".join(self._qualified_name())
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return TableRef(name, None, alias)

    def _order_item(self) -> OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("asc"):
            pass
        elif self.accept_kw("desc"):
            desc = True
        nf = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nf = True
            else:
                self.expect_kw("last")
                nf = False
        return OrderItem(e, desc, nf)

    # -- expressions (precedence climbing) ------------------------------------

    def parse_expr(self):
        return self._or_expr()

    def _or_expr(self):
        left = self._and_expr()
        args = [left]
        while self.accept_kw("or"):
            args.append(self._and_expr())
        return args[0] if len(args) == 1 else ABool("or", args)

    def _and_expr(self):
        left = self._not_expr()
        args = [left]
        while self.accept_kw("and"):
            args.append(self._not_expr())
        return args[0] if len(args) == 1 else ABool("and", args)

    def _not_expr(self):
        if self.accept_kw("not"):
            return ABool("not", [self._not_expr()])
        return self._is_expr()

    def _is_expr(self):
        e = self._cmp_expr()
        while True:
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                if self.accept_kw("null"):
                    e = ANullTest(e, isnull=not neg)
                elif self.accept_kw("true"):
                    e = AOp("is_true" if not neg else "is_not_true", [e])
                elif self.accept_kw("false"):
                    e = AOp("is_false" if not neg else "is_not_false", [e])
                elif self._accept_word("distinct"):
                    if not self._accept_word("from"):
                        raise ParseError("expected FROM after IS DISTINCT")
                    e = ADistinctFrom(e, self._cmp_expr(), negated=not neg)
                else:
                    raise ParseError(
                        "expected NULL/TRUE/FALSE/DISTINCT FROM after IS")
            elif self.accept_kw("isnull"):
                e = ANullTest(e, isnull=True)
            elif self.accept_kw("notnull"):
                e = ANullTest(e, isnull=False)
            else:
                return e

    def _cmp_expr(self):
        e = self._btw_expr()
        op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
        if op:
            if op == "!=":
                op = "<>"
            return AOp(op, [e, self._btw_expr()])
        return e

    def _btw_expr(self):
        e = self._add_expr()
        neg = False
        save = self.i
        if self.accept_kw("not"):
            neg = True
        if self.accept_kw("between"):
            lo = self._add_expr()
            self.expect_kw("and")
            hi = self._add_expr()
            return ABetween(e, lo, hi, neg)
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.peek().kind == "kw" and self.peek().value == "select":
                q = self.parse_select()
                self.expect_op(")")
                return AIn(e, ASubquery(q), neg)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return AIn(e, items, neg)
        if self.accept_kw("like"):
            pat = self._add_expr()
            node = AOp("like", [e, pat])
            return ABool("not", [node]) if neg else node
        if neg:
            self.i = save
        return e

    def _add_expr(self):
        e = self._mul_expr()
        while True:
            op = self.accept_op("+", "-", "||", "&", "|", "#", "<<", ">>")
            if not op:
                return e
            e = AOp(op, [e, self._mul_expr()])

    def _mul_expr(self):
        e = self._unary_expr()
        while True:
            op = self.accept_op("*", "/", "%", "^")
            if not op:
                return e
            e = AOp("pow" if op == "^" else op, [e, self._unary_expr()])

    def _unary_expr(self):
        if self.accept_op("-"):
            return AOp("neg", [self._unary_expr()])
        if self.accept_op("+"):
            return self._unary_expr()
        if self.accept_op("~"):
            return AOp("~", [self._unary_expr()])
        return self._cast_expr()

    def _cast_expr(self):
        e = self._primary()
        while self.peek().kind == "cast":
            self.next()
            e = ACast(e, self._typename())
        return e

    def _typename(self) -> str:
        parts = [self.next().value]
        # double precision / character varying
        while self.peek().kind in ("ident", "kw") and \
                (parts + [self.peek().value])[0] in ("double", "character", "time", "timestamp"):
            nxt = self.peek().value
            if (parts[0] == "double" and nxt == "precision") or \
               (parts[0] == "character" and nxt == "varying"):
                parts.append(self.next().value)
            else:
                break
        # numeric(p,s) / varchar(n): swallow parens
        if self.accept_op("("):
            depth = 1
            while depth:
                t = self.next()
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    depth -= 1
        return " ".join(parts)

    def _primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            if re.fullmatch(r"\d+", t.value):
                v = int(t.value)
                return ALiteral(v)
            return ALiteral(Decimal(t.value))
        if t.kind == "str":
            self.next()
            return ALiteral(t.value[1:-1].replace("''", "'"), is_string=True)
        if t.kind == "kw":
            if self.accept_kw("null"):
                return ALiteral(None)
            if self.accept_kw("true"):
                return ALiteral(True)
            if self.accept_kw("false"):
                return ALiteral(False)
            if self.accept_kw("case"):
                whens = []
                while self.accept_kw("when"):
                    c = self.parse_expr()
                    self.expect_kw("then")
                    r = self.parse_expr()
                    whens.append((c, r))
                orelse = self.parse_expr() if self.accept_kw("else") else None
                self.expect_kw("end")
                return ACase(whens, orelse)
            if self.accept_kw("cast"):
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                tn = self._typename()
                self.expect_op(")")
                return ACast(e, tn)
            if self.accept_kw("exists"):
                self.expect_op("(")
                q = self.parse_select()
                self.expect_op(")")
                return AExists(q)
            if self.accept_kw("coalesce"):
                self.expect_op("(")
                args = [self.parse_expr()]
                while self.accept_op(","):
                    args.append(self.parse_expr())
                self.expect_op(")")
                return AFunc("coalesce", args)
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "kw" and self.peek().value == "select":
                q = self.parse_select()
                self.expect_op(")")
                return ASubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "ident":
            name = self._qualified_name()
            if self.accept_op("("):
                distinct = bool(self.accept_kw("distinct"))
                if self.accept_op("*"):
                    self.expect_op(")")
                    return self._maybe_over(AFunc(name[-1], [], star=True))
                args = []
                if not self.accept_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                    self.expect_op(")")
                return self._maybe_over(
                    AFunc(name[-1], args, distinct=distinct))
            if self.peek().kind == "op" and self.peek().value == "." and False:
                pass
            # t.* handled at select-item level via AStar? keep simple:
            return AName(tuple(name))
        if t.kind == "kw" and t.value in ("left", "right") \
                and self.peek(1).kind == "op" and self.peek(1).value == "(":
            # LEFT(s, n) / RIGHT(s, n): join keywords PG still allows as
            # function names (col_name_keyword class)
            name = self.next().value
            self.next()
            args = [self.parse_expr()]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return self._maybe_over(AFunc(name, args))
        raise ParseError(f"syntax error at or near {t.value!r}")


def parse(sql: str):
    with span("parse"):
        sql = sql.strip().rstrip(";")
        p = Parser(sql)
        stmt = p.parse_statement()
        if p.peek().kind != "eof" and p.peek().value != ";":
            raise ParseError(f"syntax error at or near {p.peek().value!r}")
        return stmt
