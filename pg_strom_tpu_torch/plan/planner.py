"""Query planner: bound AST -> physical plan -> execution.

Mirrors the reference's planning decisions in standalone form:
  qual split           dev_quals vs host_quals per relation
                       (gpuscan.c:196-205 via codegen availability)
  join planning        left-deep chains, equi-clauses pulled from WHERE for
                       comma joins (gpuhashjoin.c clause split, 736-751)
  aggregate rewrite    Aggrefs -> partial slots + host finalization
                       (gpupreagg.c:1033+ catalog rewrite)
  cost model           tpu_setup/operator/tuple cost vs cpu costs
                       (main.c:167-198), debug_force flags override
  EXPLAIN              plan-shape text (explain_agg corpus analog)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence

from ..config import config
from ..sqltypes import T
from ..datastore import Table, Database, Column
from ..errors import SqlError
from ..expr.ir import (
    Expr, Const, ColumnRef, FuncExpr, BoolExpr, NullTest, BooleanTest,
    CaseExpr, CoalesceExpr, Aggref, Param, SubPlan, bind_columns,
    referenced_columns, walk,
)
from ..expr.catalog import device_expression_supported
from ..expr.eval_cpu import eval_expr_cpu
from ..ops.preagg import AggInstance, lookup_agg
from ..utils.perfmon import Perfmon, active as perfmon_active, span
from ..pgops import cmp_values
from ..exec.join_exec import HashJoinExecutor
from ..exec.scan_exec import ScanExecutor
from ..sql import parser as ast
from .binder import Scope, bind_expr, BindError
from .cost import (
    Cost, cost_seqscan, cost_tpuscan, cost_hashjoin, cost_tpuhashjoin,
    cost_hostagg, cost_tpupreagg, estimate_num_groups, rel_width,
    eq_join_selectivity,
)


def rename_table(tbl: Table, alias: str) -> Table:
    """View of tbl with columns named '<alias>.<col>' (shares Column data)."""
    return Table(name=alias, columns={f"{alias}.{c}": col
                                      for c, col in tbl.columns.items()})


# ---------------------------------------------------------------------------
# expression utilities
# ---------------------------------------------------------------------------

def conjuncts(e: Optional[Expr]) -> list[Expr]:
    if e is None:
        return []
    if isinstance(e, BoolExpr) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def and_all(es: Sequence[Expr]) -> Optional[Expr]:
    es = list(es)
    if not es:
        return None
    if len(es) == 1:
        return es[0]
    return BoolExpr(type=T.BOOL, op="and", args=tuple(es))


def rels_of(e: Expr) -> set[str]:
    return {c.split(".", 1)[0] for c in referenced_columns(e)}


def contains_agg(e: Expr) -> bool:
    return any(isinstance(n, Aggref) for n in walk(e))


def replace_subtrees(e: Expr, mapping: dict[Expr, int]) -> Expr:
    """Replace mapped subtrees with Param(idx) (for final projection eval)."""
    if e in mapping:
        return Param(type=e.type, index=mapping[e])
    if isinstance(e, SubPlan):
        # a correlated subquery's outer args may reference grouped
        # columns/aggregates of THIS query level; they evaluate against
        # the projected row, so Param substitution is exactly right
        # (the ungrouped-column check would false-positive here, because
        # walk() descends into SubPlans)
        return dataclasses.replace(e, outer_args=tuple(
            replace_subtrees(a, mapping) for a in e.outer_args))
    if isinstance(e, (FuncExpr, BoolExpr, CoalesceExpr)):
        return dataclasses.replace(
            e, args=tuple(replace_subtrees(a, mapping) for a in e.args))
    if isinstance(e, (NullTest, BooleanTest)):
        return dataclasses.replace(e, arg=replace_subtrees(e.arg, mapping))
    if isinstance(e, CaseExpr):
        return dataclasses.replace(
            e,
            whens=tuple((replace_subtrees(c, mapping), replace_subtrees(r, mapping))
                        for c, r in e.whens),
            orelse=None if e.orelse is None else replace_subtrees(e.orelse, mapping))
    return e


# ---------------------------------------------------------------------------
# physical plan nodes (for EXPLAIN and execution)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanNode:
    kind: str                   # TpuScan | SeqScan | TpuHashJoin | TpuPreAgg |
                                # HostAgg | Sort | Limit | Result | Subquery
    detail: dict
    children: list["PlanNode"]
    cost: Optional[Cost] = None

    def render(self, indent: int = 0, verbose: bool = False,
               costs: bool = False) -> list[str]:
        pad = " " * indent
        arrow = "" if indent == 0 else "->  "
        head = f"{pad}{arrow}{self.kind}" + self._head()
        if costs and self.cost is not None:
            head += f"  {self.cost.render()}"
        lines = [head]
        for k, v in self.detail.items():
            if k.startswith("_"):
                continue
            if not verbose and k in ("output",):
                continue
            lines.append(f"{pad}      {k}: {v}")
        for c in self.children:
            lines.extend(c.render(indent + 2, verbose, costs))
        return lines

    def _head(self) -> str:
        rel = self.detail.get("_rel")
        return f" on {rel}" if rel else ""


# ---------------------------------------------------------------------------
# planned query
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlannedQuery:
    out_names: list[str]
    out_types: list[T]
    _run: Any               # () -> list[tuple]
    root: PlanNode
    perfmon: Perfmon

    def execute(self) -> list[tuple]:
        with perfmon_active(self.perfmon), self.perfmon.timer("execute"):
            return self._run()

    def explain(self, verbose: bool = False, costs: bool = False) -> str:
        return "\n".join(self.root.render(0, verbose, costs))


def fmt_expr(e: Expr) -> str:
    if isinstance(e, Const):
        return "NULL" if e.value is None else repr(e.value)
    if isinstance(e, ColumnRef):
        return e.name
    if isinstance(e, FuncExpr):
        name = e.fname.split("::", 1)[0]
        if name == "cast":
            return f"({fmt_expr(e.args[0])})::{e.fname.split('::')[1]}"
        if name == "neg":
            return f"(- {fmt_expr(e.args[0])})"
        if not name[0].isalpha():
            return f"({fmt_expr(e.args[0])} {name} {fmt_expr(e.args[1])})"
        return f"{name}({', '.join(fmt_expr(a) for a in e.args)})"
    if isinstance(e, BoolExpr):
        if e.op == "not":
            return f"(NOT {fmt_expr(e.args[0])})"
        return "(" + f" {e.op.upper()} ".join(fmt_expr(a) for a in e.args) + ")"
    if isinstance(e, NullTest):
        return f"({fmt_expr(e.arg)} IS {'NULL' if e.isnull else 'NOT NULL'})"
    if isinstance(e, Aggref):
        inner = "*" if e.star else ", ".join(fmt_expr(a) for a in e.args)
        return f"{e.aggname}({inner})"
    if isinstance(e, CaseExpr):
        return "CASE ... END"
    if isinstance(e, Param):
        return f"$({e.index})"
    if isinstance(e, CoalesceExpr):
        return f"COALESCE({', '.join(fmt_expr(a) for a in e.args)})"
    if isinstance(e, BooleanTest):
        return f"({fmt_expr(e.arg)} {e.test.replace('_', ' ').upper()})"
    return repr(e)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_select(stmt: ast.SelectStmt, db: Database) -> PlannedQuery:
    from .window import stmt_has_windows, plan_windowed
    if stmt.grouping_sets is not None:
        return plan_grouping_sets(stmt, db)
    if stmt_has_windows(stmt):
        return plan_windowed(stmt, db)
    perfmon = Perfmon()

    # ---- FROM: resolve relations (subqueries planned recursively) ---------
    rels: list[tuple[str, Any]] = []   # (alias, Table | thunk for subquery)
    sub_plans: dict[str, PlannedQuery] = {}

    def add_ref(tr: ast.TableRef):
        if tr.subquery is not None:
            alias = tr.alias or f"subquery{len(rels)}"
            sub = plan_query(tr.subquery, db)
            if tr.col_aliases:
                # t(a, b): rename the first k output columns (PG errors
                # when the alias list is wider than the subquery output)
                if len(tr.col_aliases) > len(sub.out_names):
                    raise SqlError(
                        f'table "{alias}" has {len(sub.out_names)} columns '
                        f'available but {len(tr.col_aliases)} columns '
                        'specified')
                sub.out_names = list(tr.col_aliases) + \
                    sub.out_names[len(tr.col_aliases):]
            sub_plans[alias] = sub
            rels.append((alias, sub))
        else:
            alias = tr.alias or tr.name
            rels.append((alias, db.get(tr.name)))

    for tr in stmt.frm:
        add_ref(tr)
    join_ons: list[Optional[Expr]] = []
    for jc in stmt.joins:
        add_ref(jc.table)

    if not rels:
        return _plan_table_less(stmt, db, perfmon)

    def materialize_rel(alias, obj) -> Table:
        if isinstance(obj, PlannedQuery):
            rows = obj.execute()
            cols = {}
            for i, (nm, t) in enumerate(zip(obj.out_names, obj.out_types)):
                from ..datastore import column_from_values_fast
                cols[nm] = column_from_values_fast(t, [r[i] for r in rows])
            return Table.from_columns(alias, cols)
        return obj

    # scope for binding uses (possibly un-executed) column layouts; for
    # subqueries we need names/types only — build a shell table
    def shell(alias, obj) -> Table:
        if isinstance(obj, PlannedQuery):
            from ..datastore import column_from_values
            return Table.from_columns(alias, {
                nm: column_from_values(t, [])
                for nm, t in zip(obj.out_names, obj.out_types)})
        return obj

    with span("plan.bind"):
        scope = Scope(rels=[(a, shell(a, o)) for a, o in rels], db=db)

        # ---- bind WHERE / JOIN ON / targets -------------------------------
        where = (bind_expr(stmt.where, scope, allow_aggs=False)
                 if stmt.where else None)
        if where is not None and where.type is not T.BOOL:
            raise BindError("argument of WHERE must be type boolean")
        bound_ons: list[list[Expr]] = []
        for jc in stmt.joins:
            bound_ons.append(
                conjuncts(bind_expr(jc.on, scope, allow_aggs=False))
                if jc.on is not None else [])
        has_outer = any(jc.jointype in ("left", "right", "full")
                        for jc in stmt.joins)
        # Outer joins: ON conditions gate MATCHING (a failed ON still emits
        # the NULL-extended row), so they must stay attached to their join —
        # and no WHERE qual may be pushed below a join whose output can
        # NULL-extend it.  The pooled-conjunct fast path below is
        # inner-join-only.
        on_conjs: list[Expr] = ([] if has_outer
                                else [c for cs in bound_ons for c in cs])

        group_exprs = [bind_expr(g, scope, allow_aggs=False)
                       for g in stmt.group_by]
        items: list[tuple[str, Expr]] = []
        for it in stmt.items:
            if isinstance(it.expr, ast.AStar):
                for nm, t in scope.all_columns(getattr(it.expr, "rel",
                                                       None)):
                    items.append((nm.split(".", 1)[1],
                                  ColumnRef(type=t, name=nm)))
                continue
            e = bind_expr(it.expr, scope, allow_aggs=True)
            name = it.alias or _default_name(it.expr, e)
            items.append((name, e))
        having = (bind_expr(stmt.having, scope, allow_aggs=True)
                  if stmt.having else None)

        has_aggs = (any(contains_agg(e) for _, e in items)
                    or bool(group_exprs)
                    or (having is not None and contains_agg(having)))

        # group by ordinal / alias
        resolved_groups: list[Expr] = []
        for g, ga in zip(group_exprs, stmt.group_by):
            if isinstance(ga, ast.ALiteral) and isinstance(ga.value, int) \
                    and not ga.is_string:
                resolved_groups.append(items[ga.value - 1][1])
            else:
                resolved_groups.append(g)
        group_exprs = resolved_groups

        # order by: may reference aliases or ordinals
        order_specs: list[tuple[Expr, bool, Optional[bool]]] = []
        alias_map = {nm: e for nm, e in items}
        for oi in stmt.order_by:
            if isinstance(oi.expr, ast.ALiteral) \
                    and isinstance(oi.expr.value, int) \
                    and not oi.expr.is_string:
                oe = items[oi.expr.value - 1][1]
            elif isinstance(oi.expr, ast.AName) and len(oi.expr.parts) == 1 \
                    and oi.expr.parts[0] in alias_map:
                oe = alias_map[oi.expr.parts[0]]
            else:
                oe = bind_expr(oi.expr, scope, allow_aggs=has_aggs)
            order_specs.append((oe, oi.descending, oi.nulls_first))

        # ---- qual classification ------------------------------------------
        all_conjs = conjuncts(where) + on_conjs
        per_rel: dict[str, list[Expr]] = {a: [] for a, _ in rels}
        join_equis: list[Expr] = []
        post_join: list[Expr] = []
        if has_outer:
            # correctness first: WHERE applies to the (NULL-extended) join
            # result, so nothing is pushed below the chain
            post_join = list(all_conjs)
        else:
            for cj in all_conjs:
                rs = rels_of(cj)
                if len(rs) <= 1:
                    if rs:
                        per_rel[next(iter(rs))].append(cj)
                    else:
                        post_join.append(cj)  # pseudo-constant qual
                elif (len(rs) == 2 and isinstance(cj, FuncExpr)
                      and cj.fname.startswith("=::")
                      and isinstance(cj.args[0], ColumnRef)
                      and isinstance(cj.args[1], ColumnRef)):
                    join_equis.append(cj)
                else:
                    post_join.append(cj)

    # ---- cost-based offload decisions -------------------------------------
    shells = {a: shell(a, o) for a, o in rels}
    n_aggs = len(_collect_aggrefs(items, having))
    out_width = rel_width([e.type for _, e in items])
    with span("plan.cost"):
        dec, node_costs = _plan_costs(
            rels, shells, sub_plans, per_rel, join_equis, has_outer,
            bound_ons, stmt.joins, has_aggs, group_exprs, n_aggs, out_width,
            post_join)

    # ---- execution closure -------------------------------------------------
    def run() -> list[tuple]:
        with span("prepare"):
            tables = {a: rename_table(materialize_rel(a, o), a)
                      for a, o in rels}
        # bulk-load pipeline: single equi-join feeding aggregation fuses into
        # one device pass per probe chunk (joined rows never materialize on
        # the host — the pgstrom_bulkslot chain analog, pg_strom.h:317-329)
        rows = None
        if has_aggs and len(rels) == 2 and join_equis and not post_join \
                and dec["agg"] and all(dec["join"].values()):
            if config.distributed:
                # distributed shuffle join+agg over the device mesh
                # (exec/dist_exec.py); ineligible shapes / device-err
                # (CpuReCheck) / exhausted repartition ladders fall back to
                # the single-device fused path below
                rows = _try_dist_join_agg(tables, rels, per_rel, join_equis,
                                          group_exprs, items, having,
                                          order_specs, perfmon)
            if rows is None:
                rows = _try_fused_join_agg(tables, rels, per_rel, join_equis,
                                           group_exprs, items, having,
                                           order_specs, perfmon)
        elif has_aggs and len(rels) >= 3 and join_equis and not post_join \
                and not has_outer and dec["agg"] and all(dec["join"].values()):
            # N-way fused star join+agg: one device node for the whole
            # fact x dims chain (no intermediate host Tables); ineligible
            # shapes fall through to the pairwise join loop below
            rows = _try_star_join_agg(tables, rels, per_rel, join_equis,
                                      group_exprs, items, having,
                                      order_specs, perfmon)
        if rows is not None:
            if stmt.distinct:
                rows = _dedupe_rows(rows)
            if stmt.offset:
                rows = rows[stmt.offset:]
            if stmt.limit is not None:
                rows = rows[:stmt.limit]
            return rows
        if has_outer:
            if len(stmt.frm) != 1:
                raise SqlError("outer joins cannot mix with comma joins")
            cur = _run_outer_chain(tables, rels, stmt.joins, bound_ons,
                                   perfmon, dec_join=dec["join"])
            cur_pred = None
            pending_equis = []
            current_alias_set = {a for a, _ in rels}
        else:
            current_alias_set = {rels[0][0]}
            cur = tables[rels[0][0]]
            cur_pred = and_all(per_rel[rels[0][0]])
            pending_equis = list(join_equis)
        # left-deep join chain in FROM order
        for alias, _ in (() if has_outer else rels[1:]):
            keys_l, keys_r = [], []
            rest = []
            for cj in pending_equis:
                a0 = cj.args[0].name.split(".", 1)[0]
                a1 = cj.args[1].name.split(".", 1)[0]
                if a0 in current_alias_set and a1 == alias:
                    keys_l.append(cj.args[0])
                    keys_r.append(cj.args[1])
                elif a1 in current_alias_set and a0 == alias:
                    keys_l.append(cj.args[1])
                    keys_r.append(cj.args[0])
                else:
                    rest.append(cj)
            pending_equis = rest
            if not keys_l:
                raise SqlError(f"cross join with {alias} is not supported")
            right = tables[alias]
            lp = {n: i for i, n in enumerate(cur.column_names)}
            rp = {n: i for i, n in enumerate(right.column_names)}
            jx = HashJoinExecutor(
                cur, right,
                [bind_columns(k, lp) for k in keys_l],
                [bind_columns(k, rp) for k in keys_r],
                out_probe_cols=cur.column_names,
                out_build_cols=right.column_names,
                probe_pred=bind_columns(cur_pred, lp) if cur_pred is not None else None,
                build_pred=(bind_columns(and_all(per_rel[alias]), rp)
                            if per_rel[alias] else None),
                probe_alias=None, build_alias=None,  # names pre-qualified
                perfmon=perfmon, offload=dec["join"].get(alias, True))
            cur = jx.run()
            cur_pred = None
            current_alias_set.add(alias)
        # leftover post-join quals force a materializing scan; a plain
        # single-relation predicate stays in cur_pred and FUSES into the
        # downstream aggregate kernel (no row-id materialization, no host
        # subset, no re-upload)
        leftover = and_all(post_join + pending_equis)
        if leftover is not None:
            pred = and_all([p for p in (cur_pred, leftover) if p is not None])
            lp = {n: i for i, n in enumerate(cur.column_names)}
            idxs = ScanExecutor(cur, bind_columns(pred, lp), perfmon,
                                offload=dec["post_scan"]).row_indexes()
            cur = _subset_table(cur, idxs)
            cur_pred = None

        if has_aggs:
            rows = _run_agg(cur, cur_pred, group_exprs, items, having,
                            order_specs, perfmon, offload=dec["agg"])
        else:
            limit_k = None
            if stmt.limit is not None and not stmt.distinct:
                # top-k pushdown is unsound under DISTINCT (k rows may
                # collapse below k after dedup)
                limit_k = stmt.limit + (stmt.offset or 0)
            rows = _run_plain(cur, cur_pred, items, order_specs, perfmon,
                              limit_k,
                              offload=dec["scan"].get(rels[0][0], True)
                              if len(rels) == 1 else dec["post_scan"])
        if stmt.distinct:
            rows = _dedupe_rows(rows)   # stable: ORDER BY order preserved
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return rows

    # ---- EXPLAIN tree ------------------------------------------------------
    with span("plan.tree"):
        root = _build_plan_tree(rels, per_rel, join_equis, post_join,
                                has_aggs, group_exprs, items, order_specs,
                                stmt, sub_plans, dec, node_costs)

    out_names = [nm for nm, _ in items]
    out_types = [e.type for _, e in items]
    return PlannedQuery(out_names, out_types, run, root, perfmon)


def _plan_costs(rels, shells, sub_plans, per_rel, join_equis, has_outer,
                bound_ons, joins, has_aggs, group_exprs, n_aggs, out_width,
                post_join):
    """Cost every candidate path pair (host vs TPU) and decide offload per
    node — the planner half of the reference's cost model (cost_gpuscan
    gpuscan.c:101-231, cost_gpuhashjoin gpuhashjoin.c:438-668,
    cost_gpupreagg gpupreagg.c:366-470).  Forced flags
    (debug_force_offload / debug_force_tpupreagg) override the comparison
    exactly like pg_strom.debug_force_gpupreagg in input/enable.conf.

    Returns (decisions, node_costs):
      decisions:  {"scan": {alias: bool}, "join": {alias: bool},
                   "agg": bool, "post_scan": bool}
      node_costs: {"scan": {alias: Cost}, "join": {alias: Cost},
                   "agg": Cost, "final": Cost}
    """
    force = config.debug_force_offload

    # statistics resolver: qualified "alias.col" -> ColumnStats (the
    # pg_statistic analog; datastore.column_stats computes/caches per
    # column version).  Subquery aliases have no base columns -> None.
    from ..datastore import column_stats

    def stats(qname: str):
        alias, _, col = qname.partition(".")
        tbl = shells.get(alias)
        if tbl is None or col == "":
            return None
        # base shells store bare column names; aliased views qualified ones
        c = tbl.columns.get(col) or tbl.columns.get(qname)
        if c is None:
            return None
        try:
            return column_stats(c)
        except Exception:
            return None

    dec_scan: dict[str, bool] = {}
    c_scan: dict[str, Cost] = {}
    for alias, _ in rels:
        if alias in sub_plans:
            base = sub_plans[alias].root.cost
            if base is None:
                base = Cost(0.0, 1000 * config.cpu_tuple_cost, 1000.0, 32)
            nrows = max(base.rows, 1.0)
            width = base.width or 32
        else:
            tbl = shells[alias]
            nrows = float(tbl.nrows)
            width = rel_width([c.type for c in tbl.columns.values()])
        quals = per_rel.get(alias, [])
        dev = [q for q in quals if device_expression_supported(q)]
        host = [q for q in quals if not device_expression_supported(q)]
        ch = cost_seqscan(nrows, width, quals, stats)
        ct = cost_tpuscan(nrows, width, dev, host, stats)
        use = (config.enabled and config.enable_tpuscan
               and alias not in sub_plans
               and (force or (bool(dev) and ct.total < ch.total)))
        dec_scan[alias] = bool(use)
        c_scan[alias] = ct if use else ch

    dec_join: dict[str, bool] = {}
    c_join: dict[str, Cost] = {}
    alias0 = rels[0][0]
    cur = c_scan[alias0]
    if has_outer:
        seq = [(jc.table.alias or jc.table.name, len(ons))
               for jc, ons in zip(joins, bound_ons)]
    else:
        seq = []
        for alias, _ in rels[1:]:
            nhc = sum(1 for cj in join_equis if alias in rels_of(cj))
            seq.append((alias, nhc))
    for alias, nhc in seq:
        inner = c_scan.get(alias, Cost(0, 0, 1, 32))
        width = cur.width + inner.width
        # equi-join selectivity from real ndistinct (eqjoinsel shape):
        # product over this inner's clauses of 1/max(nd_l, nd_r)
        clauses = [cj for cj in join_equis if alias in rels_of(cj)]
        eq_sel = 1.0
        for cj in clauses:
            eq_sel *= eq_join_selectivity(cj, stats)
        if not clauses:
            eq_sel = None
        ch = cost_hashjoin(cur, inner, nhc, width, eq_sel)
        ct = cost_tpuhashjoin(cur, [inner], [nhc], width,
                              None if eq_sel is None else [eq_sel])
        use = (config.enabled and config.enable_tpuhashjoin
               and (force or ct.total < ch.total))
        dec_join[alias] = bool(use)
        cur = ct if use else ch
        c_join[alias] = cur

    dec_post = True
    if post_join:
        dev = [q for q in post_join if device_expression_supported(q)]
        host = [q for q in post_join if not device_expression_supported(q)]
        ch = cost_seqscan(cur.rows, cur.width, post_join)
        ct = cost_tpuscan(cur.rows, cur.width, dev, host)
        # the leftover-qual scan reads an already materialized intermediate,
        # so the disk term is shared; decision rides the qual-eval terms
        dec_post = (config.enabled and config.enable_tpuscan
                    and (force or (bool(dev) and ct.total < ch.total)))
        cur = ct if dec_post else ch

    dec_agg = False
    c_agg = None
    if has_aggs:
        ngc = len(group_exprs)
        n_groups = estimate_num_groups(cur.rows, ngc, group_exprs, stats)
        ch = cost_hostagg(cur, n_aggs, ngc, n_groups, out_width)
        ct = cost_tpupreagg(cur, n_aggs, ngc, n_groups, out_width)
        dec_agg = (config.enabled and config.enable_tpupreagg
                   and (force or config.debug_force_tpupreagg
                        or ct.total < ch.total))
        c_agg = ct if dec_agg else ch
        cur = c_agg

    decisions = {"scan": dec_scan, "join": dec_join, "agg": bool(dec_agg),
                 "post_scan": bool(dec_post)}
    node_costs = {"scan": c_scan, "join": c_join, "agg": c_agg, "final": cur}
    return decisions, node_costs


def _run_outer_chain(tables, rels, joins, bound_ons, perfmon,
                     dec_join=None) -> Table:
    """FROM t0 {LEFT|RIGHT|FULL|INNER} JOIN tN ON ... processed in order.

    ON-clause split per join (PostgreSQL semantics):
      equi pairs (cur = new)     -> hash join keys
      nullable-side-only quals   -> residual match condition (a failed ON
                                    still emits the NULL-extended row)
      preserved-build-side quals -> pushed as build_pred (gate matching only)
      mixed / non-equi           -> residual
    RIGHT is executed as LEFT with probe/build swapped."""
    alias0 = rels[0][0]
    cur = tables[alias0]
    cur_aliases = {alias0}
    for jc, ons in zip(joins, bound_ons):
        alias = jc.table.alias or jc.table.name
        right = tables[alias]
        jt = jc.jointype
        if jt == "cross":
            raise SqlError("CROSS JOIN inside an outer-join chain is not supported")
        equis_cur: list[Expr] = []
        equis_new: list[Expr] = []
        cur_only: list[Expr] = []
        new_only: list[Expr] = []
        residual: list[Expr] = []
        for cj in ons:
            rs = rels_of(cj)
            if (len(rs) == 2 and isinstance(cj, FuncExpr)
                    and cj.fname.startswith("=::")
                    and isinstance(cj.args[0], ColumnRef)
                    and isinstance(cj.args[1], ColumnRef)):
                a0 = cj.args[0].name.split(".", 1)[0]
                a1 = cj.args[1].name.split(".", 1)[0]
                if a0 in cur_aliases and a1 == alias:
                    equis_cur.append(cj.args[0])
                    equis_new.append(cj.args[1])
                    continue
                if a1 in cur_aliases and a0 == alias:
                    equis_cur.append(cj.args[1])
                    equis_new.append(cj.args[0])
                    continue
            if rs and rs <= cur_aliases:
                cur_only.append(cj)
            elif rs and rs <= {alias}:
                new_only.append(cj)
            else:
                residual.append(cj)
        if not equis_cur:
            raise SqlError(f"{jt.upper()} JOIN with {alias} requires an "
                           "equality join condition")
        probe_pred = build_pred = None
        if jt == "right":
            probe, build = right, cur
            pk, bk = equis_new, equis_cur
            build_pred = and_all(cur_only)
            residual += new_only
            jt_exec = "left"
        elif jt == "left":
            probe, build = cur, right
            pk, bk = equis_cur, equis_new
            build_pred = and_all(new_only)
            residual += cur_only
            jt_exec = "left"
        elif jt == "full":
            probe, build = cur, right
            pk, bk = equis_cur, equis_new
            residual += cur_only + new_only
            jt_exec = "full"
        else:  # inner JOIN ... ON written inside an outer chain
            probe, build = cur, right
            pk, bk = equis_cur, equis_new
            probe_pred = and_all(cur_only)
            build_pred = and_all(new_only)
            jt_exec = "inner"
        lp = {n: i for i, n in enumerate(probe.column_names)}
        rp = {n: i for i, n in enumerate(build.column_names)}
        jx = HashJoinExecutor(
            probe, build,
            [bind_columns(k, lp) for k in pk],
            [bind_columns(k, rp) for k in bk],
            out_probe_cols=probe.column_names,
            out_build_cols=build.column_names,
            probe_pred=(bind_columns(probe_pred, lp)
                        if probe_pred is not None else None),
            build_pred=(bind_columns(build_pred, rp)
                        if build_pred is not None else None),
            probe_alias=None, build_alias=None,
            jointype=jt_exec,
            residual=and_all(residual),   # executor binds to joined layout
            perfmon=perfmon,
            offload=True if dec_join is None else dec_join.get(alias, True))
        cur = jx.run()
        cur_aliases.add(alias)
    return cur


def _dedupe_rows(rows: list[tuple]) -> list[tuple]:
    from ..exec.hostexec import canon_group_key
    seen: set = set()
    out: list[tuple] = []
    for r in rows:
        k = tuple(canon_group_key(v) for v in r)
        if k not in seen:
            seen.add(k)
            out.append(r)
    return out


def _default_name(a, e: Expr) -> str:
    if isinstance(e, ColumnRef):
        return e.name.split(".", 1)[-1]
    if isinstance(e, Aggref):
        return e.aggname
    if isinstance(a, ast.AFunc):
        return a.name
    if isinstance(a, ast.ACast):
        return _default_name(a.arg, e)
    return "?column?"


def _subset_table(tbl: Table, idxs: list[int]) -> Table:
    import numpy as np
    cols = {}
    ii = np.asarray(idxs, dtype=np.int64)
    for nm, c in tbl.columns.items():
        nc = Column(type=c.type, data=c.data[ii], valid=c.valid[ii],
                    dictionary=c.dictionary)
        if c.type is T.NUMERIC:
            nc.num_exp = c.num_exp[ii]
            nc.num_dscale = c.num_dscale[ii]
            nc.recheck = c.recheck[ii]
            if nc.recheck.any():
                for newpos, old in enumerate(idxs):
                    if nc.recheck[newpos]:
                        nc._exact[newpos] = c._exact[old]
        cols[nm] = nc
    return Table.from_columns(tbl.name, cols)


def _try_fused_join_agg(tables, rels, per_rel, join_equis, group_exprs,
                        items, having, order_specs, perfmon):
    """Fused probe-join-aggregate over a 2-relation query.  Returns finished
    rows, or None when the shape/expressions aren't fused-eligible (the
    caller then runs the generic join -> aggregate pipeline)."""
    a0, a1 = rels[0][0], rels[1][0]
    keys_l, keys_r = [], []
    for cj in join_equis:
        s0 = cj.args[0].name.split(".", 1)[0]
        s1 = cj.args[1].name.split(".", 1)[0]
        if s0 == a0 and s1 == a1:
            keys_l.append(cj.args[0])
            keys_r.append(cj.args[1])
        elif s1 == a0 and s0 == a1:
            keys_l.append(cj.args[1])
            keys_r.append(cj.args[0])
        else:
            return None
    if not keys_l:
        return None
    aggrefs = _collect_aggrefs(items, having)
    insts = _agg_instances(aggrefs)
    from ..exec.joinagg_exec import JoinPreAggExecutor
    ex = JoinPreAggExecutor(
        tables[a0], tables[a1], keys_l, keys_r, group_exprs, insts,
        probe_pred=and_all(per_rel[a0]) if per_rel[a0] else None,
        build_pred=and_all(per_rel[a1]) if per_rel[a1] else None,
        perfmon=perfmon)
    if not ex.device_ok():
        return None
    raw = ex.run()
    return _finish_agg(raw, group_exprs, aggrefs, items, having, order_specs)


def _try_star_join_agg(tables, rels, per_rel, join_equis, group_exprs,
                       items, having, order_specs, perfmon):
    """N-way fused star join+aggregate (exec/starjoin_exec.py): every join
    equi-clause keys a later relation in FROM order by exactly one earlier
    one (the fact, or an earlier dimension: a snowflake chain).  Returns
    finished rows, or None to fall back to the pairwise HashJoin chain
    (non-star equi pattern, non-dense snowflake parent, fan-out past the
    slice cap, build-side recheck)."""
    dim_keys = _star_dims(rels, join_equis)
    if dim_keys is None:
        return None
    a0 = rels[0][0]
    order = [a for a, _ in rels]
    aggrefs = _collect_aggrefs(items, having)
    insts = _agg_instances(aggrefs)
    from ..exec.starjoin_exec import StarJoinAggExecutor, StarFallback, \
        DimSpec
    dims = [DimSpec(table=tables[alias],
                    probe_keys=dim_keys[alias][0],
                    build_keys=dim_keys[alias][1],
                    build_pred=(and_all(per_rel[alias])
                                if per_rel[alias] else None),
                    src=(None if dim_keys[alias][2] == a0
                         else order.index(dim_keys[alias][2]) - 1))
            for alias, _ in rels[1:]]
    ex = StarJoinAggExecutor(
        tables[a0], dims, group_exprs, insts,
        probe_pred=and_all(per_rel[a0]) if per_rel[a0] else None,
        perfmon=perfmon)
    try:
        raw = ex.run()
    except StarFallback:
        return None
    return _finish_agg(raw, group_exprs, aggrefs, items, having, order_specs)


def _try_dist_join_agg(tables, rels, per_rel, join_equis, group_exprs,
                       items, having, order_specs, perfmon):
    """Distributed shuffle join+aggregate over the device mesh
    (exec/dist_exec.py).  Returns finished rows, or None to fall back to
    the single-device path (ineligible shape, device CpuReCheck, or an
    exhausted overflow->repartition ladder)."""
    a0, a1 = rels[0][0], rels[1][0]
    keys_l, keys_r = [], []
    for cj in join_equis:
        s0 = cj.args[0].name.split(".", 1)[0]
        s1 = cj.args[1].name.split(".", 1)[0]
        if s0 == a0 and s1 == a1:
            keys_l.append(cj.args[0])
            keys_r.append(cj.args[1])
        elif s1 == a0 and s0 == a1:
            keys_l.append(cj.args[1])
            keys_r.append(cj.args[0])
        else:
            return None
    if not keys_l:
        return None
    aggrefs = _collect_aggrefs(items, having)
    insts = _agg_instances(aggrefs)
    from ..exec.dist_exec import DistJoinAggExecutor, DistFallback
    ex = DistJoinAggExecutor(
        tables[a0], tables[a1], keys_l, keys_r, group_exprs, insts,
        probe_pred=and_all(per_rel[a0]) if per_rel[a0] else None,
        build_pred=and_all(per_rel[a1]) if per_rel[a1] else None,
        perfmon=perfmon)
    if not ex.eligible():
        return None
    try:
        raw = ex.run()
    except DistFallback:
        return None
    return _finish_agg(raw, group_exprs, aggrefs, items, having, order_specs)


def _agg_instances(aggrefs) -> list[AggInstance]:
    """The aggregate instances of a join's aggregates (args unbound: the
    join executors bind them to their joined layout)."""
    insts = []
    for ag in aggrefs:
        d, fam = lookup_agg(ag.aggname, tuple(a.type for a in ag.args),
                            star=ag.star)
        insts.append(AggInstance(aggname=ag.aggname, family=fam,
                                 slots=d.slots, args=tuple(ag.args),
                                 distinct=ag.distinct))
    return insts


def _collect_aggrefs(items, having) -> list[Aggref]:
    aggrefs: list[Aggref] = []
    for _, e in items:
        for n in walk(e):
            if isinstance(n, Aggref) and n not in aggrefs:
                aggrefs.append(n)
    if having is not None:
        for n in walk(having):
            if isinstance(n, Aggref) and n not in aggrefs:
                aggrefs.append(n)
    return aggrefs


def _finish_agg(raw, group_exprs, aggrefs, items, having,
                order_specs) -> list[tuple]:
    """Final projection over (group keys..., agg values...) rows: HAVING,
    target-list finalization, ORDER BY."""
    mapping: dict[Expr, int] = {}
    for gi, g in enumerate(group_exprs):
        mapping.setdefault(g, gi)
    for ai, ag in enumerate(aggrefs):
        mapping.setdefault(ag, len(group_exprs) + ai)
    finals = [replace_subtrees(e, mapping) for _, e in items]
    hav = replace_subtrees(having, mapping) if having is not None else None
    orders = [(replace_subtrees(oe, mapping), d, nf)
              for oe, d, nf in order_specs]

    # any ColumnRef surviving the substitution is an ungrouped reference:
    # PG raises at plan time (otherwise it would escape as an internal
    # RuntimeError from the projection eval)
    for src in finals + ([hav] if hav is not None else []) \
            + [o for o, _, _ in orders]:
        for n2 in walk(src):
            if isinstance(n2, ColumnRef):
                raise SqlError(
                    f'column "{n2.name}" must appear in the GROUP BY '
                    "clause or be used in an aggregate function")

    out = []
    for row in raw:
        if hav is not None and eval_expr_cpu(hav, _norow, row) is not True:
            continue
        vals = tuple(eval_expr_cpu(f, _norow, row) for f in finals)
        okeys = tuple(eval_expr_cpu(o, _norow, row) for o, _, _ in orders)
        out.append((okeys, vals))
    return _order_and_strip(out, orders)


def _run_agg(cur: Table, pred, group_exprs, items, having, order_specs,
             perfmon, offload: bool = True) -> list[tuple]:
    layout = {n: i for i, n in enumerate(cur.column_names)}
    aggrefs = _collect_aggrefs(items, having)
    insts = []
    for ag in aggrefs:
        d, fam = lookup_agg(ag.aggname, tuple(a.type for a in ag.args),
                            star=ag.star)
        insts.append(AggInstance(
            aggname=ag.aggname, family=fam, slots=d.slots,
            args=tuple(bind_columns(a, layout) for a in ag.args),
            distinct=ag.distinct))
    bound_groups = [bind_columns(g, layout) for g in group_exprs]
    bpred = bind_columns(pred, layout) if pred is not None else None
    raw = None
    if offload and (config.distributed
                    or (config.device_distinct
                        and any(i_.distinct for i_ in insts))):
        # single-table data-parallel aggregation over the mesh; ALSO the
        # device-assisted DISTINCT tier: an eligible agg(DISTINCT x) runs
        # through the dedup-exchange step on the local mesh instead of the
        # host row loop.  Ineligible shapes / device recheck fall back to
        # the local executor.
        from ..exec.dist_exec import DistPreAggExecutor, DistFallback
        dx = DistPreAggExecutor(cur, bound_groups, insts, pred=bpred,
                                perfmon=perfmon)
        if dx.eligible():
            try:
                raw = dx.run()
            except DistFallback:
                raw = None
    if raw is None:
        from ..exec.preagg_exec import PreAggExecutor
        ex = PreAggExecutor(cur, bpred, bound_groups, insts, perfmon=perfmon,
                            offload=offload)
        raw = ex.run()   # rows: (group key vals..., agg vals...)
    return _finish_agg(raw, group_exprs, aggrefs, items, having, order_specs)


def _norow(slot: int):
    raise RuntimeError("unsubstituted column reference in final projection")


def _run_plain(cur: Table, pred, items, order_specs, perfmon,
               limit_k: Optional[int] = None,
               offload: bool = True) -> list[tuple]:
    layout = {n: i for i, n in enumerate(cur.column_names)}
    bpred = bind_columns(pred, layout) if pred is not None else None
    bitems = [bind_columns(e, layout) for _, e in items]
    borders = [(bind_columns(oe, layout), d, nf) for oe, d, nf in order_specs]
    # device top-k window raised to 2^20: k <= 8192 rides lax.top_k, larger
    # k the exact full packed/adaptive sort (ops/sort.build_sort_topk_fn)
    if order_specs and limit_k is not None and 0 < limit_k <= (1 << 20):
        rows = _topk_rows(cur, bpred, bitems, borders, limit_k, perfmon)
        if rows is not None:
            return rows
    idxs = ScanExecutor(cur, bpred, perfmon, offload=offload).row_indexes()
    cols = list(cur.columns.values())
    # vectorized materialization for plain column projections (the common
    # SELECT cols ... shape): batch numpy gathers + tolist instead of a
    # per-row python eval loop — ~10x on megarow outputs.  Plain-column
    # ORDER BY keys order the INDEXES with np.lexsort over encoded planes
    # first, so no python row objects exist until final materialization.
    if all(isinstance(e, ColumnRef) for e in bitems):
        import numpy as _np
        ii = _np.asarray(idxs, dtype=_np.int64)
        if borders:
            ii2 = _order_indexes(cols, borders, ii)
            if ii2 is None:
                ii = None            # non-vectorizable key: row loop below
            else:
                ii = ii2
        if ii is not None:
            lanes = [_column_values_at(cols[e.index], ii) for e in bitems]
            return list(zip(*lanes)) if lanes else [() for _ in ii]
    out = []
    for i in idxs:
        row = lambda s: cols[s].get(i)
        vals = tuple(eval_expr_cpu(e, row) for e in bitems)
        okeys = tuple(eval_expr_cpu(o, row) for o, _, _ in borders)
        out.append((okeys, vals))
    return _order_and_strip(out, borders)


def _order_plane_keys(c: Column, ii) -> Optional[list]:
    """int64 key lanes (most-significant first) ordering column c at rows ii
    exactly as cmp_values orders the python values; None => not encodable."""
    import numpy as _np
    t = c.type
    if t in (T.INT2, T.INT4, T.INT8, T.DATE, T.TIME, T.TIMESTAMP, T.BOOL):
        return [c.data[ii].astype(_np.int64)]
    if t in (T.FLOAT4, T.FLOAT8):
        a = c.data[ii].astype(_np.float64)
        a = _np.where(_np.isnan(a), _np.float64("nan"), a)  # canonical NaN
        a = _np.where(a == 0.0, 0.0, a)                     # -0 -> +0
        bits = a.view(_np.int64)
        return [_np.where(bits < 0,
                          _np.int64(-1) - (bits & _np.int64((1 << 63) - 1)),
                          bits)]
    if t in (T.TEXT, T.BPCHAR):
        d = list(c.dictionary or ())
        order = sorted(range(len(d)), key=lambda j: d[j].encode())
        rank = _np.zeros(max(len(d), 1), _np.int64)
        for r, j in enumerate(order):
            rank[j] = r
        codes = _np.clip(c.data[ii].astype(_np.int64), 0, max(len(d) - 1, 0))
        return [rank[codes]]
    if t is T.NUMERIC:
        if c.recheck is not None and c.recheck[ii].any():
            return None              # out-of-window Decimals: exact row path
        mant = c.data[ii].astype(_np.int64)
        exp = c.num_exp[ii].astype(_np.int64)
        m_abs = _np.abs(mant)
        sign = _np.sign(mant)
        p10 = _np.array([10 ** k for k in range(19)], dtype=_np.int64)
        nd = _np.searchsorted(p10, m_abs, side="right")     # decimal digits
        E = nd + exp
        p = _np.where(mant == 0, _np.int64(0), sign * (E + 64))
        shift = _np.clip(18 - nd, 0, 18)
        s = _np.where(mant == 0, _np.int64(0), sign * (m_abs * p10[shift]))
        return [p, s]
    return None


def _order_indexes(cols, borders, ii):
    """ii reordered per plain-ColumnRef ORDER BY keys via np.lexsort over
    encoded planes (stable; PG NULL placement).  None => caller falls back
    to the exact per-row path."""
    import numpy as _np
    arrays: list = []                  # np.lexsort: LAST array is primary
    for oe, desc, nf in reversed(borders):
        if not isinstance(oe, ColumnRef):
            return None
        c = cols[oe.index]
        lanes = _order_plane_keys(c, ii)
        if lanes is None:
            return None
        nulls = ~c.valid[ii]
        nulls_first = desc if nf is None else nf
        nkey = _np.where(nulls, _np.int8(-1 if nulls_first else 1),
                         _np.int8(0))
        for lane in reversed(lanes):   # least-significant lane first
            if desc:
                lane = _np.int64(-1) - lane
            arrays.append(_np.where(nulls, _np.int64(0), lane))
        arrays.append(nkey)
    return ii[_np.lexsort(tuple(arrays))]


def _column_values_at(c: Column, ii) -> list:
    """Vectorized python values of column c at row indexes ii."""
    import numpy as _np
    t = c.type
    valid = c.valid[ii]
    if t is T.NUMERIC:
        return [c.get(int(i)) for i in ii]          # Decimal: per-row exact
    data = c.data[ii]
    if t in (T.TEXT, T.BPCHAR):
        d = c.dictionary or []
        if not d:
            return [None] * len(ii)                 # all-NULL text column
        vals = [d[k] for k in data.tolist()]
    elif t is T.BOOL:
        vals = [bool(v) for v in data.tolist()]
    else:
        vals = data.tolist()                         # ints / floats exact
    if not valid.all():
        bad = _np.flatnonzero(~valid)
        for j in bad.tolist():
            vals[j] = None
    return vals


def _topk_rows_dist(cur: Table, names, schema, specs, bpred, k: int,
                    bitems, perfmon) -> Optional[list[tuple]]:
    """Distributed ORDER BY + LIMIT: shard rows over the mesh (pure data
    parallelism — no shuffle), run the top-k once a shard on its device,
    merge the ndev*k candidates on the host exactly like the chunked
    single-device flow.  The padded shard planes stay resident in the
    tcache aux space, so a repeated query ships 0 bytes.  Returns None to
    fall back (device error, prefix-tie overflow, recheck rows)."""
    import numpy as np
    import torch
    from ..parallel.mesh import mesh_for_config, mesh_size, per_shard
    from ..exec.devcache import TCACHE, fetch_host
    from ..expr.lower_torch import planes_of_column
    from ..ops.sort import build_sort_topk_fn

    cols = [cur.columns[n] for n in names]
    for c in cols:
        if c.recheck is not None and c.recheck.any():
            return None
    ndev = mesh_size()
    mesh = mesh_for_config(ndev)
    n = cur.nrows
    shard_n = max(-(-n // ndev), 1024)
    kk = min(k, shard_n)
    fn = build_sort_topk_fn(schema, list(specs), bpred, kk)

    rkey = ("dist_topk_args", tuple(c.uid for c in cols), tuple(names),
            shard_n, tuple(str(d) for d in mesh.devices))
    shard_planes = TCACHE.get_aux(rkey, perfmon)
    if shard_planes is not None:
        perfmon.bump("dist_resident_hits")
    else:
        def shard_of(s, dev):
            lo, hi = min(s * shard_n, n), min((s + 1) * shard_n, n)
            out = []
            for c in cols:
                pl = []
                for p in planes_of_column(c):
                    blk = np.zeros((shard_n,) + p.shape[1:], p.dtype)
                    blk[:hi - lo] = p[lo:hi]
                    pl.append(torch.from_numpy(blk).to(dev))
                out.append(tuple(pl))
            return tuple(out)
        with perfmon.timer("upload"):
            shard_planes = [shard_of(s, d)
                            for s, d in enumerate(mesh.devices)]
        perfmon.add_bytes("h2d", ndev * shard_n * sum(
            p.dtype.itemsize * int(np.prod(p.shape[1:], dtype=np.int64))
            for c in cols for p in planes_of_column(c)))
        TCACHE.put_aux(rkey, shard_planes, cur.name, cols)
    nrows_d = np.clip(n - shard_n * np.arange(ndev, dtype=np.int64),
                      0, shard_n)
    with perfmon.timer("dispatch"):
        outs = per_shard(mesh, lambda s, pl: perfmon.device_call(
            "tpusort_topk", fn, pl, int(nrows_d[s])), shard_planes)
    with perfmon.timer("device_wait"):
        outs = fetch_host(outs)
    if any(int(o[3]) != 0 or bool(o[4]) for o in outs):
        return None                    # single-device flow handles retries
    nqual_total = sum(int(o[2]) for o in outs)
    take = min(k, nqual_total)
    if take == 0:
        return []
    nlanes = len(outs[0][1])
    gids = np.concatenate([np.asarray(o[0], dtype=np.int64) + shard_n * s
                           for s, o in enumerate(outs)])
    lanes = np.concatenate([np.stack([np.asarray(t) for t in o[1]])
                            for o in outs], axis=1)
    order = np.lexsort(tuple([gids] + [lanes[i]
                                       for i in range(nlanes - 1, -1, -1)]))
    sel = gids[order[:take]]
    out_rows = []
    for gid in sel:
        i = int(gid)
        row = lambda s: cols[s].get(i)  # noqa: E731
        out_rows.append(tuple(eval_expr_cpu(e, row) for e in bitems))
    return out_rows


def _topk_rows(cur: Table, bpred, bitems, borders, k: int,
               perfmon) -> Optional[list[tuple]]:
    """Device ORDER BY + LIMIT: per-chunk packed sort -> k candidates with
    their encoded key lanes -> host lexicographic merge -> materialize only
    the k winning rows.  Returns None when not device-eligible (caller runs
    the host path)."""
    import numpy as np
    from ..exec.devcache import chunk_capacity, device, fetch_host, \
        launch_chunks
    from ..expr.lower_torch import schema_from_chunk_columns
    from ..ops.sort import build_sort_topk_fn, SortSpec
    from ..utils.devprog import tiered_capacity

    if not (config.enabled and config.enable_tpusort):
        return None
    exprs = [oe for oe, _, _ in borders] + ([bpred] if bpred is not None else [])
    if any(not device_expression_supported(e) for e in exprs):
        return None
    if cur.nrows == 0:
        return []

    with perfmon.timer("prepare"):
        names = cur.column_names
        schema = schema_from_chunk_columns(
            names, [cur.columns[n] for n in names])
        cap = tiered_capacity(chunk_capacity(cur.nrows), device(), perfmon)
        specs = [SortSpec(oe, d, nf) for oe, d, nf in borders]
    if config.distributed:
        from ..parallel.mesh import mesh_size
        if mesh_size() >= 2:
            # distributed top-k: rows shard over the mesh, each shard
            # computes its local top-k, the host merges ndev*k candidates
            # — the same merge the chunked flow uses.  None => fall through
            # to the single-device path (overflow / recheck / error).
            rows = _topk_rows_dist(cur, names, schema, specs, bpred, k,
                                   bitems, perfmon)
            if rows is not None:
                return rows
    with perfmon.timer("prepare"):
        fn = build_sort_topk_fn(schema, specs, bpred, min(k, cap))

    results = []
    for cc, res in launch_chunks(
            cur, names, cap, perfmon,
            lambda cc: perfmon.device_call("tpusort_topk", fn, cc.planes,
                                           cc.nrows)):
        if res is None:
            return None                # mixed host/device merge: host path
        results.append((cc, res))

    def exact_rerun(cc):
        """Prefix-tie overflow (threshold route) or a key set the adaptive
        word cannot hold: re-run this chunk with the exact full sort (the
        host-driven retry, the DataStoreNoSpace analog)."""
        efn = build_sort_topk_fn(schema, specs, bpred, min(k, cap),
                                 exact=True)
        with perfmon.timer("dispatch"):
            r = perfmon.device_call("tpusort_topk", efn, cc.planes, cc.nrows)
        with perfmon.timer("device_wait"):
            return fetch_host(r)

    lanes_all: list = []
    gids_all: list = []
    nqual_total = 0
    nlanes = None
    for cc, (top, tops, nqual, err, ovf) in results:
        if bool(ovf):
            top, tops, nqual, err, ovf = exact_rerun(cc)
        if int(err) != 0:
            return None                # exactness escape: host path
        nqual_total += int(nqual)
        gids_all.append(np.asarray(top, dtype=np.int64) + cc.start)
        nlanes = len(tops)
        lanes_all.append(np.stack([np.asarray(t) for t in tops]))
    take = min(k, nqual_total)
    if take == 0:
        return []
    lanes = np.concatenate(lanes_all, axis=1)      # [nlanes, ncand]
    gids = np.concatenate(gids_all)
    # primary = lane 0 (dead bit), ..., last lane, then the global row for
    # the stable host sort's tie order; np.lexsort keys: last = primary
    order = np.lexsort(tuple([gids] + [lanes[i]
                                       for i in range(nlanes - 1, -1, -1)]))
    sel = gids[order[:take]]
    cols = list(cur.columns.values())
    out = []
    for gid in sel:
        i = int(gid)
        row = lambda s: cols[s].get(i)
        out.append(tuple(eval_expr_cpu(e, row) for e in bitems))
    return out


def _order_and_strip(rows: list[tuple], orders) -> list[tuple]:
    if orders:
        specs = [(i, desc, nf) for i, (_, desc, nf) in enumerate(orders)]
        rows = _lexsort_rows(rows, specs, lambda r, i: r[0][i])
    return [v for _, v in rows]


def _f64_orderkey_host(vals: list, nulls: "np.ndarray") -> "np.ndarray":
    """int64 keys ordering python floats per PG float8_cmp (NaN greatest,
    -0 == +0)."""
    import numpy as np
    a = np.array([0.0 if v is None else v for v in vals], dtype=np.float64)
    a = np.where(np.isnan(a), np.float64("nan"), a)     # canonical quiet NaN
    a = np.where(a == 0.0, 0.0, a)                      # -0 -> +0
    bits = a.view(np.int64)
    return np.where(bits < 0, np.int64(-1) - (bits & np.int64((1 << 63) - 1)),
                    bits)


def _encode_sort_column(vals: list, nulls: "np.ndarray"):
    """int64 key array ordering the non-null values exactly as cmp_values
    does (null slots hold 0).  Returns None when no vectorizable encoding
    applies — the caller falls back to the python comparison sort."""
    import datetime
    import numpy as np
    from decimal import Decimal as _Dec
    nn = [v for v in vals if v is not None]
    if not nn:
        return np.zeros(len(vals), np.int64)
    if all(isinstance(v, (int, bool)) and not isinstance(v, float)
           for v in nn):
        try:
            return np.fromiter((0 if v is None else int(v) for v in vals),
                               np.int64, len(vals))
        except OverflowError:
            return None
    if all(isinstance(v, float) for v in nn):
        return _f64_orderkey_host(vals, nulls)
    # factorize: order-preserving integer codes over the distinct values
    if all(isinstance(v, str) for v in nn):
        ordered = sorted(set(nn), key=lambda s: s.encode())  # C collation
        codes = {v: i for i, v in enumerate(ordered)}
        return np.fromiter((0 if v is None else codes[v] for v in vals),
                           np.int64, len(vals))
    if all(isinstance(v, _Dec) for v in nn):
        # Decimal NaN is unhashable and sorts greatest (PG numeric order)
        nancode = None
        finite = [v for v in nn if not v.is_nan()]
        ordered = sorted(set(finite))
        codes = {v: i for i, v in enumerate(ordered)}
        if len(finite) != len(nn):
            nancode = len(ordered)
        return np.fromiter(
            (0 if v is None else
             (nancode if v.is_nan() else codes[v]) for v in vals),
            np.int64, len(vals))
    if all(isinstance(v, (datetime.date, datetime.time)) for v in nn) \
            and len({type(v) for v in nn}) == 1:
        ordered = sorted(set(nn))
        codes = {v: i for i, v in enumerate(ordered)}
        return np.fromiter((0 if v is None else codes[v] for v in vals),
                           np.int64, len(vals))
    return None


def _lexsort_rows(rows: list, specs: list, getter) -> list:
    """Stable multi-key ordering of python row tuples via np.lexsort over
    encoded int64 keys — the ~100x replacement for functools.cmp_to_key on
    large results.  specs: (key index, descending, nulls_first|None).
    Falls back to the exact python comparison sort when a key column has no
    vectorizable encoding."""
    import numpy as np
    if len(rows) <= 64:
        return _cmp_sort_rows(rows, specs, getter)
    arrays: list = []                    # np.lexsort: LAST array is primary
    for i, desc, nf in reversed(specs):
        vals = [getter(r, i) for r in rows]
        nulls = np.fromiter((v is None for v in vals), np.bool_, len(vals))
        enc = _encode_sort_column(vals, nulls)
        if enc is None:
            return _cmp_sort_rows(rows, specs, getter)
        if desc:
            enc = np.int64(-1) - enc     # order-reversing, overflow-free
        enc = np.where(nulls, np.int64(0), enc)
        nulls_first = desc if nf is None else nf
        nkey = np.where(nulls, np.int8(-1 if nulls_first else 1), np.int8(0))
        arrays.append(enc)
        arrays.append(nkey)              # null rank dominates the value key
    order = np.lexsort(tuple(arrays))
    return [rows[int(j)] for j in order]


def _cmp_sort_rows(rows: list, specs: list, getter) -> list:
    def cmp(a, b):
        for i, desc, nf in specs:
            va, vb = getter(a, i), getter(b, i)
            nulls_first = desc if nf is None else nf
            if va is None and vb is None:
                continue
            if va is None:
                return -1 if nulls_first else 1
            if vb is None:
                return 1 if nulls_first else -1
            c = cmp_values(va, vb)
            if c:
                return -c if desc else c
        return 0
    return sorted(rows, key=functools.cmp_to_key(cmp))


def _kernel_text(obj, alias: str, dev_quals: list[Expr]) -> str:
    """Lowered device kernel dump (pg_strom.show_device_kernel analog,
    main.c:399-439): the scan qual over this schema, traced with make_fx
    over an 8-row chunk of the table's planes on the configured device,
    printed as its FX graph."""
    try:
        import numpy as np
        import torch
        from torch.fx.experimental.proxy_tensor import make_fx
        from ..exec.devcache import device
        from ..expr.lower_torch import (build_qual_fn,
                                        schema_from_chunk_columns,
                                        planes_of_column)
        tbl = obj if isinstance(obj, Table) else None
        if tbl is None:
            return "(subquery input)"
        r = rename_table(tbl, alias)
        names = r.column_names
        schema = schema_from_chunk_columns(names, list(r.columns.values()))
        pred = and_all([bind_columns(q, {n: i for i, n in enumerate(names)})
                        for q in dev_quals])
        fn = build_qual_fn(pred, schema)
        dev = device()
        dummy = tuple(
            tuple(torch.from_numpy(np.zeros((8,) + p.shape[1:], p.dtype))
                  .to(dev) for p in planes_of_column(c))
            for c in r.columns.values())
        graph = make_fx(lambda cols: fn(cols, 8))(dummy).graph
        text = str(graph)
        return text if len(text) < 4000 else text[:4000] + " ..."
    except Exception as e:  # kernel dump must never break EXPLAIN
        return f"(unavailable: {e})"


def _plan_table_less(stmt, db, perfmon) -> PlannedQuery:
    """SELECT without FROM (e.g. `select sum(1E+48)` in recheck_agg —
    aggregates over a single virtual row, scalar expressions otherwise)."""
    scope = Scope(rels=[], db=db)
    items = []
    for it in stmt.items:
        e = bind_expr(it.expr, scope, allow_aggs=True)
        items.append((it.alias or _default_name(it.expr, e), e))
    has_aggs = any(contains_agg(e) for _, e in items)

    def run():
        if not has_aggs:
            return [tuple(eval_expr_cpu(e, _norow) for _, e in items)]
        # one virtual row: aggregate transitions over exactly one tuple
        from ..exec.hostexec import new_state, update_state
        from ..ops.preagg import AGG_CATALOG
        aggrefs = []
        for _, e in items:
            for n in walk(e):
                if isinstance(n, Aggref) and n not in aggrefs:
                    aggrefs.append(n)
        insts = []
        for ag in aggrefs:
            d, fam = lookup_agg(ag.aggname, tuple(a.type for a in ag.args),
                                star=ag.star)
            insts.append(AggInstance(aggname=ag.aggname, family=fam,
                                     slots=d.slots, args=tuple(ag.args),
                                     distinct=ag.distinct))
        states = [new_state(i2) for i2 in insts]
        for inst, s in zip(insts, states):
            args = [eval_expr_cpu(a, _norow) for a in inst.args]
            update_state(inst, s, args)
        vals = [AGG_CATALOG[(i2.aggname, i2.family)].final(s)
                for i2, s in zip(insts, states)]
        mapping = {ag: i for i, ag in enumerate(aggrefs)}
        finals = [replace_subtrees(e, mapping) for _, e in items]
        return [tuple(eval_expr_cpu(f, _norow, vals) for f in finals)]

    node = PlanNode("Result", {}, [])
    return PlannedQuery([nm for nm, _ in items], [e.type for _, e in items],
                        run, node, perfmon)


def _star_dims(rels, join_equis) -> Optional[dict]:
    """{inner alias: (probe key exprs over its source relation, build key
    exprs, source alias)} when every equi clause keys a later-listed
    relation by exactly one earlier relation (classic star AND snowflake
    chains) — the fused N-way device chain shape (exec/starjoin_exec.py);
    None otherwise."""
    if len(rels) < 3 or not join_equis:
        return None
    order = [a for a, _ in rels]
    pos = {a: i for i, a in enumerate(order)}
    keys: dict[str, tuple[list, list, set]] = \
        {a: ([], [], set()) for a in order[1:]}
    for cj in join_equis:
        s0 = cj.args[0].name.split(".", 1)[0]
        s1 = cj.args[1].name.split(".", 1)[0]
        if s0 == s1 or s0 not in pos or s1 not in pos:
            return None
        # the LATER rel in FROM order is the inner being keyed
        inner, outer = (s0, s1) if pos[s0] > pos[s1] else (s1, s0)
        if inner == order[0]:
            return None
        src_expr, in_expr = ((cj.args[1], cj.args[0]) if inner == s0
                             else (cj.args[0], cj.args[1]))
        keys[inner][0].append(src_expr)
        keys[inner][1].append(in_expr)
        keys[inner][2].add(outer)
    # an inner without an equi is a cross join; keys from two relations
    # are not a chain
    if any(len(srcs) != 1 for _, _, srcs in keys.values()):
        return None
    return {a: (pk, bk, next(iter(srcs)))
            for a, (pk, bk, srcs) in keys.items()}


def _star_shape(rels, join_equis) -> bool:
    return _star_dims(rels, join_equis) is not None


def _annotate_distributed(d: dict) -> None:
    """Mark plan nodes whose executor may route over the device mesh
    (pg_strom.distributed; runtime eligibility can still fall back)."""
    if not config.distributed:
        return
    from ..parallel.mesh import mesh_size
    ndev = mesh_size()
    if ndev < 2:
        return
    h = int(getattr(config, "dist_mesh_hosts", 1) or 1)
    shape = f"{h}x{ndev // h} hosts x chips" if h > 1 else f"{ndev} devices"
    d["Distributed"] = f"mesh ({shape})"


def _build_plan_tree(rels, per_rel, join_equis, post_join, has_aggs,
                     group_exprs, items, order_specs, stmt,
                     sub_plans, dec=None, node_costs=None) -> PlanNode:
    dec = dec or {"scan": {}, "join": {}, "agg": True, "post_scan": True}
    node_costs = node_costs or {"scan": {}, "join": {}, "agg": None,
                                "final": None}

    def scan_node(alias, obj):
        if alias in sub_plans:
            return PlanNode("Subquery", {"_rel": alias},
                            [sub_plans[alias].root],
                            cost=node_costs["scan"].get(alias))
        quals = per_rel.get(alias, [])
        dev = [q for q in quals if device_expression_supported(q)]
        host = [q for q in quals if not device_expression_supported(q)]
        d = {"_rel": alias}
        if dev:
            d["Device Filter"] = " AND ".join(fmt_expr(q) for q in dev)
        if host:
            d["Filter"] = " AND ".join(fmt_expr(q) for q in host)
        # the cost verdict names the node; a qual-less scan under a Tpu
        # parent is the bulk-load shape (gpuscan_try_replace_seqscan_path,
        # gpuscan.c:241-517) and keeps the TpuScan name when enabled
        kind = "TpuScan" if (dec["scan"].get(alias) and dev) \
            else ("TpuScan" if config.enabled and not quals else "SeqScan")
        if dev and config.show_device_kernel and kind == "TpuScan":
            d["Device Kernel"] = _kernel_text(obj, alias, dev)
        return PlanNode(kind, d, [], cost=node_costs["scan"].get(alias))

    star = (has_aggs and not post_join and dec["agg"]
            and all(dec["join"].values()) and dec["join"]
            and _star_shape(rels, join_equis)
            and config.enabled and config.enable_tpuhashjoin)
    if star:
        # one fused N-way device node (the multi-rel GpuHashJoin+GpuPreAgg
        # merge, gpuhashjoin.c:789-835): fact chunk probes every dimension
        # and aggregates in a single program
        d = {"Hash Cond": " AND ".join(fmt_expr(k) for k in join_equis)}
        if group_exprs:
            d["Group Key"] = ", ".join(fmt_expr(g) for g in group_exprs)
        d["output"] = ", ".join(fmt_expr(e) for _, e in items)
        node = PlanNode("TpuStarJoinAgg", d,
                        [scan_node(a, o) for a, o in rels],
                        cost=node_costs["agg"])
        if order_specs:
            d2 = {"Sort Key": ", ".join(
                fmt_expr(oe) + (" DESC" if desc else "")
                for oe, desc, _ in order_specs)}
            node = PlanNode("Sort", d2, [node], cost=node_costs["final"])
        if stmt.limit is not None:
            node = PlanNode("Limit", {"Count": str(stmt.limit)}, [node],
                            cost=node_costs["final"])
        return node

    node = scan_node(*rels[0])
    for alias, obj in rels[1:]:
        keys = [cj for cj in join_equis if alias in rels_of(cj)]
        d = {"Hash Cond": " AND ".join(fmt_expr(k) for k in keys)}
        kind = "TpuHashJoin" if dec["join"].get(alias, False) else "HashJoin"
        node = PlanNode(kind, d, [node, scan_node(alias, obj)],
                        cost=node_costs["join"].get(alias))
    if post_join:
        node = PlanNode("Result",
                        {"Filter": " AND ".join(fmt_expr(q) for q in post_join)},
                        [node])
    if has_aggs:
        d = {}
        if group_exprs:
            d["Group Key"] = ", ".join(fmt_expr(g) for g in group_exprs)
        d["output"] = ", ".join(fmt_expr(e) for _, e in items)
        kind = "TpuPreAgg" if dec["agg"] else "HashAggregate"
        if kind == "TpuPreAgg":
            _annotate_distributed(d)
            if (config.device_distinct and not config.distributed
                    and any(getattr(a, "distinct", False)
                            for a in _collect_aggrefs(items, None))):
                # the device-assisted DISTINCT tier (runtime eligibility
                # can still fall back to the host row loop)
                d["Distinct"] = "device dedup exchange"
        node = PlanNode(kind, d, [node], cost=node_costs["agg"])
    else:
        node = PlanNode("Result",
                        {"output": ", ".join(fmt_expr(e) for _, e in items)},
                        [node], cost=node_costs["final"])
    if order_specs:
        d = {"Sort Key": ", ".join(
            fmt_expr(oe) + (" DESC" if desc else "")
            for oe, desc, _ in order_specs)}
        if (stmt.limit is not None and not has_aggs and not stmt.distinct
                and 0 < stmt.limit + (stmt.offset or 0) <= (1 << 20)
                and config.enabled and config.enable_tpusort):
            # ORDER BY + LIMIT rides the device top-k (plan-shape marker;
            # recheck rows or host-only keys fall back at run time)
            d["Method"] = "device top-k"
        node = PlanNode("Sort", d, [node], cost=node_costs["final"])
    if stmt.limit is not None:
        node = PlanNode("Limit", {"Count": str(stmt.limit)}, [node],
                        cost=node_costs["final"])
    return node


# ---------------------------------------------------------------------------
# set operations (UNION / UNION ALL)
# ---------------------------------------------------------------------------

def plan_query(stmt, db: Database) -> PlannedQuery:
    """Plan any query expression: SELECT or a set-op chain, with WITH
    entries desugared first (the span `plan`)."""
    with span("plan"):
        if getattr(stmt, "ctes", None):
            stmt = _expand_ctes(stmt)
        if isinstance(stmt, ast.ARecursive):
            return plan_recursive(stmt, db)
        if isinstance(stmt, ast.SetOpStmt):
            return plan_setop(stmt, db)
        return plan_select(stmt, db)


def _expand_ctes(stmt, outer: dict | None = None):
    """Desugar WITH: rewrite every reference to a CTE name into a
    FROM-subquery carrying the CTE body (+ its column aliases).

    PostgreSQL >= 12 inlines single-reference CTEs exactly like this; for
    multi-reference CTEs the body plans (and its lazily-materialized
    subquery table builds) once per reference instead of once per query —
    same rows, only a cost difference.  Scoping follows PG: a CTE may
    reference earlier CTEs in the same WITH list, inner WITH lists shadow
    outer ones, and CTE names shadow real tables."""
    cmap = dict(outer or {})
    for c in getattr(stmt, "ctes", None) or []:
        body = _expand_ctes(c.query, cmap)    # self name NOT yet visible
        if getattr(c, "recursive", False) and _refs_table(body, c.name):
            # WITH RECURSIVE: split base UNION [ALL] rec; references
            # become ARecursive subqueries (worktable iteration,
            # plan_recursive)
            if not isinstance(body, ast.SetOpStmt) or body.op != "union" \
                    or body.order_by or body.limit is not None:
                raise SqlError(
                    f'recursive query "{c.name}" does not have the form '
                    "non-recursive-term UNION [ALL] recursive-term")
            if _refs_table(body.left, c.name):
                raise SqlError(
                    f'recursive reference to query "{c.name}" must not '
                    "appear within its non-recursive term")
            cmap[c.name] = (ast.ARecursive(c.name, c.columns, body.left,
                                           body.right, body.all),
                            c.columns)
        else:
            cmap[c.name] = (body, c.columns)
    if not cmap:
        return stmt

    def rw(n):
        if isinstance(n, ast.TableRef):
            if n.subquery is not None:
                return dataclasses.replace(
                    n, subquery=_expand_ctes(n.subquery, cmap))
            ent = cmap.get(n.name)
            if ent is not None:
                body, cols = ent
                return ast.TableRef(None, body, n.alias or n.name,
                                    n.col_aliases or cols)
            return n
        if isinstance(n, (ast.SelectStmt, ast.SetOpStmt)):
            # nested scope (subqueries in expressions, setop sides):
            # inherits this scope's CTEs, its own WITH shadows
            return _expand_ctes(n, cmap)
        if isinstance(n, list):
            return [rw(x) for x in n]
        if isinstance(n, tuple):
            return tuple(rw(x) for x in n)
        if dataclasses.is_dataclass(n) and not isinstance(n, type):
            return dataclasses.replace(n, **{
                f.name: rw(getattr(n, f.name))
                for f in dataclasses.fields(n)})
        return n

    fields = {f.name: rw(getattr(stmt, f.name))
              for f in dataclasses.fields(stmt) if f.name != "ctes"}
    fields["ctes"] = []
    return dataclasses.replace(stmt, **fields)


def _refs_table(n, name: str) -> bool:
    """Does this AST fragment reference table `name` (not shadowed
    tracking — recursive CTE detection)?"""
    if isinstance(n, ast.TableRef):
        if n.name == name:
            return True
        return n.subquery is not None and _refs_table(n.subquery, name)
    if isinstance(n, (list, tuple)):
        return any(_refs_table(x, name) for x in n)
    if dataclasses.is_dataclass(n) and not isinstance(n, type):
        return any(_refs_table(getattr(n, f.name), name)
                   for f in dataclasses.fields(n))
    return False


class _ChainDb:
    """Database view binding one extra table name (the recursive CTE's
    working table) in front of a parent database."""

    def __init__(self, name: str, tbl, parent):
        self._name = name
        self._tbl = tbl
        self._parent = parent

    def get(self, name: str):
        if name == self._name:
            return self._tbl
        return self._parent.get(name)

    def __getattr__(self, item):
        return getattr(self._parent, item)


def plan_recursive(stmt: "ast.ARecursive", db: Database) -> PlannedQuery:
    """WITH RECURSIVE worktable iteration (PostgreSQL RecursiveUnion):
    result/work start as the non-recursive term; each step re-plans the
    recursive term with the CTE name bound to the PREVIOUS step's rows
    only; UNION dedupes against everything emitted (canon_group_key
    equality), UNION ALL appends.  The reference leaves this node to the
    PostgreSQL executor (grafter.c swaps only scan/join/agg); here each
    term still plans through the full pipeline, so scans/joins/aggs
    inside the recursion offload per iteration."""
    from ..datastore import column_from_values_fast
    from ..exec.hostexec import canon_group_key
    base_pq = plan_query(stmt.base, db)
    out_names = list(base_pq.out_names)
    if stmt.columns:
        if len(stmt.columns) > len(out_names):
            raise SqlError(
                f'WITH query "{stmt.name}" has {len(out_names)} columns '
                f"available but {len(stmt.columns)} columns specified")
        out_names = list(stmt.columns) + out_names[len(stmt.columns):]
    out_types = list(base_pq.out_types)

    # plan-time validation against an EMPTY worktable: arity and column
    # types of the recursive term must match the non-recursive term
    # (checking inside the loop would miss both whenever the base term
    # returned zero rows, and a type mismatch would silently truncate
    # values into the worktable each iteration)
    from ..datastore import column_from_values
    shell_wt = Table.from_columns(stmt.name, {
        nm: column_from_values(t, [])
        for nm, t in zip(out_names, out_types)})
    val_pq = plan_query(stmt.rec, _ChainDb(stmt.name, shell_wt, db))
    if len(val_pq.out_types) != len(out_types):
        raise SqlError("each UNION query must have the same "
                       "number of columns")
    from .window import _common_type
    for ci, (bt, rt) in enumerate(zip(out_types, val_pq.out_types)):
        # PG: the recursive term may implicitly coerce UP to the
        # non-recursive term's type, never change it (int8 base accepts
        # an int4 rec term; int4 base rejects numeric/int8 rec terms)
        if bt != rt and _common_type(bt, rt) != bt:
            raise SqlError(
                f'recursive query "{stmt.name}" column {ci + 1} has type '
                f"{rt.value} in the recursive term but {bt.value} overall")

    def run() -> list[tuple]:
        rows = base_pq.execute()
        if not stmt.union_all:
            rows = _dedupe_rows(rows)
        seen = (None if stmt.union_all else
                {tuple(canon_group_key(v) for v in r) for r in rows})
        result = list(rows)
        work = rows
        iters = 0
        while work:
            iters += 1
            if iters > 20000:
                raise SqlError("recursion depth limit exceeded in "
                               f'recursive query "{stmt.name}"')
            if len(result) > 50_000_000:
                raise SqlError(
                    f'recursive query "{stmt.name}" result too large')
            wt = Table.from_columns(stmt.name, {
                nm: column_from_values_fast(t, [r[i] for r in work])
                for i, (nm, t) in enumerate(zip(out_names, out_types))})
            pq2 = plan_query(stmt.rec, _ChainDb(stmt.name, wt, db))
            new = pq2.execute()
            if not stmt.union_all:
                fresh = []
                for r in new:
                    k = tuple(canon_group_key(v) for v in r)
                    if k not in seen:
                        seen.add(k)
                        fresh.append(r)
                new = fresh
            result.extend(new)
            work = new
        return result

    root = PlanNode("RecursiveUnion",
                    {"cte": stmt.name,
                     "union": "all" if stmt.union_all else "distinct"},
                    [base_pq.root],
                    cost=base_pq.root.cost)    # >= the base term's rows
    return PlannedQuery(out_names, out_types, run, root, base_pq.perfmon)


def _gs_single_pass(stmt, db, sets, all_keys, per_items, per_having,
                    nulled):
    """ONE finest-grain device aggregation for plain single-table
    grouping sets: run GROUP BY <all keys> once, then roll every coarser
    set up by merging the finest groups' STATES host-side (ROLLUP is a
    prefix lattice; merge_partials is the same operation chunk partials
    already merge with, so semantics are the engine's established
    two-phase contract).  Returns (produce, out_names, out_types, root,
    perfmon) or None -> the per-set subplan path (which also serves
    pg_strom.distributed, where each set rides the mesh).  Reference
    frame: gpupreagg.c:1988-2187 splices ONE node under the Agg
    regardless of grouping shape."""
    from ..exec.preagg_exec import PreAggExecutor, finalize_agg_states
    from ..ops.preagg import merge_partials
    if config.distributed:
        return None
    if len(stmt.frm) != 1 or stmt.joins or \
            stmt.frm[0].subquery is not None or getattr(stmt, "ctes", None):
        return None
    try:
        tbl = db.get(stmt.frm[0].name)
    except KeyError:
        return None
    if not isinstance(tbl, Table):
        return None
    alias = stmt.frm[0].alias or stmt.frm[0].name
    perfmon = Perfmon()
    try:
        scope = Scope(rels=[(alias, tbl)], db=db)
        bound_keys = [bind_expr(k, scope, allow_aggs=False)
                      for k in all_keys]
        bitems = [[bind_expr(it.expr, scope, allow_aggs=True)
                   for it in items_s] for items_s in per_items]
        bhavs = [bind_expr(h, scope, allow_aggs=True)
                 if h is not None else None for h in per_having]
        bwhere = (bind_expr(stmt.where, scope, allow_aggs=False)
                  if stmt.where is not None else None)
    except Exception:
        return None
    aggrefs: list = []
    for its, hv in zip(bitems, bhavs):
        for ag in _collect_aggrefs([(None, e) for e in its], hv):
            if ag not in aggrefs:
                aggrefs.append(ag)
    if any(ag.distinct for ag in aggrefs):
        return None                       # __distinct_seen__ can't merge
    projs = [[all_keys.index(e) for e in s] for s in sets]
    cur = rename_table(tbl, alias)
    layout = {n: i for i, n in enumerate(cur.column_names)}
    insts = []
    for ag in aggrefs:
        d, fam = lookup_agg(ag.aggname, tuple(a.type for a in ag.args),
                            star=ag.star)
        insts.append(AggInstance(
            aggname=ag.aggname, family=fam, slots=d.slots,
            args=tuple(bind_columns(a, layout) for a in ag.args),
            distinct=ag.distinct))
    bgroups = [bind_columns(g, layout) for g in bound_keys]
    bpred = bind_columns(bwhere, layout) if bwhere is not None else None
    set_keys = [[bound_keys[i] for i in proj] for proj in projs]

    out_names, out_types = [], []
    for p, it in enumerate(per_items[0]):
        j = next((j for j in range(len(sets)) if not nulled[j][p]), 0)
        out_names.append(it.alias or _default_name(it.expr, bitems[0][p]))
        out_types.append(bitems[j][p].type)

    def produce() -> list[tuple]:
        cur2 = rename_table(db.get(stmt.frm[0].name), alias)
        ex = PreAggExecutor(cur2, bpred, bgroups, insts, perfmon=perfmon)
        states, displays = ex.run_states()
        rows: list[tuple] = []
        for j in range(len(sets)):
            proj = projs[j]
            ms: dict = {}
            md: dict = {}
            for ck, st in states.items():
                nk = tuple(ck[i] for i in proj)
                if nk not in ms:
                    ms[nk] = st
                    md[nk] = tuple(displays[ck][i] for i in proj)
                else:
                    ms[nk] = [merge_partials(inst, a, b)
                              for inst, a, b in zip(insts, ms[nk], st)]
            raw = finalize_agg_states(set_keys[j], insts, ms, md)
            rows.extend(_finish_agg(raw, set_keys[j], aggrefs,
                                    [(None, e) for e in bitems[j]],
                                    bhavs[j], []))
        return rows

    root = PlanNode(
        "MixedAggregate",
        {"grouping_sets": len(sets), "strategy": "single-pass rollup"},
        [PlanNode("TpuPreAgg",
                  {"keys": ", ".join(fmt_expr(g) for g in bound_keys),
                   "finest": True}, [])])
    return produce, out_names, out_types, root, perfmon


def plan_grouping_sets(stmt: "ast.SelectStmt", db: Database) -> PlannedQuery:
    """GROUP BY ROLLUP / CUBE / GROUPING SETS — PG's MixedAggregate.
    Plain single-table shapes aggregate in ONE finest-grain device pass
    with host-side state rollup (_gs_single_pass); other shapes (joins,
    subqueries, distributed) desugar into one grouped subplan per set
    whose rows append.  Per set, grouping keys absent from the set render
    NULL in the select list, and GROUPING(e1..ek) folds to its constant
    bitmask.  ORDER BY / LIMIT / DISTINCT apply to the appended rows
    (output-column references only, like a set op)."""
    from .window import stmt_has_windows
    if stmt_has_windows(stmt):
        raise SqlError(
            "window functions with GROUPING SETS are not supported")
    sets = stmt.grouping_sets or [[]]
    all_keys: list = []
    for s in sets:
        for e in s:
            if e not in all_keys:
                all_keys.append(e)

    from ..ops.preagg import AGG_CATALOG
    aggnames = {name for name, _fam in AGG_CATALOG}

    def gs_rewrite(e, present: list):
        """NULL out grouping exprs not in this set; fold grouping() to
        its bitmask.  Does not descend into aggregate calls (their args
        aggregate normally) or subqueries."""
        if e is None:
            return None
        if isinstance(e, ast.AFunc) and e.name == "grouping" and e.args:
            mask = 0
            for a in e.args:
                if a not in all_keys:
                    raise SqlError("arguments to GROUPING must be "
                                   "grouping expressions of the query")
                mask = (mask << 1) | (0 if a in present else 1)
            return ast.ALiteral(mask)
        if e in all_keys:
            return e if e in present else ast.ALiteral(None)
        if isinstance(e, ast.AFunc) and e.name in aggnames:
            return e
        if isinstance(e, (ast.ASubquery, ast.AExists)):
            return e
        if isinstance(e, (list, tuple)):
            out = [gs_rewrite(x, present) for x in e]
            return type(e)(out) if isinstance(e, list) else tuple(out)
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            return dataclasses.replace(e, **{
                f.name: gs_rewrite(getattr(e, f.name), present)
                for f in dataclasses.fields(e)})
        return e

    def ast_has_agg(e) -> bool:
        """True if e contains an aggregate call at this query level
        (does not descend into subqueries, whose aggregates are theirs)."""
        if e is None:
            return False
        if isinstance(e, ast.AFunc) and e.name in aggnames:
            return True
        if isinstance(e, (ast.ASubquery, ast.AExists)):
            return False
        if isinstance(e, (list, tuple)):
            return any(ast_has_agg(x) for x in e)
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            return any(ast_has_agg(getattr(e, f.name))
                       for f in dataclasses.fields(e))
        return False

    per_items, per_having, nulled = [], [], []
    for s in sets:
        items_s = [ast.SelectItem(gs_rewrite(it.expr, s), it.alias)
                   for it in stmt.items]
        nulled.append([i2.expr == ast.ALiteral(None)
                       for i2 in items_s])
        per_items.append(items_s)
        per_having.append(gs_rewrite(stmt.having, s))

    single = _gs_single_pass(stmt, db, sets, all_keys, per_items,
                             per_having, nulled)
    if single is not None:
        produce, out_names, out_types, root, perfmon = single
    else:
        subplans, strip_last = [], []
        for s, items_s, having_s in zip(sets, per_items, per_having):
            strip = False
            if not s and not any(ast_has_agg(it.expr) for it in items_s) \
                    and not ast_has_agg(having_s):
                # GROUP BY () with no aggregates anywhere: PG still makes
                # exactly one group, but a plain projection would emit one
                # row per input row.  Inject count(*) so the subplan plans
                # as a one-row aggregate; strip the column at execution.
                items_s = items_s + [ast.SelectItem(
                    ast.AFunc("count", [], star=True), "__gs_one__")]
                strip = True
            strip_last.append(strip)
            sub = dataclasses.replace(
                stmt, items=items_s, group_by=list(s), grouping_sets=None,
                having=having_s, order_by=[], limit=None,
                offset=None, distinct=False, ctes=[])
            subplans.append(plan_query(sub, db))

        out_names = list(subplans[0].out_names)
        if strip_last[0]:
            out_names = out_names[:-1]
        out_types = []
        for p in range(len(out_names)):
            j = next((j for j in range(len(sets)) if not nulled[j][p]), 0)
            out_types.append(subplans[j].out_types[p])

        def produce() -> list[tuple]:
            rows: list[tuple] = []
            for sp, strip in zip(subplans, strip_last):
                got = sp.execute()
                if strip:
                    got = [r[:-1] for r in got]
                rows.extend(got)
            return rows

        root = PlanNode("MixedAggregate",
                        {"grouping_sets": len(sets)},
                        [sp.root for sp in subplans])
        perfmon = subplans[0].perfmon

    specs = []
    for oi in stmt.order_by:
        e = oi.expr
        if isinstance(e, ast.ALiteral) and isinstance(e.value, int) \
                and not e.is_string and 1 <= e.value <= len(out_names):
            pos = e.value - 1
        elif isinstance(e, ast.AName) and len(e.parts) == 1 \
                and e.parts[0] in out_names:
            pos = out_names.index(e.parts[0])
        elif e in [it.expr for it in stmt.items]:
            pos = [it.expr for it in stmt.items].index(e)
        else:
            raise SqlError("ORDER BY with GROUPING SETS must reference an "
                           "output column")
        specs.append((pos, oi.descending, oi.nulls_first))

    def run() -> list[tuple]:
        rows = produce()
        if stmt.distinct:
            rows = _dedupe_rows(rows)
        if specs:
            rows = _lexsort_rows(rows, specs, lambda r, i: r[i])
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return rows

    return PlannedQuery(out_names, out_types, run, root, perfmon)


def plan_setop(stmt: "ast.SetOpStmt", db: Database) -> PlannedQuery:
    """UNION / EXCEPT / INTERSECT [ALL].  PostgreSQL setop semantics:
    rows compare with NULLs equal and one NaN (canon_group_key, the same
    canonicalization DISTINCT/GROUP BY use); EXCEPT ALL keeps
    max(0, countL - countR) copies, INTERSECT ALL min(countL, countR)."""
    opname = stmt.op.upper()
    lpq = plan_query(stmt.left, db)
    rpq = plan_query(stmt.right, db)
    if len(lpq.out_types) != len(rpq.out_types):
        raise SqlError(f"each {opname} query must have the same number "
                       "of columns")
    for lt, rt in zip(lpq.out_types, rpq.out_types):
        if lt is not rt:
            raise SqlError(f"{opname} types {lt.value} and {rt.value} "
                           "cannot be matched")
    out_names, out_types = list(lpq.out_names), list(lpq.out_types)
    perfmon = Perfmon()

    def run() -> list[tuple]:
        lrows = list(lpq.execute())
        rrows = list(rpq.execute())
        if stmt.op == "union":
            rows = lrows + rrows
            if not stmt.all:
                rows = _dedupe_rows(rows)
        else:
            rows = _setop_rows(stmt.op, stmt.all, lrows, rrows)
        if stmt.order_by:
            rows = _sort_rows_by_output(rows, stmt.order_by, out_names)
        if stmt.offset:
            rows = rows[stmt.offset:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return rows

    label = opname + (" ALL" if stmt.all else "")
    if stmt.op == "union":
        root = PlanNode("Append", {"op": label}, [lpq.root, rpq.root])
        if not stmt.all:
            root = PlanNode("Unique", {"op": label}, [root])
    else:
        # PG renders these as HashSetOp Except / HashSetOp Intersect
        root = PlanNode("HashSetOp", {"op": label}, [lpq.root, rpq.root])
    return PlannedQuery(out_names, out_types, run, root, perfmon)


def _setop_rows(op: str, all_: bool, lrows: list, rrows: list) -> list:
    """EXCEPT / INTERSECT row arithmetic over canonical row keys.
    Output rows come from the left input in left order (PG's hashed
    setop also emits left-side tuples)."""
    from ..exec.hostexec import canon_group_key
    from collections import Counter

    def key(r: tuple) -> tuple:
        return tuple(canon_group_key(v) for v in r)

    rcnt = Counter(key(r) for r in rrows)
    out: list[tuple] = []
    if op == "except":
        if all_:
            rem = dict(rcnt)
            for r in lrows:
                k = key(r)
                if rem.get(k, 0) > 0:
                    rem[k] -= 1
                else:
                    out.append(r)
        else:
            seen: set = set()
            for r in lrows:
                k = key(r)
                if k not in rcnt and k not in seen:
                    seen.add(k)
                    out.append(r)
    elif op == "intersect":
        if all_:
            rem = dict(rcnt)
            for r in lrows:
                k = key(r)
                if rem.get(k, 0) > 0:
                    rem[k] -= 1
                    out.append(r)
        else:
            seen = set()
            for r in lrows:
                k = key(r)
                if k in rcnt and k not in seen:
                    seen.add(k)
                    out.append(r)
    else:  # pragma: no cover - parser only produces the three ops
        raise SqlError(f"unknown set operation {op!r}")
    return out


def _sort_rows_by_output(rows, order_by, out_names) -> list[tuple]:
    """ORDER BY over a set-op result: output names / ordinals only (PG
    requires ORDER BY of a UNION to reference output columns)."""
    specs = []
    for oi in order_by:
        if isinstance(oi.expr, ast.ALiteral) and isinstance(oi.expr.value, int) \
                and not oi.expr.is_string:
            i = oi.expr.value - 1
        elif isinstance(oi.expr, ast.AName) and len(oi.expr.parts) == 1 \
                and oi.expr.parts[0] in out_names:
            i = out_names.index(oi.expr.parts[0])
        else:
            raise SqlError("ORDER BY on a UNION must name an output column")
        specs.append((i, oi.descending, oi.nulls_first))

    return _lexsort_rows(rows, specs, lambda r, i: r[i])
