"""Cost model: host-vs-TPU plan selection.

TPU-native re-creation of the reference's cost functions, driven by the same
GUC taxonomy (config.tpu_setup_cost / tpu_operator_cost / tpu_tuple_cost vs
the cpu_* / seq_page_cost defaults):

  cost_seqscan / cost_tpuscan     reference gpuscan.c:101-231 (cost_gpuscan:
                                  disk + gpu_setup + gpu-per-tuple dev quals
                                  + cpu-per-tuple on the selected fraction)
  cost_hashjoin / cost_tpuhashjoin reference gpuhashjoin.c:438-668
                                  (cost_gpuhashjoin + final_cost_gpuhashjoin:
                                  build-side host hashing at cpu cost, probe
                                  at gpu_operator_cost per hash clause)
  cost_hostagg / cost_tpupreagg   reference gpupreagg.c:366-470
                                  (cost_gpupreagg: setup + per-chunk sort
                                  log2 term + per-row gpu operator cost)

Selectivity estimation follows PostgreSQL's defaults where the reference
leans on clauselist_selectivity (DEFAULT_EQ_SEL = 0.005,
DEFAULT_INEQ_SEL = 1/3, DEFAULT_RANGE_INEQ_SEL implied by products); we own
the datastore, so row counts are exact rather than estimated.

The planner (plan/planner.py) compares each Tpu* path against its host twin
and offloads only when the TPU path is cheaper — unless
config.debug_force_offload / debug_force_tpupreagg force the device plan the
way pg_strom.debug_force_gpupreagg does in the regression conf
(input/enable.conf; gpupreagg.c:2947+).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from ..config import config
from ..sqltypes import T
from ..expr.ir import (
    Expr, Const, ColumnRef, FuncExpr, BoolExpr, NullTest, BooleanTest,
    CaseExpr, CoalesceExpr, Aggref, walk,
)

# PostgreSQL selectivity defaults (selfuncs.h)
DEFAULT_EQ_SEL = 0.005
DEFAULT_INEQ_SEL = 1.0 / 3.0
DEFAULT_SEL = 0.5

_TYPE_WIDTH = {
    T.BOOL: 1, T.INT2: 2, T.INT4: 4, T.INT8: 8,
    T.FLOAT4: 4, T.FLOAT8: 8, T.NUMERIC: 12,
    T.DATE: 4, T.TIME: 8, T.TIMESTAMP: 8,
    T.TEXT: 16, T.BPCHAR: 16,
}


def type_width(t: T) -> int:
    return _TYPE_WIDTH.get(t, 8)


@dataclasses.dataclass
class Cost:
    """A path cost: PostgreSQL's (startup_cost, total_cost) pair plus the
    output row estimate and tuple width the parent node plans with."""
    startup: float = 0.0
    total: float = 0.0
    rows: float = 0.0
    width: int = 0

    def render(self) -> str:
        return (f"(cost={self.startup:.2f}..{self.total:.2f} "
                f"rows={max(int(round(self.rows)), 0)} width={self.width})")


def expr_cost_per_tuple(e: Optional[Expr]) -> float:
    """Per-tuple evaluation cost of an expression tree: one
    cpu_operator_cost per function/operator node (cost_qual_eval analog)."""
    if e is None:
        return 0.0
    n = 0
    for node in walk(e):
        if isinstance(node, (FuncExpr, BoolExpr, NullTest, BooleanTest,
                             CaseExpr, CoalesceExpr, Aggref)):
            n += 1
    return n * config.cpu_operator_cost


def quals_cost_per_tuple(quals: Sequence[Expr]) -> float:
    return sum(expr_cost_per_tuple(q) for q in quals)


def _const_as_float(v) -> float | None:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _col_const(e: FuncExpr):
    """(ColumnRef, Const, op) for a binary compare, flipping the operator
    when the clause is written const-op-column; None otherwise."""
    op = e.fname.split("::", 1)[0]
    if len(e.args) != 2:
        return None
    a, b = e.args
    if isinstance(a, ColumnRef) and isinstance(b, Const):
        return a, b, op
    if isinstance(a, Const) and isinstance(b, ColumnRef):
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        return b, a, flip.get(op, op)
    return None


def clause_selectivity(e: Optional[Expr], stats=None) -> float:
    """Selectivity with real column statistics when `stats` (a callable:
    qualified column name -> datastore.ColumnStats | None) is supplied —
    1/ndistinct for equality, min/max linear interpolation for range
    compares, null_count for NULL tests (PostgreSQL eqsel/scalarineqsel
    shapes, selfuncs.c) — falling back to the hardcoded defaults the
    reference planner would inherit from a stats-less pg_statistic."""
    if e is None:
        return 1.0
    if isinstance(e, BoolExpr):
        if e.op == "and":
            s = 1.0
            for a in e.args:
                s *= clause_selectivity(a, stats)
            return s
        if e.op == "or":
            s = 0.0
            for a in e.args:
                sa = clause_selectivity(a, stats)
                s = s + sa - s * sa
            return s
        if e.op == "not":
            return 1.0 - clause_selectivity(e.args[0], stats)
    if isinstance(e, FuncExpr):
        op = e.fname.split("::", 1)[0]
        cc = _col_const(e) if stats is not None else None
        st = stats(cc[0].name) if cc is not None else None
        if st is not None and st.n_valid > 0:
            col, konst, op = cc[0], cc[1], cc[2]
            nonnull = st.n_valid / max(st.nrows, 1)
            k = _const_as_float(konst.value)
            if op in ("=", "<>"):
                sel = (1.0 / st.ndistinct) if st.ndistinct else DEFAULT_EQ_SEL
                if (k is not None and st.min_val is not None
                        and not (float(st.min_val) <= k <= float(st.max_val))):
                    sel = 1.0 / max(st.nrows, 1.0)   # outside observed range
                sel *= nonnull
                return sel if op == "=" else max(nonnull - sel, 0.0)
            if (op in ("<", "<=", ">", ">=") and k is not None
                    and st.min_val is not None):
                lo, hi = float(st.min_val), float(st.max_val)
                if hi > lo:
                    frac = (k - lo) / (hi - lo)
                else:
                    frac = 0.5 if lo <= k <= hi else (0.0 if k < lo else 1.0)
                frac = min(max(frac, 0.0), 1.0)
                if op in (">", ">="):
                    frac = 1.0 - frac
                # clamp to PostgreSQL's interpolation floor/ceiling
                return min(max(frac, 1.0e-4), 1.0 - 1.0e-4) * nonnull
        if op == "=":
            return DEFAULT_EQ_SEL
        if op == "<>":
            return 1.0 - DEFAULT_EQ_SEL
        if op in ("<", "<=", ">", ">="):
            return DEFAULT_INEQ_SEL
    if isinstance(e, NullTest):
        if stats is not None and isinstance(e.arg, ColumnRef):
            st = stats(e.arg.name)
            if st is not None and st.nrows > 0:
                nf = st.null_count / st.nrows
                return nf if e.isnull else 1.0 - nf
        return DEFAULT_EQ_SEL if e.isnull else 1.0 - DEFAULT_EQ_SEL
    if isinstance(e, Const) and e.type is T.BOOL:
        return 1.0 if e.value else 0.0
    return DEFAULT_SEL


def quals_selectivity(quals: Sequence[Expr], stats=None) -> float:
    s = 1.0
    for q in quals:
        s *= clause_selectivity(q, stats)
    return s


def eq_join_selectivity(clause: Expr, stats=None) -> float:
    """Equi-join clause selectivity: 1 / max(nd_left, nd_right) (System R /
    PostgreSQL eqjoinsel without MCVs); DEFAULT_EQ_SEL without stats."""
    if stats is None or not isinstance(clause, FuncExpr) \
            or len(clause.args) != 2:
        return DEFAULT_EQ_SEL
    nds = []
    for a in clause.args:
        if isinstance(a, ColumnRef):
            st = stats(a.name)
            if st is not None and st.ndistinct:
                nds.append(st.ndistinct)
    if not nds:
        return DEFAULT_EQ_SEL
    return 1.0 / max(max(nds), 1.0)


def _pages(nrows: float, width: int) -> float:
    """Heap pages the relation would occupy (8KB pages, ~24B tuple header —
    the disk-cost term both scan paths share, cost_gpuscan gpuscan.c:130)."""
    return max(nrows * (width + 24) / 8192.0, 1.0)


def rel_width(types: Sequence[T]) -> int:
    return sum(type_width(t) for t in types)


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------

def cost_seqscan(nrows: float, width: int, quals: Sequence[Expr],
                 stats=None) -> Cost:
    """Plain host scan: disk + cpu_tuple_cost + qual eval per tuple."""
    run = config.seq_page_cost * _pages(nrows, width)
    per_tuple = config.cpu_tuple_cost + quals_cost_per_tuple(quals)
    run += per_tuple * nrows
    sel = quals_selectivity(quals, stats)
    return Cost(0.0, run, nrows * sel, width)


def cost_tpuscan(nrows: float, width: int, dev_quals: Sequence[Expr],
                 host_quals: Sequence[Expr], stats=None) -> Cost:
    """TPU scan (cost_gpuscan, gpuscan.c:101-167): disk cost + setup +
    device quals at the TPU per-tuple rate + host quals and tuple cost only
    on rows the device filter passes."""
    run = config.seq_page_cost * _pages(nrows, width)
    dev_per_tuple = quals_cost_per_tuple(dev_quals)
    if config.cpu_tuple_cost > 0.0:
        dev_per_tuple *= config.tpu_tuple_cost / config.cpu_tuple_cost
    dev_sel = quals_selectivity(dev_quals, stats)
    startup = config.tpu_setup_cost
    cpu_per_tuple = quals_cost_per_tuple(host_quals) + config.cpu_tuple_cost
    run += dev_per_tuple * nrows + cpu_per_tuple * dev_sel * nrows
    sel = dev_sel * quals_selectivity(host_quals, stats)
    return Cost(startup, startup + run, nrows * sel, width)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def cost_hashjoin(outer: Cost, inner: Cost, n_hash_clauses: int,
                  out_width: int, eq_sel: float | None = None) -> Cost:
    """Host hash join (initial_cost_hashjoin shape): hash the inner side at
    cpu cost, probe each outer row at cpu_operator_cost per clause."""
    nhc = max(n_hash_clauses, 1)
    startup = (outer.startup + inner.total
               + (config.cpu_operator_cost * nhc + config.cpu_tuple_cost)
               * inner.rows)
    run = (outer.total - outer.startup
           + (config.cpu_operator_cost * nhc + config.cpu_tuple_cost)
           * outer.rows)
    sel = eq_sel if eq_sel is not None else DEFAULT_EQ_SEL ** nhc
    rows = max(outer.rows * inner.rows * sel, 1.0)
    return Cost(startup, startup + run, rows, out_width)


def cost_tpuhashjoin(outer: Cost, inners: Sequence[Cost],
                     n_hash_clauses_per_inner: Sequence[int],
                     out_width: int,
                     eq_sels: Sequence[float] | None = None) -> Cost:
    """TPU hash join (cost_gpuhashjoin, gpuhashjoin.c:438-498): the build
    side is hashed host-side at cpu cost (multihash_preload analog), the
    probe runs on device at tpu_operator_cost per hash clause, plus the
    fixed device setup cost.  N-way: every inner adds its build cost to
    startup (the multi-rel chain shares one probe pass)."""
    startup = outer.startup + config.tpu_setup_cost
    nhc_total = 0
    rows = outer.rows
    for i, (inner, nhc) in enumerate(zip(inners, n_hash_clauses_per_inner)):
        nhc = max(nhc, 1)
        nhc_total += nhc
        startup += inner.total
        startup += (config.cpu_operator_cost * nhc
                    + config.cpu_tuple_cost) * inner.rows
        sel = (eq_sels[i] if eq_sels is not None and i < len(eq_sels)
               else DEFAULT_EQ_SEL ** nhc)
        rows *= inner.rows * sel
    run = (outer.total - outer.startup
           + config.tpu_operator_cost * nhc_total * outer.rows)
    return Cost(startup, startup + run, max(rows, 1.0), out_width)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def cost_hostagg(input_cost: Cost, n_aggs: int, n_group_cols: int,
                 n_groups: float, out_width: int) -> Cost:
    """Host aggregation (PostgreSQL cost_agg shape): one transition call per
    agg per input row, one per-output-row finalization."""
    n_aggs = max(n_aggs, 1)
    startup = input_cost.total
    startup += config.cpu_operator_cost * n_aggs * input_cost.rows
    startup += config.cpu_operator_cost * n_group_cols * input_cost.rows
    run = (config.cpu_operator_cost * n_aggs + config.cpu_tuple_cost) \
        * n_groups
    return Cost(startup, startup + run, n_groups, out_width)


def cost_tpupreagg(input_cost: Cost, n_aggs: int, n_group_cols: int,
                   n_groups: float, out_width: int) -> Cost:
    """TPU two-phase aggregation (cost_gpupreagg, gpupreagg.c:366-470):
    device setup + per-chunk grouping term + per-row device transition cost,
    then host finalization over num_groups * num_chunks partial rows."""
    n_aggs = max(n_aggs, 1)
    startup = input_cost.total + config.tpu_setup_cost
    rows_per_chunk = float(config.chunk_rows)
    num_chunks = max(input_cost.rows / rows_per_chunk, 1.0)
    # per-chunk grouping cost: the reference pays a bitonic-sort log2 ladder
    # (gpupreagg.c:428-432); the MXU one-hot grouping is one matmul pass,
    # same log-shaped accounting keeps the knobs comparable
    comparison_cost = 2.0 * config.tpu_operator_cost
    eff_rows = min(rows_per_chunk, max(input_cost.rows, 1.0))
    startup += comparison_cost * math.log2(max(eff_rows * eff_rows, 2.0)) \
        * num_chunks
    run = config.tpu_operator_cost * (n_aggs + n_group_cols) \
        * input_cost.rows
    # host finalization over the partial rows coming back per chunk
    partial_rows = n_groups * num_chunks
    run += (config.cpu_operator_cost * n_aggs + config.cpu_tuple_cost) \
        * partial_rows
    return Cost(startup, startup + run, n_groups, out_width)


def estimate_num_groups(nrows: float, n_group_cols: int,
                        group_exprs: Sequence[Expr] | None = None,
                        stats=None) -> float:
    """Group-count estimate.  With statistics (`stats`: qualified column
    name -> ColumnStats), the per-column ndistinct product is scaled by
    PostgreSQL's occupancy formula d * (1 - (1 - n/N)^(N/d))
    (estimate_num_groups, selfuncs.c) so a filtered input prices fewer
    groups; without stats, the old min(nrows/10, 200*cols) fallback."""
    if n_group_cols == 0:
        return 1.0
    if group_exprs and stats is not None:
        d_total = 1.0
        n_table = None
        missing = False
        for ge in group_exprs:
            cols = [n for n in walk(ge) if isinstance(n, ColumnRef)]
            if not cols:
                missing = True
                break
            d_e = 1.0
            for c in cols:
                st = stats(c.name)
                if st is None or not st.ndistinct:
                    missing = True
                    break
                d_e *= max(st.ndistinct + (1.0 if st.null_count else 0.0),
                           1.0)
                n_table = max(n_table or 0.0, float(st.nrows))
            if missing:
                break
            d_total *= d_e
        if not missing and n_table:
            d = min(d_total, n_table)
            n = max(min(nrows, n_table), 1.0)
            if d > 0 and n < n_table:
                # occupancy: expected distinct values in an n-row sample of
                # an N-row table with d distinct values
                d = d * (1.0 - (1.0 - n / n_table) ** (n_table / d))
            return max(min(d, nrows), 1.0)
    return max(min(nrows / 10.0, 200.0 * n_group_cols), 1.0)
