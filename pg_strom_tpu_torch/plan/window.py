"""Window functions: func(args) OVER (PARTITION BY ... ORDER BY ...).

The reference runs window functions on the PostgreSQL CPU executor (its
GPU paths cover scan/join/preagg only — gpupreagg.c's aggregate catalog
has no window entries); here the engine IS the database, so WindowAgg is
a host tier layered over the device pipeline, the same split the
reference ships.

Execution is a three-stage desugar that reuses the whole engine:

  1. INNER: the original query minus the window calls, its items replaced
     by the distinct window-free component expressions (__c0..__cN) that
     the select list, the window argument/partition/order expressions,
     and the outer ORDER BY need.  This stage keeps FROM/WHERE/GROUP BY/
     HAVING — so windows over grouped queries, joins and device-offloaded
     scans all work — and is planned by the normal planner (device
     kernels included).
  2. WINDOW: per partition (canon_group_key equality, the GROUP BY/
     DISTINCT canonicalization), rows sort by the window ORDER BY with
     PostgreSQL null ordering, peer groups are rows tied on every sort
     key, and each function computes with PG default-frame semantics
     (RANGE UNBOUNDED PRECEDING..CURRENT ROW with ORDER BY, the whole
     partition without).  Aggregate windows run the SAME exact host
     transition functions as the aggregate engine (hostexec.update_state
     + AGG_CATALOG finals), so sum/avg/stddev/... match PG bit-for-bit.
  3. POST: the rewritten select list (windows -> __wJ columns) over a
     temp table of components + window values, planned by the normal
     planner again — DISTINCT / ORDER BY / LIMIT land here, in PG's
     evaluation order (windows compute before DISTINCT).

Frame clauses, nested windows, DISTINCT inside a window call and
SELECT * alongside a window are rejected up front.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

from ..sqltypes import T
from ..errors import SqlError
from ..sql import parser as ast
from ..pgops import cmp_values
from ..exec.hostexec import canon_group_key, new_state, update_state
from ..ops.preagg import AggInstance, lookup_agg

_RANKERS = ("row_number", "rank", "dense_rank")
_OFFSETS = ("lag", "lead", "first_value", "last_value")


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _contains_window(v: Any) -> bool:
    """Any AWindow in this AST fragment, not descending into subqueries
    (their windows belong to their own SELECT's scope)."""
    if isinstance(v, ast.AWindow):
        return True
    if isinstance(v, (ast.ASubquery, ast.AExists, ast.SelectStmt,
                      ast.SetOpStmt)):
        return False
    if isinstance(v, (list, tuple)):
        return any(_contains_window(x) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return any(_contains_window(getattr(v, f.name))
                   for f in dataclasses.fields(v))
    return False


def stmt_has_windows(stmt: "ast.SelectStmt") -> bool:
    """True when this SELECT needs the WindowAgg tier; raises for window
    calls in clauses PostgreSQL forbids them in."""
    found = any(_contains_window(it.expr) for it in stmt.items) or \
        any(_contains_window(oi.expr) for oi in stmt.order_by)
    for clause, label in ((stmt.where, "WHERE"),
                          (stmt.group_by, "GROUP BY"),
                          (stmt.having, "HAVING")):
        if clause is not None and _contains_window(clause):
            raise SqlError(
                f"window functions are not allowed in {label}")
    for jc in stmt.joins:
        if jc.on is not None and _contains_window(jc.on):
            raise SqlError("window functions are not allowed in JOIN/ON")
    return found


# ---------------------------------------------------------------------------
# rewrite: windows -> __wJ, window-free subtrees -> __cI
# ---------------------------------------------------------------------------

class _Rewriter:
    def __init__(self):
        self.comps: list = []       # distinct window-free component exprs
        self.wins: list = []        # distinct AWindow nodes

    def comp_idx(self, e) -> int:
        for i, c in enumerate(self.comps):
            if c == e:
                return i
        self.comps.append(e)
        return len(self.comps) - 1

    def _win_ref(self, w: ast.AWindow) -> ast.AName:
        if _contains_window(w.func.args) or _contains_window(w.partition) \
                or _contains_window([oi.expr for oi in w.order]):
            raise SqlError("window function calls cannot be nested")
        for j, c in enumerate(self.wins):
            if c == w:
                return ast.AName((f"__w{j}",))
        self.wins.append(w)
        return ast.AName((f"__w{len(self.wins) - 1}",))

    def rewrite(self, e):
        """Replace every AWindow with its __wJ column and every MAXIMAL
        window-free subtree with a __cI component column (literals stay
        inline — no point shipping constant columns through the inner)."""
        if isinstance(e, ast.AWindow):
            return self._win_ref(e)
        if not _contains_window(e):
            if isinstance(e, ast.ALiteral):
                return e
            return ast.AName((f"__c{self.comp_idx(e)}",))
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            return dataclasses.replace(e, **{
                f.name: self._rw_val(getattr(e, f.name))
                for f in dataclasses.fields(e)})
        return e

    def _rw_val(self, v):
        if isinstance(v, list):
            return [self._rw_val(x) for x in v]
        if isinstance(v, tuple):
            return tuple(self._rw_val(x) for x in v)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return self.rewrite(v)
        return v


@dataclasses.dataclass
class _WinSpec:
    fname: str
    star: bool
    arg_idx: Optional[int]          # component index of arg0 (None: none)
    offset: int                     # lag/lead offset (literal)
    default_idx: Optional[int]      # lag/lead default component
    part_idx: list                  # partition component indexes
    order: list                     # (comp_idx, descending, nulls_first)
    # aggregate windows only, resolved at plan time (ops/preagg catalog)
    _adef: Any = None
    _fam: str = ""


def _build_spec(w: ast.AWindow, rw: _Rewriter) -> _WinSpec:
    f = w.func
    if f.distinct:
        raise SqlError("DISTINCT is not implemented for window functions")
    arg_idx = default_idx = None
    offset = 1
    if f.name in _RANKERS:
        if f.args or f.star:
            raise SqlError(f"{f.name}() takes no arguments")
    elif f.name in _OFFSETS:
        if f.star or not f.args:
            raise SqlError(f"{f.name}() requires an argument")
        arg_idx = rw.comp_idx(f.args[0])
        if f.name in ("lag", "lead"):
            if len(f.args) >= 2:
                off = f.args[1]
                if not (isinstance(off, ast.ALiteral)
                        and isinstance(off.value, int)
                        and not off.is_string):
                    raise SqlError(f"{f.name}() offset must be an integer "
                                   "literal")
                offset = off.value
            if len(f.args) >= 3:
                default_idx = rw.comp_idx(f.args[2])
            if len(f.args) > 3:
                raise SqlError(f"{f.name}() takes at most 3 arguments")
        elif len(f.args) > 1:
            raise SqlError(f"{f.name}() takes 1 argument")
    else:
        # aggregate-as-window: resolved against the engine's AGG_CATALOG
        if not f.star:
            if len(f.args) != 1:
                raise SqlError(f'window aggregate "{f.name}" supports '
                               "exactly one argument")
            arg_idx = rw.comp_idx(f.args[0])
    part_idx = [rw.comp_idx(e) for e in w.partition]
    order = [(rw.comp_idx(oi.expr), oi.descending, oi.nulls_first)
             for oi in w.order]
    return _WinSpec(f.name, f.star, arg_idx, offset, default_idx,
                    part_idx, order)


_NUM_CHAIN = (T.INT2, T.INT4, T.INT8, T.NUMERIC, T.FLOAT4, T.FLOAT8)


def _common_type(a: T, b: T) -> Optional[T]:
    """PG select_common_type for the lag/lead anyelement pair: identical,
    the numeric promotion chain, or date->timestamp; None = no common
    type (PG raises at plan time)."""
    if a == b:
        return a
    if a in _NUM_CHAIN and b in _NUM_CHAIN:
        return _NUM_CHAIN[max(_NUM_CHAIN.index(a), _NUM_CHAIN.index(b))]
    if {a, b} == {T.DATE, T.TIMESTAMP}:
        return T.TIMESTAMP
    return None


def _win_type(spec: _WinSpec, ctypes: list) -> T:
    if spec.fname in _RANKERS:
        return T.INT8
    if spec.fname in _OFFSETS:
        at = ctypes[spec.arg_idx]
        if spec.default_idx is not None:
            ct = _common_type(at, ctypes[spec.default_idx])
            if ct is None:
                raise SqlError(
                    f"{spec.fname}() default must be coercible to the "
                    f"argument type")
            return ct
        return at
    argts = () if spec.star or spec.arg_idx is None \
        else (ctypes[spec.arg_idx],)
    adef, _fam = lookup_agg(spec.fname, argts, star=spec.star)
    return adef.rettype


# ---------------------------------------------------------------------------
# window computation (PG default-frame semantics)
# ---------------------------------------------------------------------------
#
# The fast path vectorizes with numpy (a per-row comparator sort and a
# Python partition dict would make a 4M-row rank() take minutes):
# partition/order keys encode to order-preserving int64 (the same
# _encode_sort_column ORDER BY uses), one global np.lexsort groups
# partitions AND orders within them, boundaries come from adjacent-key
# compares, and each function computes from positional arrays.  Aggregate
# windows with float/numeric transitions keep the bit-exact sequential
# host transitions (addition is not associative; prefix-subtract would
# drift an ulp from PG's per-partition running sums) but still ride the
# vectorized sort + boundaries.  Unencodable keys fall back to the exact
# per-row path below.

_FAST_MIN_ROWS = 256        # below this the python path wins; tests set 0


def _window_values(spec: _WinSpec, rows: list, ctypes: list) -> list:
    n = len(rows)
    if n <= _FAST_MIN_ROWS:
        return _window_values_slow(spec, rows, ctypes)
    import numpy as np
    from .planner import _encode_sort_column

    enc_cache: dict = {}

    def enc_col(idx):
        if idx not in enc_cache:
            vals = [r[idx] for r in rows]
            nulls = np.fromiter((v is None for v in vals), np.bool_, n)
            e = _encode_sort_column(vals, nulls)
            enc_cache[idx] = None if e is None else (e, nulls)
        return enc_cache[idx]

    for idx in spec.part_idx + [i for (i, _, _) in spec.order]:
        if enc_col(idx) is None:
            return _window_values_slow(spec, rows, ctypes)

    # global sort: np.lexsort's LAST key is primary, so partition keys go
    # last; lexsort is stable, preserving input order for full ties (the
    # same tie order as the python sorted() the slow path uses)
    arrays: list = []
    for i, desc, nf in reversed(spec.order):
        e, nulls = enc_col(i)
        enc = (np.int64(-1) - e) if desc else e
        enc = np.where(nulls, np.int64(0), enc)
        nulls_first = desc if nf is None else nf
        nkey = np.where(nulls, np.int8(-1 if nulls_first else 1),
                        np.int8(0))
        arrays.append(enc)
        arrays.append(nkey)
    for p in reversed(spec.part_idx):
        e, nulls = enc_col(p)
        arrays.append(np.where(nulls, np.int64(0), e))
        arrays.append(nulls.astype(np.int8))
    order = (np.lexsort(tuple(arrays)) if arrays
             else np.arange(n, dtype=np.int64))

    # boundaries in sorted coordinates
    new_part = np.zeros(n, np.bool_)
    new_part[0] = True
    for p in spec.part_idx:
        e, nulls = enc_col(p)
        es = np.where(nulls, np.int64(0), e)[order]
        ns = nulls[order]
        new_part[1:] |= (es[1:] != es[:-1]) | (ns[1:] != ns[:-1])
    new_peer = new_part.copy()
    for i, _desc, _nf in spec.order:
        e, nulls = enc_col(i)
        es = np.where(nulls, np.int64(0), e)[order]
        ns = nulls[order]
        new_peer[1:] |= (es[1:] != es[:-1]) | (ns[1:] != ns[:-1])

    idx = np.arange(n, dtype=np.int64)
    part_start = np.maximum.accumulate(np.where(new_part, idx, 0))
    peer_start = np.maximum.accumulate(np.where(new_peer, idx, 0))
    next_new = np.empty(n, np.bool_)
    next_new[:-1] = new_peer[1:]
    next_new[-1] = True
    peer_end = np.minimum.accumulate(
        np.where(next_new, idx, n)[::-1])[::-1]

    def scatter_ints(vals_sorted) -> list:
        res = np.empty(n, np.int64)
        res[order] = vals_sorted
        return res.tolist()

    def gather_obj(col_idx):
        ov = np.empty(n, object)
        ov[:] = [r[col_idx] for r in rows]
        return ov[order]                 # values in sorted coordinates

    def scatter_obj(vals_sorted) -> list:
        res = np.empty(n, object)
        res[order] = vals_sorted
        return res.tolist()

    f = spec.fname
    if f == "row_number":
        return scatter_ints(idx - part_start + 1)
    if f == "rank":
        return scatter_ints(peer_start - part_start + 1)
    if f == "dense_rank":
        c = np.cumsum(new_peer.astype(np.int64))
        return scatter_ints(c - c[part_start] + 1)
    if f in ("lag", "lead"):
        off = spec.offset if f == "lag" else -spec.offset
        src = idx - np.int64(off)
        valid = (src >= 0) & (src < n)
        srcc = np.clip(src, 0, n - 1)
        valid &= part_start[srcc] == part_start
        av = gather_obj(spec.arg_idx)
        res = np.where(valid, av[srcc], None)
        if spec.default_idx is not None:
            # PG: the default expression evaluates at the CURRENT row
            dv = gather_obj(spec.default_idx)
            res = np.where(valid, res, dv)
        return scatter_obj(res)
    if f == "first_value":
        av = gather_obj(spec.arg_idx)
        return scatter_obj(av[part_start])
    if f == "last_value":
        # default frame ends at the CURRENT ROW's last peer (the classic
        # PG last_value gotcha) — whole partition without ORDER BY
        av = gather_obj(spec.arg_idx)
        return scatter_obj(av[peer_end])
    if f == "count":
        if spec.star:
            return scatter_ints(peer_end - part_start + 1)
        vals = [r[spec.arg_idx] for r in rows]
        nn = np.fromiter((v is not None for v in vals), np.int64, n)[order]
        pre = np.cumsum(nn)
        return scatter_ints(pre[peer_end] - pre[part_start]
                            + nn[part_start])
    if f in ("min", "max"):
        got = _minmax_window_fast(spec, rows, np, enc_col, order,
                                  new_part, idx, peer_end, scatter_obj)
        if got is not None:
            return got
    got = _agg_window_int_fast(spec, rows, np, order, new_part, new_peer,
                               idx, part_start, peer_end, scatter_obj)
    if got is not None:
        return got
    # exact sequential transitions over the vectorized sort + boundaries
    return _agg_window_sequential(spec, rows, order, new_part, next_new)


def _minmax_window_fast(spec, rows, np, enc_col, order, new_part, idx,
                        peer_end, scatter_obj):
    """Segmented running min/max, fully vectorized and exact: encode the
    argument order-preservingly, densify to ranks (< 2^31), pack
    (partition ordinal << 32 | rank+1) into one int64 — partition
    ordinals increase along the sorted order, so a global
    maximum.accumulate never lets an earlier partition's max leak into
    the current one.  Display value is the EARLIEST occurrence of the
    extreme (strict-increase detection), matching the host transition's
    keep-on-tie (visible for Decimal 1.5 vs 1.50 and -0.0 vs 0.0)."""
    got = enc_col(spec.arg_idx)
    if got is None:
        return None
    e, nulls = got
    n = len(rows)
    es = e[order]
    ns = nulls[order]
    uniq, inv = np.unique(es, return_inverse=True)
    if len(uniq) >= (1 << 31):
        return None
    rank = inv.astype(np.int64) + 1          # 0 reserved for NULL
    if spec.fname == "min":
        rank = np.int64(len(uniq) + 1) - rank
    rank = np.where(ns, np.int64(0), rank)
    part_ord = np.cumsum(new_part.astype(np.int64)) - 1
    comp = (part_ord << np.int64(32)) | rank
    run = np.maximum.accumulate(comp)
    prev = np.empty(n, np.int64)
    prev[0] = np.int64(-1)
    prev[1:] = run[:-1]
    isnew = comp > prev
    arg = np.maximum.accumulate(np.where(isnew, idx, np.int64(-1)))
    have = (run & np.int64(0xFFFFFFFF)) > 0  # partition saw a non-null
    av = np.empty(n, object)
    av[:] = [r[spec.arg_idx] for r in rows]
    av = av[order]
    res = np.where(have[peer_end], av[np.clip(arg[peer_end], 0, n - 1)],
                   None)
    return scatter_obj(res)


def _agg_window_int_fast(spec, rows, np, order, new_part, new_peer, idx,
                         part_start, peer_end, scatter_obj):
    """Integer-slot aggregate windows (sum/avg/variance over int args):
    python-int prefix sums on object arrays — exact at any magnitude
    (integer addition is associative, so prefix-subtract is the same
    value the sequential transition computes) — with finals evaluated
    once per peer group, like the sequential path."""
    adef, fam = spec._adef, spec._fam
    if adef is None or spec.star or spec.arg_idx is None:
        return None
    if not set(adef.slots) <= {"nrows", "count", "sum_i", "sumsq_i"}:
        return None
    n = len(rows)
    vals = [r[spec.arg_idx] for r in rows]
    nn = np.fromiter((v is not None for v in vals), np.int64, n)[order]
    iv = np.empty(n, object)
    iv[:] = [0 if v is None else int(v) for v in vals]
    iv = iv[order]
    pre_n = np.cumsum(nn)
    cnt = pre_n[peer_end] - pre_n[part_start] + nn[part_start]
    nrows = peer_end - part_start + 1
    pre_s = np.cumsum(iv)
    tot = pre_s[peer_end] - pre_s[part_start] + iv[part_start]
    if "sumsq_i" in adef.slots:
        sq = iv * iv
        pre_q = np.cumsum(sq)
        totq = pre_q[peer_end] - pre_q[part_start] + sq[part_start]
    gid = np.cumsum(new_peer.astype(np.int64)) - 1
    starts = np.flatnonzero(new_peer)
    finals = np.empty(len(starts), object)
    for g, ps in enumerate(starts):
        pe = peer_end[ps]
        s = {}
        for kind in adef.slots:
            if kind == "nrows":
                s[kind] = int(nrows[pe])
            elif kind == "count":
                s[kind] = int(cnt[pe])
            elif kind == "sum_i":
                s[kind] = int(tot[pe])
            elif kind == "sumsq_i":
                s[kind] = int(totq[pe])
        finals[g] = adef.final(s)
    return scatter_obj(finals[gid])


def _agg_window_sequential(spec, rows, order, new_part, next_new) -> list:
    """Aggregate windows whose transitions are not associative-exact
    (float CHECKFLOATVAL chains, numeric dscale tracking): run the SAME
    sequential host transitions as the slow path, over the numpy sort
    and precomputed peer boundaries."""
    n = len(rows)
    out: list = [None] * n
    adef, fam = spec._adef, spec._fam
    inst = AggInstance(aggname=spec.fname, family=fam, slots=adef.slots,
                       args=())
    state = None
    peer: list = []
    for pos in range(n):
        i = int(order[pos])
        if new_part[pos]:
            state = new_state(inst)
        args = [] if spec.arg_idx is None else [rows[i][spec.arg_idx]]
        update_state(inst, state, args)
        peer.append(i)
        if next_new[pos]:
            val = adef.final(state)
            for j in peer:
                out[j] = val
            peer = []
    return out


def _window_values_slow(spec: _WinSpec, rows: list, ctypes: list) -> list:
    n = len(rows)
    out: list = [None] * n

    parts: dict = {}
    for i in range(n):
        k = tuple(canon_group_key(rows[i][p]) for p in spec.part_idx)
        parts.setdefault(k, []).append(i)

    def cmp_rows(ia: int, ib: int) -> int:
        for idx, desc, nf in spec.order:
            a, b = rows[ia][idx], rows[ib][idx]
            nf_eff = desc if nf is None else nf    # PG default null order
            if a is None or b is None:
                if a is None and b is None:
                    continue
                if a is None:
                    return -1 if nf_eff else 1
                return 1 if nf_eff else -1
            c = cmp_values(a, b)
            if c:
                return -c if desc else c
        return 0

    for idxs in parts.values():
        ordered = (sorted(idxs, key=functools.cmp_to_key(cmp_rows))
                   if spec.order else list(idxs))
        if spec.order:
            groups: list[list[int]] = [[ordered[0]]]
            for prev, i in zip(ordered, ordered[1:]):
                if cmp_rows(prev, i) == 0:
                    groups[-1].append(i)
                else:
                    groups.append([i])
        else:
            groups = [ordered]     # no ORDER BY: the whole partition peers
        _compute_partition(spec, rows, ordered, groups, out)
    return out


def _compute_partition(spec, rows, ordered, groups, out) -> None:
    f = spec.fname
    if f == "row_number":
        for pos, i in enumerate(ordered):
            out[i] = pos + 1
        return
    if f == "rank":
        start = 1
        for g in groups:
            for i in g:
                out[i] = start
            start += len(g)
        return
    if f == "dense_rank":
        for gi, g in enumerate(groups):
            for i in g:
                out[i] = gi + 1
        return
    if f in ("lag", "lead"):
        off = spec.offset if f == "lag" else -spec.offset
        for pos, i in enumerate(ordered):
            j = pos - off
            if 0 <= j < len(ordered):
                out[i] = rows[ordered[j]][spec.arg_idx]
            elif spec.default_idx is not None:
                # PG: the default expression evaluates at the CURRENT row
                out[i] = rows[i][spec.default_idx]
        return
    if f == "first_value":
        fv = rows[ordered[0]][spec.arg_idx]
        for i in ordered:
            out[i] = fv
        return
    if f == "last_value":
        # default frame ends at the CURRENT ROW's last peer (the classic
        # PG last_value gotcha) — whole partition without ORDER BY
        for g in groups:
            lv = rows[g[-1]][spec.arg_idx]
            for i in g:
                out[i] = lv
        return
    # aggregate windows: exact host transitions, running over peer groups
    adef, fam = spec._adef, spec._fam    # resolved at plan time
    inst = AggInstance(aggname=f, family=fam, slots=adef.slots, args=())
    state = new_state(inst)
    for g in groups:
        for i in g:
            args = [] if spec.arg_idx is None \
                else [rows[i][spec.arg_idx]]
            update_state(inst, state, args)
        val = adef.final(state)
        for i in g:
            out[i] = val


# ---------------------------------------------------------------------------
# columnar window path (plane space, zero python rows)
# ---------------------------------------------------------------------------
#
# When the inner stage is a plain scan (single table, no joins/grouping),
# the row-based tier above still pays three O(n) python costs: tuple
# materialization of the inner result, per-value re-encoding, and
# column_from_values re-ingestion for the POST stage.  This path never
# leaves plane space: component columns are numpy gathers of the table's
# planes (text dictionaries and numeric planes ride along untouched),
# window keys encode via the planner's _order_plane_keys, and the POST
# stage receives real Columns — including, when there is no WHERE, the
# ORIGINAL Column objects (same uid), so the device chunk cache reuses
# the table's resident device buffers.

def _gather_column(col, ii, extra_valid=None):
    from ..datastore import column_gather
    return column_gather(col, ii, extra_valid)


def _const_column(t: T, v, n: int):
    import numpy as np
    from ..datastore import column_from_values
    one = column_from_values(t, [v])
    return _gather_column(one, np.zeros(n, np.int64))


def _fast_column(t: T, vals: list):
    from ..datastore import column_from_values_fast
    return column_from_values_fast(t, vals)


class _Frame:
    """Sorted-order frame shared by every function of one window spec:
    the global lexsort (partition keys most significant) plus partition
    and peer boundaries in sorted coordinates."""

    def __init__(self, np, n, key_of, spec):
        self.np = np
        self.n = n
        arrays: list = []
        for i, desc, nf in reversed(spec.order):
            lanes, nulls = key_of(i)
            nulls_first = desc if nf is None else nf
            nkey = np.where(nulls, np.int8(-1 if nulls_first else 1),
                            np.int8(0))
            for lane in reversed(lanes):
                if desc:
                    lane = np.int64(-1) - lane
                arrays.append(np.where(nulls, np.int64(0), lane))
            arrays.append(nkey)
        for p in reversed(spec.part_idx):
            lanes, nulls = key_of(p)
            for lane in reversed(lanes):
                arrays.append(np.where(nulls, np.int64(0), lane))
            arrays.append(nulls.astype(np.int8))
        self.order = (np.lexsort(tuple(arrays)) if arrays
                      else np.arange(n, dtype=np.int64))
        order = self.order
        new_part = np.zeros(n, np.bool_)
        if n:
            new_part[0] = True
        for p in spec.part_idx:
            lanes, nulls = key_of(p)
            ns = nulls[order]
            new_part[1:] |= ns[1:] != ns[:-1]
            for lane in lanes:
                ls = np.where(nulls, np.int64(0), lane)[order]
                new_part[1:] |= ls[1:] != ls[:-1]
        new_peer = new_part.copy()
        for i, _d, _nf in spec.order:
            lanes, nulls = key_of(i)
            ns = nulls[order]
            new_peer[1:] |= ns[1:] != ns[:-1]
            for lane in lanes:
                ls = np.where(nulls, np.int64(0), lane)[order]
                new_peer[1:] |= ls[1:] != ls[:-1]
        idx = np.arange(n, dtype=np.int64)
        self.idx = idx
        self.new_part = new_part
        self.new_peer = new_peer
        self.part_start = np.maximum.accumulate(np.where(new_part, idx, 0))
        self.peer_start = np.maximum.accumulate(np.where(new_peer, idx, 0))
        next_new = np.empty(n, np.bool_)
        if n:
            next_new[:-1] = new_peer[1:]
            next_new[-1] = True
        self.next_new = next_new
        self.peer_end = np.minimum.accumulate(
            np.where(next_new, idx, n)[::-1])[::-1]

    def scatter_i8_col(self, vals_sorted):
        from ..datastore import column_from_numpy
        res = self.np.empty(self.n, self.np.int64)
        res[self.order] = vals_sorted
        return column_from_numpy(T.INT8, res)

    def gather_col(self, col, src_sorted, valid_sorted=None):
        """Column whose ORIGINAL-order row i holds col[order[src_sorted]]
        for i's sorted position (NULL where valid_sorted is False)."""
        np = self.np
        fg = np.empty(self.n, np.int64)
        fg[self.order] = self.order[np.clip(src_sorted, 0, self.n - 1)]
        ev = None
        if valid_sorted is not None:
            ev = np.empty(self.n, np.bool_)
            ev[self.order] = valid_sorted
        return _gather_column(col, fg, extra_valid=ev)


def _dense_ranks(np, lanes, nulls, n):
    """1-based dense ranks of the non-null rows under the lane ordering
    (0 for nulls); None when they might not fit the 31-bit pack.

    NULL rows sort as a separate PRIMARY group (their data planes hold
    0, which would otherwise interleave with real zero-valued rows and
    split an equal run into distinct ranks, breaking the keep-first-on-tie
    display for -0.0/0.0 and numeric dscale)."""
    if n >= (1 << 31):
        return None, 0
    masked = [np.where(nulls, np.int64(0), lane) for lane in lanes]
    o2 = np.lexsort(tuple(reversed(masked)) + (nulls,))
    newv = np.zeros(n, np.bool_)
    if n:
        newv[0] = True
    ns = nulls[o2]
    newv[1:] |= ns[1:] != ns[:-1]
    for ls in (m[o2] for m in masked):
        newv[1:] |= ls[1:] != ls[:-1]
    ranks_sorted = np.cumsum(newv.astype(np.int64))
    rank = np.empty(n, np.int64)
    rank[o2] = ranks_sorted
    nrank = int(ranks_sorted[-1]) if n else 0
    return np.where(nulls, np.int64(0), rank), nrank


def _window_column(spec, ccols, wtype, fr, key_of, np):
    """One spec's output Column in plane space; None -> row path."""
    n = fr.n
    f = spec.fname
    idx, order = fr.idx, fr.order
    part_start, peer_start, peer_end = (fr.part_start, fr.peer_start,
                                        fr.peer_end)
    if f == "row_number":
        return fr.scatter_i8_col(idx - part_start + 1)
    if f == "rank":
        return fr.scatter_i8_col(peer_start - part_start + 1)
    if f == "dense_rank":
        c = np.cumsum(fr.new_peer.astype(np.int64))
        return fr.scatter_i8_col(c - c[part_start] + 1)
    if f in ("lag", "lead"):
        acol = ccols[spec.arg_idx]
        if spec.default_idx is not None:
            dcol = ccols[spec.default_idx]
            if dcol.type != acol.type or \
                    acol.type in (T.TEXT, T.BPCHAR):
                return None      # promotion / dict merge: row path
        off = spec.offset if f == "lag" else -spec.offset
        src = idx - np.int64(off)
        vp = (src >= 0) & (src < n)
        srcc = np.clip(src, 0, n - 1)
        vp &= part_start[srcc] == part_start
        out = fr.gather_col(acol, srcc, vp)
        if spec.default_idx is not None:
            # PG: the default expression evaluates at the CURRENT row
            vorig = np.empty(n, np.bool_)
            vorig[order] = vp
            out = _merge_columns(out, ccols[spec.default_idx], vorig, np)
        return out
    if f == "first_value":
        return fr.gather_col(ccols[spec.arg_idx], part_start)
    if f == "last_value":
        # default frame ends at the CURRENT ROW's last peer
        return fr.gather_col(ccols[spec.arg_idx], peer_end)
    if f == "count":
        if spec.star:
            return fr.scatter_i8_col(peer_end - part_start + 1)
        nn = ccols[spec.arg_idx].valid[order].astype(np.int64)
        pre = np.cumsum(nn)
        return fr.scatter_i8_col(pre[peer_end] - pre[part_start]
                                 + nn[part_start])
    if f in ("min", "max"):
        got = key_of(spec.arg_idx)
        if got is None:
            return None
        lanes, nulls = got
        rank, nrank = _dense_ranks(np, [l[order] for l in lanes],
                                   nulls[order], n)
        if rank is None:
            return None
        if f == "min":
            rank = np.where(rank > 0, np.int64(nrank + 1) - rank,
                            np.int64(0))
        part_ord = np.cumsum(fr.new_part.astype(np.int64)) - 1
        comp = (part_ord << np.int64(32)) | rank
        run = np.maximum.accumulate(comp)
        prev = np.empty(n, np.int64)
        if n:
            prev[0] = np.int64(-1)
            prev[1:] = run[:-1]
        isnew = comp > prev            # earliest occurrence of the extreme
        arg = np.maximum.accumulate(np.where(isnew, idx, np.int64(-1)))
        have = (run & np.int64(0xFFFFFFFF)) > 0
        return fr.gather_col(ccols[spec.arg_idx],
                             np.clip(arg[peer_end], 0, n - 1),
                             have[peer_end])
    # aggregate windows
    from ..datastore import column_from_numpy
    adef, fam = spec._adef, spec._fam
    if adef is None:
        return None
    acol = None if (spec.star or spec.arg_idx is None) \
        else ccols[spec.arg_idx]
    gid_sorted = np.cumsum(fr.new_peer.astype(np.int64)) - 1
    gid = np.empty(n, np.int64)
    gid[order] = gid_sorted
    slots = set(adef.slots)
    if acol is not None and slots <= {"nrows", "count", "sum_i",
                                      "sumsq_i"}:
        # integer slots: prefix sums (associative => prefix-subtract is
        # the exact value the sequential transition computes)
        nn = acol.valid[order].astype(np.int64)
        pre_n = np.cumsum(nn)
        cnt = pre_n[peer_end] - pre_n[part_start] + nn[part_start]
        if f == "sum" and fam in ("i2", "i4"):
            # sum(int2/int4) -> bigint; <= 2^31 rows of int4 cannot
            # overflow int64, so the final's range check cannot trip
            iv64 = np.where(acol.valid, acol.data.astype(np.int64),
                            np.int64(0))[order]
            pre = np.cumsum(iv64)
            tot = pre[peer_end] - pre[part_start] + iv64[part_start]
            data = np.empty(n, np.int64)
            data[order] = tot
            valid = np.empty(n, np.bool_)
            valid[order] = cnt > 0
            return column_from_numpy(T.INT8, data, valid)
        iv = acol.data[order].astype(object)        # exact bigints
        iv = np.where(acol.valid[order], iv, 0)
        nrows = peer_end - part_start + 1
        pre_s = np.cumsum(iv)
        tot = pre_s[peer_end] - pre_s[part_start] + iv[part_start]
        totq = None
        if "sumsq_i" in slots:
            sq = iv * iv
            pre_q = np.cumsum(sq)
            totq = pre_q[peer_end] - pre_q[part_start] + sq[part_start]
        starts = np.flatnonzero(fr.new_peer)
        by_kind = {"nrows": nrows, "count": cnt, "sum_i": tot,
                   "sumsq_i": totq}
        lanes = [(kind, by_kind[kind][starts].tolist())
                 for kind in adef.slots]
        final = adef.final
        fvals = [final({k: int(v) for (k, _), v
                        in zip(lanes, vals)})
                 for vals in zip(*(vs for _, vs in lanes))]
        fcol = _fast_column(wtype, fvals)
        return _gather_column(fcol, gid)
    if acol is not None and f == "sum" and fam in ("f4", "f8") and \
            slots <= {"nrows", "count", "sum_f"}:
        # per-partition np.cumsum IS the sequential float add chain the
        # host transition performs (ufunc.accumulate is strictly
        # left-to-right), and cums[peer_end] already restarts at the
        # partition — bit-exact, no prefix-subtract rounding drift.
        # float4 accumulates stepwise in float32 like PG float4pl.
        pstarts = np.flatnonzero(fr.new_part)
        if len(pstarts) <= max(1024, n // 128):
            dt = np.float32 if fam == "f4" else np.float64
            av = np.where(acol.valid,
                          acol.data.astype(dt), dt(0))[order]
            cums = np.empty(n, dt)
            bounds = pstarts.tolist() + [n]
            for b0, b1 in zip(bounds, bounds[1:]):
                cums[b0:b1] = np.cumsum(av[b0:b1], dtype=dt)
            # the sequential state starts at +0.0, so its running sum is
            # never -0.0; cumsum's first element is the raw value.  x+0.0
            # only rewrites -0.0 -> +0.0 (bitwise identity otherwise)
            cums += dt(0.0)
            if not np.isinf(cums).any():   # CHECKFLOATVAL: exact path
                nn = acol.valid[order].astype(np.int64)
                pre_n = np.cumsum(nn)
                cnt = (pre_n[peer_end] - pre_n[part_start]
                       + nn[part_start])
                data = np.empty(n, np.float64)
                data[order] = cums[peer_end].astype(np.float64)
                valid = np.empty(n, np.bool_)
                valid[order] = cnt > 0
                return column_from_numpy(wtype, data, valid)
    # float/numeric transitions are not associative-exact: run the SAME
    # sequential host transitions over the vectorized sort + boundaries
    from .planner import _column_values_at
    vals_sorted = (None if acol is None
                   else _column_values_at(acol, order))
    inst = AggInstance(aggname=f, family=fam, slots=adef.slots, args=())
    fvals = []
    state = None
    for pos in range(n):
        if fr.new_part[pos]:
            state = new_state(inst)
        update_state(inst, state,
                     [] if vals_sorted is None else [vals_sorted[pos]])
        if fr.next_new[pos]:
            fvals.append(adef.final(state))
    fcol = _fast_column(wtype, fvals)
    return _gather_column(fcol, gid)


def _merge_columns(a, b, take_a, np):
    """Row-wise select between two same-typed, non-text Columns."""
    from ..datastore import Column
    valid = np.where(take_a, a.valid, b.valid)
    data = np.where(take_a, a.data, b.data)
    out = Column(type=a.type, data=data, valid=valid)
    if a.num_exp is not None:
        out.num_exp = np.where(take_a, a.num_exp, b.num_exp)
        out.num_dscale = np.where(take_a, a.num_dscale, b.num_dscale)
        out.recheck = np.where(take_a, a.recheck, b.recheck)
        if out.recheck.any():
            for i in np.flatnonzero(out.recheck):
                src = a if take_a[int(i)] else b
                out._exact[int(i)] = src._exact[int(i)]
    return out


def _inner_columns(stmt, comps, ctypes, db, perfmon, np):
    """Component Columns of the inner stage for the plain-scan shape
    (single table, no joins/group/having); None -> row path.  The WHERE
    still rides the device scan pipeline (ScanExecutor, recheck replay
    included)."""
    from .planner import rename_table
    from .binder import Scope, bind_expr
    from ..expr.ir import bind_columns, ColumnRef, Const
    from ..exec.scan_exec import ScanExecutor
    if len(stmt.frm) != 1 or stmt.joins or stmt.group_by or \
            stmt.having is not None or getattr(stmt, "ctes", None):
        return None
    tr = stmt.frm[0]
    if tr.subquery is not None:
        return None
    try:
        tbl = db.get(tr.name)
    except KeyError:
        return None
    from ..datastore import Table
    if not isinstance(tbl, Table):
        return None
    alias = tr.alias or tr.name
    cur = rename_table(tbl, alias)
    scope = Scope(rels=[(alias, tbl)], db=db)
    layout = {n: i for i, n in enumerate(cur.column_names)}
    cols = list(cur.columns.values())
    try:
        bcomps = [bind_columns(bind_expr(c, scope, allow_aggs=True), layout)
                  for c in comps]
        bpred = (bind_columns(bind_expr(stmt.where, scope), layout)
                 if stmt.where is not None else None)
    except Exception:
        return None
    if not all(isinstance(e, (ColumnRef, Const)) for e in bcomps):
        return None
    if bpred is not None and bpred.type is not T.BOOL:
        return None
    idxs = ScanExecutor(cur, bpred, perfmon).row_indexes()
    ii = np.asarray(idxs, dtype=np.int64)
    out = []
    for e, t in zip(bcomps, ctypes):
        if isinstance(e, ColumnRef):
            out.append(_gather_column(cols[e.index], ii))
        else:
            out.append(_const_column(t, e.value, len(ii)))
    return out


_COLUMNAR_KEY_TYPES = (T.BOOL, T.INT2, T.INT4, T.INT8, T.DATE, T.TIME,
                       T.TIMESTAMP, T.FLOAT4, T.FLOAT8, T.TEXT, T.BPCHAR,
                       T.NUMERIC)


def _columnar_supported(specs, ctypes) -> bool:
    """Static (type-only) per-spec guards, checked BEFORE the device
    scan so an eventual row-path fallback doesn't pay the scan twice."""
    for spec in specs:
        for i in spec.part_idx + [i for (i, _, _) in spec.order]:
            if ctypes[i] not in _COLUMNAR_KEY_TYPES:
                return False
        if spec.fname in ("lag", "lead") and spec.default_idx is not None:
            at = ctypes[spec.arg_idx]
            if ctypes[spec.default_idx] != at or at in (T.TEXT, T.BPCHAR):
                return False
        if spec.fname in ("min", "max") and                 ctypes[spec.arg_idx] not in _COLUMNAR_KEY_TYPES:
            return False
    return True


_INNER_ROWS = object()     # sentinel: (_INNER_ROWS, rows) = inner already ran


def _run_columnar(inner, comps, ctypes, specs, wtypes, db, perfmon,
                  post_stmt, ipq):
    """Full plane-space execution of a windowed query.

    Returns the finished rows, OR None (row path; nothing executed), OR
    (_INNER_ROWS, rows) when the complex-shaped inner already executed —
    the caller's row tier reuses those rows instead of re-running it."""
    import numpy as np
    from .planner import plan_query
    from ..datastore import Table, column_from_values_fast
    from ..config import config
    if not getattr(config, "vectorized_windows", True):
        return None
    if not _columnar_supported(specs, ctypes):
        return None
    rows = None
    ccols = _inner_columns(inner, comps, ctypes, db, perfmon, np)
    if ccols is None:
        # complex inner (joins / grouping / subqueries): run it through
        # the planner once and convert the row output to columns — the
        # same plane-space window compute then covers every inner shape.
        # Partition/order key columns convert and probe FIRST, so a
        # query that always falls back (unencodable key) doesn't pay the
        # full O(rows x cols) conversion every execution.
        rows = ipq.execute()
        if len(rows) <= _FAST_MIN_ROWS:
            return (_INNER_ROWS, rows)
        from .planner import _order_plane_keys
        conv: dict = {}

        def conv_col(i):
            if i not in conv:
                conv[i] = column_from_values_fast(
                    ctypes[i], [r[i] for r in rows])
            return conv[i]

        for i in sorted({i for spec in specs for i in
                         spec.part_idx + [i2 for (i2, _, _) in spec.order]}):
            c = conv_col(i)
            if _order_plane_keys(
                    c, np.arange(len(c.data), dtype=np.int64)) is None:
                return (_INNER_ROWS, rows)
        ccols = [conv_col(i) for i in range(len(ctypes))]

    def fallback():
        return (_INNER_ROWS, rows) if rows is not None else None

    n = len(ccols[0].data) if ccols else 0
    key_cache: dict = {}

    def key_of(i):
        if i not in key_cache:
            from .planner import _order_plane_keys
            col = ccols[i]
            lanes = _order_plane_keys(col, np.arange(len(col.data),
                                                    dtype=np.int64))
            key_cache[i] = None if lanes is None else (lanes, ~col.valid)
        return key_cache[i]

    for spec in specs:
        for i in spec.part_idx + [i for (i, _, _) in spec.order]:
            if key_of(i) is None:
                return fallback()
    wcols = []
    frames: dict = {}          # the lexsort is shared across same-frame specs
    for spec, wtype in zip(specs, wtypes):
        fkey = (tuple(spec.part_idx), tuple(spec.order))
        fr = frames.get(fkey)
        if fr is None:
            fr = frames[fkey] = _Frame(np, n, key_of, spec)
        wc = _window_column(spec, ccols, wtype, fr, key_of, np)
        if wc is None:
            return fallback()
        wcols.append(wc)
    named = {f"__c{i}": c for i, c in enumerate(ccols)}
    named.update({f"__w{j}": c for j, c in enumerate(wcols)})
    tdb = _TempDb(Table.from_columns("__winsrc__", named))
    return plan_query(post_stmt, tdb).execute()


# ---------------------------------------------------------------------------
# the WindowAgg plan
# ---------------------------------------------------------------------------

def _untyped_name(e) -> str:
    if isinstance(e, ast.AName):
        return e.parts[-1]
    if isinstance(e, ast.AWindow):
        return e.func.name
    if isinstance(e, ast.AFunc):
        return e.name
    if isinstance(e, ast.ACast):
        return _untyped_name(e.arg)
    return "?column?"


class _TempDb:
    """Single-table database view for the POST stage."""

    def __init__(self, tbl):
        self._tbl = tbl
        self.tables = {tbl.name: tbl}

    def get(self, name: str):
        if name == self._tbl.name:
            return self._tbl
        raise KeyError(f'relation "{name}" does not exist')


def _temp_table(schema: list, data: dict):
    from ..datastore import Table, column_from_values_fast
    return Table.from_columns("__winsrc__", {
        nm: column_from_values_fast(t, data.get(nm, []))
        for nm, t in schema})


def plan_windowed(stmt: "ast.SelectStmt", db):
    """Plan a SELECT containing window functions (see module docstring)."""
    from .planner import plan_query, PlannedQuery, PlanNode, Perfmon

    rw = _Rewriter()
    post_items: list = []
    out_aliases: list[str] = []
    for it in stmt.items:
        if isinstance(it.expr, ast.AStar):
            raise SqlError("SELECT * together with window functions is not "
                           "supported; list the columns explicitly")
        name = it.alias or _untyped_name(it.expr)
        out_aliases.append(name)
        post_items.append(ast.SelectItem(rw.rewrite(it.expr), name))

    # outer ORDER BY: resolve output aliases / ordinals to the rewritten
    # item exprs (they may not exist as columns of the temp table), then
    # rewrite anything else through the same component machinery
    post_order: list = []
    for oi in stmt.order_by:
        e, target = oi.expr, None
        if isinstance(e, ast.ALiteral) and isinstance(e.value, int) \
                and not e.is_string:
            if not (1 <= e.value <= len(post_items)):
                raise SqlError(f"ORDER BY position {e.value} is not in "
                               "select list")
            target = post_items[e.value - 1].expr
        elif isinstance(e, ast.AName) and len(e.parts) == 1 \
                and e.parts[0] in out_aliases:
            target = post_items[out_aliases.index(e.parts[0])].expr
        if target is None:
            target = rw.rewrite(e)
        post_order.append(dataclasses.replace(oi, expr=target))

    specs = [_build_spec(w, rw) for w in rw.wins]

    comps = rw.comps or [ast.ALiteral(1)]      # SELECT rn() OVER () FROM t
    inner = dataclasses.replace(
        stmt,
        items=[ast.SelectItem(c, f"__c{i}") for i, c in enumerate(comps)],
        order_by=[], limit=None, offset=None, distinct=False, ctes=[])
    ipq = plan_query(inner, db)
    ctypes = list(ipq.out_types)

    wtypes = []
    for spec in specs:
        wtypes.append(_win_type(spec, ctypes))
        if spec.fname not in _RANKERS and spec.fname not in _OFFSETS:
            argts = () if spec.star or spec.arg_idx is None \
                else (ctypes[spec.arg_idx],)
            spec._adef, spec._fam = lookup_agg(spec.fname, argts,
                                               star=spec.star)

    schema = [(f"__c{i}", t) for i, t in enumerate(ctypes)] + \
             [(f"__w{j}", t) for j, t in enumerate(wtypes)]
    post_stmt = ast.SelectStmt(
        post_items, [ast.TableRef("__winsrc__", None, None)], [], None,
        [], None, post_order, stmt.limit, stmt.offset,
        distinct=stmt.distinct)
    shell = plan_query(post_stmt, _TempDb(_temp_table(schema, {})))
    out_names, out_types = list(shell.out_names), list(shell.out_types)

    def run() -> list[tuple]:
        got = _run_columnar(inner, comps, ctypes, specs, wtypes, db,
                            ipq.perfmon, post_stmt, ipq)
        if isinstance(got, tuple) and len(got) == 2 and \
                got[0] is _INNER_ROWS:
            rows = got[1]                  # inner already executed
        elif got is not None:
            return got
        else:
            rows = ipq.execute()
        data = {f"__c{i}": [r[i] for r in rows]
                for i in range(len(ctypes))}
        for j, spec in enumerate(specs):
            data[f"__w{j}"] = _window_values(spec, rows, ctypes)
        tdb = _TempDb(_temp_table(schema, data))
        return plan_query(post_stmt, tdb).execute()

    root = PlanNode(
        "WindowAgg",
        {"functions": ", ".join(
            s.fname + ("(*)" if s.star else "") +
            (" partition" if s.part_idx else "") +
            (" order" if s.order else "") for s in specs)},
        [ipq.root],
        # windows emit one row per input row: propagate the inner row
        # estimate so an OUTER query over this subquery costs against
        # the real cardinality (the 0-row shell default would make a
        # 4M-row outer aggregate plan host-side)
        cost=ipq.root.cost)
    return PlannedQuery(out_names, out_types, run, root, ipq.perfmon)
