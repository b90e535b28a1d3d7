"""K5: a join on a dense build key under a scalar aggregate, one pass over
the probe chunk.

The shape is a star-schema query that sums fact columns over the rows that
join one filtered dimension, such as SSB Q1.1:

    select sum(lo_extendedprice * lo_discount) from lineorder, date
    where lo_orderdate = d_datekey and d_year = 1993
      and lo_discount between 1 and 3 and lo_quantity < 25

With a dense build table (hashjoin.build_hash_table's `dense_ok`: unique
build keys in a direct-address window) and aggregate arguments that read
probe columns only, the join is a membership test of key - kmin, and the
whole query a chunk is one pass over the probe planes.  The reference has
no kernel for it: it runs the dense probe and the ungrouped aggregate as
XLA glue (ops/joinagg.py's dense branch), and so does the port wherever
this module declines.

* `scalar_program` decides whether the plan fits and lowers it: the probe
  predicate (inside `_pred_kernel_safe`'s envelope) to ranges [lo, hi] of
  its top-level `column op integer constant` conjuncts and K1's postfix
  program (preagg_fused2._lower_pred) for the rest, each distinct
  aggregate argument to a postfix program of int2/int4 columns, integer
  constants and + - *, and every slot to nrows (count(*)), count or
  sum_i.  A column with no NULL (datastore.column_stats) ships no
  validity plane.
* `member_table` turns whichever dense variant the build table holds (the
  identity, K3's table against its sentinel, or the plain table) into a
  bitmap of the window; the executor caches it beside the table.
* `joinagg_scalar` runs the kernel (ops/cuda/joinagg_scalar.cu) on a CUDA
  chunk, or raises, and its plain PyTorch version
  (`joinagg_scalar_reference`) on a CPU chunk.  Both return int64
  [2 + 2 * n_args]: the err lane, count(*), then (count, sum) of each
  argument; an argument that leaves its type's range on a joined row with
  no NULL operand sets ERR_INT2_OVERFLOW / ERR_INT4_OVERFLOW, and the
  chunk replays on the host.
* `build_join_scalar_fn` is the device function the executor dispatches:
  the ungrouped preagg output dict (`err`, `collision`, `ngroups`,
  `gmask`, `keys`, `slots`, `nout`), as joinagg.build_join_preagg_fn's
  dense branch emits it.
* `K5Batch` runs K5 for a launch plan (exec/joinagg_exec.py) over the
  resident chunks of a repeated query shape: a parameter block a chunk
  made once, the constants written in place, one output buffer read
  back in one copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..errors import ERR_INT2_OVERFLOW, ERR_INT4_OVERFLOW
from ..expr.catalog import entry_for_funcexpr
from ..expr.ir import BoolExpr, ColumnRef, Const, Expr, FuncExpr
from ..sqltypes import T
from ..utils.perfmon import bump_active, span
from .preagg_fused2 import (DT_BOOL, DT_F32, DT_I16, DT_I32, PRED_W,
                            _lower_pred, _pred_kernel_safe, _pred_mask)

# limits of the kernel's by-value parameter (ops/cuda/joinagg_scalar.cu)
MAX_IN = 12
MAX_PRED = 32
MAX_RANGE = 8
MAX_ARGS = 4
MAX_ARG_OPS = 24
PRED_DEPTH = 8            # the predicate's stack: 4-bit nibbles in 32 bits
ARG_DEPTH = 4             # the arguments' stack: four registers
ARG_W = 3
A_COL, A_CONST, A_ADD, A_SUB, A_MUL = range(1, 6)
SHAPE_STACK, SHAPE_LEAF, SHAPE_BINARY = range(3)
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_FLIP = {"=": "=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
_ARITH = {"add": A_ADD, "sub": A_SUB, "mul": A_MUL}
_INT_BOUNDS = {2: (-(1 << 15), (1 << 15) - 1), 4: (-(1 << 31), (1 << 31) - 1)}
_OVF_ERR = {2: ERR_INT2_OVERFLOW, 4: ERR_INT4_OVERFLOW}
_WIDTH = {T.INT2: 2, T.INT4: 4}
_PLANE_DT = {T.INT2: DT_I16, T.INT4: DT_I32, T.DATE: DT_I32,
             T.FLOAT4: DT_F32, T.BOOL: DT_BOOL}
_TORCH_DT = {DT_I16: torch.int16, DT_I32: torch.int32,
             DT_F32: torch.float32, DT_BOOL: torch.bool}
_KEY_TYPES = (T.INT2, T.INT4, T.DATE)
_SLOTS = ("nrows", "count", "sum_i")


@dataclasses.dataclass(frozen=True)
class ScalarProgram:
    """The lowered plan: which probe planes the kernel reads, the predicate
    and argument programs, and where each aggregate's slots sit in the
    output."""
    inputs: tuple            # (probe column index, "data" | "valid")
    dtypes: tuple            # DT_* of each input
    key_d: int               # input position of the key's data plane
    key_v: int               # ... of its validity plane; -1 = no NULL
    ranges: np.ndarray       # int32 [n_range, 4]: (din, vin, lo, hi)
    pred: np.ndarray         # int32 [n_pred, PRED_W]: the other conjuncts
    arg: np.ndarray          # int32 [n_ops, ARG_W]
    arg_start: tuple         # argument j's rows: arg[arg_start[j]:...[j+1]]
    arg_shape: tuple         # SHAPE_* of each argument
    slots: tuple             # per aggregate: ((kind, output index), ...)

    @property
    def n_args(self) -> int:
        return len(self.arg_start) - 1


def scalar_program(pschema, probe_keys: Sequence[Expr],
                   probe_pred: Optional[Expr], aggs,
                   probe_slots: Sequence[int],
                   has_nulls: Callable[[int], bool]
                   ) -> Optional[ScalarProgram]:
    """Lower an ungrouped dense join+aggregate for K5, or None when it lies
    outside the kernel's envelope (the caller keeps ops/joinagg.py's dense
    branch).

    probe_keys and probe_pred are bound to the probe layout; the aggregate
    arguments to the joined layout, whose slot j is probe column
    probe_slots[j] (-1: a build column).  has_nulls(i): probe column i may
    hold a NULL."""
    if len(probe_keys) != 1:
        return None
    key = probe_keys[0]
    if not isinstance(key, ColumnRef) or key.type not in _KEY_TYPES:
        return None
    if not _pred_kernel_safe(probe_pred, pschema):
        return None
    inputs: list = []
    pos: dict = {}

    def get_in(idx: int, plane: str) -> int:
        if (idx, plane) not in pos:
            pos[(idx, plane)] = len(inputs)
            inputs.append((idx, plane))
        return pos[(idx, plane)]

    def get_valid(idx: int) -> int:
        return get_in(idx, "valid") if has_nulls(idx) else -1

    key_d = get_in(key.index, "data")
    key_v = get_valid(key.index)
    stack = [probe_pred] if probe_pred is not None else []
    while stack:
        x = stack.pop()
        if isinstance(x, ColumnRef):
            get_in(x.index, "data")
            get_valid(x.index)
        stack.extend(x.children())
    # top-level conjuncts `column op integer constant` become ranges; the
    # rest stays a postfix program
    ranges, rest = split_ranges(conjuncts(probe_pred))
    rest_pred = (None if not rest else rest[0] if len(rest) == 1
                 else BoolExpr(T.BOOL, "and", tuple(rest)))
    pred, depth = _lower_pred(rest_pred, _Layout(tuple(inputs)))
    if (depth > PRED_DEPTH or len(pred) > MAX_PRED
            or len(ranges) > MAX_RANGE):
        return None
    range_rows = [(pos[(c.index, "data")], pos.get((c.index, "valid"), -1),
                   lo, hi) for c, (lo, hi) in ranges.items()]

    def lower_arg(e: Expr, rows: list) -> Optional[int]:
        """Emit e's postfix rows; its stack depth, or None outside the
        envelope."""
        if isinstance(e, ColumnRef):
            if e.type not in _WIDTH or probe_slots[e.index] < 0:
                return None
            pidx = probe_slots[e.index]
            rows.append((A_COL, get_in(pidx, "data"), get_valid(pidx)))
            return 1
        if isinstance(e, Const):
            if e.type not in _WIDTH or e.value is None:
                return None
            rows.append((A_CONST, int(e.value), 0))
            return 1
        if not isinstance(e, FuncExpr):
            return None
        kind = entry_for_funcexpr(e).kind
        if kind == ("cast", T.INT2, T.INT4):       # widening: no operation
            return lower_arg(e.args[0], rows)
        if kind[0] != "int_arith" or kind[1] not in _ARITH \
                or kind[2] not in _WIDTH:
            return None
        da = lower_arg(e.args[0], rows)
        db = lower_arg(e.args[1], rows) if da is not None else None
        if db is None:
            return None
        rows.append((_ARITH[kind[1]], _WIDTH[kind[2]], 0))
        return max(da, db + 1)

    args: list = []                 # distinct argument expressions
    arg_rows: list = []
    arg_start = [0]
    slots = []
    for inst in aggs:
        if not set(inst.slots) <= set(_SLOTS) or len(inst.args) > 1:
            return None
        out = []
        j = None
        if inst.args:
            a = inst.args[0]
            if a not in args:
                rows: list = []
                d = lower_arg(a, rows)
                if d is None or d > ARG_DEPTH:
                    return None
                args.append(a)
                arg_rows.extend(rows)
                arg_start.append(len(arg_rows))
            j = args.index(a)
        for kind in inst.slots:
            if kind == "nrows":
                out.append((kind, 1))
            elif j is None:
                return None
            else:
                out.append((kind, 2 + 2 * j + (kind == "sum_i")))
        slots.append(tuple(out))
    if (len(args) > MAX_ARGS or len(arg_rows) > MAX_ARG_OPS
            or len(inputs) > MAX_IN):
        return None
    dtypes = tuple(DT_BOOL if plane == "valid"
                   else _PLANE_DT.get(pschema[idx].type, -1)
                   for idx, plane in inputs)
    if -1 in dtypes:
        return None
    return ScalarProgram(
        inputs=tuple(inputs), dtypes=dtypes, key_d=key_d, key_v=key_v,
        ranges=np.asarray(range_rows, np.int64).reshape(-1, 4),
        pred=np.asarray(pred, np.int32).reshape(-1, PRED_W),
        arg=np.asarray(arg_rows, np.int32).reshape(-1, ARG_W),
        arg_start=tuple(arg_start),
        arg_shape=tuple(_shape(arg_rows[a:b]) for a, b in
                        zip(arg_start, arg_start[1:])),
        slots=tuple(slots))


def conjuncts(e: Optional[Expr]) -> list:
    if e is None:
        return []
    if isinstance(e, BoolExpr) and e.op == "and":
        return [c for a in e.args for c in conjuncts(a)]
    return [e]


def range_clause(e: Expr) -> Optional[tuple]:
    """(column, op, constant) of a clause `column op constant` (either
    order, op flipped to put the column first) over an int2 / int4 / date
    column and an integer or date constant; None for any other clause."""
    if not isinstance(e, FuncExpr) or len(e.args) != 2:
        return None
    op = e.fname.split("::", 1)[0]
    col, c = e.args
    if isinstance(col, Const) and isinstance(c, ColumnRef):
        col, c, op = c, col, _FLIP.get(op)
    if (not isinstance(col, ColumnRef) or not isinstance(c, Const)
            or op not in _FLIP or col.type not in _KEY_TYPES
            or c.type not in (T.INT2, T.INT4, T.INT8, T.DATE)):
        return None
    return col, op, c


def _range_of(e: Expr) -> Optional[tuple]:
    """(column, lo, hi) of a clause `column op constant` (range_clause),
    TRUE where lo <= column <= hi; None for any other clause, and for one
    that no value meets."""
    r = range_clause(e)
    if r is None or r[2].value is None:
        return None
    col, op, c = r
    v = int(c.value)
    lo, hi = {"=": (v, v), "<": (_I32_MIN, v - 1), "<=": (_I32_MIN, v),
              ">": (v + 1, _I32_MAX), ">=": (v, _I32_MAX)}[op]
    if not _I32_MIN <= lo <= hi <= _I32_MAX:
        return None
    return col, lo, hi


def split_ranges(conjs: Sequence[Expr]) -> tuple[dict, list]:
    """The conjuncts `column op integer constant` folded into one [lo, hi]
    a column (a dict by ColumnRef, in the order the columns first
    appear), and the rest: the other clauses, one that no value meets and
    one whose range would leave its column's empty."""
    ranges: dict = {}
    rest = []
    for c in conjs:
        r = _range_of(c)
        lo_hi = ranges.get(r[0]) if r is not None else None
        if r is None or (lo_hi is not None
                         and max(lo_hi[0], r[1]) > min(lo_hi[1], r[2])):
            rest.append(c)         # an empty intersection stays a clause
        elif lo_hi is None:
            ranges[r[0]] = [r[1], r[2]]
        else:
            lo_hi[:] = [max(lo_hi[0], r[1]), min(lo_hi[1], r[2])]
    return ranges, rest


def _shape(rows: list) -> int:
    """SHAPE_LEAF for one column or constant, SHAPE_BINARY for two leaves
    and an operator, else SHAPE_STACK."""
    leaf = [r[0] in (A_COL, A_CONST) for r in rows]
    if leaf == [True]:
        return SHAPE_LEAF
    if leaf == [True, True, False]:
        return SHAPE_BINARY
    return SHAPE_STACK


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The input list _lower_pred reads positions from (V2Sig's field)."""
    inputs: tuple


def member_table(ht: dict, dcap: int, use_mxu: bool, row_bits: int) -> dict:
    """The build side as a bitmap over the dense window: bit (off & 31) of
    word off >> 5 is set where key kmin + off is a build key.  Read from
    the variant the probe would use: the identity (`dense_ident`: keys
    kmin .. kmin + nbuild - 1), K3's table against its sentinel
    (`use_mxu`; hashjoin.build_probe_dense_fn's), or the plain table."""
    dev = ht["dense"].device
    off = torch.arange(dcap, dtype=torch.int64, device=dev)
    if bool(ht["dense_ident"]):
        hit = off < ht["nbuild"].to(torch.int64)
    elif use_mxu:
        hit = ht["dense_M"][:dcap] != (1 << row_bits) - 1
    else:
        hit = ht["dense"][:dcap] >= 0
    return member_from_mask(hit, int(ht["kmin"]))


def member_from_mask(hit: torch.Tensor, kmin: int) -> dict:
    """The membership table of a bool mask over the window (key kmin + i is
    a build key where hit[i]; its length a multiple of 32)."""
    bit = torch.arange(32, dtype=torch.int64, device=hit.device)
    words = (hit.view(-1, 32).to(torch.int64) << bit).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return {"bits": words.to(torch.int32), "kmin": kmin,
            "dcap": hit.shape[0]}


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _wrap32(w: torch.Tensor) -> torch.Tensor:
    return ((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def joinagg_scalar_reference(prog: ScalarProgram, planes, member: dict,
                             nrows: int) -> torch.Tensor:
    """Plain K5: int64 [2 + 2 * n_args] = (err, count(*), (count, sum) per
    argument) over the first nrows rows of the planes (one per
    prog.inputs position)."""
    dev = planes[0].device
    out = torch.zeros(2 + 2 * prog.n_args, dtype=torch.int64, device=dev)
    n = max(0, min(int(nrows), planes[0].shape[0]))
    if n == 0:
        return out
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def valid(vin: int) -> torch.Tensor:
        return ones if vin < 0 else planes[vin][:n].to(torch.bool)

    off = planes[prog.key_d][:n].to(torch.int64) - member["kmin"]
    inw = valid(prog.key_v) & (off >= 0) & (off < member["dcap"])
    o = torch.where(inw, off, torch.zeros_like(off))
    word = member["bits"][o >> 5].to(torch.int64)
    m = _pred_mask(prog, planes, n) & inw & (((word >> (o & 31)) & 1) == 1)
    for din, vin, lo, hi in prog.ranges.tolist():
        x = planes[din][:n].to(torch.int64)
        m = m & (x >= lo) & (x <= hi) & valid(vin)
    out[1] = m.sum()
    err = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(prog.n_args):
        stack: list = []
        for op, a1, a2 in prog.arg[prog.arg_start[j]:
                                   prog.arg_start[j + 1]].tolist():
            if op == A_COL:
                stack.append((planes[a1][:n].to(torch.int64), valid(a2)))
                continue
            if op == A_CONST:
                stack.append((torch.full((n,), a1, dtype=torch.int64,
                                         device=dev), ones))
                continue
            y, yv = stack.pop()
            x, xv = stack.pop()
            w = x + y if op == A_ADD else x - y if op == A_SUB else x * y
            lo, hi = _INT_BOUNDS[a1]
            v = xv & yv
            bad = (((w < lo) | (w > hi)) & v & m).any()
            err = torch.maximum(err, torch.where(
                bad, torch.tensor(_OVF_ERR[a1], device=dev),
                torch.zeros((), dtype=torch.int64, device=dev)))
            stack.append((_wrap32(w), v))
        val, vv = stack[-1]
        ok = vv & m
        out[2 + 2 * j] = ok.sum()
        out[3 + 2 * j] = torch.where(ok, val, torch.zeros_like(val)).sum()
    out[0] = err
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class _K5Args(ctypes.Structure):
    """ops/cuda/joinagg_scalar.cu's K5Args, passed to the kernel by value."""
    _fields_ = [("plane", ctypes.c_void_p * MAX_IN),
                ("member", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("nrows", ctypes.c_longlong),
                ("kmin", ctypes.c_longlong),
                ("dcap", ctypes.c_longlong),
                ("dtype", ctypes.c_int * MAX_IN),
                ("pred", ctypes.c_int * (MAX_PRED * PRED_W)),
                ("range", ctypes.c_int * (MAX_RANGE * 4)),
                ("arg", ctypes.c_int * (MAX_ARG_OPS * ARG_W)),
                ("arg_start", ctypes.c_int * (MAX_ARGS + 1)),
                ("arg_shape", ctypes.c_int * MAX_ARGS),
                ("n_in", ctypes.c_int),
                ("n_pred", ctypes.c_int),
                ("n_range", ctypes.c_int),
                ("n_args", ctypes.c_int),
                ("key_d", ctypes.c_int),
                ("key_v", ctypes.c_int),
                ("key32", ctypes.c_int)]


def k5_args(prog: ScalarProgram, member: dict) -> _K5Args:
    """The kernel's parameter with everything but the planes, nrows and
    the output filled in (the caller keeps it for the query's chunks)."""
    a = _K5Args()
    _set_member(a, member)
    a.dtype[:len(prog.dtypes)] = prog.dtypes
    a.pred[:prog.pred.size] = prog.pred.reshape(-1).tolist()
    _set_ranges(a, prog.ranges)
    a.arg[:prog.arg.size] = prog.arg.reshape(-1).tolist()
    a.arg_start[:len(prog.arg_start)] = prog.arg_start
    a.arg_shape[:prog.n_args] = prog.arg_shape
    a.n_in = len(prog.inputs)
    a.n_pred = prog.pred.shape[0]
    a.n_range = prog.ranges.shape[0]
    a.n_args = prog.n_args
    a.key_d = prog.key_d
    a.key_v = prog.key_v
    return a


def _set_member(a: _K5Args, member: dict) -> None:
    a.member = member["bits"].data_ptr()
    a.kmin = member["kmin"]
    a.dcap = member["dcap"]
    # the 32-bit offset (unsigned)key - (unsigned)kmin is exact for 32-bit
    # keys when kmin lies in [-2^31, 2^31 - dcap] (so dcap < 2^32)
    a.key32 = int(_I32_MIN <= member["kmin"] <= (1 << 31) - member["dcap"]
                  and member["dcap"] < 1 << 32)


def _set_ranges(a: _K5Args, ranges: np.ndarray) -> None:
    # (din, vin, lo, hi - lo): the kernel tests (unsigned)(x - lo) <= hi - lo
    a.range[:ranges.size] = [
        v for din, vin, lo, hi in ranges.tolist()
        for v in (din, vin, lo, hi - lo - (1 << 32) * (hi - lo > _I32_MAX))]


@functools.lru_cache(maxsize=None)
def _k5_library() -> ctypes.CDLL:
    """The kernel library, once its K5Args is known to match _K5Args in
    size (checked on the first launch)."""
    from .cuda import library
    lib = library()
    if lib.pgstrom_k5_args_size() != ctypes.sizeof(_K5Args):
        raise RuntimeError(
            f"K5's parameter is {lib.pgstrom_k5_args_size()} bytes in the "
            f"library, {ctypes.sizeof(_K5Args)} in ctypes")
    return lib


_BLOCK = 256             # ops/cuda/joinagg_scalar.cu's K5_BLOCK
_BLOCKS_PER_SM = 2       # ... and K5_MIN_BLOCKS: the blocks an SM holds


def _grid(nrows: int, dev: torch.device) -> int:
    """Blocks of a launch over nrows rows: one 4-row group a thread, at
    most the blocks the card holds at once."""
    from .cuda import sm_count
    ngroups = -(-nrows // 4)
    return max(1, min(-(-ngroups // _BLOCK),
                      sm_count(dev.index if dev.index is not None
                               else torch.cuda.current_device())
                      * _BLOCKS_PER_SM))


def _check(prog: ScalarProgram, planes, member: dict, nrows: int) -> None:
    dev = planes[0].device
    bits = member["bits"]
    bad = (len(planes) != len(prog.inputs) or bits.device != dev
           or bits.dtype != torch.int32 or not bits.is_contiguous()
           or bits.shape[0] * 32 < member["dcap"])
    for p, dt in zip(planes, prog.dtypes):
        w = p.element_size() * 4     # a group of 4 rows is one vector load
        bad = bad or (p.device != dev or p.dtype != _TORCH_DT[dt]
                      or p.dim() != 1 or not p.is_contiguous()
                      or p.shape[0] < nrows or p.data_ptr() % w != 0)
    if bad:
        raise ValueError(
            f"K5 needs one contiguous 1-D plane per input ({prog.dtypes}), "
            f"each of >= nrows={nrows} rows aligned to 4 rows, and an int32 "
            f"bitmap of >= {member['dcap']} bits, on one device; got "
            f"{[(str(p.dtype), tuple(p.shape), str(p.device)) for p in planes]}"
            f", bitmap {bits.dtype} {tuple(bits.shape)} on {bits.device}")


def joinagg_scalar_cuda(prog: ScalarProgram, planes, member: dict,
                        nrows: int, args: Optional[_K5Args] = None
                        ) -> torch.Tensor:
    """Launch K5: the same int64 [2 + 2 * n_args] as
    joinagg_scalar_reference.  Raises on a bad input, a build or a launch
    failure."""
    from .cuda import cuda_error_text
    _check(prog, planes, member, nrows)
    dev = planes[0].device
    if args is None:
        args = k5_args(prog, member)
    grid = _grid(nrows, dev)
    lib = _k5_library()
    with torch.cuda.device(dev), span("K5"):
        out = torch.zeros(2 + 2 * prog.n_args, dtype=torch.int64,
                          device=dev)
        if nrows == 0:
            return out
        for i, p in enumerate(planes):
            args.plane[i] = p.data_ptr()
        args.nrows = nrows
        args.out = out.data_ptr()
        rc = lib.pgstrom_k5_launch(
            ctypes.byref(args), grid,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: {cuda_error_text(rc)}")
    joinagg_scalar_cuda.launches += 1
    return out


joinagg_scalar_cuda.launches = 0   # main-path launch count (chip_smoke.py)


def joinagg_scalar(prog: ScalarProgram, planes, member: dict, nrows: int,
                   args: Optional[_K5Args] = None) -> torch.Tensor:
    """K5 over one chunk: the kernel on CUDA planes, the plain version on
    CPU planes."""
    dev = planes[0].device
    if dev.type == "cuda":
        return joinagg_scalar_cuda(prog, planes, member, nrows, args)
    if dev.type == "cpu":
        return joinagg_scalar_reference(prog, planes, member, nrows)
    raise RuntimeError(f"K5 has no kernel for device {dev}")


def build_join_scalar_fn(prog: ScalarProgram, member: dict) -> Callable:
    """f(ht, pcols, bcols, nrows, salt) -> the ungrouped preagg output dict
    of one probe chunk (+ 'nout' = 0), computed by K5."""
    planes_of = [(idx, 0 if plane == "data" else 1)
                 for idx, plane in prog.inputs]
    args = (k5_args(prog, member) if member["bits"].device.type == "cuda"
            else None)
    const = {"collision": torch.tensor(False),
             "ngroups": torch.tensor(1, dtype=torch.int32),
             "gmask": torch.ones(1, dtype=torch.bool), "keys": (),
             "nout": torch.tensor(0, dtype=torch.int32)}

    def f(ht: dict, pcols: tuple, bcols: tuple, nrows, salt):
        out = joinagg_scalar(prog, [pcols[i][k] for i, k in planes_of],
                             member, int(nrows), args)
        bump_active("joinagg_scalar_chunks")
        return {"err": out[0],
                "slots": tuple({kind: out[i:i + 1] for kind, i in s}
                               for s in prog.slots),
                **const}

    return f


class K5Batch:
    """K5 over a fixed list of resident chunks, for a launch plan's
    queries.  Made once: a parameter block per chunk with its planes, rows
    and output row filled in, one int64 [nchunks, 2 + 2 * n_args] buffer
    on the device and, on CUDA, a pinned host twin of it.  Per query:
    `set_member` and `set_ranges` write what the query's constants reach,
    `launch` zeroes the buffer once and launches K5 once a chunk into its
    row (on CPU planes the plain version, with no `K5` span, as
    `joinagg_scalar`), `fetch` copies the buffer back
    in one transfer and waits once.  Its caller keeps it to one query at a
    time (the pinned buffer is the query's until `fetch` returns)."""

    def __init__(self, prog: ScalarProgram, member: dict, planes: list,
                 nrows: list):
        self.prog, self.member = prog, member
        self.planes, self.nrows = planes, [int(n) for n in nrows]
        self.dev = planes[0][0].device
        shape = (len(planes), 2 + 2 * prog.n_args)
        self.out = torch.zeros(shape, dtype=torch.int64, device=self.dev)
        self.cuda = self.dev.type == "cuda"
        self.args, self.grids = [], []
        if not self.cuda:
            self.host = self.out
            return
        for p, n in zip(planes, self.nrows):
            _check(prog, p, member, n)
        self.host = torch.zeros(shape, dtype=torch.int64, pin_memory=True)
        for i, (p, n) in enumerate(zip(planes, self.nrows)):
            a = k5_args(prog, member)
            for j, t in enumerate(p):
                a.plane[j] = t.data_ptr()
            a.nrows = n
            a.out = self.out[i].data_ptr()
            self.args.append(a)
            self.grids.append(_grid(n, self.dev))

    def set_member(self, member: dict) -> None:
        if member is self.member:
            return
        self.member = member
        for a in self.args:
            _set_member(a, member)

    def set_ranges(self, ranges: np.ndarray) -> None:
        """New bounds for the program's range rows (the same rows, in the
        same order: only lo and hi may differ)."""
        self.prog = dataclasses.replace(self.prog, ranges=ranges)
        for a in self.args:
            _set_ranges(a, ranges)

    def launch(self) -> None:
        bump_active("joinagg_scalar_chunks", len(self.planes))
        if not self.cuda:
            for i, (p, n) in enumerate(zip(self.planes, self.nrows)):
                self.out[i] = joinagg_scalar_reference(
                    self.prog, p, self.member, n)
            return
        from .cuda import cuda_error_text
        lib = _k5_library()
        with torch.cuda.device(self.dev), span("K5"):
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(self.dev).cuda_stream)
            self.out.zero_()
            for a, grid, n in zip(self.args, self.grids, self.nrows):
                if n == 0:
                    continue
                rc = lib.pgstrom_k5_launch(ctypes.byref(a), grid, stream)
                if rc != 0:
                    raise RuntimeError(
                        f"K5 launch failed: {cuda_error_text(rc)}")
                joinagg_scalar_cuda.launches += 1

    def fetch(self) -> np.ndarray:
        """The rows of the last launch, [nchunks, 2 + 2 * n_args], read
        back in one transfer (counted in the query's `d2h_reads`)."""
        bump_active("d2h_reads")
        if self.cuda:
            with torch.cuda.device(self.dev):
                self.host.copy_(self.out, non_blocking=True)
                torch.cuda.current_stream(self.dev).synchronize()
        return self.host.numpy().copy()
