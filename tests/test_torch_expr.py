"""The port's expression lowering (pg_strom_tpu_torch/expr/lower_torch.py)
and key hashes (ops/hashing.py) against the JAX reference.

Mirrors tests/test_expr.py case for case.  Each case builds the same
columns and expression in both packages and runs `build_project_fn` on the
same planes: the reference jitted on the CPU, the port on CPU tensors.

* `data`, `valid` and the uint8 `err` lane must be equal; ints, bools,
  numeric (mant, exp) and float + - * / sqrt bit for bit, transcendental
  float8 results within 1 ulp;
* the port must also keep the exactness contract against the host
  evaluator (`eval_cpu`): the host value, the host error, or a recheck.

The hash section holds `hash_column32`, `combine_hashes32`, `hash_column`
and `combine_hashes` bit-identical to the reference's over every key type,
NULLs, float -0.0 / NaN and dictionary-coded text.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.datastore import column_from_values as r_values
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr import lower_jax as r_lower
from pg_strom_tpu.ops import hashing as r_hash
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.errors import SqlError, ERR_CPU_RECHECK
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr import lower_torch as p_lower
from pg_strom_tpu_torch.expr.eval_cpu import eval_expr_cpu
from pg_strom_tpu_torch.ops import hashing as p_hash

USEC_DAY = 86_400_000_000
# float8 math whose result is not required to be bit-exact (1 ulp), with
# the libm function it is held against
_TRANSCENDENTAL = {"exp": np.exp, "ln": np.log, "log": np.log10,
                   "cbrt": np.cbrt, "sin": np.sin, "cos": np.cos,
                   "atan": np.arctan, "power": np.power, "sqrt": np.sqrt}
# XLA:CPU's f64 cbrt is up to ~100 ulp off at 1e-300: the port's is held
# to 1 ulp of libm and to rel 1e-12 of the reference.  sqrt is held to
# libm exactly (IEEE) and to the reference bit for bit.
_LOOSE_REF = {"cbrt"}


def _col(M, name, t):
    return M.ir.ColumnRef(type=M.T[t], name=name)


def _f(M, op, *args):
    return M.ir.resolve_function(op, args)


def _c(M, t, v):
    return M.ir.Const(type=M.T[t], value=v)


def _run(M, lower, spec, build, nrows=None, pad=0):
    """(outs planes, mask, err) of one package, plus its bound expr and
    columns."""
    names = [n for n, _, _ in spec]
    rcols = [r_values(R.T[t], list(vs) + [0] * pad) for _, t, vs in spec]
    cols = rcols if M is RP else [from_reference(_tbl(names, rcols))
                                  .columns[nm] for nm in names]
    layout = {nm: i for i, nm in enumerate(names)}
    bound = M.ir.bind_columns(build(M), layout)
    schema = lower.schema_from_chunk_columns(names, cols)
    fn = lower.build_project_fn([bound], schema)
    planes = tuple(lower.planes_of_column(c) for c in cols)
    n = len(spec[0][2]) if nrows is None else nrows
    if M is RP:
        outs, mask, err = jax.jit(fn)(planes, np.int32(n))
    else:
        outs, mask, err = fn(tuple(tuple(torch.from_numpy(np.asarray(p))
                                         for p in ps) for ps in planes), n)
    return ([np.asarray(p) for p in outs[0]], np.asarray(mask),
            np.asarray(err), bound, cols)


def _tbl(names, cols):
    return R.Table.from_columns("t", dict(zip(names, cols)))


class _Pkg:
    def __init__(self, T, ir):
        self.T, self.ir = T, ir


RP = _Pkg(R.T, r_ir)
PP = _Pkg(P.T, p_ir)


def check_case(spec, build, fname=None):
    rout, rmask, rerr, _, _ = _run(RP, r_lower, spec, build)
    pout, pmask, perr, bound, cols = _run(PP, p_lower, spec, build)
    assert np.array_equal(rerr, perr), (rerr, perr)
    assert np.array_equal(rmask, pmask)
    assert len(rout) == len(pout)
    assert np.array_equal(rout[1], pout[1])          # valid
    rd, pd = rout[0], pout[0]
    assert rd.dtype == pd.dtype, (rd.dtype, pd.dtype)
    if fname in _TRANSCENDENTAL:
        ok = rout[1] & np.isfinite(rd)
        if fname in _LOOSE_REF:
            np.testing.assert_allclose(pd[ok], rd[ok], rtol=1e-12)
        elif fname == "sqrt":
            assert np.array_equal(pd[ok], rd[ok])
        else:
            np.testing.assert_array_max_ulp(pd[ok], rd[ok], maxulp=1)
        args = [np.asarray([v if v is not None else 0.0 for v in vs],
                           np.float64) for _, _, vs in spec]
        with np.errstate(all="ignore"):
            libm = _TRANSCENDENTAL[fname](*args)
        okl = ok & np.isfinite(libm)
        np.testing.assert_array_max_ulp(pd[okl], libm[okl],
                                        maxulp=0 if fname == "sqrt" else 1)
        assert np.array_equal(np.isnan(rd[rout[1]]), np.isnan(pd[rout[1]]))
    else:
        assert np.array_equal(rd, pd, equal_nan=rd.dtype.kind == "f"), \
            (rd, pd)
    for a, b in zip(rout[2:], pout[2:]):            # numeric exp lane
        assert np.array_equal(a, b)
    _check_host_contract(pout, perr, bound, cols, fname)


def _check_host_contract(out, err, bound, cols, fname):
    """The port's device lanes against the host evaluator (the reference
    test's rule: value, same error, or recheck)."""
    data, valid = out[0], out[1]
    exp = out[2] if len(out) > 2 else None
    for i in range(len(data)):
        try:
            v = ("val", eval_expr_cpu(bound, lambda s: cols[s].get(i)))
        except SqlError as e:
            v = ("err", e)
        if err[i] == ERR_CPU_RECHECK:
            continue
        if v[0] == "err":
            assert err[i] != 0, (i, v)
            continue
        assert err[i] == 0, (i, err[i], v)
        v = v[1]
        if v is None:
            assert not valid[i], i
            continue
        assert valid[i], i
        if exp is not None:
            assert Decimal(int(data[i])).scaleb(int(exp[i])) == v
        elif isinstance(v, bool):
            assert bool(data[i]) == v
        elif isinstance(v, float):
            if fname in _TRANSCENDENTAL:
                assert float(data[i]) == pytest.approx(v, rel=1e-12,
                                                       abs=1e-300)
            else:
                assert float(data[i]) == v or (np.isnan(data[i])
                                               and np.isnan(v))
        else:
            assert int(data[i]) == v


def col(M, name, t):
    return _col(M, name, t)


# name -> (column spec, expression builder, function name for tolerance)
CASES = {
    "int_add_overflow_int2": (
        [("a", "INT2", [1, 32767, -32768, None, 100]),
         ("b", "INT2", [2, 1, -1, 5, None])],
        lambda M: _f(M, "+", col(M, "a", "INT2"), col(M, "b", "INT2")), None),
    "int_mixed_width_promotion": (
        [("a", "INT2", [5, -3, None]), ("b", "INT4", [100000, 2147483647, 7])],
        lambda M: _f(M, "+", col(M, "a", "INT2"), col(M, "b", "INT4")), None),
    "int8_mul_overflow": (
        [("a", "INT8", [3_037_000_500, 3_037_000_500, 2, None, -(1 << 62),
                        -1, -(1 << 63)]),
         ("b", "INT8", [3_037_000_500, 2, 3, 4, 4, -(1 << 63), -1])],
        lambda M: _f(M, "*", col(M, "a", "INT8"), col(M, "b", "INT8")), None),
    "int_div_truncation_and_zero": (
        [("a", "INT4", [7, -7, 7, -7, 5, None]),
         ("b", "INT4", [2, 2, -2, -2, 0, 0])],
        lambda M: _f(M, "/", col(M, "a", "INT4"), col(M, "b", "INT4")), None),
    "int_mod_sign": (
        [("a", "INT4", [7, -7, 7, -7, 3]), ("b", "INT4", [3, 3, -3, -3, 0])],
        lambda M: _f(M, "%", col(M, "a", "INT4"), col(M, "b", "INT4")), None),
    "int8_min_div_minus1": (
        [("a", "INT8", [-(1 << 63), 10]), ("b", "INT8", [-1, -1])],
        lambda M: _f(M, "/", col(M, "a", "INT8"), col(M, "b", "INT8")), None),
    "float4_precision": (
        [("x", "FLOAT4", [1.5, 3.14159, 1e38, None]),
         ("y", "FLOAT4", [2.5, 2.71828, 1e38, 2.0])],
        lambda M: _f(M, "*", col(M, "x", "FLOAT4"), col(M, "y", "FLOAT4")),
        None),
    "float_div_by_zero": (
        [("x", "FLOAT8", [1.0, 0.0]), ("y", "FLOAT8", [0.0, 0.0])],
        lambda M: _f(M, "/", col(M, "x", "FLOAT8"), col(M, "y", "FLOAT8")),
        None),
    "numeric_add_align": (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("0.001"), None,
                           Decimal("123456789.123456789")]),
         ("y", "NUMERIC", [Decimal("2.25"), Decimal("1000"), Decimal("1"),
                           Decimal("0.000000001")])],
        lambda M: _f(M, "+", col(M, "x", "NUMERIC"), col(M, "y", "NUMERIC")),
        None),
    "numeric_mul": (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("-0.25")]),
         ("y", "NUMERIC", [Decimal("4"), Decimal("8.8")])],
        lambda M: _f(M, "*", col(M, "x", "NUMERIC"), col(M, "y", "NUMERIC")),
        None),
    "numeric_out_of_window": (
        [("x", "NUMERIC", [Decimal("1e48"), Decimal("1e-32")]),
         ("y", "NUMERIC", [Decimal("1e48"), Decimal("1e-32")])],
        lambda M: _f(M, "*", col(M, "x", "NUMERIC"), col(M, "y", "NUMERIC")),
        None),
    "kleene_not_null_test": (
        [("p", "BOOL", [True, True, False, None, None, False]),
         ("q", "BOOL", [True, None, None, None, False, False])],
        lambda M: M.ir.BoolExpr(type=M.T.BOOL, op="not", args=(
            M.ir.NullTest(type=M.T.BOOL, arg=col(M, "q", "BOOL"),
                          isnull=True),)), None),
    "case_masks_errors": (
        [("a", "INT4", [10, 20, 30]), ("b", "INT4", [2, 0, 5])],
        lambda M: M.ir.CaseExpr(type=M.T.INT4, whens=((
            _f(M, "<>", col(M, "b", "INT4"), _c(M, "INT4", 0)),
            _f(M, "/", col(M, "a", "INT4"), col(M, "b", "INT4"))),),
            orelse=_c(M, "INT4", 0)), None),
    "null_args_mask_errors": (
        [("a", "INT4", [None]), ("b", "INT4", [0])],
        lambda M: _f(M, "/", col(M, "a", "INT4"), col(M, "b", "INT4")), None),
    "cast_int_narrowing": (
        [("a", "INT4", [100, 40000, -40000, None])],
        lambda M: M.ir.explicit_cast(col(M, "a", "INT4"), M.T.INT2), None),
    "cast_float_to_int_rounding": (
        [("x", "FLOAT8", [1.5, 2.5, -1.5, 0.4, 1e19, float("nan")])],
        lambda M: M.ir.explicit_cast(col(M, "x", "FLOAT8"), M.T.INT8), None),
    "cast_numeric_to_int": (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("2.5"), Decimal("-1.5"),
                           Decimal("10"), Decimal("0.49")])],
        lambda M: M.ir.explicit_cast(col(M, "x", "NUMERIC"), M.T.INT4), None),
    "cast_int_to_numeric": (
        [("a", "INT8", [5, -123, None])],
        lambda M: M.ir.explicit_cast(col(M, "a", "INT8"), M.T.NUMERIC), None),
    "cast_numeric_to_float8": (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("-0.001"), None,
                           Decimal("123456789.25")])],
        lambda M: M.ir.explicit_cast(col(M, "x", "NUMERIC"), M.T.FLOAT8),
        None),
    "timestamp_to_date": (
        [("t", "TIMESTAMP", [0, 1, USEC_DAY - 1, USEC_DAY,
                             5 * USEC_DAY + 123, -1, -USEC_DAY,
                             -USEC_DAY - 1, None])],
        lambda M: M.ir.explicit_cast(col(M, "t", "TIMESTAMP"), M.T.DATE),
        None),
    "date_timestamp_roundtrip": (
        [("d", "DATE", [0, 1, -1, 7305, None])],
        lambda M: M.ir.explicit_cast(M.ir.explicit_cast(
            col(M, "d", "DATE"), M.T.TIMESTAMP), M.T.DATE), None),
    "timestamp_to_time": (
        [("ts", "TIMESTAMP", [3 * USEC_DAY + 7_500_000, -2 * USEC_DAY + 5, 0,
                              None])],
        lambda M: M.ir.explicit_cast(col(M, "ts", "TIMESTAMP"), M.T.TIME),
        None),
    "date_plus_time": (
        [("d", "DATE", [10, -3, None]), ("t", "TIME", [5_000_000, 12, 7])],
        lambda M: _f(M, "+", col(M, "d", "DATE"), col(M, "t", "TIME")), None),
    "time_plus_date": (
        [("d", "DATE", [4]), ("t", "TIME", [99])],
        lambda M: _f(M, "+", col(M, "t", "TIME"), col(M, "d", "DATE")), None),
    "bit_ops_int4": (
        [("a", "INT4", [5, -7, 1 << 30, None]), ("b", "INT4", [3, 33, 2, 1])],
        lambda M: _f(M, "#", _f(M, "<<", col(M, "a", "INT4"),
                                col(M, "b", "INT4")),
                     _f(M, ">>", col(M, "a", "INT4"), col(M, "b", "INT4"))),
        None),
}
for _op in "+-*/":
    CASES[f"float8_{_op}"] = (
        [("x", "FLOAT8", [1.5, -2.25, 1e308, None, 0.0, -0.0, float("nan")]),
         ("y", "FLOAT8", [2.5, 4.0, 1e308, 1.0, 3.0, 2.0, 1.0])],
        lambda M, o=_op: _f(M, o, col(M, "x", "FLOAT8"),
                            col(M, "y", "FLOAT8")), None)
for _op in ("=", "<", ">=", "<>"):
    CASES[f"numeric_compare_{_op}"] = (
        [("x", "NUMERIC", [Decimal("1.5"), Decimal("1.50"), Decimal("-2")]),
         ("y", "NUMERIC", [Decimal("1.49"), Decimal("1.5"), Decimal("3")])],
        lambda M, o=_op: _f(M, o, col(M, "x", "NUMERIC"),
                            col(M, "y", "NUMERIC")), None)
    CASES[f"float8_bits_compare_{_op}"] = (
        [("x", "FLOAT8", [1.5, -0.0, float("nan"), float("nan"), -3.0]),
         ("y", "FLOAT8", [1.5, 0.0, float("nan"), 1e300, -2.0])],
        lambda M, o=_op: _f(M, o, col(M, "x", "FLOAT8"),
                            col(M, "y", "FLOAT8")), None)
for _op in ("and", "or"):
    CASES[f"kleene_{_op}"] = (
        [("p", "BOOL", [True, True, False, None, None, False]),
         ("q", "BOOL", [True, None, None, None, False, False])],
        lambda M, o=_op: M.ir.BoolExpr(type=M.T.BOOL, op=o, args=(
            col(M, "p", "BOOL"), col(M, "q", "BOOL"))), None)
for _isnull in (True, False):
    CASES[f"null_test_{_isnull}"] = (
        [("p", "INT4", [1, None, 3])],
        lambda M, v=_isnull: M.ir.NullTest(type=M.T.BOOL,
                                           arg=col(M, "p", "INT4"),
                                           isnull=v), None)
for _op, _val in [("=", "banana"), ("<>", "banana"), ("<", "b"), (">=", "b"),
                  ("=", "missing"), ("<=", "apricot")]:
    CASES[f"text_{_op}_{_val}"] = (
        [("s", "TEXT", ["apple", "banana", None, "cherry", "apricot"])],
        lambda M, o=_op, v=_val: _f(M, o, col(M, "s", "TEXT"),
                                    _c(M, "TEXT", v)), None)
for _fn in ("sqrt", "exp", "ln", "floor", "ceil", "cbrt", "sin", "round",
            "log", "cos", "atan", "sign", "degrees", "trunc", "abs"):
    CASES[f"math1_{_fn}"] = (
        [("x", "FLOAT8", [4.0, 0.25, 100.0, None, 2.0, -0.0, 1e-300, 27.0,
                          -8.0, 2.5, -2.5])],
        lambda M, f=_fn: _f(M, f, col(M, "x", "FLOAT8")), _fn)
CASES["math1_sqrt_negative"] = (
    [("x", "FLOAT8", [-1.0, 4.0])],
    lambda M: _f(M, "sqrt", col(M, "x", "FLOAT8")), "sqrt")
CASES["math2_power"] = (
    [("x", "FLOAT8", [2.0, -8.0, 0.5, 10.0, None]),
     ("y", "FLOAT8", [10.0, 0.5, -3.0, 308.5, 1.0])],
    lambda M: _f(M, "power", col(M, "x", "FLOAT8"), col(M, "y", "FLOAT8")),
    "power")


@pytest.mark.parametrize("name", list(CASES))
def test_lowering_matches_reference(name):
    spec, build, fname = CASES[name]
    check_case(spec, build, fname)


def test_rows_beyond_nrows_never_error():
    """Padded rows hold a zero divisor; nrows masks them in both packages."""
    spec = [("a", "INT4", [10, 20]), ("b", "INT4", [2, 5])]

    def build(M):
        return _f(M, "/", col(M, "a", "INT4"), col(M, "b", "INT4"))
    for M, lower in ((RP, r_lower), (PP, p_lower)):
        _, mask, err, _, _ = _run(M, lower, spec, build, nrows=2, pad=2)
        assert err.max() == 0
        assert list(mask) == [True, True, False, False]


def test_qual_fn_matches_reference():
    spec = [("x", "FLOAT8", [1.0, None, 3.0, float("nan"), 0.5]),
            ("a", "INT4", [1, 2, 0, 4, 5])]
    names = [n for n, _, _ in spec]
    rcols = [r_values(R.T[t], vs) for _, t, vs in spec]
    pcols = [from_reference(_tbl(names, rcols)).columns[nm] for nm in names]
    outs = []
    for M, lower, cols in ((RP, r_lower, rcols), (PP, p_lower, pcols)):
        pred = M.ir.bind_columns(M.ir.BoolExpr(type=M.T.BOOL, op="or", args=(
            _f(M, ">", col(M, "x", "FLOAT8"), _c(M, "FLOAT8", 0.75)),
            _f(M, "=", _f(M, "/", _c(M, "INT4", 10), col(M, "a", "INT4")),
               _c(M, "INT4", 5)))), {n: i for i, n in enumerate(names)})
        fn = lower.build_qual_fn(pred, lower.schema_from_chunk_columns(
            names, cols))
        planes = tuple(lower.planes_of_column(c) for c in cols)
        if M is RP:
            mask, err = jax.jit(fn)(planes, np.int32(5))
        else:
            mask, err = fn(tuple(tuple(torch.from_numpy(np.asarray(p))
                                       for p in ps) for ps in planes), 5)
        outs.append((np.asarray(mask), np.asarray(err)))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

def _hash_inputs(rng, n=3000):
    f4 = rng.standard_normal(n).astype(np.float32)
    f4[:4] = [0.0, -0.0, np.nan, -np.nan]
    f8 = rng.standard_normal(n)
    f8[:4] = [0.0, -0.0, np.nan, -np.nan]
    return {
        "INT2": rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
        "INT4": rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        .astype(np.int32),
        "INT8": rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64),
        "DATE": rng.integers(-10000, 10000, n).astype(np.int32),
        "TIMESTAMP": rng.integers(-2 ** 50, 2 ** 50, n, dtype=np.int64),
        "FLOAT4": f4, "FLOAT8": f8, "BOOL": rng.random(n) > 0.5,
        "TEXT": rng.integers(0, 30, n).astype(np.int32),
        "NUMERIC": rng.integers(-10 ** 12, 10 ** 12, n, dtype=np.int64),
    }


@pytest.mark.parametrize("tname", ["INT2", "INT4", "INT8", "DATE",
                                   "TIMESTAMP", "FLOAT4", "FLOAT8",
                                   "FLOAT8_bits", "BOOL", "TEXT", "NUMERIC"])
def test_hash_column_bit_identical(tname):
    rng = np.random.default_rng(7)
    base = tname.split("_")[0]
    d = _hash_inputs(rng)[base]
    valid = rng.random(len(d)) > 0.1
    bits = d.view(np.int64) if tname == "FLOAT8_bits" else None
    exp = (rng.integers(-32, 32, len(d)).astype(np.int32)
           if base == "NUMERIC" else None)
    rt, pt = R.T[base], P.T[base]

    def jarr(a):
        return None if a is None else jnp.asarray(a)

    def tarr(a):
        return None if a is None else torch.from_numpy(a)
    # FLOAT8_bits: the reference hashes its bits plane; the port has none
    # and hashes the data lane's bits, which must give the same hashes
    r32 = np.asarray(r_hash.hash_column32(rt, jarr(d), jarr(valid),
                                          jarr(exp), jarr(bits)))
    p32 = p_hash.hash_column32(pt, tarr(d), tarr(valid), tarr(exp)).numpy()
    assert np.array_equal(r32.astype(np.int64), p32)
    r64 = np.asarray(r_hash.hash_column(rt, jarr(d), jarr(valid), jarr(exp),
                                        jarr(bits)))
    p64 = p_hash.hash_column(pt, tarr(d), tarr(valid), tarr(exp)).numpy()
    assert np.array_equal(r64.view(np.int64), p64)


def test_combine_hashes_bit_identical():
    rng = np.random.default_rng(8)
    ins = _hash_inputs(rng)
    valid = rng.random(3000) > 0.1
    keys = [("INT4", ins["INT4"]), ("TEXT", ins["TEXT"]),
            ("FLOAT8", ins["FLOAT8"])]
    r32 = [r_hash.hash_column32(R.T[t], jnp.asarray(d), jnp.asarray(valid))
           for t, d in keys]
    p32 = [p_hash.hash_column32(P.T[t], torch.from_numpy(d),
                                torch.from_numpy(valid)) for t, d in keys]
    assert np.array_equal(np.asarray(r_hash.combine_hashes32(r32))
                          .astype(np.int64),
                          p_hash.combine_hashes32(p32).numpy())
    r64 = [r_hash.hash_column(R.T[t], jnp.asarray(d), jnp.asarray(valid))
           for t, d in keys]
    p64 = [p_hash.hash_column(P.T[t], torch.from_numpy(d),
                              torch.from_numpy(valid)) for t, d in keys]
    assert np.array_equal(np.asarray(r_hash.combine_hashes(r64))
                          .view(np.int64),
                          p_hash.combine_hashes(p64).numpy())
