"""The hash join (pg_strom_tpu_torch/ops/hashjoin.py, exec/join_exec.py)
against the JAX reference; mirrors tests/test_hashjoin.py.

Three levels, each on the same numpy-seeded tables in both packages:

* the build: every entry of build_hash_table's dict is equal, `dense_M`
  after decoding the reference's digit matrix into the port's raw table;
* the probes: build_probe_dense_fn (identity, K3 and gather branches),
  build_probe_multi_fn and build_probe_fn (overflow and long chains
  included) give equal outputs;
* the executor: HashJoinExecutor rows and perfmon counters are equal for
  inner / left / right / full joins, residual ON conditions, nloops
  partitions, NULL and duplicate keys, float8 keys with -0 and NaN, an
  empty build side, and a long chain that falls back to the host.

The port runs on the CPU (K3's plain version); comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pg_strom_tpu as R
import pg_strom_tpu_torch as P
from pg_strom_tpu.expr import ir as r_ir
from pg_strom_tpu.expr.lower_jax import (
    schema_from_chunk_columns as r_schema, planes_of_column as r_planes)
from pg_strom_tpu.ops import hashjoin as r_hj
from pg_strom_tpu.exec import join_exec as r_je
from pg_strom_tpu.utils.perfmon import Perfmon as RPerfmon
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.expr import ir as p_ir
from pg_strom_tpu_torch.expr.lower_torch import (
    schema_from_chunk_columns as p_schema, planes_of_column as p_planes)
from pg_strom_tpu_torch.ops import hashjoin as p_hj
from pg_strom_tpu_torch.ops.mxu_lookup import decode_digit_matrix
from pg_strom_tpu_torch.exec import join_exec as p_je
from pg_strom_tpu_torch.utils.perfmon import Perfmon as PPerfmon

COUNTERS = ("device_chunks", "recheck_chunks", "regrow_retries",
            "nloops_passes")


def _pair(name: str, cols: dict):
    """(reference Table, port Table) from {col: (type name, values)}."""
    rt = R.Table.from_columns(name, {
        c: R.column_from_values(R.T[t], v) for c, (t, v) in cols.items()})
    return rt, from_reference(rt)


def _make(nprobe=700, nbuild=50, dup=3, seed=7):
    """tests/test_hashjoin.make_tables: NULL keys on both sides, every
    fifth build key duplicated."""
    rng = np.random.default_rng(seed)
    bkeys, bpayload = [], []
    for i in range(nbuild):
        for _ in range(dup if i % 5 == 0 else 1):
            bkeys.append(i if rng.random() > 0.05 else None)
            bpayload.append(int(rng.integers(0, 1000)))
    build = _pair("dim", {"k": ("INT4", bkeys),
                          "payload": ("INT4", bpayload)})
    probe = _pair("fact", {
        "k": ("INT4", [int(rng.integers(0, nbuild * 2))
                       if rng.random() > 0.05 else None
                       for _ in range(nprobe)]),
        "v": ("FLOAT8", [float(rng.random()) for _ in range(nprobe)]),
        "id": ("INT4", list(range(nprobe)))})
    return probe, build


def _dim(keys, seed=3):
    """A build side with the given keys and a row-number payload."""
    return _pair("dim", {"k": ("INT4", list(keys)),
                         "payload": ("INT4", list(range(len(keys))))})


def _fact(nkeys, nprobe=500, seed=3, lo=-3):
    rng = np.random.default_rng(seed)
    return _pair("fact", {
        "k": ("INT4", [int(rng.integers(lo, nkeys + 5))
                       if rng.random() > 0.05 else None
                       for _ in range(nprobe)]),
        "v": ("FLOAT8", [float(i) for i in range(nprobe)]),
        "id": ("INT4", list(range(nprobe)))})


def _ref(M, ir, table, name):
    names = table.column_names
    return ir.ColumnRef(type=table.columns[name].type, name=name,
                        index=names.index(name))


# ---------------------------------------------------------------------------
# build_hash_table
# ---------------------------------------------------------------------------

def _build_both(rt, pt, keys=("k",), pred=None):
    names = rt.column_names
    rk = [_ref(R, r_ir, rt, k) for k in keys]
    pk = [_ref(P, p_ir, pt, k) for k in keys]
    rpred = ppred = None
    if pred is not None:
        rpred = pred(R, r_ir, rt)
        ppred = pred(P, p_ir, pt)
    rb = max(rt.nrows, 1).bit_length()
    cap = max(16, 1 << (rt.nrows - 1).bit_length())
    rchunk = next(iter(rt.chunks(cap)))
    pchunk = next(iter(pt.chunks(cap)))
    rht = jax.jit(r_hj.build_hash_table(
        r_schema(names, [rt.columns[n] for n in names]), rk, rpred,
        row_bits=rb))(tuple(tuple(jnp.asarray(p) for p in
                                  r_planes(rchunk.columns[n]))
                            for n in names), np.int32(rchunk.nrows))
    pht = p_hj.build_hash_table(
        p_schema(names, [pt.columns[n] for n in names]), pk, ppred,
        row_bits=rb)(tuple(tuple(torch.from_numpy(np.ascontiguousarray(p))
                                 for p in p_planes(pchunk.columns[n]))
                           for n in names), pchunk.nrows)
    return rht, pht, rk, pk


def _assert_tables_equal(rht, pht):
    assert set(rht) == set(pht)
    for key in ("bucket_start", "order", "kmin", "dense_ok", "dense_m_ok",
                "dense_ident", "nbuild", "err"):
        np.testing.assert_array_equal(np.asarray(pht[key]),
                                      np.asarray(rht[key]), err_msg=key)
    assert len(pht["key_planes"]) == len(rht["key_planes"])
    for rp, pp in zip(rht["key_planes"], pht["key_planes"]):
        for a, b in zip(rp, pp):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    rdense = np.asarray(rht["dense"])
    pdense = pht["dense"].numpy()
    K = rht["dense_M"].shape[0] // 128
    rM = decode_digit_matrix(np.asarray(rht["dense_M"]), 0, K)
    pM = pht["dense_M"].numpy()
    assert rdense.shape == pdense.shape and rM.shape == pM.shape
    if bool(rht["dense_ok"]) or rdense.shape[0] == 1:
        np.testing.assert_array_equal(pdense, rdense)
        np.testing.assert_array_equal(pM, rM)
    else:
        # duplicate build keys: a slot written twice holds either row (the
        # scatter order is undefined in both packages); dense_ok is false
        # and no probe reads the table.  Every other slot is equal.
        slots = np.flatnonzero(pdense == rdense)
        assert len(slots) >= pdense.shape[0] - 64
        np.testing.assert_array_equal(pM[slots[slots < pM.shape[0]]],
                                      rM[slots[slots < rM.shape[0]]])


def _float_keys():
    rng = np.random.default_rng(3)
    vals = [float(rng.random()) for _ in range(40)]
    return _pair("dim", {
        "k": ("FLOAT8", vals[:20] + [-0.0, float("nan"), None]),
        "payload": ("INT4", list(range(23)))})


def _multi_keys():
    rng = np.random.default_rng(9)
    return _pair("dim", {
        "k": ("INT4", [int(v) for v in rng.integers(0, 20, 90)]),
        "k2": ("INT8", [int(v) for v in rng.integers(-5, 5, 90)]),
        "payload": ("INT4", list(range(90)))})


BUILDS = {
    "unique_shuffled": (lambda: _dim(np.random.default_rng(1)
                                     .permutation(300).tolist()), ("k",)),
    "serial": (lambda: _dim(range(100, 164)), ("k",)),
    "gap_null": (lambda: _dim([None if i == 10 else i for i in range(64)]),
                 ("k",)),
    "duplicates_nulls": (lambda: _make()[1], ("k",)),
    "far_keys": (lambda: _dim([0, 1 << 30, 5]), ("k",)),
    "float8": (_float_keys, ("k",)),
    "two_keys": (_multi_keys, ("k", "k2")),
    "window_beyond_k3": (lambda: _dim(list(range(0, 5 * 20000, 5))), ("k",)),
}


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_hash_table_entries_equal(name):
    make, keys = BUILDS[name]
    rt, pt = make()
    rht, pht, _, _ = _build_both(rt, pt, keys)
    _assert_tables_equal(rht, pht)


def test_build_hash_table_with_pred():
    rt, pt = _make()[1]

    def pred(M, ir, t):
        return ir.resolve_function(">", (_ref(M, ir, t, "payload"),
                                         ir.Const(type=M.T.INT4, value=300)))
    rht, pht, _, _ = _build_both(rt, pt, ("k",), pred)
    _assert_tables_equal(rht, pht)


def test_identity_flags():
    for keys, ident in (([100 + i for i in range(64)], True),
                        (list(range(64))[:3] + [40] + list(range(4, 40))
                         + [3] + list(range(41, 64)), False),
                        ([None if i == 10 else i for i in range(64)], False)):
        rt, pt = _dim(keys)
        rht, pht, _, _ = _build_both(rt, pt)
        assert bool(pht["dense_ident"]) == bool(rht["dense_ident"]) == ident


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _probe_inputs(rt, pt, cap=1024):
    names = rt.column_names
    rc = next(iter(rt.chunks(cap)))
    pc = next(iter(pt.chunks(cap)))
    rcols = tuple(tuple(jnp.asarray(p) for p in r_planes(rc.columns[n]))
                  for n in names)
    pcols = tuple(tuple(torch.from_numpy(np.ascontiguousarray(p))
                        for p in p_planes(pc.columns[n])) for n in names)
    return (r_schema(names, [rt.columns[n] for n in names]), rcols,
            p_schema(names, [pt.columns[n] for n in names]), pcols, rc.nrows)


def _outs_equal(r_out, p_out):
    for a, b in zip(r_out, p_out):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("branch,keys", [
    ("ident", [100 + i for i in range(64)]),
    ("mxu", np.random.default_rng(2).permutation(300).tolist()),
    ("gather", list(range(0, 5 * 20000, 5))),
])
def test_probe_dense_branches_equal(branch, keys):
    brt, bpt = _dim(keys)
    rht, pht, _, _ = _build_both(brt, bpt)
    assert bool(rht["dense_ok"])
    nk = max(k for k in keys if k is not None)
    prt, ppt = _fact(nk, nprobe=900, seed=len(keys), lo=-3)
    rs, rcols, ps, pcols, nrows = _probe_inputs(prt, ppt)
    bcap = max(16, 1 << (brt.nrows - 1).bit_length())
    use_mxu = branch == "mxu"
    dcap = r_hj.mxu_dense_window(bcap) if use_mxu else r_hj.dense_cap_for(bcap)
    rb = max(brt.nrows, 1).bit_length()
    if branch == "gather":
        assert not bool(rht["dense_m_ok"])
    kw = dict(use_mxu=use_mxu, row_bits=rb, use_ident=branch == "ident")
    r_out = jax.jit(r_hj.build_probe_dense_fn(
        rs, [_ref(R, r_ir, prt, "k")], dcap, **kw))(rht, rcols,
                                                    np.int32(nrows))
    p_out = p_hj.build_probe_dense_fn(
        ps, [_ref(P, p_ir, ppt, "k")], dcap, **kw)(pht, pcols, nrows)
    _outs_equal(r_out, p_out)
    assert int(p_out[2]) > 0


@pytest.mark.parametrize("fanout,max_chain", [(2, 8), (4, 16)])
def test_probe_multi_equal(fanout, max_chain):
    brt, bpt = _make()[1]
    rht, pht, _, _ = _build_both(brt, bpt)
    prt, ppt = _make()[0]
    rs, rcols, ps, pcols, nrows = _probe_inputs(prt, ppt)
    kt = (R.T.INT4,)
    r_out = jax.jit(r_hj.build_probe_multi_fn(
        rs, [_ref(R, r_ir, prt, "k")], kt, max_chain, fanout))(
            rht, rcols, np.int32(nrows))
    p_out = p_hj.build_probe_multi_fn(
        ps, [_ref(P, p_ir, ppt, "k")], (P.T.INT4,), max_chain, fanout)(
            pht, pcols, nrows)
    _outs_equal(r_out, p_out)


@pytest.mark.parametrize("case", ["fits", "overflow", "long_chain",
                                  "two_keys", "float8"])
def test_probe_chain_equal(case):
    keys = ("k",)
    max_chain, out_cap = 16, 2048
    if case == "two_keys":
        brt, bpt = _multi_keys()
        keys = ("k", "k2")
        rng = np.random.default_rng(4)
        prt, ppt = _pair("fact", {
            "k": ("INT4", [int(v) for v in rng.integers(0, 25, 600)]),
            "k2": ("INT8", [int(v) for v in rng.integers(-6, 6, 600)])})
    elif case == "float8":
        brt, bpt = _float_keys()
        vals = list(brt.columns["k"].data[:20]) + [0.0, float("nan"), 1.5]
        prt, ppt = _pair("fact", {"k": ("FLOAT8", [float(v) for v in vals]
                                        * 3)})
    else:
        brt, bpt = _make()[1]
        prt, ppt = _make()[0]
        if case == "overflow":
            out_cap = 64
        if case == "long_chain":
            max_chain = 2
    rht, pht, _, _ = _build_both(brt, bpt, keys)
    rs, rcols, ps, pcols, nrows = _probe_inputs(prt, ppt)
    nb = int(rht["bucket_start"].shape[0]) - 1
    rkt = tuple(brt.columns[k].type for k in keys)
    pkt = tuple(bpt.columns[k].type for k in keys)
    r_out = jax.jit(r_hj.build_probe_fn(
        rs, [_ref(R, r_ir, prt, k) for k in keys], rkt, nb, max_chain,
        out_cap))(rht, rcols, np.int32(nrows))
    p_out = p_hj.build_probe_fn(
        ps, [_ref(P, p_ir, ppt, k) for k in keys], pkt, nb, max_chain,
        out_cap)(pht, pcols, nrows)
    nout = int(r_out[2])
    assert int(p_out[2]) == nout and int(p_out[3]) == int(r_out[3])
    np.testing.assert_array_equal(p_out[0].numpy(), np.asarray(r_out[0]))
    np.testing.assert_array_equal(p_out[1].numpy(), np.asarray(r_out[1]))
    if case == "overflow":
        assert nout > out_cap
    if case == "long_chain":
        assert int(p_out[3]) != 0
    if case == "float8":
        assert nout >= 22                     # -0 = +0 and NaN = NaN pairs


# ---------------------------------------------------------------------------
# HashJoinExecutor
# ---------------------------------------------------------------------------

def _rows(t):
    key = lambda r: tuple((v is None, v if v == v else 1e308)  # noqa: E731
                          for v in r)
    return sorted((tuple(t.columns[c].get(i) for c in t.column_names)
                   for i in range(t.nrows)), key=key)


def _exec_both(probe, build, pkeys=("k",), bkeys=("k",), pcols=None,
               bcols=None, jointype="inner", probe_pred=None,
               build_pred=None, residual=None, chunk_rows=256, **cfg):
    outs = []
    for M, ir, ex, Pm, (pt, bt) in (
            (R, r_ir, r_je, RPerfmon, (probe[0], build[0])),
            (P, p_ir, p_je, PPerfmon, (probe[1], build[1]))):
        pm = Pm()
        kw = dict(cfg, chunk_rows=chunk_rows)
        if M is P:
            kw["device"] = "cpu"
        with M.override(**kw):
            t = ex.HashJoinExecutor(
                pt, bt, [_ref(M, ir, pt, k) for k in pkeys],
                [_ref(M, ir, bt, k) for k in bkeys],
                out_probe_cols=pcols or pt.column_names,
                out_build_cols=bcols or bt.column_names,
                probe_pred=probe_pred(M, ir, pt) if probe_pred else None,
                build_pred=build_pred(M, ir, bt) if build_pred else None,
                jointype=jointype,
                residual=residual(M, ir, pt, bt) if residual else None,
                perfmon=pm).run()
        outs.append((t.column_names, _rows(t),
                     {c: pm.counts.get(c, 0) for c in COUNTERS}))
    (rn, rrows, rc), (pn, prows, pc) = outs
    assert pn == rn
    assert prows == rrows
    assert pc == rc
    return prows, pc


def _v_lt(M, ir, t):
    return ir.resolve_function("<", (_ref(M, ir, t, "v"),
                                     ir.Const(type=M.T.FLOAT8, value=0.5)))


def _residual(M, ir, pt, bt):
    # ON ... AND i.payload > o.id (bound to the joined layout by name)
    return ir.resolve_function(">", (
        ir.ColumnRef(type=M.T.INT4, name="i.payload"),
        ir.ColumnRef(type=M.T.INT4, name="o.id")))


@pytest.mark.parametrize("jointype", ["inner", "left", "full"])
def test_executor_join_types(jointype):
    probe, build = _make()
    rows, c = _exec_both(probe, build, jointype=jointype)
    assert c["device_chunks"] >= 3 and c["recheck_chunks"] == 0
    if jointype != "inner":
        assert any(r[-1] is None for r in rows)      # NULL-extended


def test_executor_right_join_as_swapped_left():
    probe, build = _make()
    _exec_both(build, probe, jointype="left")


@pytest.mark.parametrize("jointype", ["inner", "left"])
def test_executor_residual_on_condition(jointype):
    probe, build = _make()
    _exec_both(probe, build, jointype=jointype, residual=_residual)


def test_executor_probe_filter_pushdown():
    probe, build = _make()
    _exec_both(probe, build, probe_pred=_v_lt)


@pytest.mark.parametrize("jointype", ["inner", "left", "full"])
def test_executor_nloops_partitions(jointype):
    rng = np.random.default_rng(7)
    probe = _pair("p", {
        "k": ("INT4", [None if i % 53 == 0 else int(v)
                       for i, v in enumerate(rng.integers(0, 1600, 1000))]),
        "x": ("FLOAT8", [float(v) for v in rng.random(1000)])})
    build = _pair("b", {
        "bk": ("INT4", [int(v) for v in rng.integers(0, 1500, 60000)]),
        "w": ("INT8", list(range(60000)))})
    # the 2.3 MB build estimate over a 1 MB budget: four partitions
    _, c = _exec_both(probe, build, pkeys=("k",), bkeys=("bk",),
                      jointype=jointype, chunk_rows=4096,
                      join_build_hbm_mb=1)
    assert c["nloops_passes"] >= 2


def test_executor_null_keys_never_match():
    probe = _pair("p", {"k": ("INT4", [1, None, 3]),
                        "v": ("FLOAT8", [0.1, 0.2, 0.3]),
                        "id": ("INT4", [0, 1, 2])})
    build = _pair("b", {"k": ("INT4", [None, 1]),
                        "payload": ("INT4", [10, 20])})
    rows, _ = _exec_both(probe, build)
    assert len(rows) == 1


def test_executor_duplicate_build_keys_fan_out():
    probe = _pair("p", {"k": ("INT4", [5, 5]), "v": ("FLOAT8", [1.0, 2.0]),
                        "id": ("INT4", [0, 1])})
    build = _pair("b", {"k": ("INT4", [5] * 4),
                        "payload": ("INT4", [1, 2, 3, 4])})
    rows, _ = _exec_both(probe, build)
    assert len(rows) == 8


def test_executor_float8_keys():
    build = _float_keys()
    vals = [float(v) for v in build[0].columns["k"].data[:20]]
    probe = _pair("p", {"k": ("FLOAT8", vals * 2 + [0.0, float("nan")]),
                        "id": ("INT4", list(range(42)))})
    rows, _ = _exec_both(probe, build, pcols=["id"], bcols=["payload"],
                         chunk_rows=64)
    assert len(rows) == 42


def test_executor_empty_build():
    probe = _make(nprobe=50)[0]
    build = _pair("b", {"k": ("INT4", []), "payload": ("INT4", [])})
    rows, _ = _exec_both(probe, build)
    assert rows == []


def test_executor_long_chain_falls_back():
    probe = _pair("p", {"k": ("INT4", [9, 1]), "v": ("FLOAT8", [0.0, 1.0]),
                        "id": ("INT4", [0, 1])})
    build = _pair("b", {"k": ("INT4", [9] * 64 + [1]),
                        "payload": ("INT4", list(range(65)))})
    rows, c = _exec_both(probe, build, join_max_bucket_probe=8)
    assert len(rows) == 65 and c["recheck_chunks"] == 1


def test_executor_regrow_on_overflow():
    n = 300
    probe = _pair("p", {"k": ("INT4", [7] * n), "v": ("FLOAT8", [0.0] * n),
                        "id": ("INT4", list(range(n)))})
    # 128-row chunks x 16 matches each exceed the 1024-pair output buffer
    build = _pair("b", {"k": ("INT4", [7] * 16),
                        "payload": ("INT4", list(range(16)))})
    rows, c = _exec_both(probe, build, chunk_rows=128)
    assert len(rows) == n * 16 and c["regrow_retries"] >= 1


@pytest.mark.parametrize("keys", [
    [100 + i for i in range(64)],                          # identity
    np.random.default_rng(5).permutation(64).tolist(),     # K3
    [None if i == 10 else i for i in range(64)],           # gap: K3
    list(range(0, 5 * 20000, 5)),                          # gather
])
def test_executor_dense_probe_branches(keys):
    nk = max(k for k in keys if k is not None)
    _exec_both(_fact(nk, nprobe=600), _dim(keys))
