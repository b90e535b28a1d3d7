"""Port-vs-reference SQL fuzz: random statements from the port's
`utils/sqlgen.py`, each run three ways with a strict comparator.

- The port's generator emits the reference's statements, string for
  string, for seeds 0-11 (the seeds of tests/test_fuzz_sql.py), SELECTs
  and DML alike.
- Every statement runs through the JAX reference (device path), the
  port's device path (plain versions of the kernels on the CPU) and the
  port's host tier (pg_strom.enabled off), under `rand_cfg` of
  tests/test_fuzz_sql.py, its distributed axis included: the port's mesh
  has as many shards as the reference has devices (8 on the rig of
  tests/conftest.py).  The three outcomes must be equal: rows as
  PostgreSQL text at extra_float_digits=-3, or the same error text.
  Unordered results compare as sorted multisets; there is no float
  tolerance and no greedy row matching.
- UPDATE/DELETE run three ways on fresh copies of the database, and the
  whole table must then be equal.

A mismatch reports its seed, config and SQL.  No case is whitelisted: the
fuzz has found no reference fault (ROADMAP §3).
"""

from __future__ import annotations

import random

import jax
import pytest

import pg_strom_tpu as R
from pg_strom_tpu.sql import execute as r_execute
import pg_strom_tpu_torch as P
from pg_strom_tpu.utils import sqlgen as r_sqlgen
from pg_strom_tpu_torch.datastore import from_reference
from pg_strom_tpu_torch.utils import sqlgen as p_sqlgen
from test_fuzz_sql import build_fuzz_db, fuzz_schema, rand_cfg

N_PER_SEED = 6
SEEDS = list(range(12))
DML_SEEDS = list(range(6))


def _specs(sqlgen):
    """tests/test_fuzz_sql.py's schema as `sqlgen`'s TableSpecs."""
    tables, pairs = fuzz_schema()
    return [sqlgen.TableSpec(t.name, dict(t.cols), t.unique_col)
            for t in tables], pairs


def _statements(sqlgen, seed):
    """test_fuzz_differential's draw: the generator, the config, then
    N_PER_SEED statements, all from one random.Random(seed)."""
    rng = random.Random(seed)
    tables, pairs = _specs(sqlgen)
    gen = sqlgen.QueryGen(rng, tables, pairs)
    cfg = rand_cfg(rng)
    return cfg, [gen.gen() for _ in range(N_PER_SEED)]


def _dml(sqlgen, seed):
    """test_fuzz_dml_differential's draw."""
    rng = random.Random(1000 + seed)
    tables, pairs = _specs(sqlgen)
    gen = sqlgen.QueryGen(rng, tables, pairs)
    out = []
    for _ in range(4):
        tname = rng.choice(["fuzz_dim", "fuzz_skew"])
        sql = gen.gen_dml(tname)
        out.append((tname, sql, rand_cfg(rng)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_matches_reference(seed):
    assert _statements(p_sqlgen, seed) == _statements(r_sqlgen, seed)
    assert _dml(p_sqlgen, seed) == _dml(r_sqlgen, seed)


WAYS = ("reference", "port device", "port host")


def _run(way, sql, db, cfg, ordered):
    """One statement one way; rows as PostgreSQL text, or the error."""
    if way == "reference":
        execute, override, error = r_execute, R.override, R.SqlError
        cfg = dict(cfg, enabled=True)
    else:
        execute, override, error = P.execute, P.override, P.SqlError
        cfg = dict(cfg, device="cpu", enabled=way == "port device",
                   debug_force_offload=True, mesh_shards=len(jax.devices()))
    try:
        with override(**cfg):
            r = execute(sql, db)
        rows = r.formatted(-3)
        return ("rows", tuple(r.columns),
                tuple(rows if ordered else sorted(rows)))
    except error as e:
        return ("error", str(e))


@pytest.fixture(scope="module")
def dbs():
    rdb = build_fuzz_db()
    return rdb, from_reference(rdb)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_port_vs_reference(dbs, seed):
    rdb, pdb = dbs
    cfg, stmts = _statements(p_sqlgen, seed)
    for i, (sql, ordered) in enumerate(stmts):
        ref, dev, host = (_run(w, sql, rdb if w == "reference" else pdb,
                               cfg, ordered) for w in WAYS)
        assert ref == dev == host, (
            f"seed={seed} q#{i} cfg={cfg}\nSQL: {sql}\n"
            f"reference: {str(ref)[:600]}\nport device: {str(dev)[:600]}\n"
            f"port host: {str(host)[:600]}")


@pytest.mark.parametrize("seed", DML_SEEDS)
def test_fuzz_dml_port_vs_reference(seed):
    for i, (tname, sql, cfg) in enumerate(_dml(p_sqlgen, seed)):
        outs = []
        for way in WAYS:
            rdb = build_fuzz_db()
            db = rdb if way == "reference" else from_reference(rdb)
            res = _run(way, sql, db, cfg, True)
            if res[0] == "error":
                outs.append(res)
                continue
            chk = _run(way, f"select * from {tname}", db, cfg, False)
            outs.append(chk)
        assert outs[0] == outs[1] == outs[2], (
            f"seed={seed} q#{i} cfg={cfg}\nSQL: {sql}\n"
            f"reference: {str(outs[0])[:400]}\n"
            f"port device: {str(outs[1])[:400]}\n"
            f"port host: {str(outs[2])[:400]}")
