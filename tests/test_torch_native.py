"""The port's native runtime (pg_strom_tpu_torch/native) against the
reference's (pg_strom_tpu/native).

- Each test class of tests/test_native.py runs over both modules: the
  arena and its slab tier with their guards, the message queue, the
  worker pool, pg_crc32, PgRandom and the CSV loader.
- The port builds its own library from its own copy of the source into
  pg_strom_tpu_torch/_build/, never the reference's.
- PgRandom's stream, and load_csv / load_csv2 planes on the same text
  (malformed-field counts included), are equal across the two modules.
- models/pg_fixture.py's tables are the reference's, column for column,
  bit for bit.
"""

import os
import threading

import numpy as np
import pytest

import pg_strom_tpu.datastore as r_ds
import pg_strom_tpu.native as r_native
import pg_strom_tpu_torch.datastore as p_ds
import pg_strom_tpu_torch.native as p_native


@pytest.fixture(params=["reference", "port"])
def N(request):
    return r_native if request.param == "reference" else p_native


@pytest.fixture()
def ds(N):
    return r_ds if N is r_native else p_ds


class TestArena:
    def test_alloc_free_roundtrip(self, N):
        a = N.Arena(1 << 20)
        ptrs = [a.alloc(100 + i * 37) for i in range(50)]
        s = a.stats()
        assert s["n_alloc"] == 50 and s["bytes_live"] > 0
        for p in ptrs:
            a.free(p)
        s = a.stats()
        assert s["n_free"] == 50 and s["bytes_live"] == 0

    def test_buddy_coalescing_allows_big_alloc_after_frees(self, N):
        a = N.Arena(1 << 20)
        ptrs = [a.alloc(1000) for _ in range(200)]
        for p in ptrs:
            a.free(p)
        big = a.alloc((1 << 20) - 4096)  # near-whole zone after coalescing
        a.free(big)

    def test_redzone_detection(self, N):
        import ctypes
        a = N.Arena(1 << 20)
        p = a.alloc(64)
        ctypes.memset(p + 64, 0x41, 4)  # stomp the redzone
        with pytest.raises(RuntimeError, match="redzone"):
            a.free(p)

    def test_double_free_detected(self, N):
        a = N.Arena(1 << 20)
        p = a.alloc(64)
        a.free(p)
        with pytest.raises(RuntimeError, match="double free"):
            a.free(p)

    def test_owner_release_sweep(self, N):
        a = N.Arena(1 << 20)
        for _ in range(10):
            a.alloc(256, owner=42)
        keep = a.alloc(256, owner=7)
        assert a.release_owner(42) == 10
        assert a.stats()["bytes_live"] > 0  # owner 7 survives
        a.free(keep)
        assert a.stats()["bytes_live"] == 0

    def test_oom(self, N):
        a = N.Arena(1 << 16)
        with pytest.raises(MemoryError):
            a.alloc(1 << 20)


class TestMQueue:
    def test_fifo(self, N):
        q = N.MQueue()
        for i in range(10):
            q.push(i)
        assert [q.pop() for _ in range(10)] == list(range(10))

    def test_timeout(self, N):
        q = N.MQueue()
        assert q.pop(timeout_ms=50) is None

    def test_close_drains(self, N):
        q = N.MQueue()
        q.push(1)
        q.close()
        assert q.pop() == 1
        assert q.pop(timeout_ms=50) is None
        assert not q.push(2)  # closed

    def test_threaded_producer_consumer(self, N):
        q = N.MQueue()
        N = 1000
        got = []

        def consumer():
            while True:
                v = q.pop()
                if v is None:
                    break
                got.append(v)

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(N):
            q.push(i)
        q.close()
        t.join()
        assert sorted(got) == list(range(N))


class TestPgRandom:
    def test_glibc_sequence_srandom_1(self, N):
        # canonical glibc random() sequence for seed 1
        r = N.PgRandom(seed=1)
        assert [r.random() for _ in range(5)] == [
            1804289383, 846930886, 1681692777, 1714636915, 1957747793]

    def test_setseed_zero_maps_to_one(self, N):
        # PG setseed(0) -> srandom(0); glibc treats seed 0 as 1
        a = N.PgRandom()
        a.setseed(0.0)
        b = N.PgRandom(seed=1)
        assert [a.random() for _ in range(3)] == [b.random() for _ in range(3)]

    def test_drandom_range(self, N):
        r = N.PgRandom(seed=1)
        vals = [r.drandom() for _ in range(1000)]
        assert all(0.0 <= v < 1.0 for v in vals)
        assert 0.4 < sum(vals) / len(vals) < 0.6


class TestCrc32:
    def test_known_value(self, N):
        # standard CRC-32 ("123456789") = 0xCBF43926
        assert N.pg_crc32(b"123456789") == 0xCBF43926

    def test_empty(self, N):
        assert N.pg_crc32(b"") == 0


class TestCsvLoader:
    def test_basic(self, N):
        text = b"1,2.5\n2,\n,3.5\n4,4.25\n"
        (di, vi), (df, vf) = N.load_csv(text, ["i", "f"])
        assert list(di[vi]) == [1, 2, 4]
        assert list(vi) == [True, True, False, True]
        assert list(df[vf]) == [2.5, 3.5, 4.25]

    def test_parallel_matches_serial(self, N):
        rng = np.random.default_rng(0)
        n = 20000
        rows = []
        for i in range(n):
            a = str(i) if rng.random() > 0.1 else ""
            b = repr(float(rng.random())) if rng.random() > 0.1 else ""
            rows.append(f"{a},{b}")
        text = ("\n".join(rows) + "\n").encode()
        serial = N.load_csv(text, ["i", "f"])
        pool = N.Pool(4)
        par = N.load_csv(text, ["i", "f"], pool=pool)
        for (ds, vs), (dp, vp) in zip(serial, par):
            assert (vs == vp).all()
            assert (ds[vs] == dp[vp]).all()

    def test_skip_column(self, N):
        text = b"1,ignored,2.5\n"
        cols = N.load_csv(text, ["i", "x", "f"])
        assert cols[1] == (None, None)
        assert cols[0][0][0] == 1 and cols[2][0][0] == 2.5


class TestSlabTier:
    """Slab classes over buddy blocks (shmem.c:94-100, 359-410 analog)."""

    def test_alloc_free_and_stats(self, N):
        a = N.Arena(1 << 22)
        ptrs = [a.slab_alloc(sz) for sz in (10, 96, 200, 500, 1000, 2500)]
        assert len(set(ptrs)) == len(ptrs)
        st = a.slab_stats()
        assert [r["size"] for r in st] == [96, 240, 512, 1184, 2520]
        assert sum(r["n_alloc"] for r in st) == 6
        for p in ptrs:
            a.slab_free(p)
        st = a.slab_stats()
        assert sum(r["n_free"] for r in st) == 6

    def test_double_free_detected(self, N):
        a = N.Arena(1 << 22)
        p = a.slab_alloc(64)
        a.slab_free(p)
        with pytest.raises(RuntimeError, match="double free"):
            a.slab_free(p)

    def test_redzone_overwrite_detected(self, N):
        import ctypes
        a = N.Arena(1 << 22)
        p = a.slab_alloc(96)
        # scribble past the 96-byte class payload
        ctypes.memset(p, 0xAB, 100)
        with pytest.raises(RuntimeError, match="redzone"):
            a.slab_free(p)

    def test_oversize_spills_to_buddy(self, N):
        a = N.Arena(1 << 22)
        p = a.slab_alloc(10_000)        # beyond the largest class
        a.slab_free(p)                  # routed back through the buddy tier

    def test_chunk_planes_ride_arena(self, N, ds):
        # query-time data path: padded chunk planes allocate from the
        # tracked arena (visible in pgstrom_arena_info / slab stats)
        Table, Chunk, column_from_values, T = (
            ds.Table, ds.Chunk, ds.column_from_values, ds.T)
        a = N.data_arena()
        before = a.stats()["n_alloc"] + sum(r["n_alloc"]
                                            for r in a.slab_stats())
        t = Table.from_columns("t", {
            "x": column_from_values(T.INT4, list(range(100)))})
        ch = Chunk.from_table(t, 0, 100, 128)
        after = a.stats()["n_alloc"] + sum(r["n_alloc"]
                                           for r in a.slab_stats())
        assert after > before
        assert int(ch.columns["x"].data[:100].sum()) == sum(range(100))


# --- the port's own build ----------------------------------------------------

def test_port_builds_its_own_library():
    """The port loads a library built from its own copy of the source into
    pg_strom_tpu_torch/_build/, keyed by the source's hash, and never the
    reference's pg_strom_tpu/native/libpgstrom_native.so."""
    path = p_native.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(p_native.__file__)))
    assert os.path.dirname(path) == os.path.join(pkg, "_build")
    assert p_native.lib()._name == path and os.path.exists(path)
    with open("/proc/self/maps") as f:
        mapped = {ln.split()[-1] for ln in f if "/" in ln}
    assert path in mapped
    assert not path.startswith(os.path.dirname(r_native.__file__))
    with open(p_native._SRC, "rb") as a, \
            open(os.path.join(os.path.dirname(r_native.__file__), "src",
                              "pgstrom_native.cc"), "rb") as b:
        assert a.read() == b.read()      # a verbatim copy of the source


def test_concurrent_builds_land_one_library(tmp_path, tmp_path_factory):
    """Processes that build at once (tier-1's xdist workers) each compile
    to a temporary name and publish it by a hard link, the first one's
    kept: every one loads a whole library from the same path, and once
    all have loaded it no process's mapping of it reads `(deleted)` (a
    later build never replaced the file under an earlier one)."""
    import subprocess
    import sys
    code = "\n".join([
        "import ctypes, os, sys, time",
        "import pg_strom_tpu_torch.native as N",
        "N._BUILD_DIR = sys.argv[1]; p = N.build()",
        "L = ctypes.CDLL(p)",
        "L.pg_crc32.restype = ctypes.c_uint32",
        "L.pg_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]",
        "print(p, L.pg_crc32(b'123456789', 9))",
        "open(os.path.join(sys.argv[2], str(os.getpid())), 'w').close()",
        "t = time.time()",
        "while len(os.listdir(sys.argv[2])) < 3 and time.time() - t < 120:",
        "    time.sleep(0.05)",
        "with open('/proc/self/maps') as f:",
        "    print(sorted({ln.split(None, 5)[-1].strip() for ln in f",
        "                  if os.path.basename(p) in ln}))"])
    sync = tmp_path_factory.mktemp("loaded")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(p_native.__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               str(sync)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o.splitlines()[0].strip() for o, _ in outs}
    assert len(lines) == 1, lines
    assert lines.pop().endswith(str(0xCBF43926))
    assert [f for f in os.listdir(tmp_path)] == [
        os.path.basename(p_native.library_path())]
    so = str(tmp_path / os.path.basename(p_native.library_path()))
    for o, _ in outs:
        assert o.splitlines()[1] == repr([so]), o


# --- the two modules give the same answers ----------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2 ** 31 - 1, 2 ** 32 - 5])
def test_pgrandom_stream_matches_reference(seed):
    r, p = r_native.PgRandom(seed), p_native.PgRandom(seed)
    assert [p.random() for _ in range(500)] == \
        [r.random() for _ in range(500)]
    assert [p.drandom() for _ in range(200)] == \
        [r.drandom() for _ in range(200)]
    r.setseed(0.25)
    p.setseed(0.25)
    assert [p.random() for _ in range(50)] == [r.random() for _ in range(50)]


def _csv_text(n: int, seed: int, bad: bool) -> bytes:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        a = "" if i % 17 == 0 else str(int(rng.integers(-10 ** 12, 10 ** 12)))
        b = "" if i % 13 == 0 else repr(float(rng.normal()))
        d = "" if i % 11 == 0 else \
            f"20{rng.integers(0, 30):02d}-{rng.integers(1, 13):02d}-" \
            f"{rng.integers(1, 29):02d}"
        t = "" if i % 7 == 0 else f"name{int(rng.integers(0, 50))}"
        m = "" if i % 5 == 0 else f"{int(rng.integers(-10 ** 6, 10 ** 6))}" \
            f".{int(rng.integers(0, 100)):02d}"
        if bad and i % 97 == 3:
            a, d = "12x", "2023-02-31"
        rows.append(",".join([a, b, d, t, m]))
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.parametrize("bad", [False, True], ids=["clean", "malformed"])
@pytest.mark.parametrize("threads", [0, 4])
def test_csv_loaders_match_reference(bad, threads):
    text = _csv_text(3000, 11, bad)
    rpool = r_native.Pool(threads) if threads else None
    ppool = p_native.Pool(threads) if threads else None
    rcols, rbad = r_native.load_csv(text, "ifxxx", pool=rpool,
                                    return_bad=True)
    pcols, pbad = p_native.load_csv(text, "ifxxx", pool=ppool,
                                    return_bad=True)
    assert pbad == rbad
    for rc, pc in zip(rcols, pcols):
        for ra, pa in zip(rc, pc):
            if ra is None:
                assert pa is None
            else:
                np.testing.assert_array_equal(pa, ra)
    rcols2, rbad2 = r_native.load_csv2(text, "ifdtn", pool=rpool)
    pcols2, pbad2 = p_native.load_csv2(text, "ifdtn", pool=ppool)
    assert pbad2 == rbad2 and (pbad2 > 0) == bad
    for rc, pc in zip(rcols2, pcols2):
        assert len(rc) == len(pc)
        for ra, pa in zip(rc, pc):
            assert pa.dtype == ra.dtype and pa.shape == ra.shape
            np.testing.assert_array_equal(pa, ra)


# --- models/pg_fixture.py ----------------------------------------------------

def _same_table(rt, pt):
    assert list(pt.columns) == list(rt.columns) and pt.nrows == rt.nrows
    for nm, rc in rt.columns.items():
        pc = pt.columns[nm]
        assert pc.type.name == rc.type.name, nm
        for a in ("data", "valid", "num_exp", "num_dscale", "recheck"):
            ra, pa = getattr(rc, a), getattr(pc, a)
            if ra is None:
                assert pa is None, (nm, a)
            else:
                assert pa.dtype == ra.dtype, (nm, a)
                # bit for bit (floats compared as their bytes)
                assert pa.tobytes() == ra.tobytes(), (nm, a)
        assert pc.dictionary == rc.dictionary, nm


@pytest.mark.parametrize("which", ["regen_preagg_test",
                                   "regen_preagg_overflow"])
def test_pg_fixture_tables_match_reference(which):
    from pg_strom_tpu.models import pg_fixture as r_fix
    from pg_strom_tpu_torch.models import pg_fixture as p_fix
    _same_table(getattr(r_fix, which)(), getattr(p_fix, which)())


def test_pg_fixture_mix_matches_reference():
    from pg_strom_tpu.models import pg_fixture as r_fix
    from pg_strom_tpu_torch import models as p_models
    from pg_strom_tpu_torch.config import override
    rdb, pdb = r_ds.Database(), p_ds.Database()
    rdb.create(r_fix.regen_preagg_test())
    pdb.create(p_models.regen_preagg_test())
    with override(device="cpu"):
        pt = p_models.regen_preagg_mix(pdb)
    _same_table(r_fix.regen_preagg_mix(rdb), pt)
