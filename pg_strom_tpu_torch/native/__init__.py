"""ctypes bindings for the C++ host runtime (libpgstrom_native.so).

The source, `src/pgstrom_native.cc`, is the reference's own
(pg_strom_tpu/native/src), copied: this package never opens the
reference's library.  The library builds at first use with one g++ call
(`g++ -O3 -fPIC -std=c++17 -pthread -shared`) into
`pg_strom_tpu_torch/_build/` (listed in .gitignore), under a name keyed by
a hash of the source and the flags, and is published there by a hard link
(utils/libbuild.publish), so processes that build at once never load a
half-written file nor one another process replaced.  A failed build
raises.

Components: Arena (buddy allocator + resource tracking, with a slab tier),
MQueue, Pool (worker threads), CSV loaders, pg_crc32, PgRandom (glibc
random() reproduction for PostgreSQL fixture parity).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence

import numpy as np

from ..utils.libbuild import publish

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "pgstrom_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libpgstrom_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this source/flag hash is built."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native runtime library is "
                           "built from this package's source at first use")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpd:
        tmp = os.path.join(tmpd, "lib.so")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        return publish(tmp, so)


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(build())
        # arena
        L.arena_create.restype = ctypes.c_void_p
        L.arena_create.argtypes = [ctypes.c_uint64]
        L.arena_destroy.argtypes = [ctypes.c_void_p]
        L.arena_alloc.restype = ctypes.c_void_p
        L.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        L.arena_free.restype = ctypes.c_int
        L.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        L.arena_check.restype = ctypes.c_int
        L.arena_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        L.arena_release_owner.restype = ctypes.c_uint64
        L.arena_release_owner.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        L.arena_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        # slab tier (shmem.c:94-100, 359-410 analog)
        L.slab_alloc.restype = ctypes.c_void_p
        L.slab_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_uint64]
        L.slab_free.restype = ctypes.c_int
        L.slab_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        L.slab_stats.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64)]
        # mqueue
        L.mq_create.restype = ctypes.c_void_p
        L.mq_destroy.argtypes = [ctypes.c_void_p]
        L.mq_push.restype = ctypes.c_int
        L.mq_push.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.mq_pop.restype = ctypes.c_int
        L.mq_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                             ctypes.c_int64]
        L.mq_close.argtypes = [ctypes.c_void_p]
        L.mq_depth.restype = ctypes.c_int64
        L.mq_depth.argtypes = [ctypes.c_void_p]
        # pool
        L.pool_create.restype = ctypes.c_void_p
        L.pool_create.argtypes = [ctypes.c_int]
        L.pool_destroy.argtypes = [ctypes.c_void_p]
        L.pool_wait.argtypes = [ctypes.c_void_p]
        L.pool_size.restype = ctypes.c_int
        L.pool_size.argtypes = [ctypes.c_void_p]
        # crc
        L.pg_crc32.restype = ctypes.c_uint32
        L.pg_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        # random
        L.pg_random_create.restype = ctypes.c_void_p
        L.pg_random_destroy.argtypes = [ctypes.c_void_p]
        L.pg_srandom.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        L.pg_random_next.restype = ctypes.c_int32
        L.pg_random_next.argtypes = [ctypes.c_void_p]
        L.pg_drandom.restype = ctypes.c_double
        L.pg_drandom.argtypes = [ctypes.c_void_p]
        # csv
        L.csv_count_rows.restype = ctypes.c_int64
        L.csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        L.csv_parse.restype = ctypes.c_int64
        L.csv_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int]
        _lib = L
        return L


class Arena:
    """Buddy allocator + owner tracking (shmem.c / restrack.c analog)."""

    def __init__(self, size: int = 1 << 28):
        self._l = lib()
        self._h = self._l.arena_create(size)
        if not self._h:
            raise MemoryError("arena_create failed")

    def alloc(self, size: int, owner: int = 0) -> int:
        p = self._l.arena_alloc(self._h, size, owner)
        if not p:
            raise MemoryError(f"arena out of memory ({size} bytes)")
        return p

    def free(self, ptr: int) -> None:
        rc = self._l.arena_free(self._h, ptr)
        if rc:
            raise RuntimeError(
                {1: "bad block magic", 2: "redzone overwritten",
                 3: "double free"}[rc])

    def check(self, ptr: int) -> int:
        return self._l.arena_check(self._h, ptr)

    def release_owner(self, owner: int) -> int:
        return int(self._l.arena_release_owner(self._h, owner))

    def stats(self) -> dict:
        buf = (ctypes.c_uint64 * 4)()
        self._l.arena_stats(self._h, buf)
        return {"n_alloc": buf[0], "n_free": buf[1],
                "bytes_live": buf[2], "size": buf[3]}

    # -- slab tier (small-object classes carved from buddy blocks;
    #    reference shmem.c:94-100, 359-410) ------------------------------

    def slab_alloc(self, size: int, owner: int = 0) -> int:
        p = self._l.slab_alloc(self._h, size, owner)
        if not p:
            raise MemoryError(f"slab out of memory ({size} bytes)")
        return p

    def slab_free(self, ptr: int) -> None:
        rc = self._l.slab_free(self._h, ptr)
        if rc:
            raise RuntimeError(
                {1: "bad slab magic", 2: "redzone overwritten",
                 3: "double free"}[rc])

    def slab_stats(self) -> list[dict]:
        buf = (ctypes.c_uint64 * 20)()
        self._l.slab_stats(self._h, buf)
        return [{"size": buf[c * 4], "n_alloc": buf[c * 4 + 1],
                 "n_free": buf[c * 4 + 2], "n_objects": buf[c * 4 + 3]}
                for c in range(5)]

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._l.arena_destroy(self._h)
        except Exception:
            pass


class MQueue:
    def __init__(self):
        self._l = lib()
        self._h = self._l.mq_create()

    def push(self, v: int) -> bool:
        return self._l.mq_push(self._h, v) == 0

    def pop(self, timeout_ms: int = -1):
        out = ctypes.c_int64()
        rc = self._l.mq_pop(self._h, ctypes.byref(out), timeout_ms)
        if rc == 0:
            return out.value
        return None  # timeout or closed

    def close(self) -> None:
        self._l.mq_close(self._h)

    def depth(self) -> int:
        return int(self._l.mq_depth(self._h))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._l.mq_destroy(self._h)
        except Exception:
            pass


class Pool:
    def __init__(self, nthreads: int = 0):
        self._l = lib()
        self._h = self._l.pool_create(nthreads)

    @property
    def size(self) -> int:
        return self._l.pool_size(self._h)

    def handle(self):
        return self._h

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._l.pool_destroy(self._h)
        except Exception:
            pass


def pg_crc32(data: bytes) -> int:
    return int(lib().pg_crc32(data, len(data)))


class PgRandom:
    """glibc random()/srandom reproduction = PostgreSQL <=9.x random()."""

    def __init__(self, seed: int = 1):
        self._l = lib()
        self._h = self._l.pg_random_create()
        self.srandom(seed)

    def srandom(self, seed: int) -> None:
        self._l.pg_srandom(self._h, seed & 0xFFFFFFFF)

    def setseed(self, seed: float) -> None:
        """PostgreSQL setseed(float8): srandom(seed * MAX_RANDOM_VALUE)."""
        self._l.pg_srandom(self._h, int(seed * 2147483647) & 0xFFFFFFFF)

    def random(self) -> int:
        return int(self._l.pg_random_next(self._h))

    def drandom(self) -> float:
        """PostgreSQL random(): uniform in [0,1)."""
        return float(self._l.pg_drandom(self._h))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._l.pg_random_destroy(self._h)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# arena-backed numpy planes: the native buddy allocator carries the engine's
# ingest data (the shmem.c data-path contract — datastore planes live in the
# tracked arena, visible in pgstrom_arena_info, redzone-checked on release)
# ---------------------------------------------------------------------------

_DATA_ARENA: "Arena | None" = None


def data_arena() -> "Arena":
    global _DATA_ARENA
    if _DATA_ARENA is None:
        _DATA_ARENA = Arena(1 << 28)      # 256MB ingest arena
        from ..utils.introspect import register_arena
        register_arena(_DATA_ARENA)
    return _DATA_ARENA


def arena_ndarray(n: int, dtype, owner: int = 0) -> np.ndarray:
    """numpy array over an Arena block; the block frees (with magic/redzone
    verification) when the array is garbage collected.  Falls back to plain
    numpy when the arena is full — capacity never blocks ingest."""
    import weakref
    a = data_arena()
    size = int(n) * np.dtype(dtype).itemsize
    use_slab = size <= 2520                  # largest slab class
    try:
        ptr = (a.slab_alloc(max(size, 1), owner) if use_slab
               else a.alloc(max(size, 1), owner))
    except MemoryError:
        return np.zeros(n, dtype=dtype)
    buf = (ctypes.c_char * max(size, 1)).from_address(ptr)
    arr = np.frombuffer(buf, dtype=dtype, count=n)
    try:
        arr.flags.writeable = True
    except Exception:
        pass
    arr[:] = 0

    def _free(aa=a, pp=ptr, slab=use_slab):
        try:
            (aa.slab_free(pp) if slab else aa.free(pp))
        except Exception:
            pass
    # ndarrays aren't weakref-able; the ctypes buffer (kept alive as the
    # array's base) is — the block frees when the LAST view dies
    weakref.finalize(buf, _free)
    return arr


def load_csv(text: bytes, types: Sequence[str],
             pool: Pool | None = None, return_bad: bool = False):
    """Parallel CSV -> (data, valid) numpy planes per column.

    types: 'i' int64 column, 'f' float64 column, 'x' skip.
    return_bad=True additionally returns the malformed-field count (empty
    fields are NULLs, not malformed) so callers can fall back to an exact
    slow path for PostgreSQL-faithful error surfaces."""
    L = lib()
    n = L.csv_count_rows(text, len(text))
    tcodes = (ctypes.c_int * len(types))(*[{"i": 0, "f": 1, "x": 2}[t]
                                           for t in types])
    datas, valids, keep = [], [], []
    dptr = (ctypes.c_void_p * len(types))()
    vptr = (ctypes.c_void_p * len(types))()
    for i, t in enumerate(types):
        if t == "x":
            dptr[i] = None
            vptr[i] = None
            datas.append(None)
            valids.append(None)
            continue
        d = np.zeros(n, dtype=np.int64 if t == "i" else np.float64)
        v = np.zeros(n, dtype=np.uint8)
        datas.append(d)
        valids.append(v)
        dptr[i] = d.ctypes.data_as(ctypes.c_void_p)
        vptr[i] = v.ctypes.data_as(ctypes.c_void_p)
    nspans = pool.size if pool is not None else 1
    bad = L.csv_parse(pool.handle() if pool else None, text, len(text),
                      tcodes, len(types), dptr, vptr, nspans)
    out = [(d, v.astype(bool) if v is not None else None)
           for d, v in zip(datas, valids)]
    return (out, int(bad)) if return_bad else out


def load_csv2(text: bytes, types: Sequence[str],
              pool: Pool | None = None):
    """Extended parallel CSV parser: int/float/date/text/numeric lanes.

    types per column: 'i' int64, 'f' float64, 'd' date (YYYY-MM-DD -> days
    since 2000-01-01), 't' text (returns a fixed-width bytes plane), 'n'
    numeric (returns (mant int64, dscale int32) planes), 'x' skip.

    Returns (cols, bad): cols[i] is (data, valid) — for 'n' columns
    (mant, dscale, valid), for 'x' None.  Planes live in the native Arena
    (pgstrom_arena_info shows them live) and free on garbage collection.
    bad > 0 means malformed / out-of-window fields: the caller must fall
    back to the exact python path for PG-faithful error surfaces."""
    L = lib()
    if not hasattr(L.csv_parse2, "_bound"):
        L.csv_text_widths.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        L.csv_parse2.restype = ctypes.c_int64
        L.csv_parse2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        L.csv_parse2._bound = True
    n = L.csv_count_rows(text, len(text))
    code = {"i": 0, "f": 1, "x": 2, "d": 3, "t": 4, "n": 5}
    tcodes = (ctypes.c_int * len(types))(*[code[t] for t in types])
    widths = (ctypes.c_int64 * len(types))(*([0] * len(types)))
    if any(t == "t" for t in types):
        L.csv_text_widths(text, len(text), tcodes, len(types), widths)
    dptr = (ctypes.c_void_p * len(types))()
    vptr = (ctypes.c_void_p * len(types))()
    aptr = (ctypes.c_void_p * len(types))()
    datas, valids, auxs = [], [], []
    for i, t in enumerate(types):
        if t == "x":
            datas.append(None); valids.append(None); auxs.append(None)
            continue
        if t == "t":
            W = max(int(widths[i]), 1)
            widths[i] = W
            d = arena_ndarray(n * W, np.uint8).reshape(n, W) if n else \
                np.zeros((0, W), np.uint8)
        elif t == "f":
            d = arena_ndarray(n, np.float64)
        else:
            d = arena_ndarray(n, np.int64)
        v = arena_ndarray(n, np.uint8)
        a = arena_ndarray(n, np.int32) if t == "n" else None
        datas.append(d); valids.append(v); auxs.append(a)
        dptr[i] = d.ctypes.data_as(ctypes.c_void_p)
        vptr[i] = v.ctypes.data_as(ctypes.c_void_p)
        aptr[i] = a.ctypes.data_as(ctypes.c_void_p) if a is not None else None
    nspans = pool.size if pool is not None else 1
    bad = L.csv_parse2(pool.handle() if pool else None, text, len(text),
                       tcodes, len(types), dptr, vptr, aptr, widths, nspans)
    out = []
    for t, d, v, a in zip(types, datas, valids, auxs):
        if t == "x":
            out.append(None)
        elif t == "n":
            out.append((d, a, v.astype(bool)))
        else:
            out.append((d, v.astype(bool)))
    return out, int(bad)
