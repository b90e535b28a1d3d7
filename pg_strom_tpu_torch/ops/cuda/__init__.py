"""Build and load the port's hand-written CUDA kernels.

nvcc compiles every `.cu` source of this directory (SOURCES) into an
object file, all of them at once in parallel processes, and links them
into one shared library with a plain C interface (no PyTorch headers, so
it builds in seconds); ctypes binds it, and the wrappers pass
`data_ptr()`s and PyTorch's current stream.  The library is built at first
use into `pg_strom_tpu_torch/_build/` (listed in .gitignore), under a name
keyed by a hash of every `.cu` and `.cuh` file of the directory and the
flags (an edited header rebuilds too), and published there by a hard
link (utils/libbuild.publish), so that concurrent processes never load a
half-written file nor one another process replaced.  A missing nvcc, a failed build or a failed launch raises: no kernel
gives way to its plain version.

  K1  preagg_fused2.cu    fused pre-aggregation over raw column planes
  K2  preagg_fused.cu     fused pre-aggregation over encoded lanes
  K4  preagg_pallas.cu    segmented column sums of a value matrix
      onehot_accum.cuh    their accumulation core (32-bit shared adds)
  K3  mxu_lookup.cu       table lookup out[i] = table[idx[i]]
  K5  joinagg_scalar.cu   a dense-key join under a scalar aggregate
      pred_program.cuh    K1's and K5's predicate program encoding
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from ...utils.libbuild import publish

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
SOURCES = ("preagg_fused2.cu", "preagg_fused.cu", "preagg_pallas.cu",
           "mxu_lookup.cu", "joinagg_scalar.cu")
# sm_90a: Hopper with its arch-specific features; --fmad=false keeps float32
# arithmetic IEEE-identical to the plain PyTorch versions (no contraction
# of a multiply and an add into one rounding); -Xptxas -v reports
# registers, shared memory and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
# the last build in this process: wall seconds and nvcc's stderr (ptxas
# register/shared-memory report); None when the library was already built
build_seconds: float | None = None
build_log: str | None = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from the "
                       "sources in this package at first use")


def library_path(src_dir: str = _DIR, build_dir: str = _BUILD_DIR) -> str:
    """Where the library of these sources and flags lives: keyed by every
    `.cu` and `.cuh` file of `src_dir` (names and contents)."""
    h = hashlib.sha256()
    for s in sorted(os.listdir(src_dir)):
        if s.endswith((".cu", ".cuh")):
            h.update(s.encode())
            with open(os.path.join(src_dir, s), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir,
                        f"libpgstrom_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless this source/flag hash is built."""
    global build_seconds, build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpd:
        objs, procs = [], []
        for s in SOURCES:
            o = os.path.join(tmpd, s.replace(".cu", ".o"))
            objs.append(o)
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(_DIR, s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for s, p in procs:
            out, err = p.communicate()
            logs.append(f"== {s}\n{out}{err}")
            if p.returncode != 0:
                failed.append(f"{s} (exit {p.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                               + "\n".join(logs))
        tmp = os.path.join(tmpd, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        publish(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build())
            c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
            L.pgstrom_k1_launch.restype = c_int
            geo = ctypes.POINTER(c_int)     # the launch plan's int32 vector
            L.pgstrom_k1_launch.argtypes = [
                c_ptr, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
                c_ll, c_int, c_int, c_int, c_int, geo, c_ptr, c_ptr, c_int,
                ctypes.c_size_t, c_ptr]
            L.pgstrom_k2_launch.restype = c_int
            L.pgstrom_k2_launch.argtypes = [
                c_ptr, c_int, c_int, c_int, c_ptr, c_ll, geo, c_ptr, c_ptr,
                c_int, ctypes.c_size_t, c_ptr]
            L.pgstrom_k4_launch.restype = c_int
            L.pgstrom_k4_launch.argtypes = [
                c_ptr, c_ptr, c_ptr, c_ll, geo, c_ptr, c_ptr, c_int,
                ctypes.c_size_t, c_ptr]
            L.pgstrom_k3_launch.restype = c_int
            L.pgstrom_k3_launch.argtypes = [
                c_ptr, c_ptr, c_int, c_int, c_ll, c_ptr, c_int, c_int, c_ptr]
            L.pgstrom_k5_launch.restype = c_int
            L.pgstrom_k5_launch.argtypes = [c_ptr, c_int, c_ptr]
            L.pgstrom_k5_args_size.restype = ctypes.c_size_t
            L.pgstrom_cuda_error_string.restype = ctypes.c_char_p
            L.pgstrom_cuda_error_string.argtypes = [c_int]
            _lib = L
        return _lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (asked once)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def cuda_error_text(code: int) -> str:
    msg = library().pgstrom_cuda_error_string(code)
    return f"{msg.decode() if msg else 'unknown error'} (cudaError {code})"
