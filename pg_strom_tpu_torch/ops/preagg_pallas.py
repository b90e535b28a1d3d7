"""K4: segmented column sums of a precomputed value matrix (the half-fused
grouped reduce behind preagg_mxu.mxu_reduce under
config.use_pallas_reduce).

The reference (pg_strom_tpu/ops/preagg_pallas.py) generates the one-hot
bucket tile in VMEM and contracts it with V on the MXU, flushing f32
partial sums into int32 hi/lo pairs every 2^16 rows.  The port computes
the contract directly (ops/cuda/preagg_pallas.cu): exact int64 sums of the
integer columns, float32 sums of the shadow columns, per bucket.

K4 is bound by the bytes of V (2 S + 4 a row).  It runs on K1 and K2's
accumulation core: 32-bit shared cells in a [G, Kt] table and a compact
shadow table, planned by ops/launch_plan.py (G = 1024 x S = 42 in one
column tile, so V is read once).  A warp copies 8 rows of V at a time
into shared memory as 16-byte vectors (whole rows when the tile is every
column, else each row's window of the tile's columns, so that a column
tile reads only its own columns and the staging grows with the tile, not
with S), and there a lane owns two columns, so that one add instruction
touches neighbouring cells of the row's bucket.

* `pallas_reduce` — the entry: a CUDA V launches the kernel (or raises), a
  CPU V runs the plain version.
* `pallas_reduce_reference` — the plain PyTorch version, an index_add_
  over row blocks (a whole-V int64 copy would be 8 bytes per cell).
* `k4_plan` — the launch plan of one call; `MAX_G` = 2048 gates K4, as in
  the reference (preagg_mxu.py:409).  A shape whose shadow table leaves no
  room for one column (past 24 shadows at G = 2048) raises; `k4_fits`
  tells it from the shape first, so that mxu_reduce routes such a call to
  its own path instead.

`sums` is zero at the shadow columns; `fsums` holds the shadow columns'
sums, which only decide host replay (preagg_mxu.mxu_overflow).
"""

from __future__ import annotations

import functools

import torch

from .launch_plan import _a16, plan_launch, widest_tile
from .preagg_mxu import sat_int64
from ..utils.perfmon import span

MAX_G = 1 << 11
_REF_ROWS = 1 << 20          # rows per block of the plain version
_RG = 8                      # rows a K4 warp stages at a time
# threads of a K4 block: one block of 1024 an SM was faster than two of
# 512 or four of 256 at every G timed on agg_group's and corr's value
# matrices (PERF.md)
K4_BLOCK = 1024


def _split(S: int, fsum_cols) -> tuple[list[int], list[int]]:
    shadow = set(fsum_cols)
    return [c for c in range(S) if c not in shadow], list(fsum_cols)


def pallas_reduce_reference(V: torch.Tensor, seg_id: torch.Tensor, G: int,
                            n: int, fsum_cols) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain K4: (ints int64[G, S] zero at shadow columns, shadow
    float32[G, S] zero at integer columns)."""
    S = V.shape[1]
    dev = V.device
    icols, scols = _split(S, fsum_cols)
    ic = torch.as_tensor(icols, dtype=torch.int64, device=dev)
    sc = torch.as_tensor(scols, dtype=torch.int64, device=dev)
    seg = seg_id[:n].to(torch.int64).clamp(0, G)
    ints = torch.zeros((G + 1, S), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G + 1, S), dtype=torch.float32, device=dev)
    for s in range(0, n, _REF_ROWS):
        blk = V[s:min(s + _REF_ROWS, n)]
        sg = seg[s:s + _REF_ROWS]
        if icols:
            part = torch.zeros((G + 1, len(icols)), dtype=torch.int64,
                               device=dev)
            part.index_add_(0, sg, sat_int64(blk[:, ic]))
            ints[:, ic] += part
        if scols:
            part = torch.zeros((G + 1, len(scols)), dtype=torch.float32,
                               device=dev)
            part.index_add_(0, sg, blk[:, sc].to(torch.float32))
            shadow[:, sc] += part
    return ints[:G], shadow[:G]


def _window_stride(S: int, Kt: int) -> int:
    """Elements from one staged row's window of Kt columns to the next:
    room for the 16-byte vectors that cover a window starting anywhere in
    its first one, and = S mod 8, so that column c of row i sits at i
    stride + c, as in whole rows (ops/cuda/preagg_pallas.cu)."""
    return Kt + 14 + ((S - Kt - 14) & 7)


def k4_table_bytes(S: int, n_shadow: int, block: int, Kt: int) -> int:
    """Shared-memory bytes of K4's own tables after the core's (keep in
    sync with table_bytes in ops/cuda/preagg_pallas.cu): the shadow columns
    and the column -> shadow index map as int32, then each warp's two
    staged _RG-row steps of V: whole rows when Kt = S, else windows."""
    step = _RG * (S if Kt == S else _window_stride(S, Kt))
    return _a16(4 * (n_shadow + S)) + block // 32 * 2 * step * 2


@functools.lru_cache(maxsize=256)
def k4_plan(G: int, S: int, n_shadow: int):
    """The accumulation core's launch plan of one K4 call, on blocks of
    K4_BLOCK threads."""
    return plan_launch(G, S, n_shadow, lambda Kt: k4_table_bytes(
        S, n_shadow, K4_BLOCK, Kt), block=K4_BLOCK)


def k4_fits(G: int, S: int, n_shadow: int) -> bool:
    """Whether k4_plan plans this shape: one column of s32 cells fits a
    block beside the shadow table (the condition k4_plan refuses on)."""
    return widest_tile(G, S, n_shadow, lambda Kt: k4_table_bytes(
        S, n_shadow, K4_BLOCK, Kt)) >= 1


def _desc(S: int, fsum_cols) -> list[int]:
    """The int32 tables the kernel loads: the shadow columns, then column
    -> shadow index (-1 for an integer column)."""
    si = [-1] * S
    for i, c in enumerate(fsum_cols):
        si[c] = i
    return list(fsum_cols) + si


def pallas_cuda(V: torch.Tensor, seg_id: torch.Tensor, G: int, n: int,
                fsum_cols, grid: int | None = None) -> tuple[torch.Tensor,
                                                             torch.Tensor]:
    """Launch K4 (ops/cuda/preagg_pallas.cu): the same (ints, shadow) as
    pallas_reduce_reference.  `grid` forces the blocks per column tile (the
    exactness-window tests); None fills the card.  Raises on a bad input, a
    build or a launch failure."""
    import ctypes
    from .cuda import library, cuda_error_text
    dev = V.device
    S = V.shape[1] if V.dim() == 2 else 0
    fsum_cols = list(fsum_cols)
    if (dev.type != "cuda" or V.dtype != torch.bfloat16 or V.dim() != 2
            or not V.is_contiguous() or V.data_ptr() % 16
            or seg_id.device != dev or seg_id.dtype != torch.int32
            or not seg_id.is_contiguous() or seg_id.shape[0] < n
            or V.shape[0] < n or not 1 <= G <= MAX_G or S < 1
            or len(set(fsum_cols)) != len(fsum_cols)
            or not all(0 <= c < S for c in fsum_cols)):
        raise ValueError(f"K4 needs a contiguous, 16-byte aligned bf16 V "
                         f"[N, S] and int32 bucket ids on one CUDA device, "
                         f"1 <= G <= {MAX_G}, distinct shadow columns of V; "
                         f"got V {V.dtype} {tuple(V.shape)} on {V.device} at "
                         f"{V.data_ptr() % 16} mod 16, seg "
                         f"{seg_id.dtype} on {seg_id.device}, G={G}, "
                         f"shadows {fsum_cols}")
    lp = k4_plan(G, S, len(fsum_cols))
    desc = torch.tensor(_desc(S, fsum_cols), dtype=torch.int32).to(dev)
    geo = (ctypes.c_int * len(lp.geo()))(*lp.geo())
    ints = torch.zeros((G, S), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G, S), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev), span("K4"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pgstrom_k4_launch(
            ctypes.c_void_p(V.data_ptr()), ctypes.c_void_p(seg_id.data_ptr()),
            ctypes.c_void_p(desc.data_ptr()), ctypes.c_longlong(n), geo,
            ctypes.c_void_p(ints.data_ptr()),
            ctypes.c_void_p(shadow.data_ptr()), 0 if grid is None else grid,
            ctypes.c_size_t(lp.smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed ({lp.ntiles} column tile(s), "
                           f"{lp.smem} B shared memory): "
                           f"{cuda_error_text(rc)}")
    pallas_cuda.launches += 1
    return ints, shadow


pallas_cuda.launches = 0     # main-path launch count (chip_smoke.py reads it)


def pallas_reduce(V: torch.Tensor, seg_id: torch.Tensor, G: int, n: int,
                  fsum_cols: list[int]):
    """Drop-in for mxu_reduce's plain path: (sums int64[G, S], fsums
    float64[G, len(fsum_cols)]).  seg_id == G drops a row."""
    if V.device.type == "cuda":
        ints, shadow = pallas_cuda(V.contiguous(), seg_id.to(torch.int32)
                                   .contiguous(), G, n, fsum_cols)
    elif V.device.type == "cpu":
        ints, shadow = pallas_reduce_reference(V, seg_id, G, n, fsum_cols)
    else:
        raise RuntimeError(f"K4 has no kernel for device {V.device}")
    sc = torch.as_tensor(list(fsum_cols), dtype=torch.int64, device=V.device)
    return ints, shadow[:, sc].to(torch.float64)
