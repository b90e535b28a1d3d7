"""K4: segmented column sums of a precomputed value matrix (the half-fused
grouped reduce behind preagg_mxu.mxu_reduce under
config.use_pallas_reduce).

The reference (pg_strom_tpu/ops/preagg_pallas.py) generates the one-hot
bucket tile in VMEM and contracts it with V on the MXU, flushing f32
partial sums into int32 hi/lo pairs every 2^16 rows.  The port computes
the contract directly (ops/cuda/preagg_pallas.cu): exact int64 sums of the
integer columns, float32 sums of the shadow columns, per bucket.

* `pallas_reduce` — the entry: a CUDA V launches the kernel (or raises), a
  CPU V runs the plain version.
* `pallas_reduce_reference` — the plain PyTorch version, an index_add_
  over row blocks (a whole-V int64 copy would be 8 bytes per cell).
* `MAX_G` = 2048 gates it, as in the reference (preagg_mxu.py:409).

`sums` is zero at the shadow columns; `fsums` holds the shadow columns'
sums, which only decide host replay (preagg_mxu.mxu_overflow).
"""

from __future__ import annotations

import torch

from .preagg_mxu import sat_int64

MAX_G = 1 << 11
_REF_ROWS = 1 << 20          # rows per block of the plain version
_BLOCK = 256                 # threads per block, at least
_SMEM_MAX = 227 * 1024       # an H100 block's shared memory (opt-in)


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


def tile_columns(G: int, S: int, has_shadow: bool,
                 extra: int = 0) -> tuple[int, int]:
    """(Kt columns per tile, shared-memory bytes) for a block-private
    [G, Kt] accumulator: all S columns when they fit, else the widest tile
    that fits an H100 block's shared memory."""
    cell = 8 + (4 if has_shadow else 0)
    fit = (_SMEM_MAX - extra - 4 * S) // (G * cell)
    if fit < 1:
        raise ValueError(f"G={G} leaves no room for one column in shared "
                         "memory")
    Kt = min(S, fit)
    return Kt, G * Kt * cell + extra + 4 * Kt


def launch_shape(dev: torch.device, n: int, smem: int,
                 ntiles: int) -> tuple[int, int]:
    """(blocks per column tile, threads per block) for a grid-stride
    kernel with `smem` bytes of block-private accumulators: as many blocks
    as fit an SM (at most 4), and threads so that each SM runs about 1024
    of them — a block that fills the shared memory alone gets 1024 threads
    (at G = 1024, K = 42 on an H100 that is 3.2x faster than 256)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, min(4, (_SMEM_MAX + 1024) // max(smem, 1)))
    block = max(_BLOCK, 1024 // per_sm)
    want = max(1, -(-sms * per_sm // ntiles))
    return max(1, min(-(-n // block), want)), block


def pallas_cuda(V: torch.Tensor, seg_id: torch.Tensor, G: int, n: int,
                fsum_cols) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (ops/cuda/preagg_pallas.cu): the same (ints, shadow) as
    pallas_reduce_reference.  Raises on a bad input, a build or a launch
    failure."""
    import ctypes
    from .cuda import library, cuda_error_text
    dev = V.device
    S = V.shape[1]
    if (V.dtype != torch.bfloat16 or V.dim() != 2 or not V.is_contiguous()
            or seg_id.device != dev or seg_id.dtype != torch.int32
            or not seg_id.is_contiguous() or seg_id.shape[0] < n
            or V.shape[0] < n or G > MAX_G):
        raise ValueError(f"K4 needs a contiguous bf16 V [N, S] and int32 "
                         f"bucket ids on one device, G <= {MAX_G}; got V "
                         f"{V.dtype} {tuple(V.shape)} on {V.device}, seg "
                         f"{seg_id.dtype} on {seg_id.device}, G={G}")
    icols, scols = _split(S, fsum_cols)
    kind = torch.zeros(S, dtype=torch.int32)
    kind[scols] = 1
    kind = kind.to(dev)
    has_shadow = bool(scols)
    Kt, smem = tile_columns(G, S, has_shadow)
    ntiles = -(-S // Kt)
    ints = torch.zeros((G, S), dtype=torch.int64, device=dev)
    shadow = torch.zeros((G, S), dtype=torch.float32, device=dev)
    grid, block = launch_shape(dev, n, smem, ntiles)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pgstrom_k4_launch(
            ctypes.c_void_p(V.data_ptr()), ctypes.c_void_p(seg_id.data_ptr()),
            ctypes.c_void_p(kind.data_ptr()), ctypes.c_longlong(n), S, G, Kt,
            int(has_shadow), ctypes.c_void_p(ints.data_ptr()),
            ctypes.c_void_p(shadow.data_ptr()), grid, ntiles, block,
            ctypes.c_size_t(smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: {cuda_error_text(rc)}")
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
