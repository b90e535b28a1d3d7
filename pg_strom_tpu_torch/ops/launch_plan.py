"""Launch planner of the accumulation core that K1, K2 and K4 share
(ops/cuda/onehot_accum.cuh): what block, what column tiles, what shared
memory.

Pure Python over the shape (G buckets, K physical columns, n_shadow float
shadow columns, the kernel's own table bytes), so that the CPU tests cover
every decision the CUDA wrappers take.

Every row adds its non-zero digits into a block-private [G, Kt] table of
32-bit cells in shared memory with native atomic adds: Kt = K when the
table fits one block, else the widest column tile that does (one tile per
blockIdx.y, each re-reading the lanes; K4 re-reads only its tile's
columns of V).  A block flushes its s32 cells into the int64 output every
S32_ROWS rows it has added.  A shape whose single column does not fit one
block is refused: K1 (G <= 4096) and K2 (G <= 2048) never come near it,
K4 at G = 2048 only past 24 float shadow columns (the compact shadow table
is in every tile).
"""

from __future__ import annotations

import dataclasses

SMEM_MAX = 232448       # an H100 block's dynamic shared memory (opt-in)
# digits are integers in [-255, 255]: 255 * 2^23 < 2^31, an s32 cell
# cannot overflow between flushes
S32_ROWS = 1 << 23


def _a16(b: int) -> int:
    return (b + 15) & ~15


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    G: int
    K: int
    n_shadow: int
    block: int           # threads (= rows of a tile)
    smem: int            # dynamic shared-memory bytes, tables included
    flush_tiles: int     # row tiles a block runs between flushes
    Kt: int              # columns per tile
    ntiles: int          # column tiles (grid.y)

    def geo(self) -> list[int]:
        """The int32 vector the kernels read (onehot::Geo::load)."""
        return [self.G, self.K, self.n_shadow, self.Kt, self.ntiles,
                self.flush_tiles, self.block]

    @property
    def flush_rows(self) -> int:
        """Rows a block adds into its s32 cells between flushes."""
        return self.flush_tiles * self.block


def widest_tile(G: int, K: int, n_shadow: int, table_bytes) -> int:
    """The widest column tile whose s32 cells fit one block's shared memory
    beside the shadow table and the kernel's own tables; 0 when not even
    one column does (or there is nothing to accumulate)."""
    if G < 1 or K < 1:
        return 0
    tb = table_bytes if callable(table_bytes) else (lambda Kt: table_bytes)
    sh = _a16(4 * G * n_shadow)
    return next((kt for kt in range(min(K, (SMEM_MAX - sh) // (4 * G)), 0, -1)
                 if 4 * G * kt <= SMEM_MAX - tb(kt) - sh - 16), 0)


def plan_launch(G: int, K: int, n_shadow: int, table_bytes,
                block: int | None = None) -> LaunchPlan:
    """The launch of one K1, K2 or K4 call.  `table_bytes` are the kernel's
    own tables in shared memory: a number (K1, K2), or a function of the
    column tile's width Kt (K4's staged rows).  `block` fixes the threads
    of a block (K4); None sizes it from the shared memory."""
    if G < 1 or K < 1:
        raise ValueError(f"nothing to accumulate: G={G}, K={K}")
    tb = table_bytes if callable(table_bytes) else (lambda Kt: table_bytes)
    sh = _a16(4 * G * n_shadow)
    Kt = widest_tile(G, K, n_shadow, tb)
    if Kt < 1:
        raise ValueError(f"G={G} with {n_shadow} shadow columns leaves no "
                         "room for one column of s32 cells in a block's "
                         "shared memory")
    # tiles of equal width: the blocks of a wide tile and a narrow one
    # would finish apart, leaving SMs idle
    Kt = -(-K // -(-K // Kt))
    smem = _a16(4 * G * Kt) + sh + tb(Kt)
    if block is None:
        # as many blocks as fit an SM (at most 4), about 1024 threads an
        # SM: a block that fills the shared memory alone gets 1024 threads
        # (3.2x faster than 256 at G = 1024, K = 42; PERF.md)
        per_sm = max(1, min(4, (SMEM_MAX + 1024) // smem))
        block = max(256, 1024 // per_sm // 32 * 32)
    return LaunchPlan(G, K, n_shadow, block=block, smem=smem,
                      flush_tiles=S32_ROWS // block, Kt=Kt,
                      ntiles=-(-K // Kt))
