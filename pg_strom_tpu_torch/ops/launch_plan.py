"""Launch planner of K1 and K2's shared accumulation core
(ops/cuda/onehot_accum.cuh): what block, what column tiles, what shared
memory.

Pure Python over the shape (G buckets, K physical columns, n_shadow float
shadow columns, the kernel's own table bytes), so that the CPU tests cover
every decision the CUDA wrappers take.

Every row adds its non-zero digits into a block-private [G, Kt] table of
32-bit cells in shared memory with native atomic adds: Kt = K when the
table fits one block, else the widest column tile that does (one tile per
blockIdx.y, each re-reading the lanes).  A block flushes its s32 cells into
the int64 output every S32_ROWS rows it has added.  A shape whose single
column does not fit one block is refused: K2 (G <= 2048) and K1
(G <= 4096) never come near it.
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


def plan_launch(G: int, K: int, n_shadow: int,
                table_bytes: int) -> LaunchPlan:
    """The launch of one K1/K2 call; `table_bytes` are the kernel's own
    tables in shared memory."""
    if G < 1 or K < 1:
        raise ValueError(f"nothing to accumulate: G={G}, K={K}")
    room = SMEM_MAX - table_bytes - _a16(4 * G * n_shadow) - 16
    Kt = min(K, room // (4 * G))
    if Kt < 1:
        raise ValueError(f"G={G} with {n_shadow} shadow columns leaves no "
                         "room for one column of s32 cells in a block's "
                         "shared memory")
    smem = _a16(4 * G * Kt) + _a16(4 * G * n_shadow) + table_bytes
    # as many blocks as fit an SM (at most 4), about 1024 threads an SM: a
    # block that fills the shared memory alone gets 1024 threads (3.2x
    # faster than 256 at G = 1024, K = 42; PERF.md)
    per_sm = max(1, min(4, (SMEM_MAX + 1024) // smem))
    block = max(256, 1024 // per_sm // 32 * 32)
    return LaunchPlan(G, K, n_shadow, block=block, smem=smem,
                      flush_tiles=S32_ROWS // block, Kt=Kt,
                      ntiles=-(-K // Kt))
