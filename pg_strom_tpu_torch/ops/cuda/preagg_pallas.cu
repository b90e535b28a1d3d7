// K4 — segmented column sums of a precomputed value matrix, for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/preagg_pallas.py _build
// (one-hot(bucket)^T . V on the MXU, the half-fused reduce behind
// preagg_mxu.mxu_reduce under config.use_pallas_reduce).  Contract: for a
// bf16 matrix V [N, K] whose integer columns hold values in [-255, 255]
// and a bucket id per row (seg >= G drops the row),
//
//   ints   int64 [G, K]  exact per-bucket sums of the integer columns,
//                        each cell converted as preagg_mxu.sat_int64 does
//   shadow float [G, K]  per-bucket float sums of the shadow columns
//                        (|v| replay guards; NaN and inf propagate)
//
// The TPU's 2^16-row hi/lo flush exists for f32 accumulation on the MXU;
// here the sums are exact integers.
//
// What bounds it on an H100: bytes.  It reads 2 K + 4 bytes a row (88 at
// the agg_group shape, 5.9 GB a 2^26-row chunk: 1.76 ms at 3.35 TB/s) and
// makes one shared-memory add per non-zero cell.  The design:
//
// * The accumulation core of K1 and K2 (onehot_accum.cuh): 32-bit cells in
//   a block-private [G, Kt] table (native ATOMS.ADD; a 64-bit shared add
//   is a compare-and-swap loop), a compact [G, n_sh] f32 table for the
//   shadow columns only, the s32 flush every S32_ROWS rows a block adds,
//   and the planner's launch (ops/launch_plan.py): G = 1024 x K = 42 is one
//   column tile, so V is read once.
// * Wide reads: a warp takes 32 rows of a block tile, 8 at a time, and
//   copies them with 16-byte cp.async into its own double buffer in
//   shared memory (the next 8 rows are in flight while the current 8 are
//   added).  When the tile is every column, eight rows are one run of
//   16 K bytes from a 16-byte aligned start: K vectors.  Otherwise each
//   row's window of the tile's columns is copied as the vectors that
//   cover it, at a row stride = K mod 8, so that row i's column c is at
//   i stride + c in both layouts: a column tile reads its own columns
//   only, and the staging grows with the tile (the planner sizes it), not
//   with K.  Blocks are 1024 threads (K4_BLOCK in ops/preagg_pallas.py),
//   faster than smaller blocks at every G timed.
// * Column tiles of equal width, and a grid of one wave (onehot::launch),
//   so that no SM idles while the blocks of a wider tile finish.
// * Two columns a lane: lane l takes columns cg + 2 l and cg + 2 l + 1 of
//   each staged row (cg walks the block's column tile 64 at a time), so
//   the lanes of one add instruction sit on cells two apart in one bucket
//   row, even at G = 32.  A row's bucket is the same for the
//   whole warp, and a lane's columns, their kind and their cells do not
//   change from row to row.  A step's reads all come before its adds (the
//   compiler keeps shared reads and adds in program order), and no read
//   is conditional (a conditional read is a branch, on which the lanes
//   past the last column diverge).
// * Shadow cells: a float shared add is a compare-and-swap loop, so the
//   shadow columns are left out of the adds above; after each step the
//   lanes add them from the staged rows, one lane a (row, shadow column).
// * A cell whose value is no integer in [-255, 255] (an inf, or a digit
//   past the range: build_mxu_columns makes them for an inf input, whose
//   chunk host replay discards) stays out of the s32 table: its saturated
//   int64 value goes straight into the output with a global 64-bit atomic,
//   which wraps the same in any order.
//
// What is left (PERF.md): neither the copies nor the adds hold it back;
// the per-element work between them (the float to int conversion, the
// range and ownership tests) does, at about a third of the bound.  At
// K = 42 only lanes 0-20 have columns, so each of those instructions does
// 21 lanes' work out of 32; a walk that packs (row, column pair) onto the
// lanes is untried.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_accum.cuh"

namespace {

constexpr int RG = 8;            // rows a warp stages at a time
constexpr int MAX_BLOCK = 1024;

// elements from one staged row to the next: K for whole rows; for windows
// of Kt columns, room for the vectors that cover a window starting
// anywhere in its first one (Kt + 14), rounded up to = K mod 8, so that
// column c of row i sits at i stride + c in either layout (a window
// vector starts at a multiple of 8 as its row's does in V)
__host__ __device__ inline int row_stride(int K, int Kt) {
  return Kt == K ? K : Kt + 14 + ((K - Kt - 14) & 7);
}
// elements of one staged RG-row step
__host__ __device__ inline int step_elems(int K, int Kt) {
  return RG * row_stride(K, Kt);
}
// the kernel's own tables after the core (ops/preagg_pallas.py computes
// the same): the shadow columns [n_sh] and column -> shadow index [K] (-1
// for an integer column) as int32, then each warp's two staged steps
__host__ __device__ inline int desc_len(int K, int nsh) { return nsh + K; }
__host__ __device__ inline size_t table_bytes(const onehot::Geo& q) {
  return onehot::align16((size_t)desc_len(q.K, q.n_sh) * 4) +
         (size_t)(q.block / 32) * 2 * step_elems(q.K, q.Kt) * 2;
}

// copy 16 bytes (`bytes` of them from global memory, the rest zeros)
// into shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

struct K4Args {
  const unsigned short* V;  // bf16 bits [nrows, K]
  const int* seg;
  const int* desc;          // the first two tables above
  long long nrows;
  unsigned long long* ints;
  float* shadow;
};

// bf16 bits b (in the high half) of a column that is this lane's (an
// integer column of the tile: `mine`) in a row of bucket g (-1: dropped):
// an integer in [-255, 255] goes to its s32 cell; returns whether the
// value is the rare other kind (see `put_rare`)
__device__ __forceinline__ bool put(unsigned b, bool mine, int g,
                                    unsigned* cell) {
  const int d = (int)__uint_as_float(b);  // as sat_int64; NaN: 0
  const bool digit = (unsigned)d + 255u <= 510u;
  if (mine && g >= 0 && digit && d != 0) atomicAdd(cell, (unsigned)d);
  return mine && g >= 0 && !digit;
}

// a value that put() left out (|v| >= 256 or inf): its saturated int64
// value straight into the output
__device__ __forceinline__ void put_rare(unsigned b, bool mine, int g,
                                         unsigned long long* cell) {
  const float v = __uint_as_float(b);
  if (mine && g >= 0 && (unsigned)(int)v + 255u > 510u)
    atomicAdd(cell, (unsigned long long)__float2ll_rz(v));  // saturating
}

// kWhole: the tile is every column (Kt = K, c0 = 0) and rows are staged
// whole; else each row's window of the tile
template <bool kWhole>
__global__ void __launch_bounds__(MAX_BLOCK) k4_kernel(K4Args a,
                                                       onehot::Geo q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = q.K, nsh = q.n_sh;
  const int c0 = kWhole ? 0 : blockIdx.y * q.Kt;
  const int c1 = kWhole ? K : min(K, c0 + q.Kt);
  unsigned* s32;
  float* sSh;
  onehot::tables(q, smem, &s32, &sSh);
  int* shcol = reinterpret_cast<int*>(smem + onehot::core_bytes(q));
  const int dl = desc_len(K, nsh);
  for (int i = threadIdx.x; i < dl; i += blockDim.x) shcol[i] = a.desc[i];
  const int* si = shcol + nsh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int se = step_elems(K, q.Kt), stride = row_stride(K, q.Kt);
  // A step's first row is a multiple of RG = 8, so row i's window starts
  // (i K + c0) & 7 elements into its first vector at every step.  The
  // staged row i, column c is at i stride + c0 % 8 + c - c0 (whole rows:
  // i K + c).
  const int kt = c1 - c0, wv = (kt + 14) / 8;  // vectors a window takes
  // the staging copies of a lane: vector v of row i's window, i wv + v =
  // lane + 32 j (a step of 32 is dq rows and dr vectors)
  const int li = lane / wv, lv = lane % wv, dq = 32 / wv, dr = 32 % wv;
  unsigned short* buf = reinterpret_cast<unsigned short*>(
      reinterpret_cast<unsigned char*>(shcol) +
      onehot::align16((size_t)dl * 4) + (size_t)warp * 2 * se * 2);
  __syncthreads();

  const long long nrows = a.nrows, step = (long long)gridDim.x * blockDim.x;
  const long long nel = nrows * K;
  // the first row of step k (rows RG k .. RG k + RG of the warp's 32) of
  // block tile t0
  auto row0 = [&](long long t0, int k) { return t0 + warp * 32 + k * RG; };

  // copy vector index e / 8 of V (elements past the last row: zeros)
  auto copy = [&](unsigned short* dst, long long e) {
    const long long l = nel - e;
    const int bytes = l >= 8 ? 16 : l > 0 ? (int)l * 2 : 0;
    cp_async16(dst, bytes ? a.V + e : a.V, bytes);
  };
  // stage step k of block tile t0 into buffer b
  auto stage = [&](long long t0, int k, int b) {
    const long long r0 = row0(t0, k);
    unsigned short* dst = buf + b * se;
    if (kWhole) {
      const long long e0 = r0 * K;
      if (nel - e0 >= RG * K) {
        for (int v = lane; v < K; v += 32)
          cp_async16(dst + 8 * v, a.V + e0 + 8 * v, 16);
      } else {  // the last rows
        for (int v = lane; v < K; v += 32) copy(dst + 8 * v, e0 + 8 * v);
      }
    } else {
      const long long e0 = r0 * K;  // a multiple of 8
      for (int i = li, v = lv; i < RG;) {
        const int w = i * K + c0;  // row i's window starts at e0 + w
        if (v < ((w & 7) + kt + 7) >> 3)
          copy(dst + i * stride + (c0 & 7) - (w & 7) + 8 * v,
               e0 + (w & ~7) + 8 * v);
        i += dq;
        v += dr;
        if (v >= wv) {
          v -= wv;
          ++i;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto bucket = [&](long long t0) {  // of the lane's row of the warp's 32
    const long long r = t0 + warp * 32 + lane;
    if (r >= nrows) return -1;
    const int s = a.seg[r];
    return (unsigned)s < (unsigned)q.G ? s : -1;
  };
  // an integer column of this block's tile
  auto mine = [&](int col) { return col >= c0 && col < c1 && si[col] < 0; };

  long long t0 = (long long)blockIdx.x * blockDim.x;  // block tile
  int k = 0, b = 0, since = 0;
  int gl = bucket(t0);
  stage(t0, 0, 0);
  while (t0 < nrows) {  // uniform across the block
    const bool last = k == 32 / RG - 1;  // of the tile's steps
    const long long nt0 = last ? t0 + step : t0;
    int ngl = gl;
    if (nt0 < nrows) {
      stage(nt0, last ? 0 : k + 1, b ^ 1);
      if (last) ngl = bucket(nt0);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group
    }
    asm volatile("cp.async.wait_group 1;\n" ::);  // this step's copies
    __syncwarp();
    // row i, column c at rows[i stride + c]
    const unsigned short* rows = buf + b * se + (c0 & 7) - c0;
    for (int cg = c0 & ~1; cg < c1; cg += 64) {
      const int c = cg + 2 * lane;  // even
      const bool ma = mine(c), mb = mine(c + 1);
      const bool ha = c >= c0 && c < c1, hb = c + 1 < c1;  // staged
      unsigned x[RG];  // the step's reads first, none conditional
      int g[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const unsigned short* row = rows + i * stride + c;
        unsigned lo = 0u, hi = 0u;
        if (ha) lo = row[0];
        if (hb) hi = row[1];
        x[i] = lo | hi << 16;
        g[i] = __shfl_sync(~0u, gl, k * RG + i);  // the same for the warp
      }
      bool rare = false;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        unsigned* cell = s32 + max(g[i], 0) * q.Kt + (c - c0);
        rare |= put(x[i] << 16, ma, g[i], cell);
        rare |= put(x[i] & 0xFFFF0000u, mb, g[i], cell + 1);
      }
      if (__any_sync(~0u, rare)) {  // uniform, and rare
        for (int i = 0; i < RG; ++i) {
          unsigned long long* cell = a.ints + (size_t)max(g[i], 0) * K + c;
          put_rare(x[i] << 16, ma, g[i], cell);
          put_rare(x[i] & 0xFFFF0000u, mb, g[i], cell + 1);
        }
      }
    }
    // the shadow columns of the tile: lane (row i, shadow s) for i < RG
    const int i = lane % RG;
    const int gi = __shfl_sync(~0u, gl, k * RG + i);
    const unsigned short* row = rows + i * stride;
    for (int t = lane; t < RG * nsh; t += 32) {
      const int s = t / RG, col = shcol[s];
      if (gi >= 0 && col >= c0 && col < c1) {
        const float x = __uint_as_float((unsigned)row[col] << 16);
        if (x != 0.f) atomicAdd(sSh + gi * nsh + s, x);  // NaN kept
      }
    }
    __syncwarp();  // buffer b is restaged by the next step
    if (last) {
      if (++since == q.flush_tiles) {
        __syncthreads();
        onehot::s32_flush(s32, q.G, K, q.Kt, c0, c1, a.ints);
        __syncthreads();
        since = 0;
      }
    }
    t0 = nt0;
    k = last ? 0 : k + 1;
    b ^= 1;
    gl = ngl;
  }
  __syncthreads();
  onehot::s32_flush(s32, q.G, K, q.Kt, c0, c1, a.ints);
  onehot::flush_shadow(q, sSh, shcol, c0, c1, a.shadow);
}

}  // namespace

// geo: the planner's int32 vector (onehot::Geo, K = the columns of V);
// grid_x <= 0 fills the card; returns a cudaError_t, or
// onehot::ERR_SMEM_PLAN
extern "C" int pgstrom_k4_launch(const void* V, const int* seg,
                                 const int* desc, long long nrows,
                                 const int* geo, unsigned long long* ints,
                                 float* shadow, int grid_x, size_t smem,
                                 void* stream) {
  const onehot::Geo q = onehot::Geo::load(geo);
  if (q.block > MAX_BLOCK || q.block % 32 ||
      smem < onehot::core_bytes(q) + table_bytes(q))
    return onehot::ERR_SMEM_PLAN;
  const K4Args a{reinterpret_cast<const unsigned short*>(V), seg, desc, nrows,
                 ints, shadow};
  return q.Kt == q.K ? onehot::launch(k4_kernel<true>, a, q, nrows, grid_x,
                                      smem, (cudaStream_t)stream)
                     : onehot::launch(k4_kernel<false>, a, q, nrows, grid_x,
                                      smem, (cudaStream_t)stream);
}
