// The accumulation core shared by K1 (preagg_fused2.cu), K2
// (preagg_fused.cu) and K4 (preagg_pallas.cu): per-bucket exact sums of
// per-row digit columns.
//
// K1 and K2 supply the addresses of their input lanes and a row decoder
// `Dec` that reads them through a row accessor `a` (a.u8(i), a.u32(i),
// a.u64(i): lane i's element of the row):
//
//   int  bucket(const Row& a)                     bucket of the row, or -1
//   void row(const Row& a, const Sink& s, c0, c1) the row's digits of the
//        columns in [c0, c1): s.digit(col, d) for every digit column (d an
//        integer in [-255, 255], zeros included) and s.shadow(col, si, v)
//        for the si-th float shadow column
//
// and `run` sums them with the launch geometry of the planner
// (ops/launch_plan.py), one row per thread.  K4 reads a row-major value
// matrix, for which one row per thread is the wrong walk; it writes its own
// loop over the same tables (`tables`, `s32_flush`, `flush_shadow`) and
// launches through `launch`.  Every non-zero digit is a 32-bit
// shared-memory atomic add (a native ATOMS.ADD on sm_90; the 64-bit and
// float adds are compare-and-swap loops) into a block-private table
// [G][Kt] (Kt = all K columns when they fit one block, else a column tile
// per blockIdx.y), shadows into [G][n_sh] f32.  A block adds at most
// S32_ROWS = 2^23 rows into the s32 cells before it flushes them into the
// int64 output (255 * 2^23 < 2^31), and ends with one global atomic per
// non-zero cell.  The tile loop is uniform across a block (it depends on
// blockIdx only), so the barriers inside it are safe.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace onehot {

// launch geometry, filled from the planner's int32 vector (keep the order
// in sync with LaunchPlan.geo() in ops/launch_plan.py)
struct Geo {
  int G, K, n_sh, Kt, ntiles, flush_tiles, block;
  __host__ __device__ static Geo load(const int* v) {
    Geo q;
    q.G = v[0]; q.K = v[1]; q.n_sh = v[2]; q.Kt = v[3]; q.ntiles = v[4];
    q.flush_tiles = v[5]; q.block = v[6];
    return q;
  }
};

// a row's elements of the input lanes (lane i at address ptr[i])
struct Row {
  const unsigned long long* ptr;
  long long r;
  __device__ __forceinline__ unsigned u8(int i) const {
    return reinterpret_cast<const unsigned char*>(ptr[i])[r];
  }
  __device__ __forceinline__ unsigned u32(int i) const {
    return reinterpret_cast<const unsigned*>(ptr[i])[r];
  }
  __device__ __forceinline__ unsigned long long u64(int i) const {
    return reinterpret_cast<const unsigned long long*>(ptr[i])[r];
  }
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// bytes of the core's shared-memory region (the kernel's own tables follow
// it); ops/launch_plan.py computes the same
__host__ __device__ inline size_t core_bytes(const Geo& q) {
  return align16((size_t)q.G * q.Kt * 4) + align16((size_t)q.G * q.n_sh * 4);
}

// where a decoder's digits go
struct Sink {
  unsigned* row;  // s32 cells [Kt] of the row's bucket
  float* sh;      // shadow row [n_sh]
  int c0, c1;
  __device__ __forceinline__ void digit(int c, int d) const {
    if (d != 0 && c >= c0 && c < c1) atomicAdd(row + (c - c0), (unsigned)d);
  }
  // a nonzero |x| below FLT_MIN adds as +-FLT_MIN: the global flush
  // (REDG.ADD.F32.FTZ) would drop a block's subnormal sum, and the host's
  // digit-window check must see every nonzero row (preagg_mxu.SHADOW_MIN)
  __device__ __forceinline__ void shadow(int c, int si, float x) const {
    if (x != 0.f && c >= c0 && c < c1)
      atomicAdd(sh + si, fabsf(x) < FLT_MIN ? copysignf(FLT_MIN, x) : x);
  }
};

// the shadow cells of a block's table into the global [G, K] output
__device__ __forceinline__ void flush_shadow(const Geo& q, const float* sSh,
                                             const int* shcol, int c0, int c1,
                                             float* g_shadow) {
  for (int i = threadIdx.x; i < q.G * q.n_sh; i += blockDim.x) {
    const int col = shcol[i % q.n_sh];
    const float f = sSh[i];
    if (col >= c0 && col < c1 && f != 0.f)
      atomicAdd(g_shadow + (size_t)(i / q.n_sh) * q.K + col, f);
  }
}

__device__ __forceinline__ void s32_flush(unsigned* s32, int G, int K, int Kt,
                                          int c0, int c1,
                                          unsigned long long* g_ints) {
  const int kt = c1 - c0;
  for (int i = threadIdx.x; i < G * kt; i += blockDim.x) {
    const int g = i / kt, j = i % kt;
    const unsigned v = s32[g * Kt + j];
    if (v) {
      s32[g * Kt + j] = 0u;
      // the cell holds a signed sum that fits 32 bits: sign-extend it
      atomicAdd(g_ints + (size_t)g * K + c0 + j,
                (unsigned long long)(long long)(int)v);
    }
  }
}

// the block's s32 cells and shadow cells at the head of its shared memory,
// zeroed (the caller's barrier publishes them)
__device__ __forceinline__ void tables(const Geo& q, unsigned char* smem,
                                       unsigned** s32, float** sSh) {
  *s32 = reinterpret_cast<unsigned*>(smem);
  *sSh = reinterpret_cast<float*>(smem + align16((size_t)q.G * q.Kt * 4));
  for (int i = threadIdx.x; i < q.G * q.Kt; i += blockDim.x) (*s32)[i] = 0u;
  for (int i = threadIdx.x; i < q.G * q.n_sh; i += blockDim.x) (*sSh)[i] = 0.f;
}

template <class Dec>
__device__ __forceinline__ void run(const Dec& dec,
                                    const unsigned long long* lanes,
                                    const Geo& q, long long nrows,
                                    unsigned char* smem, const int* shcol,
                                    unsigned long long* g_ints,
                                    float* g_shadow) {
  const int R = blockDim.x, t = threadIdx.x;
  const int G = q.G, K = q.K, Kt = q.Kt, nsh = q.n_sh;
  const int c0 = blockIdx.y * Kt, c1 = min(K, c0 + Kt);
  unsigned* s32;
  float* sSh;
  tables(q, smem, &s32, &sSh);
  __syncthreads();

  int since = 0;
  const long long stride = (long long)gridDim.x * R;
  for (long long base = (long long)blockIdx.x * R; base < nrows;
       base += stride) {
    const Row a{lanes, base + t};
    if (a.r < nrows) {
      const int g = dec.bucket(a);
      if (g >= 0)
        dec.row(a, Sink{s32 + (size_t)g * Kt, sSh + g * nsh, c0, c1}, c0,
                c1);
    }
    if (++since == q.flush_tiles) {
      __syncthreads();
      s32_flush(s32, G, K, Kt, c0, c1, g_ints);
      __syncthreads();
      since = 0;
    }
  }
  __syncthreads();
  s32_flush(s32, G, K, Kt, c0, c1, g_ints);
  flush_shadow(q, sSh, shcol, c0, c1, g_shadow);
}

// ---------------------------------------------------------------------------
// host side: the grid and the launch
// ---------------------------------------------------------------------------

// kernel<<<(grid_x, column tiles), block, smem>>>(a, q); grid_x <= 0 asks
// for as many blocks as the card holds at once, shared among the column
// tiles (rounded down: a block past one wave would run alone after it),
// capped by the row tiles; a positive grid_x is taken as it is; returns a
// cudaError_t
template <class Kernel, class Args>
inline int launch(Kernel kernel, const Args& a, const Geo& q, long long nrows,
                  int grid_x, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (grid_x <= 0) {
    int dev = 0, sms = 0, occ = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, q.block, smem)) != cudaSuccess)
      return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    const long long want = (long long)occ * sms / q.ntiles;
    const long long rows = (nrows + q.block - 1) / q.block;
    grid_x = (int)(want < rows ? want : rows);
    if (grid_x < 1) grid_x = 1;
  }
  kernel<<<dim3(grid_x, q.ntiles), q.block, smem, stream>>>(a, q);
  return (int)cudaGetLastError();
}

// -1: the planner's shared-memory bytes do not cover the core's layout
constexpr int ERR_SMEM_PLAN = -1;

}  // namespace onehot
