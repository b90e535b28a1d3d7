// K4 — segmented column sums of a precomputed value matrix, for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/preagg_pallas.py _build
// (one-hot(bucket)^T . V on the MXU, the half-fused reduce behind
// preagg_mxu.mxu_reduce under config.use_pallas_reduce).  Contract: for a
// bf16 matrix V [N, S] whose integer columns hold values in [-255, 255]
// and a bucket id per row (seg >= G drops the row),
//
//   ints   int64 [G, S]  exact per-bucket sums of the integer columns
//   shadow float [G, S]  per-bucket float sums of the shadow columns
//                        (|v| replay guards; NaN and inf propagate)
//
// `kind[c]` says which columns are shadows.  The TPU's 2^16-row hi/lo
// flush exists for f32 accumulation on the MXU; here sums are int64.
//
// What bounds it on an H100: it reads 2 S bytes a row plus the bucket id,
// and every non-zero cell is one shared-memory atomic add, many of them on
// the few hot rows of a small G.  The design keeps a block-private [G, Kt]
// accumulator in shared memory (int64, plus float for shadows), walks the
// rows with a grid-stride loop and flushes non-zero cells to global memory
// with one atomic each.  When G * S cells do not fit the shared memory,
// the columns are tiled: blockIdx.y picks a tile of Kt columns and each
// tile re-reads the rows.  wgmma, TMA and warp-specialised reduction are
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__global__ void k4_kernel(const __nv_bfloat16* __restrict__ V,
                          const int* __restrict__ seg,
                          const int* __restrict__ kind, long long nrows, int S,
                          int G, int Kt, int has_shadow,
                          unsigned long long* __restrict__ g_ints,
                          float* __restrict__ g_shadow) {
  extern __shared__ unsigned long long smem[];
  const int c0 = blockIdx.y * Kt;
  const int kt = min(Kt, S - c0);
  const int cells = G * Kt;
  unsigned long long* s_acc = smem;
  float* s_sh = reinterpret_cast<float*>(smem + cells);
  int* s_kind = reinterpret_cast<int*>(s_sh + (has_shadow ? cells : 0));

  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_acc[i] = 0ull;
  if (has_shadow)
    for (int i = threadIdx.x; i < cells; i += blockDim.x) s_sh[i] = 0.f;
  for (int i = threadIdx.x; i < kt; i += blockDim.x) s_kind[i] = kind[c0 + i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < nrows; r += stride) {
    const int g = seg[r];
    if ((unsigned)g >= (unsigned)G) continue;  // dropped row
    const __nv_bfloat16* row = V + r * S + c0;
    unsigned long long* arow = s_acc + (size_t)g * Kt;
    float* srow = s_sh + (size_t)g * Kt;
    for (int j = 0; j < kt; ++j) {
      const float v = __bfloat162float(row[j]);
      if (s_kind[j]) {
        if (v != 0.f) atomicAdd(srow + j, v);  // NaN != 0: kept
      } else {
        const long long iv = (long long)v;  // integer in [-255, 255]
        if (iv != 0) atomicAdd(arow + j, (unsigned long long)iv);
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < G * kt; i += blockDim.x) {
    const int g = i / kt, j = i % kt;
    const unsigned long long a = s_acc[g * Kt + j];
    if (a) atomicAdd(g_ints + (size_t)g * S + c0 + j, a);
    if (has_shadow) {
      const float f = s_sh[g * Kt + j];
      if (f != 0.f) atomicAdd(g_shadow + (size_t)g * S + c0 + j, f);
    }
  }
}

}  // namespace

extern "C" int pgstrom_k4_launch(const void* V, const int* seg, const int* kind,
                                 long long nrows, int S, int G, int Kt,
                                 int has_shadow, unsigned long long* ints,
                                 float* shadow, int grid_x, int grid_y,
                                 int block, size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      k4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k4_kernel<<<dim3(grid_x, grid_y), block, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(V), seg, kind, nrows, S, G, Kt,
      has_shadow, ints, shadow);
  return (int)cudaGetLastError();
}
