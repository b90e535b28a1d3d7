// K2 — fused grouped pre-aggregation over encoded lanes, for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/preagg_fused.py
// _build_kernel_impl (V built in VMEM from a few encoded lanes, then
// one-hot(bucket)^T . V on the MXU).  Contract, per bucket g < G and per
// physical column c < K of the plan's op table (ops/preagg_fused.py):
//
//   ints   int64 [G, K]  exact sum over the rows with seg == g of the
//                        column's integer value
//   shadow float [G, K]  sum of the column's float value for the `fabs`
//                        and `f32` shadow columns (NaN and inf propagate)
//
// Op table rows are (tag, col, input, f4 slot); the inputs are u32 lanes
// (int32 storage), bool lanes and float32 lanes, encoded by torch:
//
//   mask    1 col   1 for every kept row (seg < G)
//   bool    1 col   the bool lane
//   limbs4  4 cols  the 8-bit limbs of a u32 lane
//   ksq12  12 cols  limbs of b*b, a*b, a*a for the u32 key word a*2^16 + b
//   f4s     9 cols  signed 8-bit digits of |x| * scale: three base-2^24
//                   splits w = v*2^24, i = floor(w), v = w - i; low level
//                   first, digit shifts 0/8/16 within a level, each digit
//                   carrying the sign of x (NaN gives zero digits)
//   fabs    1 col   shadow |x|
//   f32     1 col   shadow x
//
// The TPU's P=8 row packing, bf16 digits and 2^16-row hi/lo flush exist
// for the MXU and have no counterpart: sums are int64 here.
//
// What bounds it on an H100: per row it reads the bucket id and a few
// lanes (about 20 bytes at the agg_group shape) and then issues one
// shared-memory atomic add per non-zero cell, tens per row, many on the
// same few rows when G is small.  The design keeps a block-private
// [G, Kt] accumulator in shared memory, walks the rows with a grid-stride
// loop, and flushes the non-zero cells to global memory once per block.
// When G * K cells do not fit the shared memory the columns are tiled:
// blockIdx.y picks a tile of Kt columns and each tile re-reads the lanes.
// wgmma, TMA and warp-specialised reduction are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (the
// digit extraction must stay IEEE-identical to the plain PyTorch version).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// keep in sync with ops/preagg_fused.py
constexpr int OP_W = 4;
enum { OP_MASK, OP_BOOL, OP_LIMBS4, OP_KSQ12, OP_F4S, OP_FABS, OP_F32 };

__device__ __forceinline__ int op_width(int tag) {
  switch (tag) {
    case OP_LIMBS4: return 4;
    case OP_KSQ12: return 12;
    case OP_F4S: return 9;
    default: return 1;
  }
}

struct Acc {
  unsigned long long* ints;  // [G, Kt] row of the current bucket
  float* sh;
  int c0, c1;
  __device__ __forceinline__ void add(int c, long long v) const {
    if (v != 0 && c >= c0 && c < c1)
      atomicAdd(ints + (c - c0), (unsigned long long)v);
  }
  __device__ __forceinline__ void addf(int c, float v) const {
    if (v != 0.f && c >= c0 && c < c1) atomicAdd(sh + (c - c0), v);
  }
};

__device__ __forceinline__ void add_limbs(const Acc& a, int col, unsigned u,
                                          int nl) {
  for (int j = 0; j < nl; ++j) a.add(col + j, (long long)((u >> (8 * j)) & 0xFFu));
}

__global__ void k2_kernel(const int* __restrict__ desc, int desc_len, int n_in,
                          int n_ops, const float* __restrict__ scale,
                          const int* __restrict__ seg,
                          long long nrows, int G, int K, int Kt,
                          int has_shadow, unsigned long long* __restrict__ g_ints,
                          float* __restrict__ g_shadow) {
  extern __shared__ unsigned long long smem[];
  const int c0 = blockIdx.y * Kt;
  const int c1 = min(K, c0 + Kt);
  const int cells = G * Kt;
  unsigned long long* s_acc = smem;
  unsigned long long* s_ptr = smem + cells;
  float* s_sh = reinterpret_cast<float*>(s_ptr + n_in);
  int* s_ops = reinterpret_cast<int*>(s_sh + (has_shadow ? cells : 0));
  const int ops_len = desc_len - 2 * n_in;

  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    s_ptr[i] = (unsigned long long)(unsigned)desc[2 * i] |
               ((unsigned long long)(unsigned)desc[2 * i + 1] << 32);
  for (int i = threadIdx.x; i < ops_len; i += blockDim.x)
    s_ops[i] = desc[2 * n_in + i];
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_acc[i] = 0ull;
  if (has_shadow)
    for (int i = threadIdx.x; i < cells; i += blockDim.x) s_sh[i] = 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < nrows; r += stride) {
    const int g = seg[r];
    if ((unsigned)g >= (unsigned)G) continue;  // dropped row
    Acc a{s_acc + (size_t)g * Kt, s_sh + (size_t)g * Kt, c0, c1};
    for (int o = 0; o < n_ops; ++o) {
      const int* op = s_ops + o * OP_W;
      const int tag = op[0], col = op[1], in = op[2];
      if (col >= c1 || col + op_width(tag) <= c0) continue;  // other tile
      switch (tag) {
        case OP_MASK:
          a.add(col, 1);
          break;
        case OP_BOOL: {
          const unsigned char b = reinterpret_cast<const unsigned char*>(s_ptr[in])[r];
          a.add(col, b != 0);
          break;
        }
        case OP_LIMBS4:
          add_limbs(a, col, reinterpret_cast<const unsigned*>(s_ptr[in])[r], 4);
          break;
        case OP_KSQ12: {
          const unsigned u = reinterpret_cast<const unsigned*>(s_ptr[in])[r];
          const unsigned hi = u >> 16, lo = u & 0xFFFFu;
          add_limbs(a, col, lo * lo, 4);
          add_limbs(a, col + 4, hi * lo, 4);
          add_limbs(a, col + 8, hi * hi, 4);
          break;
        }
        case OP_F4S: {
          const float x = reinterpret_cast<const float*>(s_ptr[in])[r];
          const float pos = x > 0.f ? x : 0.f;
          const float neg = x < 0.f ? -x : 0.f;  // NaN: both zero
          const bool sneg = x < 0.f;
          float v = (pos + neg) * scale[op[3]];
          int iv[3];
          for (int k = 0; k < 3; ++k) {
            const float w = v * 16777216.f;
            const float fi = floorf(w);
            v = w - fi;
            iv[k] = __float2int_rz(fi);  // saturating; NaN -> 0
          }
          for (int j = 0; j < 9; ++j) {
            const int d = (iv[2 - j / 3] >> (8 * (j % 3))) & 0xFF;
            a.add(col + j, sneg ? -d : d);
          }
          break;
        }
        case OP_FABS:
          a.addf(col, fabsf(reinterpret_cast<const float*>(s_ptr[in])[r]));
          break;
        default:  // OP_F32
          a.addf(col, reinterpret_cast<const float*>(s_ptr[in])[r]);
          break;
      }
    }
  }

  __syncthreads();
  const int kt = c1 - c0;
  for (int i = threadIdx.x; i < G * kt; i += blockDim.x) {
    const int g = i / kt, j = i % kt;
    const unsigned long long v = s_acc[g * Kt + j];
    if (v) atomicAdd(g_ints + (size_t)g * K + c0 + j, v);
    if (has_shadow) {
      const float f = s_sh[g * Kt + j];
      if (f != 0.f) atomicAdd(g_shadow + (size_t)g * K + c0 + j, f);
    }
  }
}

}  // namespace

extern "C" int pgstrom_k2_launch(const int* desc, int desc_len, int n_in,
                                 int n_ops, const float* scale, const int* seg,
                                 long long nrows, int G, int K, int Kt,
                                 int has_shadow, unsigned long long* ints,
                                 float* shadow, int grid_x, int grid_y,
                                 int block, size_t smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k2_kernel<<<dim3(grid_x, grid_y), block, smem, (cudaStream_t)stream>>>(
      desc, desc_len, n_in, n_ops, scale, seg, nrows, G, K, Kt, has_shadow,
      ints, shadow);
  return (int)cudaGetLastError();
}
