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
// Every digit is an integer in [-255, 255].  The row decoder below turns a
// row into those digits; the accumulation core (onehot_accum.cuh) sums
// them per bucket with 32-bit native shared-memory adds into a
// block-private table, one column tile wherever it fits (G = 1024, K = 42
// included), in the launch ops/launch_plan.py plans.
//
// What bounds it on an H100: it reads the bucket id and a few lanes (about
// 23 bytes a row at the agg_group shape), so bytes bound it at 0.46 ms per
// 2^26 rows.  The cells are 32-bit because a 64-bit shared-memory add is a
// compare-and-swap loop on this card, and because they let G = 1024 read
// its lanes once, in one column tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (the
// digit extraction must stay IEEE-identical to the plain PyTorch version).

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_accum.cuh"

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

__device__ __forceinline__ void put_limbs(const onehot::Sink& s, int col,
                                          unsigned u, int nl) {
  for (int j = 0; j < nl; ++j) s.digit(col + j, (int)((u >> (8 * j)) & 0xFFu));
}

// lanes: the encoded inputs, then the bucket ids (lane n_in)
struct K2Dec {
  const int* ops;  // [n_ops, OP_W]
  int n_ops, G, seg_lane;
  const float* scale;

  __device__ __forceinline__ int bucket(const onehot::Row& a) const {
    const int g = (int)a.u32(seg_lane);
    return (unsigned)g < (unsigned)G ? g : -1;  // else a dropped row
  }

  __device__ __forceinline__ void row(const onehot::Row& a,
                                      const onehot::Sink& s, int c0,
                                      int c1) const {
    int si = 0;  // running index of the shadow columns
    for (int o = 0; o < n_ops; ++o) {
      const int* op = ops + o * OP_W;
      const int tag = op[0], col = op[1], in = op[2];
      const bool is_sh = tag == OP_FABS || tag == OP_F32;
      const int my_si = si;
      si += is_sh;
      if (col >= c1 || col + op_width(tag) <= c0) continue;  // other tile
      switch (tag) {
        case OP_MASK:
          s.digit(col, 1);
          break;
        case OP_BOOL:
          s.digit(col, a.u8(in) != 0);
          break;
        case OP_LIMBS4:
          put_limbs(s, col, a.u32(in), 4);
          break;
        case OP_KSQ12: {
          const unsigned u = a.u32(in);
          const unsigned hi = u >> 16, lo = u & 0xFFFFu;
          put_limbs(s, col, lo * lo, 4);
          put_limbs(s, col + 4, hi * lo, 4);
          put_limbs(s, col + 8, hi * hi, 4);
          break;
        }
        case OP_F4S: {
          const float x = __uint_as_float(a.u32(in));
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
            s.digit(col + j, sneg ? -d : d);
          }
          break;
        }
        case OP_FABS:
          s.shadow(col, my_si, fabsf(__uint_as_float(a.u32(in))));
          break;
        default:  // OP_F32
          s.shadow(col, my_si, __uint_as_float(a.u32(in)));
          break;
      }
    }
  }
};

// the descriptor: lane addresses (lo, hi int32 words; the n_in encoded
// lanes, then the bucket ids), the op table, then the shadow columns'
// indexes; loaded into shared memory after the core
struct K2Args {
  const int* desc;
  int desc_len, n_in, n_ops;
  const float* scale;
  long long nrows;
  unsigned long long* ints;
  float* shadow;
};

__device__ __forceinline__ K2Dec k2_prologue(const K2Args& a,
                                             const onehot::Geo& q,
                                             unsigned char* smem,
                                             const unsigned long long** lanes,
                                             const int** shcol) {
  const int nl = a.n_in + 1;
  unsigned char* p = smem + onehot::core_bytes(q);
  unsigned long long* s_ptr = reinterpret_cast<unsigned long long*>(p);
  int* s_ops = reinterpret_cast<int*>(s_ptr + nl);
  const int ops_len = a.desc_len - 2 * nl;
  for (int i = threadIdx.x; i < nl; i += blockDim.x)
    s_ptr[i] = (unsigned long long)(unsigned)a.desc[2 * i] |
               ((unsigned long long)(unsigned)a.desc[2 * i + 1] << 32);
  for (int i = threadIdx.x; i < ops_len; i += blockDim.x)
    s_ops[i] = a.desc[2 * nl + i];
  *lanes = s_ptr;
  *shcol = s_ops + a.n_ops * OP_W;
  return K2Dec{s_ops, a.n_ops, q.G, a.n_in, a.scale};
}

// the core's first barrier publishes the tables
__global__ void k2_kernel(K2Args a, onehot::Geo q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned long long* lanes;
  const int* shcol;
  const K2Dec dec = k2_prologue(a, q, smem, &lanes, &shcol);
  onehot::run<K2Dec>(dec, lanes, q, a.nrows, smem, shcol, a.ints, a.shadow);
}

}  // namespace

// geo: the planner's int32 vector (onehot::Geo); grid_x <= 0 fills the
// card; returns a cudaError_t, or onehot::ERR_SMEM_PLAN
extern "C" int pgstrom_k2_launch(const int* desc, int desc_len, int n_in,
                                 int n_ops, const float* scale,
                                 long long nrows, const int* geo,
                                 unsigned long long* ints, float* shadow,
                                 int grid_x, size_t smem, void* stream) {
  const onehot::Geo q = onehot::Geo::load(geo);
  const size_t nl = (size_t)n_in + 1;
  const size_t tables = 8 * nl + 4 * ((size_t)desc_len - 2 * nl);
  if (smem < onehot::core_bytes(q) + tables) return onehot::ERR_SMEM_PLAN;
  const K2Args a{desc, desc_len, n_in, n_ops, scale, nrows, ints, shadow};
  return onehot::launch(k2_kernel, a, q, nrows, grid_x, smem,
                        (cudaStream_t)stream);
}
