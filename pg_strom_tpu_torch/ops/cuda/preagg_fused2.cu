// K1 — fused grouped pre-aggregation over raw column planes, for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/preagg_fused2.py
// _build_kernel (one-hot(bucket)^T . V on the MXU).  It computes the same
// contract: for every live row (row < nrows, predicate TRUE) a dense bucket
// seg = key - kmin (NULL key -> rng + 1), and per physical column the exact
// sum of that column's per-row value over the rows of each bucket:
//
//   ints   int64 [G, K]   two's-complement sums (u64 atomics)
//   shadow float  [G, K]  sum of |x| for the `fabs` columns (NaN/inf kept)
//
// One fixed kernel, driven by tables (ops/preagg_fused2.py lower_program):
// an op table says which value each physical column holds (mask, count,
// 8-bit limbs of v - min, limbs of squares, signed float4 digit windows,
// |x|), and a postfix program evaluates the WHERE clause per row over a
// (data, valid) stack kept in two 32-bit registers — PostgreSQL float
// order (NaN == NaN, NaN above everything) and Kleene AND/OR/NOT.
//
// What bounds it on an H100: it reads each plane once (18 bytes a row at
// the flagship shape), yet measured about 0.14 of HBM bandwidth there
// (2.62 ms per 2^26-row chunk, H100 80GB HBM3 at 700 W), so bandwidth is
// not the limit; the per-row, per-column atomic adds are its work.  The
// design keeps those adds in shared memory: each block owns a private
// [G, K] accumulator when G*K fits, walks its rows with a grid-stride
// loop, skips zero contributions, and flushes the non-zero cells to global
// memory once.  Wider G*K adds straight into global memory.  Warp-level
// aggregation, wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (float32
// digit extraction must stay IEEE-identical to the plain PyTorch version).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// op table rows: (tag, col, din, vin, nl, x, flag, 0) — keep in sync with
// ops/preagg_fused2.py
constexpr int OP_W = 8;
enum { OP_MASK, OP_CNT, OP_SUM_I4, OP_SUM_I8, OP_SUMSQ4, OP_SUMSQ4_BIG,
       OP_F4S, OP_FABS };
// predicate program rows (postfix): (opcode, a1, ..., a8)
constexpr int PRED_W = 9;
enum { P_CMP = 1, P_NULLTEST, P_BOOLCOL, P_CONST, P_AND, P_OR, P_NOT };
// plane element types
enum { DT_I32, DT_F32, DT_I64, DT_BOOL };

struct Tables {
  const unsigned long long* ptr;  // plane addresses [n_in]
  const int* dtype;               // plane element types [n_in]
  const int* ops;                 // [n_ops, OP_W]
  const int* pred;                // [n_prog, PRED_W]
  const int* scal_i;              // [ni]: kmin, then per-op int32 mins
  const unsigned* scal_u;         // [nu]: per-op int64 mins as (lo, hi)
  const float* f4sc;              // [2, nf4]: two-step float4 scales
};

__device__ __forceinline__ bool rd_valid(const Tables& t, int vin, long long r) {
  if (vin < 0) return true;  // validity elided: NULL-free column
  return reinterpret_cast<const unsigned char*>(t.ptr[vin])[r] != 0;
}

__device__ __forceinline__ int rd_i32(const Tables& t, int i, long long r) {
  if (t.dtype[i] == DT_BOOL)
    return reinterpret_cast<const unsigned char*>(t.ptr[i])[r] != 0;
  return reinterpret_cast<const int*>(t.ptr[i])[r];
}

__device__ __forceinline__ float rd_f32(const Tables& t, int i, long long r) {
  int dt = t.dtype[i];
  if (dt == DT_F32) return reinterpret_cast<const float*>(t.ptr[i])[r];
  return (float)rd_i32(t, i, r);  // int column in the float domain (RN)
}

__device__ __forceinline__ long long rd_i64(const Tables& t, int i, long long r) {
  return reinterpret_cast<const long long*>(t.ptr[i])[r];
}

__device__ __forceinline__ void add_i(unsigned long long* p, long long v) {
  if (v != 0) atomicAdd(p, (unsigned long long)v);
}

__device__ __forceinline__ void add_limbs(unsigned long long* p,
                                          unsigned long long u, int nl) {
  for (int j = 0; j < nl; ++j) add_i(p + j, (long long)((u >> (8 * j)) & 0xFFull));
}

// predicate over row r: TRUE (data & valid) keeps the row
__device__ bool eval_pred(const Tables& t, int n_prog, long long r) {
  unsigned sd = 0, sv = 0;  // (data, valid) stack, top at bit 0
  for (int p = 0; p < n_prog; ++p) {
    const int* in = t.pred + p * PRED_W;
    bool d = false, v = true;
    switch (in[0]) {
      case P_CMP: {
        const int tag = in[1];
        const bool is_float = in[2] != 0;
        bool lt, eq;
        if (is_float) {
          float x = in[3] == 0 ? rd_f32(t, in[4], r) : __int_as_float(in[4]);
          float y = in[6] == 0 ? rd_f32(t, in[7], r) : __int_as_float(in[7]);
          bool xn = isnan(x), yn = isnan(y), nn = xn || yn;
          lt = (nn && !xn && yn) || (!nn && x < y);
          eq = (nn && xn && yn) || (!nn && x == y);
        } else {
          int x = in[3] == 0 ? rd_i32(t, in[4], r) : in[4];
          int y = in[6] == 0 ? rd_i32(t, in[7], r) : in[7];
          lt = x < y;
          eq = x == y;
        }
        switch (tag) {
          case 0: d = eq; break;
          case 1: d = !eq; break;
          case 2: d = lt; break;
          case 3: d = lt || eq; break;
          case 4: d = !(lt || eq); break;
          default: d = !lt; break;
        }
        if (in[3] == 0) v = v && rd_valid(t, in[5], r);
        if (in[6] == 0) v = v && rd_valid(t, in[8], r);
        break;
      }
      case P_NULLTEST: {
        bool cv = rd_valid(t, in[2], r);
        d = in[1] ? !cv : cv;
        break;
      }
      case P_BOOLCOL:
        d = rd_i32(t, in[1], r) != 0;
        v = rd_valid(t, in[2], r);
        break;
      case P_CONST:
        d = in[1] != 0;
        break;
      case P_NOT:
        sd ^= 1u;  // negate the top's data, keep its validity
        continue;
      default: {   // P_AND / P_OR: Kleene logic over the top two entries
        const bool d2 = sd & 1u, v2 = sv & 1u;
        const bool d1 = (sd >> 1) & 1u, v1 = (sv >> 1) & 1u;
        sd >>= 2;
        sv >>= 2;
        if (in[0] == P_AND) {
          v = (v1 && v2) || (v1 && !d1) || (v2 && !d2);
          d = d1 && d2;
        } else {
          v = (v1 && v2) || (v1 && d1) || (v2 && d2);
          d = d1 || d2;
        }
        break;
      }
    }
    sd = (sd << 1) | (unsigned)d;
    sv = (sv << 1) | (unsigned)v;
  }
  return n_prog == 0 || ((sd & sv) & 1u);
}

// signed float4 digit window (op f4s): the top nl digits of |x| * 2^-E in
// DB-bit digits, low digit first, each carrying the sign of x
__device__ void add_f4_digits(unsigned long long* p, float x, int nl, int DB,
                              float sc0, float sc1, bool use_abs) {
  const bool neg = x < 0.f;
  float av = use_abs ? fabsf(x)
                     : ((x > 0.f ? x : 0.f) + (x < 0.f ? -x : 0.f));  // NaN -> 0
  float v = (av * sc0) * sc1;
  const float pb = (float)(1 << (3 * DB));
  const int iters = (nl + 2) / 3;
  const int drop = 3 * iters - nl;
  int words[4];
  for (int k = 0; k < iters; ++k) {
    float w = v * pb;
    float i = floorf(w);
    v = w - i;
    words[k] = (int)i;
  }
  const int dmask = (1 << DB) - 1;
  for (int j = 0; j < nl; ++j) {
    const int tt = j + drop;
    const int dg = (words[iters - 1 - tt / 3] >> ((tt % 3) * DB)) & dmask;
    add_i(p + j, neg ? -dg : dg);
  }
}

__global__ void k1_kernel(const int* __restrict__ desc, int desc_len, int n_in,
                          int n_ops, int n_prog, int ni, int nu, int nf4,
                          long long nrows, int key_d, int key_v, int rng, int G,
                          int K, int DB, int has_shadow, int use_smem,
                          unsigned long long* __restrict__ g_ints,
                          float* __restrict__ g_shadow) {
  extern __shared__ unsigned long long smem[];
  const int cells = G * K;
  unsigned long long* s_acc = smem;
  unsigned long long* s_ptr = smem + (use_smem ? cells : 0);
  float* s_sh = reinterpret_cast<float*>(s_ptr + n_in);
  int* s_meta = reinterpret_cast<int*>(s_sh + ((use_smem && has_shadow) ? cells : 0));
  const int meta_len = desc_len - 2 * n_in;

  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    s_ptr[i] = (unsigned long long)(unsigned)desc[2 * i] |
               ((unsigned long long)(unsigned)desc[2 * i + 1] << 32);
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x)
    s_meta[i] = desc[2 * n_in + i];
  if (use_smem) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) s_acc[i] = 0ull;
    if (has_shadow)
      for (int i = threadIdx.x; i < cells; i += blockDim.x) s_sh[i] = 0.f;
  }
  __syncthreads();

  Tables t;
  t.ptr = s_ptr;
  t.dtype = s_meta;
  t.ops = t.dtype + n_in;
  t.pred = t.ops + n_ops * OP_W;
  t.scal_i = t.pred + n_prog * PRED_W;
  t.scal_u = reinterpret_cast<const unsigned*>(t.scal_i + ni);
  t.f4sc = reinterpret_cast<const float*>(t.scal_u + nu);
  unsigned long long* acc = use_smem ? s_acc : g_ints;
  float* sh = (use_smem && has_shadow) ? s_sh : g_shadow;
  const unsigned kmin = (unsigned)t.scal_i[0];

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < nrows;
       r += stride) {
    if (n_prog && !eval_pred(t, n_prog, r)) continue;
    int seg = rd_valid(t, key_v, r)
                  ? (int)((unsigned)rd_i32(t, key_d, r) - kmin)
                  : rng + 1;
    if ((unsigned)seg >= (unsigned)G) continue;  // outside every bucket
    unsigned long long* arow = acc + (size_t)seg * K;
    float* srow = sh + (size_t)seg * K;
    for (int o = 0; o < n_ops; ++o) {
      const int* op = t.ops + o * OP_W;
      const int tag = op[0], col = op[1], din = op[2], vin = op[3], nl = op[4];
      const int x = op[5];
      if (tag == OP_MASK) {
        add_i(arow + col, 1);
        continue;
      }
      const bool ok = rd_valid(t, vin, r);
      switch (tag) {
        case OP_CNT:
          if (ok) add_i(arow + col, 1);
          break;
        case OP_SUM_I4:
          if (ok) {
            unsigned u = (unsigned)rd_i32(t, din, r) - (unsigned)t.scal_i[x];
            add_limbs(arow + col, u, nl);
          }
          break;
        case OP_SUM_I8:
          if (ok) {
            unsigned long long mn = (unsigned long long)t.scal_u[x] |
                                    ((unsigned long long)t.scal_u[x + 1] << 32);
            add_limbs(arow + col, (unsigned long long)rd_i64(t, din, r) - mn, nl);
          }
          break;
        case OP_SUMSQ4:
        case OP_SUMSQ4_BIG:
          if (ok) {
            const int d = rd_i32(t, din, r);
            const unsigned u = d < 0 ? 0u - (unsigned)d : (unsigned)d;
            if (tag == OP_SUMSQ4) {
              add_limbs(arow + col, u * u, nl);
            } else {
              const unsigned a = u >> 16, b = u & 0xFFFFu;
              add_limbs(arow + col, b * b, 4);
              add_limbs(arow + col + 4, a * b, 4);
              add_limbs(arow + col + 8, a * a, 4);
            }
          }
          break;
        case OP_F4S:
          if (ok)
            add_f4_digits(arow + col, rd_f32(t, din, r), nl, DB, t.f4sc[x],
                          t.f4sc[nf4 + x], op[6] != 0);
          break;
        case OP_FABS:
          if (ok) atomicAdd(srow + col, fabsf(rd_f32(t, din, r)));
          break;
        default:
          break;
      }
    }
  }

  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if (s_acc[i]) atomicAdd(g_ints + i, s_acc[i]);
      if (has_shadow && s_sh[i] != 0.f) atomicAdd(g_shadow + i, s_sh[i]);
    }
  }
}

}  // namespace

extern "C" int pgstrom_k1_launch(const int* desc, int desc_len, int n_in,
                                 int n_ops, int n_prog, int ni, int nu, int nf4,
                                 long long nrows, int key_d, int key_v, int rng,
                                 int G, int K, int DB, int has_shadow,
                                 int use_smem, unsigned long long* ints,
                                 float* shadow, int grid, int block,
                                 size_t smem, void* stream) {
  k1_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      desc, desc_len, n_in, n_ops, n_prog, ni, nu, nf4, nrows, key_d, key_v, rng,
      G, K, DB, has_shadow, use_smem, ints, shadow);
  return (int)cudaGetLastError();
}

extern "C" const char* pgstrom_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
