// K1 — fused grouped pre-aggregation over raw column planes, for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/preagg_fused2.py
// _build_kernel (one-hot(bucket)^T . V on the MXU).  It computes the same
// contract: for every live row (row < nrows, predicate TRUE) a dense bucket
// seg = key - kmin (NULL key -> rng + 1), and per physical column the exact
// sum of that column's per-row value over the rows of each bucket:
//
//   ints   int64 [G, K]   two's-complement sums
//   shadow float  [G, K]  sum of |x| for the `fabs` columns (NaN/inf kept)
//
// One fixed kernel, driven by tables (ops/preagg_fused2.py lower_program):
// an op table says which value each physical column holds (mask, count,
// 8-bit limbs of v - min, limbs of squares, signed float4 digit windows,
// |x|), and a postfix program evaluates the WHERE clause per row over a
// (data, valid) stack kept in two 32-bit registers — PostgreSQL float
// order (NaN == NaN, NaN above everything) and Kleene AND/OR/NOT.
//
// The row decoder below turns a live row into its digits (integers in
// [-255, 255]: 8-bit limbs, 7- or 8-bit float digits, 0/1 counts); the
// accumulation core shared with K2 (onehot_accum.cuh) sums them per bucket
// with 32-bit native shared-memory adds into a block-private table, tiled
// by columns where [G, K] does not fit one block, in the launch
// ops/launch_plan.py plans.
//
// What bounds it on an H100: it reads each plane once (18 bytes a row at
// the flagship shape), 0.36 ms per 2^26-row chunk at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (float32
// digit extraction must stay IEEE-identical to the plain PyTorch version).

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_accum.cuh"
#include "pred_program.cuh"

namespace {

// op table rows: (tag, col, din, vin, nl, x, flag, 0) — keep in sync with
// ops/preagg_fused2.py
constexpr int OP_W = 8;
enum { OP_MASK, OP_CNT, OP_SUM_I4, OP_SUM_I8, OP_SUMSQ4, OP_SUMSQ4_BIG,
       OP_F4S, OP_FABS };

struct Tables {
  const int* dtype;               // plane element types [n_in]
  const int* ops;                 // [n_ops, OP_W]
  const int* pred;                // [n_prog, PRED_W]
  const int* scal_i;              // [ni]: kmin, then per-op int32 mins
  const unsigned* scal_u;         // [nu]: per-op int64 mins as (lo, hi)
  const float* f4sc;              // [2, nf4]: two-step float4 scales
};

// plane reads through the core's row accessor (onehot_accum.cuh)
__device__ __forceinline__ bool rd_valid(const onehot::Row& a, int vin) {
  if (vin < 0) return true;  // validity elided: NULL-free column
  return a.u8(vin) != 0;
}

__device__ __forceinline__ int rd_i32(const Tables& t, const onehot::Row& a,
                                      int i) {
  if (t.dtype[i] == DT_BOOL) return a.u8(i) != 0;
  return (int)a.u32(i);
}

__device__ __forceinline__ float rd_f32(const Tables& t, const onehot::Row& a,
                                        int i) {
  if (t.dtype[i] == DT_F32) return __uint_as_float(a.u32(i));
  return (float)rd_i32(t, a, i);  // int column in the float domain (RN)
}

__device__ __forceinline__ void put_limbs(const onehot::Sink& s, int col,
                                          unsigned long long u, int nl) {
  for (int j = 0; j < nl; ++j) s.digit(col + j, (int)((u >> (8 * j)) & 0xFFull));
}

// predicate over the row: TRUE (data & valid) keeps the row
__device__ bool eval_pred(const Tables& t, int n_prog, const onehot::Row& a) {
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
          float x = in[3] == 0 ? rd_f32(t, a, in[4]) : __int_as_float(in[4]);
          float y = in[6] == 0 ? rd_f32(t, a, in[7]) : __int_as_float(in[7]);
          bool xn = isnan(x), yn = isnan(y), nn = xn || yn;
          lt = (nn && !xn && yn) || (!nn && x < y);
          eq = (nn && xn && yn) || (!nn && x == y);
        } else {
          int x = in[3] == 0 ? rd_i32(t, a, in[4]) : in[4];
          int y = in[6] == 0 ? rd_i32(t, a, in[7]) : in[7];
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
        if (in[3] == 0) v = v && rd_valid(a, in[5]);
        if (in[6] == 0) v = v && rd_valid(a, in[8]);
        break;
      }
      case P_NULLTEST: {
        bool cv = rd_valid(a, in[2]);
        d = in[1] ? !cv : cv;
        break;
      }
      case P_BOOLCOL:
        d = rd_i32(t, a, in[1]) != 0;
        v = rd_valid(a, in[2]);
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
__device__ void put_f4_digits(const onehot::Sink& s, int col, float x, int nl,
                              int DB, float sc0, float sc1, bool use_abs) {
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
    s.digit(col + j, neg ? -dg : dg);
  }
}

struct K1Dec {
  Tables t;
  int n_ops, n_prog, nf4, key_d, key_v, rng, G, DB;

  __device__ __forceinline__ int bucket(const onehot::Row& a) const {
    if (n_prog && !eval_pred(t, n_prog, a)) return -1;
    const int seg = rd_valid(a, key_v)
                        ? (int)((unsigned)rd_i32(t, a, key_d) -
                                (unsigned)t.scal_i[0])
                        : rng + 1;
    return (unsigned)seg < (unsigned)G ? seg : -1;  // else outside every bucket
  }

  // every digit column of the live row, zeros where the argument is NULL
  __device__ __forceinline__ void row(const onehot::Row& a,
                                      const onehot::Sink& s, int c0,
                                      int c1) const {
    int si = 0;  // running index of the shadow (fabs) columns
    for (int o = 0; o < n_ops; ++o) {
      const int* op = t.ops + o * OP_W;
      const int tag = op[0], col = op[1], din = op[2], vin = op[3], nl = op[4];
      const int x = op[5];
      const int my_si = si;
      si += tag == OP_FABS;
      if (col >= c1 || col + nl <= c0) continue;  // other column tile
      if (tag == OP_MASK) {
        s.digit(col, 1);
        continue;
      }
      const bool ok = rd_valid(a, vin);
      switch (tag) {
        case OP_CNT:
          s.digit(col, ok);
          break;
        case OP_SUM_I4:
          put_limbs(s, col,
                    ok ? (unsigned)rd_i32(t, a, din) - (unsigned)t.scal_i[x] : 0u,
                    nl);
          break;
        case OP_SUM_I8: {
          const unsigned long long mn =
              (unsigned long long)t.scal_u[x] |
              ((unsigned long long)t.scal_u[x + 1] << 32);
          put_limbs(s, col,
                    ok ? a.u64(din) - mn : 0ull, nl);
          break;
        }
        case OP_SUMSQ4:
        case OP_SUMSQ4_BIG: {
          const int d = ok ? rd_i32(t, a, din) : 0;
          const unsigned u = d < 0 ? 0u - (unsigned)d : (unsigned)d;
          if (tag == OP_SUMSQ4) {
            put_limbs(s, col, u * u, nl);
          } else {
            const unsigned a = u >> 16, b = u & 0xFFFFu;
            put_limbs(s, col, b * b, 4);
            put_limbs(s, col + 4, a * b, 4);
            put_limbs(s, col + 8, a * a, 4);
          }
          break;
        }
        case OP_F4S:
          put_f4_digits(s, col, ok ? rd_f32(t, a, din) : 0.f, nl, DB,
                        t.f4sc[x], t.f4sc[nf4 + x], op[6] != 0);
          break;
        case OP_FABS:
          if (ok) s.shadow(col, my_si, fabsf(rd_f32(t, a, din)));
          break;
        default:
          break;
      }
    }
  }
};

struct K1Args {
  const int* desc;
  int desc_len, n_in, n_ops, n_prog, ni, nu, nf4;
  long long nrows;
  int key_d, key_v, rng, DB;
  unsigned long long* ints;
  float* shadow;
};

// the descriptor: plane addresses (lo, hi int32 words), plane types, op
// table, predicate program, scal_i, scal_u, f4 scales, then the shadow
// columns' indexes; loaded into shared memory after the core
__device__ __forceinline__ K1Dec k1_prologue(const K1Args& a,
                                             const onehot::Geo& q,
                                             unsigned char* smem,
                                             const unsigned long long** lanes,
                                             const int** shcol) {
  unsigned char* p = smem + onehot::core_bytes(q);
  unsigned long long* s_ptr = reinterpret_cast<unsigned long long*>(p);
  int* s_meta = reinterpret_cast<int*>(s_ptr + a.n_in);
  const int meta_len = a.desc_len - 2 * a.n_in;
  for (int i = threadIdx.x; i < a.n_in; i += blockDim.x)
    s_ptr[i] = (unsigned long long)(unsigned)a.desc[2 * i] |
               ((unsigned long long)(unsigned)a.desc[2 * i + 1] << 32);
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x)
    s_meta[i] = a.desc[2 * a.n_in + i];
  *lanes = s_ptr;
  K1Dec d;
  d.t.dtype = s_meta;
  d.t.ops = d.t.dtype + a.n_in;
  d.t.pred = d.t.ops + a.n_ops * OP_W;
  d.t.scal_i = d.t.pred + a.n_prog * PRED_W;
  d.t.scal_u = reinterpret_cast<const unsigned*>(d.t.scal_i + a.ni);
  d.t.f4sc = reinterpret_cast<const float*>(d.t.scal_u + a.nu);
  *shcol = reinterpret_cast<const int*>(d.t.f4sc + 2 * a.nf4);
  d.n_ops = a.n_ops;
  d.n_prog = a.n_prog;
  d.nf4 = a.nf4;
  d.key_d = a.key_d;
  d.key_v = a.key_v;
  d.rng = a.rng;
  d.G = q.G;
  d.DB = a.DB;
  return d;
}

// the core's first barrier publishes the tables
__global__ void k1_kernel(K1Args a, onehot::Geo q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned long long* lanes;
  const int* shcol;
  const K1Dec dec = k1_prologue(a, q, smem, &lanes, &shcol);
  onehot::run<K1Dec>(dec, lanes, q, a.nrows, smem, shcol, a.ints, a.shadow);
}

}  // namespace

// geo: the planner's int32 vector (onehot::Geo); grid_x <= 0 fills the
// card; returns a cudaError_t, or onehot::ERR_SMEM_PLAN
extern "C" int pgstrom_k1_launch(const int* desc, int desc_len, int n_in,
                                 int n_ops, int n_prog, int ni, int nu, int nf4,
                                 long long nrows, int key_d, int key_v, int rng,
                                 int DB, const int* geo,
                                 unsigned long long* ints, float* shadow,
                                 int grid_x, size_t smem, void* stream) {
  const onehot::Geo q = onehot::Geo::load(geo);
  const size_t tables = 8 * (size_t)n_in + 4 * (size_t)(desc_len - 2 * n_in);
  if (smem < onehot::core_bytes(q) + tables) return onehot::ERR_SMEM_PLAN;
  const K1Args a{desc, desc_len, n_in, n_ops, n_prog, ni, nu, nf4, nrows,
                 key_d, key_v, rng, DB, ints, shadow};
  return onehot::launch(k1_kernel, a, q, nrows, grid_x, smem,
                        (cudaStream_t)stream);
}

extern "C" const char* pgstrom_cuda_error_string(int code) {
  if (code == onehot::ERR_SMEM_PLAN)
    return "the launch plan's shared-memory bytes do not cover the kernel's "
           "layout";
  return cudaGetErrorString((cudaError_t)code);
}
