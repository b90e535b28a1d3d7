// K5 — a join on a dense build key under a scalar aggregate, in one pass
// over the probe chunk, for Hopper.
//
// Replaces no TPU kernel: the reference runs this shape as XLA glue (the
// dense probe of ops/hashjoin.py, then the ungrouped branch of
// ops/preagg.py), and so did the port, in many full passes over the chunk
// in int64 and float64: 26.6 ms of device time a SSB Q1.1 query at SF 20
// on an H100, where the four columns it reads take 0.57 ms to stream.
// For each live probe row it
//
//   1. evaluates the probe side's WHERE clause over the raw planes: its
//      top-level `column op constant` conjuncts as ranges, the rest as a
//      postfix program in K1's encoding (pred_program.cuh);
//   2. tests the join key's offset key - kmin against a membership bitmap
//      of the build side (dense build keys are unique, and the aggregate
//      reads probe columns only, so the join is a membership test);
//   3. evaluates each aggregate argument, a postfix program of columns,
//      integer constants and + - *, with PostgreSQL's int2/int4 overflow
//      rule: a row that passes 1 and 2 and whose operands are not NULL
//      raises its type's error code into the err lane (the chunk then
//      replays on the host, which raises as PostgreSQL does);
//   4. adds count(*), and each argument's non-NULL count and sum, into
//      int64 registers: below 2^32 rows a chunk, int2/int4 values cannot
//      overflow them.  Warp, then block, then one global atomic a block
//      into out int64 [2 + 2 * n_args]: err, rows, (count, sum) per
//      argument.  Integer adds make it exact and the same on every run.
//
// What bounds it on an H100: bytes, each plane read once (16 B a row for
// Q1.1's four int4 columns), 0.32 ms for a 2^26-row chunk at 3.35 TB/s.
// Interpreting programs costs instructions a row, and a first version
// that ran every clause through the stack interpreter issued so many
// that it reached a third of that bound.  The design:
//
//   * persistent blocks in a grid-stride loop over groups of 4 rows; a
//     thread holds one group: one 16-byte (int4, float4) or smaller
//     (int2, bool) vector load a plane, coalesced across the warp;
//   * the next group's first LOAD_BATCH planes are loaded before the
//     current group is evaluated, so a thread's loads are in flight while
//     it computes;
//   * the words are staged in shared memory (the programs index planes at
//     run time, and a register array indexed at run time would go to local
//     memory), and each program row is decoded once for the 4 rows;
//   * the WHERE clause's top-level conjuncts of the form column-op-integer
//     constant arrive as ranges [lo, hi], one unsigned compare a row
//     each; the rest is K1's postfix program, its (data, valid) stack as
//     4-bit nibbles in two registers;
//   * the membership test is one 32-bit subtract and compare where kmin
//     allows (key32), then one bit of the bitmap through the read-only
//     cache;
//   * an argument of one leaf, or of two leaves and an operator (Q1.1's
//     extendedprice * discount), is evaluated directly; any other runs the
//     stack interpreter;
//   * the programs and constants are a by-value kernel parameter: no
//     upload, no device operation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pred_program.cuh"

namespace {

// keep in sync with ops/joinagg_scalar.py
constexpr int K5_BLOCK = 256;
// two blocks an SM (a cap of 128 registers; the kernel takes 108): on an
// H100 a cap of three spills and a second prefetched group needs 138
// registers, and both ran slower
constexpr int K5_MIN_BLOCKS = 2;
constexpr int K5_MAX_IN = 12;
constexpr int LOAD_BATCH = 4;  // planes whose loads a thread issues at once
constexpr int K5_MAX_PRED = 32;
constexpr int K5_MAX_RANGE = 8;
constexpr int K5_MAX_ARGS = 4;
constexpr int K5_MAX_ARG_OPS = 24;
constexpr int ARG_W = 3;  // (opcode, a1, a2)
// argument program rows: A_COL (din, vin), A_CONST (value), A_ADD / A_SUB
// / A_MUL (result type's width in bytes: 2 or 4)
enum { A_COL = 1, A_CONST, A_ADD, A_SUB, A_MUL };
// an argument's shape: the stack interpreter, one leaf, leaf op leaf
enum { SHAPE_STACK, SHAPE_LEAF, SHAPE_BINARY };
constexpr unsigned ERR_INT2_OVERFLOW = 3, ERR_INT4_OVERFLOW = 4;

struct K5Args {
  const void* plane[K5_MAX_IN];
  const unsigned* member;     // bit (off & 31) of word off >> 5
  unsigned long long* out;    // [2 + 2 * n_args], zeroed by the caller
  long long nrows, kmin, dcap;
  int dtype[K5_MAX_IN];
  int pred[K5_MAX_PRED * PRED_W];
  int range[K5_MAX_RANGE * 4];  // (din, vin, lo, hi - lo)
  int arg[K5_MAX_ARG_OPS * ARG_W];
  int arg_start[K5_MAX_ARGS + 1];
  int arg_shape[K5_MAX_ARGS];
  int n_in, n_pred, n_range, n_args, key_d, key_v, key32;
};

__device__ __forceinline__ int ld1(int dt, const void* p, long long r) {
  switch (dt) {
    case DT_I16: return __ldg(static_cast<const short*>(p) + r);
    case DT_BOOL: return __ldg(static_cast<const unsigned char*>(p) + r) != 0;
    default: return __ldg(static_cast<const int*>(p) + r);
  }
}

// the group's 4 rows of one plane as 32-bit words (a float as its bits);
// nv < 4 (the chunk's last group) reads its rows one by one
__device__ __forceinline__ int4 ld4(int dt, const void* p, long long r0,
                                    int nv) {
  if (nv == 4) {
    switch (dt) {
      case DT_I16: {
        const short4 s = __ldg(reinterpret_cast<const short4*>(
            static_cast<const short*>(p) + r0));
        return make_int4(s.x, s.y, s.z, s.w);
      }
      case DT_BOOL: {
        const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(
            static_cast<const unsigned char*>(p) + r0));
        return make_int4(b.x != 0, b.y != 0, b.z != 0, b.w != 0);
      }
      default:
        return __ldg(reinterpret_cast<const int4*>(
            static_cast<const int*>(p) + r0));
    }
  }
  int t[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nv) t[k] = ld1(dt, p, r0 + k);
  return make_int4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ int rows_of(const K5Args& a, long long g) {
  const long long left = a.nrows - (g << 2);
  return left < 4 ? (int)left : 4;
}

// planes [p0, p0 + LOAD_BATCH) of group g
__device__ __forceinline__ void load_batch(const K5Args& a, int p0,
                                           long long g, int4* w) {
  const int nv = rows_of(a, g);
#pragma unroll
  for (int p = 0; p < LOAD_BATCH; ++p)
    if (p0 + p < a.n_in) w[p] = ld4(a.dtype[p0 + p], a.plane[p0 + p], g << 2, nv);
}

__device__ __forceinline__ unsigned nib(int4 w) {
  return (unsigned)(w.x != 0) | ((unsigned)(w.y != 0) << 1) |
         ((unsigned)(w.z != 0) << 2) | ((unsigned)(w.w != 0) << 3);
}

__device__ __forceinline__ int lane(int4 w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// the thread's staged words: plane p at st[p * B]
struct Staged {
  const int4* st;
  int B;
  __device__ __forceinline__ int4 word(int p) const { return st[p * B]; }
  __device__ __forceinline__ unsigned valid(int vin) const {
    return vin < 0 ? 0xFu : nib(word(vin));
  }
};

__device__ __forceinline__ float as_f32(const K5Args& a, int p, int w) {
  return a.dtype[p] == DT_F32 ? __int_as_float(w) : (float)w;
}

// 4 rows' range conjuncts: bit k set where row k lies in every range
__device__ __forceinline__ unsigned ranges4(const K5Args& a,
                                            const Staged& s) {
  unsigned m = 0xFu;
  for (int i = 0; i < a.n_range; ++i) {
    const int* r = a.range + 4 * i;
    const int4 w = s.word(r[0]);
    const unsigned lo = (unsigned)r[2], span = (unsigned)r[3];
    unsigned in = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      in |= (unsigned)((unsigned)lane(w, k) - lo <= span) << k;
    m &= in;
    if (r[1] >= 0) m &= s.valid(r[1]);
  }
  return m;
}

// 4 rows' predicate program: bit k set where row k is TRUE
__device__ __forceinline__ unsigned eval_pred4(const K5Args& a,
                                               const Staged& s) {
  unsigned sd = 0, sv = 0;  // (data, valid) stack, a nibble a level
  for (int p = 0; p < a.n_pred; ++p) {
    const int* in = a.pred + p * PRED_W;
    unsigned d = 0, v = 0xFu;
    switch (in[0]) {
      case P_CMP: {
        const bool is_float = in[2] != 0;
        const int4 xw = in[3] == 0 ? s.word(in[4]) : make_int4(0, 0, 0, 0);
        const int4 yw = in[6] == 0 ? s.word(in[7]) : make_int4(0, 0, 0, 0);
        unsigned lt = 0, eq = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool l, e;
          if (is_float) {
            const float x = in[3] == 0 ? as_f32(a, in[4], lane(xw, k))
                                       : __int_as_float(in[4]);
            const float y = in[6] == 0 ? as_f32(a, in[7], lane(yw, k))
                                       : __int_as_float(in[7]);
            const bool xn = isnan(x), yn = isnan(y), nn = xn || yn;
            l = (nn && !xn && yn) || (!nn && x < y);
            e = (nn && xn && yn) || (!nn && x == y);
          } else {
            const int x = in[3] == 0 ? lane(xw, k) : in[4];
            const int y = in[6] == 0 ? lane(yw, k) : in[7];
            l = x < y;
            e = x == y;
          }
          lt |= (unsigned)l << k;
          eq |= (unsigned)e << k;
        }
        switch (in[1]) {
          case 0: d = eq; break;
          case 1: d = ~eq; break;
          case 2: d = lt; break;
          case 3: d = lt | eq; break;
          case 4: d = ~(lt | eq); break;
          default: d = ~lt; break;
        }
        d &= 0xFu;
        if (in[3] == 0) v &= s.valid(in[5]);
        if (in[6] == 0) v &= s.valid(in[8]);
        break;
      }
      case P_NULLTEST: {
        const unsigned cv = s.valid(in[2]);
        d = in[1] ? (~cv & 0xFu) : cv;
        break;
      }
      case P_BOOLCOL:
        d = nib(s.word(in[1]));
        v = s.valid(in[2]);
        break;
      case P_CONST:
        d = in[1] ? 0xFu : 0u;
        break;
      case P_NOT:
        sd ^= 0xFu;  // negate the top's data, keep its validity
        continue;
      default: {     // P_AND / P_OR: Kleene logic over the top two levels
        const unsigned d2 = sd & 0xFu, v2 = sv & 0xFu;
        const unsigned d1 = (sd >> 4) & 0xFu, v1 = (sv >> 4) & 0xFu;
        sd >>= 8;
        sv >>= 8;
        if (in[0] == P_AND) {
          v = ((v1 & v2) | (v1 & ~d1) | (v2 & ~d2)) & 0xFu;
          d = d1 & d2;
        } else {
          v = ((v1 & v2) | (v1 & d1) | (v2 & d2)) & 0xFu;
          d = d1 | d2;
        }
        break;
      }
    }
    sd = (sd << 4) | d;
    sv = (sv << 4) | v;
  }
  return a.n_pred == 0 ? 0xFu : (sd & sv & 0xFu);
}

// 4 rows' join match: a non-NULL key whose offset is a build key
__device__ __forceinline__ unsigned match4(const K5Args& a, const Staged& s) {
  const int4 kw = s.word(a.key_d);
  unsigned hit = 0;
  if (a.key32) {  // kmin in [-2^31, 2^31 - dcap]: the 32-bit offset is exact
    const unsigned km = (unsigned)a.kmin, dc = (unsigned)a.dcap;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned off = (unsigned)lane(kw, k) - km;
      if (off < dc) hit |= ((__ldg(a.member + (off >> 5)) >> (off & 31)) & 1u) << k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long off = (long long)lane(kw, k) - a.kmin;
      if ((unsigned long long)off < (unsigned long long)a.dcap)
        hit |= ((__ldg(a.member + (off >> 5)) >> (off & 31)) & 1u) << k;
    }
  }
  return hit & s.valid(a.key_v);
}

__device__ __forceinline__ void leaf4(const int* in, const Staged& s,
                                      int4& r, unsigned& rv) {
  if (in[0] == A_COL) {
    r = s.word(in[1]);
    rv = s.valid(in[2]);
  } else {
    r = make_int4(in[1], in[1], in[1], in[1]);
    rv = 0xFu;
  }
}

// x op y in int64, wrapped to 32 bits; a row of `m` whose result leaves
// the int2 / int4 range (width in[1]) raises the type's error
__device__ __forceinline__ int4 binop4(const int* in, int4 x, int4 y,
                                       unsigned m, unsigned& err) {
  int t[4];
  unsigned ovf = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long xa = lane(x, k), ya = lane(y, k);
    const long long w = in[0] == A_ADD ? xa + ya
                        : in[0] == A_SUB ? xa - ya : xa * ya;
    t[k] = (int)(unsigned)(unsigned long long)w;
    const long long back = in[1] == 2 ? (long long)(short)t[k] : (long long)t[k];
    ovf |= (unsigned)(back != w) << k;
  }
  if (ovf & m)
    err = max(err, in[1] == 2 ? ERR_INT2_OVERFLOW : ERR_INT4_OVERFLOW);
  return make_int4(t[0], t[1], t[2], t[3]);
}

// argument j over the 4 rows: its values, their validity nibble, and the
// overflow error of any row of `m` whose operands were all non-NULL
__device__ __forceinline__ void eval_arg4(const K5Args& a, int j,
                                          const Staged& s, unsigned m,
                                          int4& val, unsigned& vv,
                                          unsigned& err) {
  const int* in = a.arg + a.arg_start[j] * ARG_W;
  if (a.arg_shape[j] == SHAPE_LEAF) {
    leaf4(in, s, val, vv);
    return;
  }
  if (a.arg_shape[j] == SHAPE_BINARY) {
    int4 x, y;
    unsigned xv, yv;
    leaf4(in, s, x, xv);
    leaf4(in + ARG_W, s, y, yv);
    vv = xv & yv;
    val = binop4(in + 2 * ARG_W, x, y, vv & m, err);
    return;
  }
  int4 s0 = make_int4(0, 0, 0, 0), s1 = s0, s2 = s0, s3 = s0;
  unsigned sv = 0;
  for (int o = a.arg_start[j]; o < a.arg_start[j + 1]; ++o, in += ARG_W) {
    int4 r;
    unsigned rv;
    if (in[0] == A_COL || in[0] == A_CONST) {
      leaf4(in, s, r, rv);
      s3 = s2;
      s2 = s1;
      s1 = s0;
    } else {
      rv = sv & (sv >> 4) & 0xFu;
      r = binop4(in, s1, s0, rv & m, err);
      s1 = s2;  // pop y and x; r is pushed below
      s2 = s3;
      sv >>= 8;
    }
    s0 = r;
    sv = (sv << 4) | rv;
  }
  val = s0;
  vv = sv & 0xFu;
}

constexpr int NACC = 1 + 2 * K5_MAX_ARGS;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// __grid_constant__: the programs are read in place from the parameter
// bank (uniform loads), not copied into each thread's local memory
__global__ void __launch_bounds__(K5_BLOCK, K5_MIN_BLOCKS)
k5_kernel(const __grid_constant__ K5Args a) {
  extern __shared__ int4 stage[];  // [n_in][B], then the block's partials
  const int B = blockDim.x;
  const Staged s{stage + threadIdx.x, B};
  long long acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  unsigned err = 0;
  const long long ngroups = (a.nrows + 3) >> 2;
  const long long stride = (long long)gridDim.x * B;
  long long g = (long long)blockIdx.x * B + threadIdx.x;
  int4 next[LOAD_BATCH];  // the first planes of the thread's next group
  if (g < ngroups) load_batch(a, 0, g, next);
  for (; g < ngroups; g += stride) {
#pragma unroll
    for (int p = 0; p < LOAD_BATCH; ++p)
      if (p < a.n_in) stage[p * B + threadIdx.x] = next[p];
    for (int p0 = LOAD_BATCH; p0 < a.n_in; p0 += LOAD_BATCH) {
      int4 w[LOAD_BATCH];
      load_batch(a, p0, g, w);
#pragma unroll
      for (int p = 0; p < LOAD_BATCH; ++p)
        if (p0 + p < a.n_in) stage[(p0 + p) * B + threadIdx.x] = w[p];
    }
    if (g + stride < ngroups) load_batch(a, 0, g + stride, next);
    const unsigned live = (1u << rows_of(a, g)) - 1u;
    unsigned m = live & ranges4(a, s) & match4(a, s);
    if (a.n_pred) m &= eval_pred4(a, s);
    acc[0] += __popc(m);
#pragma unroll
    for (int j = 0; j < K5_MAX_ARGS; ++j) {
      if (j < a.n_args) {
        int4 val;
        unsigned vv;
        eval_arg4(a, j, s, m, val, vv, err);
        const unsigned ok = vv & m;
        acc[1 + 2 * j] += __popc(ok);
        acc[2 + 2 * j] += ((ok & 1u) ? (long long)val.x : 0) +
                          ((ok & 2u) ? (long long)val.y : 0) +
                          ((ok & 4u) ? (long long)val.z : 0) +
                          ((ok & 8u) ? (long long)val.w : 0);
      }
    }
  }
  // warp, then block, then one global atomic per quantity
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = warp_sum(acc[i]);
  err = __reduce_max_sync(0xFFFFFFFFu, err);
  __syncthreads();  // every thread is done with its staged words
  long long* part = reinterpret_cast<long long*>(stage);  // [warps][NACC + 1]
  if (lane_id == 0) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) part[warp * (NACC + 1) + i] = acc[i];
    part[warp * (NACC + 1) + NACC] = err;
  }
  __syncthreads();
  const int nq = 1 + 2 * a.n_args;
  if (threadIdx.x <= nq) {  // thread nq takes err
    long long t = 0;
    for (int q = 0; q < (B >> 5); ++q) {
      const long long v = part[q * (NACC + 1) + (threadIdx.x < nq ? threadIdx.x
                                                                   : NACC)];
      t = threadIdx.x < nq ? t + v : (v > t ? v : t);
    }
    if (threadIdx.x < nq) {
      if (t != 0) atomicAdd(a.out + 1 + threadIdx.x, (unsigned long long)t);
    } else if (t != 0) {
      atomicMax(a.out, (unsigned long long)t);
    }
  }
}

}  // namespace

extern "C" size_t pgstrom_k5_args_size() { return sizeof(K5Args); }

// one launch of `grid` blocks over the chunk; returns a cudaError_t.
// `args` is a K5Args (a void pointer: a parameter of a type with internal
// linkage would hide the function from the library's exported symbols)
extern "C" int pgstrom_k5_launch(const void* args, int grid, void* stream) {
  const K5Args* a = static_cast<const K5Args*>(args);
  const size_t stage = (size_t)a->n_in * K5_BLOCK * sizeof(int4);
  const size_t part = (size_t)(K5_BLOCK / 32) * (NACC + 1) * sizeof(long long);
  k5_kernel<<<grid, K5_BLOCK, stage > part ? stage : part,
              (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
