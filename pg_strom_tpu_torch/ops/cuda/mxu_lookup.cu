// K3 — table lookup out[i] = table[idx[i]], for Hopper.
//
// Replaces the TPU Pallas kernel pg_strom_tpu/ops/mxu_lookup.py
// _build_kernel (a one-hot(hi) x digit-matrix contraction on the MXU plus
// a one-hot(lo) sublane reduce, because the TPU has no vector gather).
// Contract: idx int32[n], table int32[nslots] (at most 2^16 slots padded
// with the caller's sentinel), out int32[n]; an index outside
// [0, nslots) yields `sentinel` and never reads out of bounds.
//
// What bounds it on an H100: bytes.  Each lookup reads 4 bytes of idx and
// writes 4 bytes of out; the table (at most 256 KB) stays in the 50 MB L2
// and its reads go through the read-only path (__ldg), so at 2^26 lookups
// the bound is 0.54 GB over 3.35 TB/s, about 0.16 ms.  The design is a
// grid-stride loop with coalesced int32 loads and stores.  Staging the
// table in shared memory, or uint16 values when K <= 2, is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void k3_kernel(const int* __restrict__ idx,
                          const int* __restrict__ table, int nslots,
                          int sentinel, long long n, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int d = idx[i];
    out[i] = ((unsigned)d < (unsigned)nslots) ? __ldg(table + d) : sentinel;
  }
}

}  // namespace

extern "C" int pgstrom_k3_launch(const int* idx, const int* table, int nslots,
                                 int sentinel, long long n, int* out,
                                 int grid, int block, void* stream) {
  k3_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(idx, table, nslots,
                                                      sentinel, n, out);
  return (int)cudaGetLastError();
}
