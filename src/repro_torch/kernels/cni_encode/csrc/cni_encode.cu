// CNI encode kernel for Hopper (sm_90a): the label degree, the exact
// saturating digest and the float32 log digest of every count row, in one
// pass over each row.  The row walk itself (cni::encode_row) and its
// arithmetic are described in common/cni_row.cuh, which cni_update.cu shares.
//
// cni_encode_kernel
//   Replaces: cni_encode_pallas / _cni_encode_kernel
//             (src/repro/kernels/cni_encode/kernel.py:62 and :26), which
//             computes the log digest and the degree only; this kernel adds
//             the exact digest that the main path's "cni" filter compares
//             (the reference computes it in jnp, core/cni.py:cni_from_counts).
//   Bound:    bytes.  It must read the (N, L) int32 counts once, gather the
//             table entries its rows need (12 bytes each: int64 + float32),
//             and write 16 bytes per row (int32 degree, int64 digest,
//             float32 log digest).  The work per row is O(min(deg, d_max))
//             adds, compares and one expf per term.
//   Design:   one thread per row over a grid-stride loop, with no
//             (N, d_max) intermediate: the Pallas body's (BV, D, L) compare
//             expansion is a TPU formulation for dense vector units and does
//             not carry over.  The tables, (d_max+1) x (max_p+1) entries
//             (up to tens of MB at max_p = 4096), are read through L2 with
//             __ldg rather than staged in shared memory.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/cni_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

__global__ void cni_encode_kernel(const int* __restrict__ counts, long long n,
                                  int L, int d_max, int max_p,
                                  const long long* __restrict__ pascal,
                                  const float* __restrict__ log_t,
                                  int* __restrict__ deg_out,
                                  long long* __restrict__ cni_out,
                                  float* __restrict__ log_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const cni::RowDigest d =
        cni::encode_row(counts + r * L, L, d_max, max_p, pascal, log_t);
    deg_out[r] = d.deg;
    cni_out[r] = d.cni;
    log_out[r] = d.log;
  }
}

}  // namespace

extern "C" {

int cni_encode(const void* counts, long long n, int L, int d_max, int max_p,
               const void* pascal, const void* log_t, void* deg, void* cni,
               void* cni_log, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cni_encode_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), n, L, d_max, max_p,
      static_cast<const long long*>(pascal), static_cast<const float*>(log_t),
      static_cast<int*>(deg), static_cast<long long*>(cni),
      static_cast<float*>(cni_log));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
