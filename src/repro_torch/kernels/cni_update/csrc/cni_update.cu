// CNI update kernel for Hopper (sm_90a): apply a batch's count deltas to
// the incremental index's frontier rows and re-encode them, in one pass.
//
// For each frontier row r it writes new_rows[r] = rows[r] + delta[r] and
// then digests the new row with cni::encode_row (common/cni_row.cuh), the walk
// cni_encode.cu runs: the label degree, the exact int64 digest saturating
// at SAT64, and the float32 log digest.  A row updated here and the same
// row encoded by cni_encode come out bit for bit equal, which keeps the
// incremental index identical to a scratch rebuild on the card.
//
// cni_update_kernel
//   Replaces: cni_update_pallas / _cni_update_kernel
//             (src/repro/kernels/cni_update/kernel.py:69 and :30), which
//             returns the new rows, the log digest and the degree; this
//             kernel adds the exact digest the port's index keeps on the
//             card (the reference keeps it on the host).
//   Bound:    bytes.  It must read the (F, L) int32 rows and deltas once,
//             write the (F, L) new rows once and 16 bytes per row (int32
//             degree, int64 digest, float32 log digest), and gather the
//             table entries its rows need (12 bytes each).
//   Design:   one warp per 32 consecutive rows, which lie contiguous in
//             memory: the warp adds and stores them with consecutive lanes
//             on consecutive words (coalesced), synchronises, and then each
//             lane walks one of the rows it has just written, from L1/L2,
//             one thread per row as in cni_encode.  The add is fused with
//             the encode, so the new rows are not read back from DRAM; the
//             walk's own reads of a row (800 bytes at L = 200) stay
//             uncoalesced but hit the cache.  No shared memory: a row's
//             length L is not bounded.
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

// new_rows is not __restrict__: the lanes read back what their warp wrote.
__global__ void cni_update_kernel(const int* __restrict__ rows,
                                  const int* __restrict__ delta, long long n,
                                  int L, int d_max, int max_p,
                                  const long long* __restrict__ pascal,
                                  const float* __restrict__ log_t,
                                  int* new_rows, int* __restrict__ deg_out,
                                  long long* __restrict__ cni_out,
                                  float* __restrict__ log_out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // every lane of a warp takes the same trip count, so the __syncwarp()
  // calls below are reached by all 32 lanes
  for (long long base = warp * 32; base < n; base += n_warps * 32) {
    const long long n_rows = min(32LL, n - base);
    const long long off = base * L;
    const long long cells = n_rows * L;
    for (long long i = lane; i < cells; i += 32) {
      new_rows[off + i] = rows[off + i] + delta[off + i];
    }
    __syncwarp();  // the warp's stores are visible to all its lanes
    if (lane < n_rows) {
      const long long r = base + lane;
      const cni::RowDigest d =
          cni::encode_row(new_rows + r * L, L, d_max, max_p, pascal, log_t);
      deg_out[r] = d.deg;
      cni_out[r] = d.cni;
      log_out[r] = d.log;
    }
    __syncwarp();  // reads of this chunk finish before the next chunk's stores
  }
}

}  // namespace

extern "C" {

int cni_update(const void* rows, const void* delta, long long n, int L,
               int d_max, int max_p, const void* pascal, const void* log_t,
               void* new_rows, void* deg, void* cni, void* cni_log,
               void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cni_update_kernel<<<static_cast<int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(delta), n, L,
      d_max, max_p, static_cast<const long long*>(pascal),
      static_cast<const float*>(log_t), static_cast<int*>(new_rows),
      static_cast<int*>(deg), static_cast<long long*>(cni),
      static_cast<float*>(cni_log));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
