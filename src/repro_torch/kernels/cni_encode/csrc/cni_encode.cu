// CNI encode kernel for Hopper (sm_90a): the label degree, the exact
// saturating digest and the float32 log digest of every count row, in one
// pass over each row.
//
// For a row counts[0..L) (counts[l] = multiplicity of ord value l+1) the
// kernel walks labels in descending ord order; for each of a label's count
// positions j = 1, 2, ... (positions at or past d_max contribute nothing)
// it adds the label to the running prefix p and gathers, at the flat index
// j * (max_p + 1) + min(p, max_p),
//
//   the exact term  hbar(j, p) from the int64 Pascal table, folded as
//                   acc += min(term, SAT64 - acc), which never forms a raw
//                   acc + term (2^62 + 2^62 overflows int64);
//   the log term    log hbar(j, p) from the float32 table.
//
// The log digest is m + log(max(sum exp(t - m), 1e-30)) with m the largest
// log term (0 when there is none), and -inf for a row of degree 0: the plain
// version's formula (core/cni.py::cni_log_from_counts) with the sum taken in
// position order.  A second walk over the row computes the sum once m is
// known; the row and its table entries are in L1/L2 by then.
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
//             __ldg rather than staged in shared memory.  Built without
//             fast math: the log path keeps IEEE inf/NaN behaviour, and the
//             float expressions hold no multiply that could fuse into an FMA.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr long long kSat64 = 1LL << 62;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

__global__ void cni_encode_kernel(const int* __restrict__ counts, long long n,
                                  int L, int d_max, int max_p,
                                  const long long* __restrict__ pascal,
                                  const float* __restrict__ log_t,
                                  int* __restrict__ deg_out,
                                  long long* __restrict__ cni_out,
                                  float* __restrict__ log_out) {
  const long long width = static_cast<long long>(max_p) + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const int* row = counts + r * L;
    // walk 1: degree, exact digest, largest log term
    int deg = 0;
    long long acc = 0;
    float m = -CUDART_INF_F;
    int j = 0;
    int p = 0;
    for (int l = L - 1; l >= 0; --l) {
      const int c = row[l];
      deg += c;
      for (int k = 0; k < c && j < d_max; ++k) {
        ++j;
        p += l + 1;
        const long long idx = j * width + min(p, max_p);
        const long long term = __ldg(pascal + idx);
        acc += min(term, kSat64 - acc);
        m = fmaxf(m, __ldg(log_t + idx));
      }
    }
    // walk 2: the sum of exp(t - m) over the same positions
    const float m_safe = isfinite(m) ? m : 0.0f;
    float s = 0.0f;
    j = 0;
    p = 0;
    for (int l = L - 1; l >= 0 && j < d_max; --l) {
      const int c = row[l];
      for (int k = 0; k < c && j < d_max; ++k) {
        ++j;
        p += l + 1;
        s += expf(__ldg(log_t + j * width + min(p, max_p)) - m_safe);
      }
    }
    deg_out[r] = deg;
    cni_out[r] = acc;
    log_out[r] = deg > 0 ? m_safe + logf(fmaxf(s, 1e-30f)) : -CUDART_INF_F;
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
