// Candidate-filter kernel for Hopper (sm_90a): the fused cniMatch grid of
// one ILGF round, label AND degree AND CNI, for every (b, v, u) cell of a
// batch of data digests (B, V) against query digests (B, U).
//
//   match(v, u) = ord_d[v] == ord_q[u] && ord_d[v] > 0
//     && ( (deg_d[v] >  deg_q[u] && (ge(v, u) || sat(v, u)))
//       || (deg_d[v] == deg_q[u] && (eq(v, u) || sat(v, u) || both_empty)) )
//
// exact mode (int64 digests, core/filters.py::cni_match):
//   ge = cv >= cu, eq = cv == cu, sat = cv == SAT64 || cu == SAT64,
//   both_empty = false.
// log mode (float32 log digests, core/filters.py::cni_match_log):
//   tol = eps * max(1, |cu|), ge = cv >= cu - tol, eq = |cv - cu| <= tol,
//   sat = cv >= thresh || cu >= thresh (thresh = LOG_SAT64 - 1e-3),
//   both_empty = deg_d[v] == 0 && deg_q[u] == 0.
//   The float32 operations are written with __fmul_rn / __fsub_rn so the
//   compiler cannot fuse eps * max(..) into an FMA: tol and cu - tol round
//   as the plain version rounds them, so the two agree at the boundary.
//
// candidate_filter_kernel
//   Replaces: candidate_filter_pallas / _candidate_filter_kernel
//             (src/repro/kernels/candidate_filter/kernel.py:46 and :22).
//             The Pallas kernel compares log digests only and lacks the
//             LOG_SAT64 pass-through of filters.cni_match_log; this kernel
//             has both modes and the pass-through, so it computes the
//             functions the path calls.
//   Bound:    bytes.  It must read the data digests (B*V*(8 or 16) bytes),
//             the query digests, and write the B*V*U byte grid once; a cell
//             is a dozen compares.
//   Design:   one thread per cell over a grid-stride loop, cells in
//             row-major (b, v, u) order, so neighbouring threads write
//             neighbouring bytes and read one data digest (broadcast within
//             a warp) and neighbouring query entries.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kSat64 = 1LL << 62;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

struct Compare {
  const int* ord_d;
  const int* deg_d;
  const void* cni_d;
  const int* ord_q;
  const int* deg_q;
  const void* cni_q;
  long long B;
  long long V;
  long long U;
  float eps;
  float thresh;
};

template <bool kLog>
__global__ void candidate_filter_kernel(Compare a,
                                        unsigned char* __restrict__ out) {
  const long long cells = a.B * a.V * a.U;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    const long long bv = i / a.U;                // b * V + v
    const long long u = i - bv * a.U;
    const long long bu = (bv / a.V) * a.U + u;   // b * U + u
    const int od = __ldg(a.ord_d + bv);
    bool ok = od > 0 && od == __ldg(a.ord_q + bu);
    if (ok) {
      const int dv = __ldg(a.deg_d + bv);
      const int du = __ldg(a.deg_q + bu);
      bool ge, eq, sat, both_empty;
      if (kLog) {
        const float cv = __ldg(static_cast<const float*>(a.cni_d) + bv);
        const float cu = __ldg(static_cast<const float*>(a.cni_q) + bu);
        const float tol = __fmul_rn(a.eps, fmaxf(1.0f, fabsf(cu)));
        ge = cv >= __fsub_rn(cu, tol);
        eq = fabsf(__fsub_rn(cv, cu)) <= tol;
        sat = cv >= a.thresh || cu >= a.thresh;
        both_empty = dv == 0 && du == 0;
      } else {
        const long long cv =
            __ldg(static_cast<const long long*>(a.cni_d) + bv);
        const long long cu =
            __ldg(static_cast<const long long*>(a.cni_q) + bu);
        ge = cv >= cu;
        eq = cv == cu;
        sat = cv == kSat64 || cu == kSat64;
        both_empty = false;
      }
      ok = (dv > du && (ge || sat)) || (dv == du && (eq || sat || both_empty));
    }
    out[i] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// log_mode: 0 = exact int64 digests, 1 = float32 log digests.
int candidate_filter(const void* ord_d, const void* deg_d, const void* cni_d,
                     const void* ord_q, const void* deg_q, const void* cni_q,
                     long long B, long long V, long long U, int log_mode,
                     float eps, float thresh, void* out, void* stream) {
  Compare a;
  a.ord_d = static_cast<const int*>(ord_d);
  a.deg_d = static_cast<const int*>(deg_d);
  a.cni_d = cni_d;
  a.ord_q = static_cast<const int*>(ord_q);
  a.deg_q = static_cast<const int*>(deg_q);
  a.cni_q = cni_q;
  a.B = B;
  a.V = V;
  a.U = U;
  a.eps = eps;
  a.thresh = thresh;
  long long blocks = (B * V * U + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (log_mode) {
    candidate_filter_kernel<true><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        a, o);
  } else {
    candidate_filter_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        a, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
