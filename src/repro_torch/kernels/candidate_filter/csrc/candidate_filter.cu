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
//   Design:   one thread per (b, v) data row (3 rows in exact mode, 4 in
//             log mode, so enough loads are in flight), over a grid-stride
//             loop of chunks of up to 256 threads' rows of one batch row.  A
//             thread loads its rows' ord, degree and digest once (the next
//             chunk's while the current one is computed); the U query
//             entries of the chunk's batch row sit in shared memory
//             (reloaded only when the batch row changes).  No cell divides:
//             a chunk costs one 64-bit division.  The chunk's rows x U
//             output bytes are staged in shared memory laid out on the
//             output's 16-byte grid: zeroed with 16-byte stores, then only
//             a row whose ord is not 0 walks the query entries and sets its
//             matches; the block then writes its contiguous span with
//             16-byte stores, byte stores only at the span's two ragged ends.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr long long kSat64 = 1LL << 62;
constexpr int kThreads = 256;
// rows a thread takes per chunk (16 B of exact, 12 B of log digest a row):
// enough loads in flight to cover the memory's latency
template <bool kLog>
constexpr int kRowsPerThread = kLog ? 4 : 3;
constexpr int kStageBytes = 16384;  // staging for one chunk's output bytes
constexpr int kBlocksPerSm = 8;

struct Compare {
  const int* ord_d;
  const int* deg_d;
  const void* cni_d;
  const int* ord_q;
  const int* deg_q;
  const void* cni_q;
  long long B;
  long long V;
  int U;
  int rows;  // rows per chunk
  float eps;
  float thresh;
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

template <bool kLog>
using Digest = typename std::conditional<kLog, float, long long>::type;

template <bool kLog>
__global__ void __launch_bounds__(kThreads)
    candidate_filter_kernel(Compare a, unsigned char* __restrict__ out) {
  using D = Digest<kLog>;
  constexpr int RPT = kRowsPerThread<kLog>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U;
  D* q_cni = reinterpret_cast<D*>(smem);
  int* q_ord = reinterpret_cast<int*>(q_cni + U);
  int* q_deg = q_ord + U;
  unsigned char* stage = smem + align16(static_cast<size_t>(U) * (sizeof(D) + 8));

  const int tid = threadIdx.x;
  const long long per_b = (a.V + a.rows - 1) / a.rows;  // chunks per batch row
  const long long total = a.B * per_b;
  const D* cni_d = static_cast<const D*>(a.cni_d);

  // row i of this thread in chunk c (chunk row tid + i * kThreads), or -1
  auto row_of = [&](long long c, int i) -> long long {
    const int r = tid + i * kThreads;
    if (c >= total || r >= a.rows) return -1;
    const long long b = c / per_b;
    const long long v = (c - b * per_b) * a.rows + r;
    return v < a.V ? b * a.V + v : -1;
  };
  int od[RPT], dv[RPT];
  D cv[RPT];
  auto fetch = [&](long long c) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long bv = row_of(c, i);
      od[i] = bv >= 0 ? __ldg(a.ord_d + bv) : 0;
      dv[i] = bv >= 0 ? __ldg(a.deg_d + bv) : 0;
      cv[i] = bv >= 0 ? __ldg(cni_d + bv) : D(0);
    }
  };

  long long loaded_b = -1;
  fetch(blockIdx.x);
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    const long long b = c / per_b;
    const long long v0 = (c - b * per_b) * a.rows;
    const int n = static_cast<int>(min(static_cast<long long>(a.rows), a.V - v0));
    int my_od[RPT], my_dv[RPT];
    D my_cv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      my_od[i] = od[i];
      my_dv[i] = dv[i];
      my_cv[i] = cv[i];
    }
    fetch(c + gridDim.x);  // in flight while this chunk is computed

    const long long span = (b * a.V + v0) * U;  // first output byte
    const int head = static_cast<int>(span & 15);
    const int end = head + n * U;  // the span in staging: [head, end)
    __syncthreads();  // the previous chunk's staging and entries are free
    // staging starts all 0: most rows match no query entry at all
    for (int w = tid * 16; w < end; w += blockDim.x * 16) {
      *reinterpret_cast<uint4*>(stage + w) = make_uint4(0, 0, 0, 0);
    }
    if (b != loaded_b) {
      for (int u = tid; u < U; u += blockDim.x) {
        q_ord[u] = __ldg(a.ord_q + b * U + u);
        q_deg[u] = __ldg(a.deg_q + b * U + u);
        q_cni[u] = __ldg(static_cast<const D*>(a.cni_q) + b * U + u);
      }
      loaded_b = b;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tid + i * kThreads;
      if (r >= n || my_od[i] <= 0) continue;  // ord 0 matches nothing
      unsigned char* dst = stage + head + r * U;
      for (int u = 0; u < U; ++u) {
        if (my_od[i] != q_ord[u]) continue;
        const int du = q_deg[u];
        const D cu = q_cni[u];
        const int dd = my_dv[i];
        const D cc = my_cv[i];
        bool ge, eq, sat, both_empty;
        if constexpr (kLog) {
          const float tol = __fmul_rn(a.eps, fmaxf(1.0f, fabsf(cu)));
          ge = cc >= __fsub_rn(cu, tol);
          eq = fabsf(__fsub_rn(cc, cu)) <= tol;
          sat = cc >= a.thresh || cu >= a.thresh;
          both_empty = dd == 0 && du == 0;
        } else {
          ge = cc >= cu;
          eq = cc == cu;
          sat = cc == kSat64 || cu == kSat64;
          both_empty = false;
        }
        if ((dd > du && (ge || sat)) || (dd == du && (eq || sat || both_empty))) {
          dst[u] = 1;
        }
      }
    }
    __syncthreads();  // the chunk's bytes are staged

    // the span [head, end) of staging sits on the output's 16-byte grid
    unsigned char* base = out + (span - head);
    for (int w = tid * 16; w < end; w += blockDim.x * 16) {
      if (w >= head && w + 16 <= end) {
        *reinterpret_cast<uint4*>(base + w) =
            *reinterpret_cast<const uint4*>(stage + w);
      } else {
        for (int x = max(w, head); x < min(w + 16, end); ++x) base[x] = stage[x];
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

int chunk_rows(long long U, bool log_mode) {
  const long long kMaxRows =
      kThreads * (log_mode ? kRowsPerThread<true> : kRowsPerThread<false>);
  const long long fit = kStageBytes / U;
  return static_cast<int>(fit >= kMaxRows ? kMaxRows : (fit < 1 ? 1 : fit));
}

// the query entries, then the staging for one chunk's output bytes
size_t smem_bytes(int U, int rows, size_t digest) {
  return align16(static_cast<size_t>(U) * (digest + 8)) +
         align16(static_cast<size_t>(rows) * U + 16);
}

template <bool kLog>
cudaError_t launch(const Compare& a, unsigned char* out, cudaStream_t s) {
  const size_t smem = smem_bytes(a.U, a.rows, sizeof(Digest<kLog>));
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_filter_kernel<kLog>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const long long chunks = a.B * ((a.V + a.rows - 1) / a.rows);
  long long blocks = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > chunks) blocks = chunks;
  candidate_filter_kernel<kLog><<<static_cast<int>(blocks), kThreads, smem, s>>>(
      a, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// log_mode: 0 = exact int64 digests, 1 = float32 log digests.  out must be
// 16-byte aligned.
int candidate_filter(const void* ord_d, const void* deg_d, const void* cni_d,
                     const void* ord_q, const void* deg_q, const void* cni_q,
                     long long B, long long V, long long U, int log_mode,
                     float eps, float thresh, void* out, void* stream) {
  if (B < 1 || V < 1 || U < 1 || U > (1 << 20) ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Compare a;
  a.ord_d = static_cast<const int*>(ord_d);
  a.deg_d = static_cast<const int*>(deg_d);
  a.cni_d = cni_d;
  a.ord_q = static_cast<const int*>(ord_q);
  a.deg_q = static_cast<const int*>(deg_q);
  a.cni_q = cni_q;
  a.B = B;
  a.V = V;
  a.U = static_cast<int>(U);
  a.rows = chunk_rows(U, log_mode != 0);
  a.eps = eps;
  a.thresh = thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* o = static_cast<unsigned char*>(out);
  return static_cast<int>(log_mode ? launch<true>(a, o, s)
                                   : launch<false>(a, o, s));
}

// The dynamic shared memory (bytes) of a launch at U query entries: the
// build report prints it beside ptxas's figures.
int candidate_filter_smem(long long U, int log_mode) {
  if (U < 1 || U > (1 << 20)) return -1;
  return static_cast<int>(smem_bytes(static_cast<int>(U), chunk_rows(U, log_mode != 0),
                                     log_mode ? sizeof(float) : sizeof(long long)));
}

}  // extern "C"
