// Embed-join kernels for Hopper (sm_90a): the validity grid, the per-row
// count pass and the emit pass of one BFS-join expansion level.
//
// Every kernel evaluates the same cell test (cell_valid below):
//
//   row_valid[r] && cand_valid[c]
//     && for all j < J with q_valid[j]: elab[table[r, q_pos[j]] * N + cand[c]] == q_lab[j]
//     && for all t < T:                 table[r, t] != cand[c]
//
// elab is the (N, N) int32 dense edge-label matrix of the filtered data graph
// (-1 = no edge), read directly; the TPU kernels instead gather a (N, C)
// candidate-restricted view and phrase the lookup as a one-hot f32 MXU
// matmul.  The function is the same, the formulation is a plain int32
// gather.  Padded rows and candidates hold vertex id 0, a real vertex, so
// they are masked by row_valid / cand_valid and never by value.
//
// embed_join_count_kernel
//   Replaces: embed_join_count_pallas / _embed_join_count_kernel
//             (src/repro/kernels/embed_join/kernel.py:174 and :103).
//   Bound:    bytes.  Per level it must read the table (R*T*4), the
//             candidate list and masks, and for each distinct mapped
//             neighbour the candidate entries of its elab row (4 bytes per
//             (neighbour, candidate) pair), then write R*4 bytes of counts;
//             the work per cell is J+T integer compares, far below the
//             card's 3.35 TB/s times its integer rate.
//   Design:   one warp per row.  The row and its J mapped elab row offsets
//             sit in shared memory; lanes stride over candidates, so a warp
//             reads 32 consecutive cand[] entries and, candidates being
//             sorted ascending, elab entries of one row close together.
//             __ballot_sync + __popc fold the row sum in registers: the
//             (R, C) grid never reaches device memory.
//
// embed_join_grid_kernel
//   Replaces: embed_join_pallas / _embed_join_kernel
//             (src/repro/kernels/embed_join/kernel.py:129 and :88).
//   Bound:    bytes: the same reads as the count kernel plus the R*C byte
//             grid written once.
//   Design:   one thread per cell over a grid-stride loop; neighbouring
//             threads take neighbouring candidates of one row, so the grid
//             write and the cand[] read coalesce.
//
// embed_join_emit_kernel
//   Replaces: the emit pass embed_join_emit_raw
//             (src/repro/kernels/embed_join/ops.py:155): the grid kernel,
//             then a cumsum for the in-row rank, then a scatter with
//             mode="drop".
//   Bound:    bytes: the count kernel's reads plus row_off (R*8) and the
//             surviving cell ids (8 bytes each) written once.
//   Design:   one warp per row, 32-candidate chunks in order.  A lane's
//             exclusive in-row rank is __popc(ballot & lanemask_lt) plus the
//             running count of earlier chunks, so survivors are written at
//             row_off[r] + rank in flat row-major order without a grid, a
//             scan pass or atomics.
//
// The C functions launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps (rows) per block of the row kernels
constexpr int kGridThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct JoinArgs {
  const int* table;                // (R, T) row-major
  int R;
  int T;
  const unsigned char* row_valid;  // (R,) bool
  const int* cand;                 // (C,)
  int C;
  const unsigned char* cand_valid; // (C,) bool
  const int* elab;                 // (N, N) row-major
  int N;
  const int* q_pos;                // (J,)
  const int* q_lab;                // (J,)
  const unsigned char* q_valid;    // (J,) bool
  int J;
};

// Cell test against one row held in shared memory: s_off[j] is the flat
// offset of the mapped neighbour's elab row, or -1 for an inert constraint.
__device__ __forceinline__ bool cell_valid(const int* s_row, int T,
                                           const long long* s_off,
                                           const int* s_lab, int J,
                                           const int* __restrict__ elab,
                                           int v) {
  for (int j = 0; j < J; ++j) {
    const long long off = s_off[j];
    if (off >= 0 && __ldg(elab + off + v) != s_lab[j]) return false;
  }
  for (int t = 0; t < T; ++t) {
    if (s_row[t] == v) return false;
  }
  return true;
}

// Per-warp shared-memory slices: kRowsPerBlock * (J offsets, J labels, T ids).
struct WarpSlices {
  long long* off;
  int* lab;
  int* row;
};

__device__ __forceinline__ WarpSlices warp_slices(int warp, int J, int T) {
  extern __shared__ long long smem[];
  WarpSlices s;
  s.off = smem + warp * J;
  int* ints = reinterpret_cast<int*>(smem + kRowsPerBlock * J);
  s.lab = ints + warp * J;
  s.row = ints + kRowsPerBlock * J + warp * T;
  return s;
}

// Loads row r into the warp's slices (all 32 lanes take part).
__device__ __forceinline__ void load_row(const JoinArgs& a, int r, int lane,
                                         const WarpSlices& s) {
  const int* row = a.table + static_cast<long long>(r) * a.T;
  for (int t = lane; t < a.T; t += kWarp) s.row[t] = row[t];
  for (int j = lane; j < a.J; j += kWarp) {
    s.off[j] = a.q_valid[j]
                   ? static_cast<long long>(row[a.q_pos[j]]) * a.N
                   : -1ll;
    s.lab[j] = a.q_lab[j];
  }
  __syncwarp();
}

__global__ void embed_join_count_kernel(JoinArgs a, int* __restrict__ counts) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerBlock + warp;
  if (r >= a.R) return;  // warp-uniform
  if (!a.row_valid[r]) {
    if (lane == 0) counts[r] = 0;
    return;
  }
  const WarpSlices s = warp_slices(warp, a.J, a.T);
  load_row(a, r, lane, s);
  int cnt = 0;
  for (int c0 = 0; c0 < a.C; c0 += kWarp) {
    const int c = c0 + lane;
    bool ok = false;
    if (c < a.C && a.cand_valid[c]) {
      ok = cell_valid(s.row, a.T, s.off, s.lab, a.J, a.elab, a.cand[c]);
    }
    cnt += __popc(__ballot_sync(kFull, ok));
  }
  if (lane == 0) counts[r] = cnt;
}

__global__ void embed_join_emit_kernel(JoinArgs a,
                                       const long long* __restrict__ row_off,
                                       long long row_base,
                                       long long* __restrict__ idx_map,
                                       long long out_cap) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerBlock + warp;
  if (r >= a.R || !a.row_valid[r]) return;  // warp-uniform
  const WarpSlices s = warp_slices(warp, a.J, a.T);
  load_row(a, r, lane, s);
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const long long base = row_off[r];
  const long long cell_row = (row_base + r) * static_cast<long long>(a.C);
  int running = 0;
  for (int c0 = 0; c0 < a.C; c0 += kWarp) {
    const int c = c0 + lane;
    bool ok = false;
    if (c < a.C && a.cand_valid[c]) {
      ok = cell_valid(s.row, a.T, s.off, s.lab, a.J, a.elab, a.cand[c]);
    }
    const unsigned ballot = __ballot_sync(kFull, ok);
    if (ok) {
      const long long slot = base + running + __popc(ballot & lanemask_lt);
      if (slot < out_cap) idx_map[slot] = cell_row + c;
    }
    running += __popc(ballot);
  }
}

__global__ void embed_join_grid_kernel(JoinArgs a,
                                       unsigned char* __restrict__ out) {
  const long long cells = static_cast<long long>(a.R) * a.C;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < cells; i += stride) {
    const int r = static_cast<int>(i / a.C);
    const int c = static_cast<int>(i - static_cast<long long>(r) * a.C);
    bool ok = a.row_valid[r] && a.cand_valid[c];
    if (ok) {
      const int* row = a.table + static_cast<long long>(r) * a.T;
      const int v = a.cand[c];
      for (int j = 0; ok && j < a.J; ++j) {
        if (a.q_valid[j] &&
            __ldg(a.elab + static_cast<long long>(row[a.q_pos[j]]) * a.N + v) !=
                a.q_lab[j]) {
          ok = false;
        }
      }
      for (int t = 0; ok && t < a.T; ++t) {
        if (row[t] == v) ok = false;
      }
    }
    out[i] = ok ? 1 : 0;
  }
}

JoinArgs make_args(const void* table, int R, int T, const void* row_valid,
                   const void* cand, int C, const void* cand_valid,
                   const void* elab, int N, const void* q_pos,
                   const void* q_lab, const void* q_valid, int J) {
  JoinArgs a;
  a.table = static_cast<const int*>(table);
  a.R = R;
  a.T = T;
  a.row_valid = static_cast<const unsigned char*>(row_valid);
  a.cand = static_cast<const int*>(cand);
  a.C = C;
  a.cand_valid = static_cast<const unsigned char*>(cand_valid);
  a.elab = static_cast<const int*>(elab);
  a.N = N;
  a.q_pos = static_cast<const int*>(q_pos);
  a.q_lab = static_cast<const int*>(q_lab);
  a.q_valid = static_cast<const unsigned char*>(q_valid);
  a.J = J;
  return a;
}

size_t row_kernel_smem(int J, int T) {
  return static_cast<size_t>(kRowsPerBlock) *
         (static_cast<size_t>(J) * (sizeof(long long) + sizeof(int)) +
          static_cast<size_t>(T) * sizeof(int));
}

}  // namespace

extern "C" {

int embed_join_count(const void* table, int R, int T, const void* row_valid,
                     const void* cand, int C, const void* cand_valid,
                     const void* elab, int N, const void* q_pos,
                     const void* q_lab, const void* q_valid, int J,
                     void* counts, void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  embed_join_count_kernel<<<blocks, kRowsPerBlock * kWarp,
                            row_kernel_smem(J, T),
                            static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int embed_join_emit(const void* table, int R, int T, const void* row_valid,
                    const void* cand, int C, const void* cand_valid,
                    const void* elab, int N, const void* q_pos,
                    const void* q_lab, const void* q_valid, int J,
                    const void* row_off, long long row_base, void* idx_map,
                    long long out_cap, void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  embed_join_emit_kernel<<<blocks, kRowsPerBlock * kWarp,
                           row_kernel_smem(J, T),
                           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const long long*>(row_off), row_base,
      static_cast<long long*>(idx_map), out_cap);
  return static_cast<int>(cudaGetLastError());
}

int embed_join_grid(const void* table, int R, int T, const void* row_valid,
                    const void* cand, int C, const void* cand_valid,
                    const void* elab, int N, const void* q_pos,
                    const void* q_lab, const void* q_valid, int J, void* out,
                    void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  const long long cells = static_cast<long long>(R) * C;
  long long blocks = (cells + kGridThreads - 1) / kGridThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  embed_join_grid_kernel<<<static_cast<int>(blocks), kGridThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
