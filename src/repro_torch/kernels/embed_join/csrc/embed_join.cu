// Embed-join kernels for Hopper (sm_90a): the validity grid, the per-row
// count pass and the emit pass of one BFS-join expansion level.
//
// Every kernel evaluates the same cell test:
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
// embed_join_rows_kernel<K, G, false>: the count kernel
//   Replaces: embed_join_count_pallas / _embed_join_count_kernel
//             (src/repro/kernels/embed_join/kernel.py:174 and :103).
//   Bound:    bytes.  Per level it must read the table (R*T*4), the
//             candidate list and masks, and for each distinct mapped
//             neighbour the candidate entries of its elab row (4 bytes per
//             (neighbour, candidate) pair), then write R*4 bytes of counts;
//             the work per cell is J+T integer compares.  That is under a
//             microsecond at the path's shapes.  What the card really pays
//             is the launch, a few dependent round trips, and the L2
//             traffic of the lookups: every row reads its own mapped elab
//             row, and a warp's 32 lookups arrive as 32-byte sectors (at the
//             join-heavy level, 41.7 MB of sectors for 4,834-wide rows and
//             candidates about one in five).
//   Design:   the Pallas kernel evaluates a whole (rows x 128) tile with
//             every lookup in flight; so does this one, cut to Hopper's
//             parallelism.  A block owns `rows` consecutive rows (about 4
//             blocks an SM, one row a block at HUMAN sizes) and its 4-8
//             warps split the candidate list into contiguous spans of 32*K
//             candidates (a lane takes K of them, 32 apart, and keeps them
//             in registers for all the block's rows; a longer list is walked
//             in passes).  The block stages its rows and the live
//             constraints in shared memory with one round trip of
//             independent loads.  Per constraint a lane issues the G x K
//             lookups of G rows before it compares any (no early exit: no
//             chain of dependent loads).  Only a ballot the label test left
//             non-empty runs the injectivity compares against the rows in
//             shared memory (a warp-uniform branch).  Each warp sums
//             __popc(__ballot_sync) in registers; the block folds its warps
//             in warp order and makes one store per row.  The (R, C) grid
//             never reaches device memory.
//
// embed_join_rows_kernel<K, G, true>: the grid kernel
//   Replaces: embed_join_pallas / _embed_join_kernel
//             (src/repro/kernels/embed_join/kernel.py:129 and :88).
//   Bound:    bytes: the same reads as the count kernel plus the R*C byte
//             grid written once.
//   Design:   the count kernel itself, with its plan, staging, candidates
//             in registers and G x K lookups in flight; where the count
//             kernel sums a ballot, each lane writes its validity byte of
//             each of its K candidates (32 apart, so a warp's 32 bytes of
//             one k coalesce).  A row group with no valid row writes its
//             zeros without a lookup.
//
// embed_join_emit_kernel<K, G, false>
//   Replaces: the emit pass embed_join_emit_raw
//             (src/repro/kernels/embed_join/ops.py:155): the grid kernel,
//             then a cumsum for the in-row rank, then a scatter with
//             mode="drop".
//   Bound:    bytes: the count kernel's reads plus row_off (R*8) and the
//             surviving cell ids (8 bytes each) written once; the lookups'
//             sectors and the round trips, as for the count kernel.
//   Design:   the count kernel's blocks, spans and lookups (about 2 blocks
//             an SM).  Each warp stores its ballot words of every row in
//             shared memory, where a row's words run in candidate order;
//             with no barrier between rows, the warps run through them as
//             the count kernel's do.  After one barrier, a warp per row
//             scans the words' popcounts (32 words at a time, warp
//             shuffles) and walks the non-empty words in order, a lane per
//             bit, writing each survivor's (row_base + r) * C + c at
//             row_off[r] + its rank: the flat row-major slot order, with no
//             grid in memory, no scan pass and no atomics, so the output is
//             the same bit for bit on every run.  The row offsets load
//             while the block stages.  A candidate list longer than two
//             passes is taken two passes (a window) at a time.  Slots >=
//             out_cap are dropped.
//
// embed_join_emit_kernel<K, G, true>: the emit that writes the next table
//   Replaces: nothing in the TPU package, whose join decodes cell ids with
//             gathers after the emit pass; here it takes the place of the
//             port's own decode (two gathers, a concatenation and a mask
//             after embed_join_emit_kernel<K, G, false>).
//   Bound:    bytes: the emit's reads (row_off as above) plus each
//             survivor's next-table row, (T + 1) int32, written once.
//   Design:   the emit kernel itself, phase 1 and the shared-memory rows
//             included; in phase 2 the lane that owns a survivor writes its
//             parent row (from shared memory) and cand[c] at its slot of the
//             (out_cap, T + 1) output, in place of the cell id.  The table
//             is complete when the kernel ends: no decode pass.
//
// Null masks: row_valid, cand_valid and q_valid may be null, meaning every
// row, candidate or constraint is live (the level loop passes exact row
// slices, exact candidate lists and only matched constraints).
//
// The C functions launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMinWarps = 4;   // warps per block of the row kernels
constexpr int kMaxWarps = 8;
constexpr int kMaxK = 8;       // candidates a lane takes per pass
constexpr int kMaxRows = 16;   // rows per block
constexpr int kRowGroup = 2;   // rows whose lookups are in flight together
constexpr int kMaxWindow = 2;  // emit: passes of ballots held at once
constexpr int kSMs = 132;
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

// Launch shape of the count and emit kernels.
struct Plan {
  int warps;   // warps per block
  int k;       // candidates a lane takes per pass
  int rows;    // rows per block
  int group;   // rows whose lookups are in flight together (1 or kRowGroup)
  int window;  // emit: passes whose ballots are held in shared memory at once
  int blocks;
  size_t smem; // dynamic shared memory bytes
};

// Shared memory of a block: the emit's running row offsets, the live
// constraints' table columns and labels, its rows and their validity, then
// the count's warp sums (rows x warps) or the emit's ballot words (rows x
// window x warps x K).
size_t row_kernel_smem(const Plan& p, int T, int J, bool emit) {
  const size_t tail = emit ? static_cast<size_t>(p.rows) * p.window * p.warps * p.k
                           : static_cast<size_t>(p.rows) * p.warps;
  return static_cast<size_t>(p.rows) * sizeof(long long) +
         (2 * static_cast<size_t>(J) + static_cast<size_t>(p.rows) * (T + 1) +
          tail) * sizeof(int);
}

// The smallest block (4-8 warps, K a power of two up to 8) whose pass
// covers the candidate list.  Rows per block: a power of two that leaves
// about 4 blocks an SM for the count kernel (no barrier: more blocks hide
// more latency) and about 2 for the emit kernel (a barrier a window:
// fewer, fuller blocks), one row a block at HUMAN sizes.
Plan plan_rows(int R, int C, int T, int J, bool emit) {
  Plan p;
  const int chunks = (C + kWarp - 1) / kWarp;  // 32-candidate lane chunks
  p.warps = chunks < kMinWarps ? kMinWarps
            : chunks < kMaxWarps ? chunks : kMaxWarps;
  p.k = 1;
  while (p.k < kMaxK && p.warps * p.k < chunks) p.k *= 2;
  const int want = R / ((emit ? 2 : 4) * kSMs);
  p.rows = 1;
  while (p.rows < kMaxRows && p.rows * 2 <= want) p.rows *= 2;
  p.group = p.rows > 1 ? kRowGroup : 1;
  const int passes = (C + p.warps * kWarp * p.k - 1) / (p.warps * kWarp * p.k);
  p.window = passes < 1 ? 1 : passes < kMaxWindow ? passes : kMaxWindow;
  p.blocks = (R + p.rows - 1) / p.rows;
  p.smem = row_kernel_smem(p, T, J, emit);
  return p;
}

struct RowSmem {
  long long* base;  // (rows,) emit: the next slot of each row
  int* jpos;        // (jv,) table column of each live constraint
  int* lab;         // (jv,) its label
  int* row;         // (rows, T) the block's rows
  int* rv;          // (rows,) their validity
  int* red;         // count: warp sums; emit: ballot words
};

__device__ __forceinline__ RowSmem carve(int rows, int J, int T) {
  extern __shared__ long long smem[];
  RowSmem s;
  s.base = smem;
  s.jpos = reinterpret_cast<int*>(smem + rows);
  s.lab = s.jpos + J;
  s.row = s.jpos + 2 * J;
  s.rv = s.row + rows * T;
  s.red = s.rv + rows;
  return s;
}

// Stages the block's nrows rows from r0 and their validity, and compacts
// the live constraints (warp 0, 32 at a time); every load is independent
// of the others, so the stage costs one round trip.  Returns the live
// constraint count (jv).
__device__ int stage_rows(const JoinArgs& a, const RowSmem& s, int r0,
                          int nrows) {
  __shared__ int s_jv;
  const int tid = threadIdx.x;
  if (tid < kWarp) {
    int jv = 0;
    for (int j0 = 0; j0 < a.J; j0 += kWarp) {
      const int j = j0 + tid;
      const bool in = j < a.J;
      const bool on = in && (a.q_valid == nullptr || a.q_valid[j]);
      const int pos = in ? a.q_pos[j] : 0;
      const int lab = in ? a.q_lab[j] : 0;
      const unsigned m = __ballot_sync(kFull, on);
      if (on) {
        const int at = jv + __popc(m & ((1u << tid) - 1u));
        s.jpos[at] = pos;
        s.lab[at] = lab;
      }
      jv += __popc(m);
    }
    if (tid == 0) s_jv = jv;
  }
  const int* rows = a.table + static_cast<long long>(r0) * a.T;
  for (int i = tid; i < nrows * a.T; i += blockDim.x) s.row[i] = __ldg(rows + i);
  for (int i = tid; i < nrows; i += blockDim.x) {
    s.rv[i] = a.row_valid == nullptr || a.row_valid[r0 + i];
  }
  __syncthreads();
  return s_jv;
}

// A lane's K candidates of a pass: c0 + k*32 + lane (id and mask loaded
// side by side).
template <int K>
__device__ __forceinline__ void load_cands(const JoinArgs& a, int c0, int lane,
                                           int (&v)[K], bool (&live)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k * kWarp + lane;
    const bool in = c < a.C;
    const bool valid = in && (a.cand_valid == nullptr || a.cand_valid[c]);
    v[k] = in ? __ldg(a.cand + c) : 0;
    live[k] = valid;
  }
}

// The cell test of G consecutive rows from g0 (rlive: the row exists and is
// valid, warp-uniform) against a lane's K candidates, as ballots.  Per live
// constraint, all G x K label lookups are issued before any is compared.
// The injectivity compares run only for a ballot the label test left
// non-empty (a warp-uniform branch), against the row in shared memory.
template <int K, int G>
__device__ __forceinline__ void test_group(const JoinArgs& a,
                                           const RowSmem& s, int g0,
                                           const bool (&rlive)[G], int jv,
                                           const int (&v)[K],
                                           const bool (&live)[K],
                                           unsigned (&bal)[G][K]) {
  bool ok[G][K];
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) ok[i][k] = rlive[i] && live[k];
  }
  for (int j = 0; j < jv; ++j) {
    const int col = s.jpos[j];
    const int lab = s.lab[j];
    int got[G][K];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const long long off =
          rlive[i] ? static_cast<long long>(s.row[(g0 + i) * a.T + col]) * a.N
                   : 0;
      const int* erow = a.elab + off;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        got[i][k] = rlive[i] && live[k] ? __ldg(erow + v[k]) : lab;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) ok[i][k] = ok[i][k] && got[i][k] == lab;
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int* row = s.row + (g0 + i) * a.T;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bal[i][k] = __ballot_sync(kFull, ok[i][k]);
      if (bal[i][k]) {
        for (int t = 0; t < a.T; ++t) ok[i][k] = ok[i][k] && v[k] != row[t];
        bal[i][k] = __ballot_sync(kFull, ok[i][k]);
      }
    }
  }
}

// Which of the G rows from g0 exist and are valid; false when none is.
template <int G>
__device__ __forceinline__ bool group_rows(const RowSmem& s, int g0, int nrows,
                                           bool (&rlive)[G]) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    rlive[i] = g0 + i < nrows && s.rv[g0 + i];
    any = any || rlive[i];
  }
  return any;
}

// The count kernel (kGrid false: counts[r], the survivors of row r) and the
// grid kernel (kGrid true: grid[r * C + c], one byte a cell).
template <int K, int G, bool kGrid>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    embed_join_rows_kernel(JoinArgs a, int rows_per_block,
                           int* __restrict__ counts,
                           unsigned char* __restrict__ grid) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, a.R - r0);
  const int per_pass = warps * kWarp * K;
  const int passes = (a.C + per_pass - 1) / per_pass;
  int v[K];
  bool live[K];
  // a single pass's candidates load while the block stages its rows
  if (passes == 1) load_cands<K>(a, warp * kWarp * K, lane, v, live);
  const RowSmem s = carve(rows_per_block, a.J, a.T);
  const int jv = stage_rows(a, s, r0, nrows);
  for (int g0 = 0; g0 < nrows; g0 += G) {
    bool rlive[G];
    const bool any = group_rows<G>(s, g0, nrows, rlive);
    if (!any && !kGrid) continue;  // block-uniform
    int cnt[G];
#pragma unroll
    for (int i = 0; i < G; ++i) cnt[i] = 0;
    for (int p = 0; p < passes; ++p) {
      const int c0 = p * per_pass + warp * kWarp * K;
      if (passes > 1) load_cands<K>(a, c0, lane, v, live);
      unsigned bal[G][K];
      if (any) {
        test_group<K, G>(a, s, g0, rlive, jv, v, live, bal);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) {
#pragma unroll
          for (int k = 0; k < K; ++k) bal[i][k] = 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (kGrid) {
          if (g0 + i >= nrows) continue;
          unsigned char* out =
              grid + static_cast<long long>(r0 + g0 + i) * a.C + c0 + lane;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (c0 + k * kWarp + lane < a.C) {
              out[k * kWarp] = static_cast<unsigned char>((bal[i][k] >> lane) & 1u);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) cnt[i] += __popc(bal[i][k]);
        }
      }
    }
    if (!kGrid && lane == 0) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (g0 + i < nrows) s.red[(g0 + i) * warps + warp] = cnt[i];
      }
    }
  }
  if (kGrid) return;  // block-uniform: no barrier is left to meet
  __syncthreads();
  for (int rr = threadIdx.x; rr < nrows; rr += blockDim.x) {
    int sum = 0;
    if (s.rv[rr]) {
      for (int w = 0; w < warps; ++w) sum += s.red[rr * warps + w];
    }
    counts[r0 + rr] = sum;
  }
}

// Writes the survivors of one row from its ballot words (chunk q holds
// candidates c0 + 32q + lane, in candidate order): a warp scan of the
// words' popcounts gives each chunk's first slot, then the warp walks the
// non-empty chunks in order, a lane per bit, so slots follow the flat
// row-major order.  A survivor's slot gets its cell id cell0 + c - c0
// (kTable false) or its next-table row: the row's T ids from shared
// memory, then cand[c] (kTable true).  Returns the row's survivor count.
template <bool kTable>
__device__ __forceinline__ int emit_row(const unsigned* words, int nwords,
                                        long long slot, long long cell0,
                                        int c0, const int* row, int T,
                                        const int* __restrict__ cand,
                                        long long* __restrict__ idx_map,
                                        int* __restrict__ out,
                                        long long out_cap, int lane) {
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int done = 0;
  for (int q0 = 0; q0 < nwords; q0 += kWarp) {
    const int q = q0 + lane;
    const unsigned w = q < nwords ? words[q] : 0u;
    const int n = __popc(w);
    int incl = n;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const long long first = slot + done + incl - n;
    unsigned nz = __ballot_sync(kFull, w != 0u);
    while (nz) {  // warp-uniform
      const int src = __ffs(nz) - 1;
      nz &= nz - 1u;
      const unsigned wq = __shfl_sync(kFull, w, src);
      const long long at =
          __shfl_sync(kFull, first, src) + __popc(wq & lanemask_lt);
      if (((wq >> lane) & 1u) && at < out_cap) {
        const int c = (q0 + src) * kWarp + lane;
        if (kTable) {
          int* dst = out + at * (T + 1);
          for (int t = 0; t < T; ++t) dst[t] = row[t];
          dst[T] = __ldg(cand + c0 + c);
        } else {
          idx_map[at] = cell0 + c;
        }
      }
    }
    done += __shfl_sync(kFull, incl, kWarp - 1);
  }
  return done;
}

template <int K, int G, bool kTable>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    embed_join_emit_kernel(JoinArgs a, int rows_per_block, int window,
                           const long long* __restrict__ row_off,
                           long long row_base, long long* __restrict__ idx_map,
                           int* __restrict__ out, long long out_cap) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, a.R - r0);
  const int per_pass = warps * kWarp * K;
  const int passes = (a.C + per_pass - 1) / per_pass;
  int v[K];
  bool live[K];
  // a single pass's candidates load while the block stages its rows
  if (passes == 1) load_cands<K>(a, warp * kWarp * K, lane, v, live);
  const RowSmem s = carve(rows_per_block, a.J, a.T);
  // the row offsets load while the block stages its rows
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) s.base[i] = row_off[r0 + i];
  const int jv = stage_rows(a, s, r0, nrows);
  const int row_words = window * warps * K;  // ballot words of a row
  for (int p0 = 0; p0 < passes; p0 += window) {
    const int np = min(window, passes - p0);
    if (p0 > 0) __syncthreads();  // the last window's words are written out
    // phase 1: each warp's ballots of every row and pass of the window
    for (int g0 = 0; g0 < nrows; g0 += G) {
      bool rlive[G];
      if (!group_rows<G>(s, g0, nrows, rlive)) continue;  // block-uniform
      for (int p = 0; p < np; ++p) {
        if (passes > 1) {
          load_cands<K>(a, (p0 + p) * per_pass + warp * kWarp * K, lane, v, live);
        }
        unsigned bal[G][K];
        test_group<K, G>(a, s, g0, rlive, jv, v, live, bal);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < G; ++i) {
            if (!rlive[i]) continue;
            unsigned* words = reinterpret_cast<unsigned*>(s.red) +
                              (g0 + i) * row_words + (p * warps + warp) * K;
#pragma unroll
            for (int k = 0; k < K; ++k) words[k] = bal[i][k];
          }
        }
      }
    }
    __syncthreads();
    // phase 2: a warp per row (rows warp, warp + warps, ...) writes its
    // survivors in candidate order and moves the row's next slot on
    for (int rr = warp; rr < nrows; rr += warps) {
      if (!s.rv[rr]) continue;  // warp-uniform
      const long long slot = s.base[rr];
      const int done = emit_row<kTable>(
          reinterpret_cast<const unsigned*>(s.red) + rr * row_words,
          np * warps * K, slot,
          (row_base + r0 + rr) * static_cast<long long>(a.C) + p0 * per_pass,
          p0 * per_pass, s.row + rr * a.T, a.T, a.cand, idx_map, out, out_cap,
          lane);
      __syncwarp();
      if (lane == 0) s.base[rr] = slot + done;
    }
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

using RowsKernel = void (*)(JoinArgs, int, int*, unsigned char*);
using EmitKernel = void (*)(JoinArgs, int, int, const long long*, long long,
                            long long*, int*, long long);

// The instantiations for a plan's K and row group G (nullptr for another K).
template <int G, bool kGrid>
RowsKernel rows_kernel(int k) {
  switch (k) {
    case 1: return embed_join_rows_kernel<1, G, kGrid>;
    case 2: return embed_join_rows_kernel<2, G, kGrid>;
    case 4: return embed_join_rows_kernel<4, G, kGrid>;
    case 8: return embed_join_rows_kernel<8, G, kGrid>;
  }
  return nullptr;
}

template <int G, bool kTable>
EmitKernel emit_kernel(int k) {
  switch (k) {
    case 1: return embed_join_emit_kernel<1, G, kTable>;
    case 2: return embed_join_emit_kernel<2, G, kTable>;
    case 4: return embed_join_emit_kernel<4, G, kTable>;
    case 8: return embed_join_emit_kernel<8, G, kTable>;
  }
  return nullptr;
}

// The count kernel (grid null) or the grid kernel (counts null).
int launch_rows(const JoinArgs& a, const Plan& p, void* counts, void* grid,
                void* stream) {
  RowsKernel kernel;
  if (grid != nullptr) {
    kernel = p.group > 1 ? rows_kernel<kRowGroup, true>(p.k)
                         : rows_kernel<1, true>(p.k);
  } else {
    kernel = p.group > 1 ? rows_kernel<kRowGroup, false>(p.k)
                         : rows_kernel<1, false>(p.k);
  }
  kernel<<<p.blocks, p.warps * kWarp, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      a, p.rows, static_cast<int*>(counts), static_cast<unsigned char*>(grid));
  return static_cast<int>(cudaGetLastError());
}

// The cell-id emit (out null) or the next-table emit (idx_map null).
int launch_emit(const JoinArgs& a, const Plan& p, const void* row_off,
                long long row_base, void* idx_map, void* out,
                long long out_cap, void* stream) {
  EmitKernel kernel;
  if (out != nullptr) {
    kernel = p.group > 1 ? emit_kernel<kRowGroup, true>(p.k)
                         : emit_kernel<1, true>(p.k);
  } else {
    kernel = p.group > 1 ? emit_kernel<kRowGroup, false>(p.k)
                         : emit_kernel<1, false>(p.k);
  }
  kernel<<<p.blocks, p.warps * kWarp, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      a, p.rows, p.window, static_cast<const long long*>(row_off), row_base,
      static_cast<long long*>(idx_map), static_cast<int*>(out), out_cap);
  return static_cast<int>(cudaGetLastError());
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
  return launch_rows(a, plan_rows(R, C, T, J, false), counts, nullptr,
                     stream);
}

int embed_join_emit(const void* table, int R, int T, const void* row_valid,
                    const void* cand, int C, const void* cand_valid,
                    const void* elab, int N, const void* q_pos,
                    const void* q_lab, const void* q_valid, int J,
                    const void* row_off, long long row_base, void* idx_map,
                    long long out_cap, void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  return launch_emit(a, plan_rows(R, C, T, J, true), row_off, row_base,
                     idx_map, nullptr, out_cap, stream);
}

// out: (out_cap, T + 1) int32 row-major, the next table.
int embed_join_emit_table(const void* table, int R, int T,
                          const void* row_valid, const void* cand, int C,
                          const void* cand_valid, const void* elab, int N,
                          const void* q_pos, const void* q_lab,
                          const void* q_valid, int J, const void* row_off,
                          void* out, long long out_cap, void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  return launch_emit(a, plan_rows(R, C, T, J, true), row_off, 0, nullptr,
                     out, out_cap, stream);
}

int embed_join_grid(const void* table, int R, int T, const void* row_valid,
                    const void* cand, int C, const void* cand_valid,
                    const void* elab, int N, const void* q_pos,
                    const void* q_lab, const void* q_valid, int J, void* out,
                    void* stream) {
  const JoinArgs a = make_args(table, R, T, row_valid, cand, C, cand_valid,
                               elab, N, q_pos, q_lab, q_valid, J);
  return launch_rows(a, plan_rows(R, C, T, J, false), nullptr, out, stream);
}

// The count and grid (emit = 0) or emit (emit = 1) kernel's launch at these
// shapes: out = {blocks, threads a block, K, rows a block, dynamic shared
// bytes}.
int embed_join_plan(int R, int C, int T, int J, int emit, int* out) {
  const Plan p = plan_rows(R, C, T, J, emit != 0);
  out[0] = p.blocks;
  out[1] = p.warps * kWarp;
  out[2] = p.k;
  out[3] = p.rows;
  out[4] = static_cast<int>(p.smem);
  return 0;
}

}  // extern "C"
