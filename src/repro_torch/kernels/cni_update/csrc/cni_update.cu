// CNI update kernel for Hopper (sm_90a): apply a batch's count deltas to
// the incremental index's frontier rows and re-encode them, in one pass.
//
// For each frontier row r it writes new_rows[r] = rows[r] + delta[r] and
// digests the new row with the term math of common/cni_row.cuh: the label
// degree, the exact int64 digest saturating at SAT64, and the float32 log
// digest.  A row updated here and the same row encoded by cni_encode come
// out bit for bit equal, which keeps the incremental index identical to a
// scratch rebuild on the card.
//
// cni_update_kernel<G, kLong>
//   Replaces: cni_update_pallas / _cni_update_kernel
//             (src/repro/kernels/cni_update/kernel.py:69 and :30), which
//             returns the new rows, the log digest and the degree; this
//             kernel adds the exact digest the port's index keeps on the
//             card (the reference keeps it on the host).
//   Bound:    bytes.  It must read the (F, L) int32 rows and deltas once,
//             write the (F, L) new rows once and 16 bytes per row (int32
//             degree, int64 digest, float32 log digest), and gather the
//             table entries its rows need (12 bytes each).
//   Design:   a group of G lanes owns a row (plan_lanes: 8 lanes up to 8
//             labels, else 16), so a warp takes 32 / G rows at a time.
//             1. Stage.  A warp owns a tile of whole consecutive rows (at
//                most kTile ints, few enough rows that every warp of the
//                card gets one): it reads rows and deltas with 16-byte
//                loads, kUnroll of each in flight a lane, adds them in
//                registers and stores the sum once to new_rows and once to
//                its tile in shared memory.  A tile is contiguous, so a
//                ragged start or end is a few scalar lanes.  No row is read
//                back from device memory.  Each warp runs alone (no block
//                barrier), so one warp's encode overlaps other warps'
//                loads.  (Double-buffering the tiles with cp.async was
//                tried side by side and did not pay: its second buffer
//                takes shared memory from the L1 that caches the gathers.)
//             2. Degree and positions.  Lane g of a group owns a
//                contiguous run of the row's labels (lane 0 the top ones)
//                and sums its counts, positions and label prefix in one
//                pass; one exclusive group scan then gives every lane the
//                position and prefix at which its labels start, and a
//                reduction the degree.  Each lane writes the clamped prefix
//                p of each of its positions in the window [w0, w0 + kPos)
//                to shared memory.
//             3. Every term in flight.  Lane k reads the prefixes of
//                positions k, k + G, ... of the window and issues all of
//                its gathers before it uses any of them.  The table
//                interleaves the two terms of an index (term_table in
//                ops.py), so a position costs one 16-byte load.
//             4. Order-free folds: the exact digest by a saturating
//                butterfly (cni::sat_add), m by fmaxf.
//             5. The float32 sum in position order: each lane computes its
//                exp(t - m) terms, and one lane of the group adds them from
//                shared memory in position order, the order of cni_encode's
//                walk.
//             d_max is not bounded: rows with more than kPos positions are
//             taken a window at a time, and their sum in a second pass over
//             the windows, once m is known.
//             Rows longer than kTile (kLong, a warp a row) are not staged:
//             the warp adds and stores the row with the same 16-byte loads,
//             then its lanes read their label runs from the inputs again
//             (from L1/L2).
//
// The C functions launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/cni_row.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;      // warps a block; each works alone
constexpr int kTile = 2048;    // ints of a warp's row tile in shared memory
constexpr int kPos = 64;       // positions a window
constexpr int kUnroll = 4;     // 16-byte loads a lane keeps in flight, per input
constexpr int kSMs = 132;
constexpr int kTargetWarps = kSMs * 32;  // tiles the plan aims to spread over
constexpr long long kMaxBlocks = kSMs * 16LL;  // tiles stride beyond this
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* rows;    // (n, L)
  const int* delta;   // (n, L)
  long long n;
  int L;
  int d_max;
  int max_p;
  const int4* terms;  // (d_max + 1) * (max_p + 1): Pascal halves, log bits, 0
  int* new_rows;      // (n, L)
  int* deg;           // (n,)
  long long* cni;     // (n,)
  float* log;         // (n,)
  int rows_per_tile;
  bool vec;           // the three row pointers are 16-byte aligned
};

struct Plan {
  int lanes;          // lanes a row
  int rows_per_tile;  // rows a warp stages at once
  bool long_rows;     // L > kTile: a warp a row, not staged
  int blocks;
  size_t smem;
};

// Lanes a row, from L (ref.py's plan_lanes): 8 up to 8 labels, 4 rows a
// warp; 16 above, 2 rows a warp, which beat a warp a row at L 200 and tied
// at L 44 when they were tried side by side; a warp for a row longer than
// a tile.
int plan_lanes(int L) { return L > kTile ? kWarp : L <= 8 ? 8 : 16; }

// Shared ints a warp: its tile (4 more for a ragged start) unless kLong,
// then per group the window's prefixes and its exp terms.
__host__ __device__ constexpr int warp_ints(int lanes, bool long_rows) {
  return (long_rows ? 0 : kTile + 4) + (kWarp / lanes) * 2 * kPos;
}

Plan plan_update(long long n, int L) {
  Plan p;
  p.long_rows = L > kTile;
  p.lanes = plan_lanes(L);
  const int groups = kWarp / p.lanes;
  if (p.long_rows) {
    p.rows_per_tile = 1;
  } else {
    // enough rows a warp to fill kTargetWarps warps, a multiple of the
    // groups, at most a tile
    const long long want = (n + kTargetWarps - 1) / kTargetWarps;
    const long long rows = (want + groups - 1) / groups * groups;
    const long long most = kTile / L;
    p.rows_per_tile = static_cast<int>(rows < most ? rows : most);
    if (p.rows_per_tile < 1) p.rows_per_tile = 1;
  }
  const long long tiles = (n + p.rows_per_tile - 1) / p.rows_per_tile;
  long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  p.blocks = static_cast<int>(blocks);
  p.smem = static_cast<size_t>(kWarps) * warp_ints(p.lanes, p.long_rows) *
           sizeof(int);
  return p;
}

// The table entry of a position past the row: Pascal term 0, log term -inf.
__device__ __forceinline__ int4 no_term() {
  return make_int4(0, 0, static_cast<int>(0xff800000u), 0);
}

// The Pascal term of a table entry: its two int32 halves, low first.
__device__ __forceinline__ long long pascal_of(int4 q) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(q.y)) << 32) |
      static_cast<unsigned>(q.x));
}

// Inclusive scans and reductions over a group of G lanes (gl: lane in group).
template <int G>
__device__ __forceinline__ int scan_add(int x, int gl) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d, G);
    if (gl >= d) x += y;
  }
  return x;
}

template <int G>
__device__ __forceinline__ long long scan_add64(long long x, int gl) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d, G);
    if (gl >= d) x += y;
  }
  return x;
}

template <int G>
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d, G);
  return x;
}

// The saturating butterfly: lane gl folds with lane gl ^ d, d = G/2 ... 1.
template <int G>
__device__ __forceinline__ long long group_sat_sum(long long x) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    x = cni::sat_add(x, __shfl_xor_sync(kFull, x, d, G));
  }
  return x;
}

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, d, G));
  }
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// A staged row in shared memory.
struct SmemRow {
  const int* p;
  __device__ int operator()(int l) const { return p[l]; }
};

// A row read from the inputs (a long row, after its sum is stored).
struct GlobalRow {
  const int* rows;
  const int* delta;
  __device__ int operator()(int l) const {
    return __ldg(rows + l) + __ldg(delta + l);
  }
};

// Stores `cells` ints from flat index f0: new_rows[f0 + e] = rows[f0 + e] +
// delta[f0 + e], and with kToTile also tile[e].  tile + e is 16-byte
// aligned wherever f0 + e is a multiple of 4 (the caller offsets the tile
// by f0 & 3).
template <bool kToTile>
__device__ __forceinline__ void stage(const Args& a, long long f0, int cells,
                                      int* tile, int lane) {
  const int head = a.vec ? min(static_cast<int>((4 - (f0 & 3)) & 3), cells)
                         : cells;
  for (int e = lane; e < head; e += kWarp) {
    const int v = __ldg(a.rows + f0 + e) + __ldg(a.delta + f0 + e);
    a.new_rows[f0 + e] = v;
    if (kToTile) tile[e] = v;
  }
  const int nvec = (cells - head) >> 2;
  const int4* r4 = reinterpret_cast<const int4*>(a.rows + f0 + head);
  const int4* d4 = reinterpret_cast<const int4*>(a.delta + f0 + head);
  int4* o4 = reinterpret_cast<int4*>(a.new_rows + f0 + head);
  int4* t4 = reinterpret_cast<int4*>(tile + head);
  for (int i0 = 0; i0 < nvec; i0 += kWarp * kUnroll) {
    int4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarp + lane;
      if (i < nvec) {
        x[u] = __ldg(r4 + i);
        y[u] = __ldg(d4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarp + lane;
      if (i < nvec) {
        const int4 v = make_int4(x[u].x + y[u].x, x[u].y + y[u].y,
                                 x[u].z + y[u].z, x[u].w + y[u].w);
        o4[i] = v;
        if (kToTile) t4[i] = v;
      }
    }
  }
  for (int e = head + 4 * nvec + lane; e < cells; e += kWarp) {
    const int v = __ldg(a.rows + f0 + e) + __ldg(a.delta + f0 + e);
    a.new_rows[f0 + e] = v;
    if (kToTile) tile[e] = v;
  }
}

// A row as its group sees it after one pass: lane gl owns the contiguous
// labels [lo, hi), walked from hi - 1 down (lane 0 the top ones), and an
// exclusive scan of the lanes' sums gives it the position and the label
// prefix at which its labels start.
struct RowScan {
  int deg;           // the row's degree: the sum of its counts (group-uniform)
  int npos;          // positions taken: min(sum of positive counts, d_max)
  int lo, hi;        // this lane's labels
  int start;         // positions before them
  long long prefix;  // label prefix before them, clamped at max_p
};

// Negative counts add to the degree and take no position, as in
// cni::encode_row.
template <int G, class Row>
__device__ __forceinline__ RowScan scan_row(const Row& row, int L, bool have,
                                            int d_max, int max_p, int gl) {
  RowScan s;
  const int seg = (L + G - 1) / G;
  s.hi = max(L - gl * seg, 0);
  s.lo = max(s.hi - seg, 0);
  int deg = 0, pos = 0;
  long long w = 0;
  if (have) {
    for (int l = s.hi - 1; l >= s.lo; --l) {
      const int c = row(l);
      const int cp = max(c, 0);
      deg += c;
      pos += cp;
      w += static_cast<long long>(cp) * (l + 1);
    }
  }
  w = min(w, static_cast<long long>(max_p));  // only the clamped prefix counts
  const int pos_in = scan_add<G>(pos, gl);
  const long long w_in = scan_add64<G>(w, gl);
  s.start = pos_in - pos;
  s.prefix = min(w_in - w, static_cast<long long>(max_p));
  s.deg = group_sum<G>(deg);
  s.npos = min(__shfl_sync(kFull, pos_in, G - 1, G), d_max);
  return s;
}

// Writes plab[j - w0] = min(p_j, max_p) for the positions j of this lane's
// labels in [w0, min(w0 + kPos, npos)): p_j is the prefix through position
// j, each of a label's positions adding its ord value l + 1.
template <class Row>
__device__ __forceinline__ void fill_window(const Row& row, const RowScan& s,
                                            bool have, int w0, int max_p,
                                            int* plab) {
  const int w1 = min(w0 + kPos, s.npos);
  const long long cap = max_p;
  int j0 = s.start;
  long long p = s.prefix;
  if (!have) return;
  for (int l = s.hi - 1; l >= s.lo && j0 < w1; --l) {
    const int cp = max(row(l), 0);
    const int first = max(j0, w0);
    long long v = p + static_cast<long long>(first - j0 + 1) * (l + 1);
    for (int j = first; j < min(j0 + cp, w1); ++j, v += l + 1) {
      plab[j - w0] = static_cast<int>(min(v, cap));
    }
    p = min(p + static_cast<long long>(cp) * (l + 1), cap);
    j0 += cp;
  }
}

// The table indices of the window's positions: lane gl takes positions
// w0 + k * G + gl; rounds past every group's positions (wmax) are skipped,
// warp-uniformly.
template <int G, int K>
__device__ __forceinline__ void window_indices(const int* plab, int w0,
                                               int npos, int wmax, int max_p,
                                               int gl, long long (&idx)[K],
                                               bool (&val)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = w0 + k * G + gl;
    val[k] = w0 + k * G < wmax && j < npos;
    idx[k] = val[k] ? cni::term_index(j + 1, plab[k * G + gl], max_p) : 0;
  }
}

// Digests one row (have: this group has a row; every lane of the warp calls
// it, so the shuffles see full warps).  Group lane 0 writes the outputs.
template <int G, class Row>
__device__ __forceinline__ void encode_group(const Row& row, bool have,
                                             long long r, const Args& a,
                                             int* plab, float* esc, int gl) {
  constexpr int K = kPos / G;
  const RowScan rs = scan_row<G>(row, a.L, have, a.d_max, a.max_p, gl);
  const int wmax = warp_max(rs.npos);
  long long acc = 0;
  float m = -CUDART_INF_F;
  float t0[K];  // window 0's log terms, for the sum when it is the only one
  bool v0[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t0[k] = 0.0f;
    v0[k] = false;
  }
  for (int w0 = 0; w0 < wmax; w0 += kPos) {
    fill_window(row, rs, have, w0, a.max_p, plab);
    __syncwarp();
    long long idx[K];
    bool val[K];
    window_indices<G, K>(plab, w0, rs.npos, wmax, a.max_p, gl, idx, val);
    long long pt[K];
    float lt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4 q = val[k] ? __ldg(a.terms + idx[k]) : no_term();
      pt[k] = pascal_of(q);
      lt[k] = __int_as_float(q.z);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc = cni::sat_add(acc, pt[k]);
      m = fmaxf(m, lt[k]);
    }
    if (w0 == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        t0[k] = lt[k];
        v0[k] = val[k];
      }
    }
    __syncwarp();  // the window is read before the next one is written
  }
  acc = group_sat_sum<G>(acc);
  const float m_safe = cni::safe_max(group_max<G>(m));
  float s = 0.0f;
  if (wmax <= kPos) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (v0[k]) esc[k * G + gl] = expf(t0[k] - m_safe);
    }
    __syncwarp();
    if (gl == 0) {
      for (int j = 0; j < rs.npos; ++j) s += esc[j];
    }
  } else {
    // more than one window: the log terms again, window by window, now
    // that m is known
    for (int w0 = 0; w0 < wmax; w0 += kPos) {
      fill_window(row, rs, have, w0, a.max_p, plab);
      __syncwarp();
      long long idx[K];
      bool val[K];
      window_indices<G, K>(plab, w0, rs.npos, wmax, a.max_p, gl, idx, val);
      float lt[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lt[k] = val[k] ? __int_as_float(__ldg(&a.terms[idx[k]].z)) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (val[k]) esc[k * G + gl] = expf(lt[k] - m_safe);
      }
      __syncwarp();
      if (gl == 0) {
        const int end = min(w0 + kPos, rs.npos);
        for (int j = w0; j < end; ++j) s += esc[j - w0];
      }
      __syncwarp();  // the terms are summed before the next window's
    }
  }
  if (have && gl == 0) {
    a.deg[r] = rs.deg;
    a.cni[r] = acc;
    a.log[r] = cni::log_digest(rs.deg, m_safe, s);
  }
}

template <int G, bool kLong>
__global__ void __launch_bounds__(kWarps * kWarp)
    cni_update_kernel(const Args a) {
  constexpr int kGroups = kWarp / G;
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int grp = lane / G;
  const int gl = lane % G;
  int* wsm = reinterpret_cast<int*>(smem4) + warp * warp_ints(G, kLong);
  int* plab = wsm + (kLong ? 0 : kTile + 4) + grp * 2 * kPos;
  float* esc = reinterpret_cast<float*>(plab + kPos);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long tiles = (a.n + a.rows_per_tile - 1) / a.rows_per_tile;
  // every lane of a warp takes the same trip counts, so the shuffles and
  // __syncwarp() calls below are reached by all 32 lanes
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
       t < tiles; t += n_warps) {
    const long long r0 = t * a.rows_per_tile;
    if constexpr (kLong) {
      const long long off = r0 * a.L;
      stage<false>(a, off, a.L, nullptr, lane);
      encode_group<G>(GlobalRow{a.rows + off, a.delta + off}, true, r0, a,
                      plab, esc, gl);
    } else {
      const int nr = static_cast<int>(
          min(static_cast<long long>(a.rows_per_tile), a.n - r0));
      const long long f0 = r0 * a.L;
      int* tile = wsm + static_cast<int>(f0 & 3);
      stage<true>(a, f0, nr * a.L, tile, lane);
      __syncwarp();
      for (int rr0 = 0; rr0 < nr; rr0 += kGroups) {
        const int rr = rr0 + grp;
        const bool have = rr < nr;
        encode_group<G>(SmemRow{tile + (have ? rr : 0) * a.L}, have, r0 + rr,
                        a, plab, esc, gl);
      }
    }
    __syncwarp();  // the tile and the windows are read before the next tile
  }
}

using Kernel = void (*)(const Args);

Kernel kernel_for(const Plan& p) {
  if (p.long_rows) return cni_update_kernel<kWarp, true>;
  return p.lanes == 8 ? cni_update_kernel<8, false> : cni_update_kernel<16, false>;
}

}  // namespace

extern "C" {

int cni_update(const void* rows, const void* delta, long long n, int L,
               int d_max, int max_p, const void* terms, void* new_rows,
               void* deg, void* cni, void* cni_log, void* stream) {
  const Plan p = plan_update(n, L);
  Args a;
  a.rows = static_cast<const int*>(rows);
  a.delta = static_cast<const int*>(delta);
  a.n = n;
  a.L = L;
  a.d_max = d_max;
  a.max_p = max_p;
  a.terms = static_cast<const int4*>(terms);
  a.new_rows = static_cast<int*>(new_rows);
  a.deg = static_cast<int*>(deg);
  a.cni = static_cast<long long*>(cni);
  a.log = static_cast<float*>(cni_log);
  a.rows_per_tile = p.rows_per_tile;
  a.vec = ((reinterpret_cast<uintptr_t>(rows) |
            reinterpret_cast<uintptr_t>(delta) |
            reinterpret_cast<uintptr_t>(new_rows)) & 15) == 0;
  const Kernel kernel = kernel_for(p);
  if (p.smem > 48 * 1024) {  // above the default, dynamic memory must be asked for
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(p.smem));
  }
  kernel<<<p.blocks, kWarps * kWarp, p.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch at these shapes: out = {lanes a row, rows a warp's tile, rows
// a block, blocks, threads a block, dynamic shared bytes}.
int cni_update_plan(long long n, int L, int* out) {
  const Plan p = plan_update(n, L);
  out[0] = p.lanes;
  out[1] = p.rows_per_tile;
  out[2] = p.rows_per_tile * kWarps;
  out[3] = p.blocks;
  out[4] = kWarps * kWarp;
  out[5] = static_cast<int>(p.smem);
  return 0;
}

}  // extern "C"
