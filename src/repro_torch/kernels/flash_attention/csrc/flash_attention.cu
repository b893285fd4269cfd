// Flash attention for Hopper (sm_90a): causal GQA attention with a
// streaming softmax, the forward pass of the LM substrate's attention.
//
// out[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] / sqrt(D)) v[b, h/G, j]
// with q and k D wide and v (and out) DV wide, DV <= D (MLA's V is narrower
// than its QK head), over the keys j that row i may see: j < kv_len, j <= q_offset + i when
// causal, j > q_offset + i - window when a window is set.  A masked key
// gets weight 0 (the Pallas kernel's -1e30 score, whose exp is 0 once a row
// has seen a real score), and the sums run in float32 whatever the input
// type (float32 or bfloat16); the output takes q's type.  A row that sees
// no key at all comes out 0.  Keys at or past kv_len are never read.
//
//   Replaces: flash_attention_pallas / _flash_kernel
//             (src/repro/kernels/flash_attention/kernel.py:87 and :29).
//             That kernel takes q_offset and kv_len as trace-time
//             constants; here both are runtime ints, so one build serves
//             every decode position (the reference's jitted decode cannot
//             reach its kernel at all, ROADMAP C6).
//
// Each call is one launch of one of two kernels, chosen by Sq.  Both are
// built for (D, DV) in {(16, 16), (32, 32), (64, 64), (96, 64), (128, 128),
// (192, 128)}: the dense heads and MLA's heads (minicpm3's 64 + 32 / 64,
// deepseek-v3's 128 + 64 / 128), each read in place; the wrapper pads any
// other width with zero columns up to the next built pair.  q, k and v are
// read through their batch, head and row strides (the last axis has stride
// 1), so a permuted view, such as MLA's V straight from its einsum, or a
// head axis broadcast with stride 0, is read where it lies.  Q K^T runs over
// D columns, P V and the output over DV.  Results are the same bit for bit
// from call to call: every sum runs in a fixed order, with no atomics.
//
// decode_kernel (Sq < 16)
//   Bound:    bytes: each visible K/V row read once per KV head and batch
//             row (kv_len * (D + DV) * 4 bytes), against 2 * (D + DV)
//             operations per query head and key.
//   Design:   flash-decoding.  One block per (batch row, KV head, group of
//             R query rows), where the rows are the G query heads of the KV
//             head times the Sq positions, so every visible K/V row leaves
//             device memory once for all G heads.  The block's visible keys
//             are cut into tiles of 16; its 4 warps take every 4th tile,
//             and each warp streams its tiles through a private two-stage
//             cp.async ring in shared memory (16-byte copies, zero-filled
//             past the visible range), so all its loads are in flight
//             before their first use and only __syncwarp orders them.  A
//             warp's 8-lane groups score one key each (a lane holds 16-byte
//             chunks j, j + 8, ... of the row; three shuffles finish the dot)
//             and keep their own running (m, l, acc) per row.  The groups
//             merge by shuffles, the warps through shared memory, with the
//             log-sum-exp rescale in a fixed order; a partial that saw no
//             key (l = 0) gets weight 0.  While doubling the blocks still
//             leaves one block an SM and each block keeps 32 keys or more,
//             a thread-block cluster of 2 or 4 blocks splits the keys
//             further and the blocks merge through distributed shared
//             memory: still one launch (granite's decode at B 8: 64 blocks
//             alone up to 63 keys, clusters of 2 from 64).  D and DV are
//             template arguments, so every index and the copy loops'
//             divisions fold at compile time; a lane's K chunks and V
//             chunks are counted apart (D 96 is 24 float32 chunks, 3 a
//             lane; DV 64 is 16, 2 a lane).  R rows a block: 8 up to DV
//             64, 4 above (a lane's accumulators, R * DV / 8 floats, stay
//             at 64 or below).
//
// prefill_kernel (Sq >= 16)
//   Bound:    operations: 2 * (D + DV) per visible (query, key) pair, in
//             float32 on
//             the CUDA cores (67 TFLOP/s); bf16 inputs run the same float32
//             maths (their bound is the bf16 tensor-core rate, which this
//             kernel does not use).
//   Design:   one block of 128 threads per (64 query rows, query head,
//             batch row), the latest (heaviest causal) query tiles launched
//             first.  Q sits in shared memory pre-scaled; K and V tiles of
//             BN keys are double-buffered with cp.async (dynamic shared
//             memory past 48 KB), the K stage D wide and the V stage DV
//             wide.  BN is 64, and 32 at D 192, where 64-key float32 stages
//             would need 235,520 bytes, past the 232,448 a block may have
//             (32 keys: 143,360).  Each thread owns an 8 x BN/16 register
//             tile of S = Q K^T (rows rg + 8i, keys cg + 16t) and the same 8
//             rows of O (DV / 16 adjacent columns: 8 x 8 at DV 128, whatever
//             D is), so every shared-memory word it reads
//             feeds 8 or more FMAs; rows are padded by 16 bytes so the
//             16-byte reads are free of bank conflicts.  The row max comes
//             from shuffles among the 16 threads that share a row, and the
//             softmax runs in base 2 (q carries log2(e), exp2f is one MUFU
//             op plus fix-ups); each thread keeps its own partial row sum,
//             added up once at the end.
//             P goes through shared memory into O += P V.  Tiles wholly in
//             the causal future or before the window are never visited; only
//             a tile that crosses the diagonal, the window's edge or kv_len
//             is masked.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns the launch's error code so the Python wrapper can raise on a
// refused launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; zero-filled (nothing read) when
// !valid.  gmem must be a mapped address either way.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// N consecutive values from shared memory into float registers, with the
// widest aligned loads (the caller guarantees 4 * N-byte alignment for
// float and 2 * N-byte alignment for bfloat16).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      x[i] = f.x;
      x[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int hq, hkv, sq, skv, d, dv;
  int causal, window, q_offset, kv_len;
  float scale;
  // (batch, head, row) strides in elements, each below 2^31 (the wrapper
  // checks); products are taken in 64 bits.  32-bit fields: with 64-bit
  // ones in this struct the prefill ran 10-14 % slower (scripts/flash_ab.py)
  int q_st[3], k_st[3], v_st[3];
};

__device__ __forceinline__ long long at(int i, int stride) {
  return static_cast<long long>(i) * stride;
}

__device__ __forceinline__ bool visible(const Args& a, int key, int qpos,
                                        int key_end) {
  bool vis = key < key_end;
  if (a.causal) vis = vis && key <= qpos;
  if (a.window > 0) vis = vis && key > qpos - a.window;
  return vis;
}

// ---------------------------------------------------------------------------
// decode: Sq < 16
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecTile = 16;   // keys per warp tile: 4 per 8-lane group
constexpr int kDecStages = 2;  // cp.async ring depth per warp
constexpr int kMaxCluster = 4;
constexpr int kMinClusterKeys = 32;  // keys per block below which no split

template <typename T>
constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // values per chunk

__host__ __device__ inline size_t decode_smem(int r, int d, int dv, int elem) {
  return sizeof(float) * (static_cast<size_t>(r) * d  // q
                          + static_cast<size_t>(kDecWarps) * r * (dv + 4))  // partials
         + static_cast<size_t>(kDecWarps) * kDecStages * kDecTile * (d + dv) *
               elem;                                                  // ring
}

// R query rows per block, QK head dim D, V head dim DV; a lane holds NCH
// 16-byte chunks of a K row and NCHV of a V row (chunks j8, j8 + 8, ...).
template <typename T, int R, int D, int DV>
__global__ void __launch_bounds__(32 * kDecWarps)
    decode_kernel(Args a, int n_rg) {
  constexpr int EPC = kEpc<T>;
  constexpr int d = D;
  constexpr int nc = D / EPC;    // 16-byte chunks in a K row
  constexpr int NCH = (nc + 7) / 8;
  constexpr int ncv = DV / EPC;  // 16-byte chunks in a V row
  constexpr int NCHV = (ncv + 7) / 8;
  constexpr int kStage = kDecTile * (D + DV);  // one stage: K tile, V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);           // (R, d)
  float* part = qs + R * d;                  // (W, R, DV + 4): 16-byte rows
  T* ring = reinterpret_cast<T*>(part + kDecWarps * R * (DV + 4));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(cluster.num_blocks());

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 3;  // key slot of this lane in a 4-key step
  const int j8 = lane & 7;    // chunk slot within the row
  const int rg = blockIdx.y % n_rg;
  const int kvh = blockIdx.y / n_rg;
  const int bb = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int rows_total = group * a.sq;

  // this block's rows: flat = rg * R + r over (query head in group, position)
  int i_min = a.sq, i_max = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int flat = rg * R + r;
    if (flat < rows_total) {
      i_min = min(i_min, flat % a.sq);
      i_max = max(i_max, flat % a.sq);
    }
  }
  // the keys some row of this block may see: [k_lo, k_hi)
  const int key_end = min(a.skv, a.kv_len);
  int k_hi = key_end;
  if (a.causal) k_hi = min(k_hi, a.q_offset + i_max + 1);
  const int k_lo = a.window > 0 ? max(0, a.q_offset + i_min - a.window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kDecTile - 1) / kDecTile : 0;
  const int per_rank = (n_tiles + cl - 1) / cl;
  const int t_begin = rank * per_rank;
  const int t_end = min(n_tiles, t_begin + per_rank);
  // this warp's tiles: t_begin + warp, + kDecWarps, ...
  const int n_mine =
      t_end > t_begin + warp ? (t_end - t_begin - warp + kDecWarps - 1) / kDecWarps
                             : 0;

  const T* kb = static_cast<const T*>(a.k) + at(bb, a.k_st[0]) + at(kvh, a.k_st[1]);
  const T* vb = static_cast<const T*>(a.v) + at(bb, a.v_st[0]) + at(kvh, a.v_st[1]);
  T* my_ring = ring + static_cast<size_t>(warp) * kDecStages * kStage;

  auto issue = [&](int s) {  // the warp's s-th tile into stage s % kDecStages
    if (s < n_mine) {
      const int key0 = k_lo + (t_begin + warp + s * kDecWarps) * kDecTile;
      T* ks = my_ring + (s % kDecStages) * kStage;
      T* vs = ks + kDecTile * D;
      // a K chunk and, where V is as wide, the V chunk beside it
      for (int idx = lane; idx < kDecTile * nc; idx += 32) {
        const int j = idx / nc, c = idx - (idx / nc) * nc;
        const int key = key0 + j;
        const bool ok = key < k_hi;
        cp_async16(ks + j * D + c * EPC, kb + at(ok ? key : 0, a.k_st[2]) + c * EPC,
                   ok);
        if constexpr (D == DV)
          cp_async16(vs + j * DV + c * EPC,
                     vb + at(ok ? key : 0, a.v_st[2]) + c * EPC, ok);
      }
      if constexpr (D != DV) {
        for (int idx = lane; idx < kDecTile * ncv; idx += 32) {
          const int j = idx / ncv, c = idx - (idx / ncv) * ncv;
          const int key = key0 + j;
          const bool ok = key < k_hi;
          cp_async16(vs + j * DV + c * EPC,
                     vb + at(ok ? key : 0, a.v_st[2]) + c * EPC, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };
#pragma unroll
  for (int s = 0; s < kDecStages; ++s) issue(s);
  // q after the copies are in flight, so its loads overlap theirs
  const T* qg = static_cast<const T*>(a.q);
  for (int idx = tid; idx < R * d; idx += blockDim.x) {
    const int r = idx / d, e = idx - (idx / d) * d;
    const int flat = rg * R + r;
    float x = 0.f;
    if (flat < rows_total) {
      const int h = kvh * group + flat / a.sq;
      x = to_f32(qg[at(bb, a.q_st[0]) + at(h, a.q_st[1]) +
                    at(flat % a.sq, a.q_st[2]) + e]) * a.scale;
    }
    qs[idx] = x;
  }
  __syncthreads();  // qs is in

  float m[R], l[R], acc[R][NCHV][EPC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NCHV; ++i)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[r][i][e] = 0.f;
  }
  int qpos[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int flat = rg * R + r;
    live[r] = flat < rows_total;
    qpos[r] = a.q_offset + (live[r] ? flat % a.sq : 0);
  }

  for (int s = 0; s < n_mine; ++s) {
    cp_async_wait<kDecStages - 1>();
    __syncwarp();
    const T* ks = my_ring + (s % kDecStages) * kStage;
    const T* vs = ks + kDecTile * D;
    const int key0 = k_lo + (t_begin + warp + s * kDecWarps) * kDecTile;

    float sc[R][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = grp * 4 + t;
      float kr[NCH][EPC];
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = j8 + 8 * i;
        if (c < nc) {
          load_f32<EPC>(ks + j * d + c * EPC, kr[i]);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kr[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = j8 + 8 * i;
          if (c < nc) {
            float qv[EPC];
            load_f32<EPC>(qs + r * d + c * EPC, qv);
#pragma unroll
            for (int e = 0; e < EPC; ++e) dot = fmaf(qv[e], kr[i][e], dot);
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        sc[r][t] = dot;
      }
    }

    // scores become weights in place; acc is rescaled, then takes the four
    // keys in order (acc * alpha + p0 v0 + p1 v1 + ...), one V row at a time
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool vis[4];
      float mt = m[r];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        vis[t] = live[r] && visible(a, key0 + grp * 4 + t, qpos[r], k_hi);
        if (vis[t]) mt = fmaxf(mt, sc[r][t]);
      }
      const float alpha = expf(m[r] - mt);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        sc[r][t] = vis[t] ? expf(sc[r][t] - mt) : 0.f;
        psum += sc[r][t];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mt;
#pragma unroll
      for (int i = 0; i < NCHV; ++i)
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[r][i][e] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = grp * 4 + t;
#pragma unroll
      for (int i = 0; i < NCHV; ++i) {
        const int c = j8 + 8 * i;
        if (c < ncv) {
          float vr[EPC];
          load_f32<EPC>(vs + j * DV + c * EPC, vr);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              acc[r][i][e] = fmaf(sc[r][t], vr[e], acc[r][i][e]);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
    issue(s + kDecStages);
  }
  cp_async_wait<0>();

  // merge the warp's four key slots (lane groups), then park the result
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 8; off <= 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float wa = l[r] > 0.f ? expf(m[r] - mm) : 0.f;
      const float wb = lo > 0.f ? expf(mo - mm) : 0.f;
#pragma unroll
      for (int i = 0; i < NCHV; ++i)
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i][e], off);
          acc[r][i][e] = acc[r][i][e] * wa + ao * wb;
        }
      l[r] = l[r] * wa + lo * wb;
      m[r] = mm;
    }
    float* pr = part + (warp * R + r) * (DV + 4);
    if (lane == 0) {
      pr[0] = m[r];
      pr[1] = l[r];
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < NCHV; ++i) {
        const int c = j8 + 8 * i;
        if (c < ncv) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) pr[2 + c * EPC + e] = acc[r][i][e];
        }
      }
    }
  }
  cluster.sync();  // every partial of every block in the cluster is parked

  // each block of the cluster finishes a share of the (row, column) outputs,
  // merging the cluster's partials in (rank, warp) order
  T* og = static_cast<T*>(a.out);
  for (int idx = rank * blockDim.x + tid; idx < R * DV;
       idx += cl * blockDim.x) {
    const int r = idx / DV, col = idx - (idx / DV) * DV;
    const int flat = rg * R + r;
    if (flat >= rows_total) continue;
    float mm = kNegInf;
    for (int c = 0; c < cl; ++c) {
      const float* pc = cluster.map_shared_rank(part, c);
      for (int w = 0; w < kDecWarps; ++w) {
        const float* pr = pc + (w * R + r) * (DV + 4);
        if (pr[1] > 0.f) mm = fmaxf(mm, pr[0]);
      }
    }
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < cl; ++c) {
      const float* pc = cluster.map_shared_rank(part, c);
      for (int w = 0; w < kDecWarps; ++w) {
        const float* pr = pc + (w * R + r) * (DV + 4);
        const float wgt = pr[1] > 0.f ? expf(pr[0] - mm) : 0.f;
        ll = ll + pr[1] * wgt;
        aa = aa + pr[2 + col] * wgt;
      }
    }
    const int h = kvh * group + flat / a.sq;
    const long long row =
        (static_cast<long long>(bb) * a.hq + h) * a.sq + flat % a.sq;
    og[row * DV + col] = from_f32<T>(aa * (1.f / fmaxf(ll, 1e-30f)));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// prefill: Sq >= 16
// ---------------------------------------------------------------------------

constexpr int kBM = 64;  // query rows per block
constexpr int kPreThreads = 128;

// keys per tile: 64, or 32 where two 64-key float32 stages of D 192 would
// not fit a block's shared memory
__host__ __device__ constexpr int prefill_bn(int d) { return d > 128 ? 32 : 64; }
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));  // 16 bytes a row

__host__ __device__ inline size_t prefill_smem(int d, int dv, int elem) {
  const int pad = 16 / elem;
  const int bn = prefill_bn(d);
  return sizeof(float) * (static_cast<size_t>(kBM) * (d + 4)     // q
                          + static_cast<size_t>(kBM) * (bn + 4))  // p
         + static_cast<size_t>(2) * bn * (d + dv + 2 * pad) * elem;  // 2 x (k, v)
}

// QK width D, V width DV: DC = DV / 16 output columns per thread.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kPreThreads)
    prefill_kernel(Args a, int n_qt, int n_b) {
  constexpr int BN = prefill_bn(D);  // keys per tile
  constexpr int NT = BN / 16;        // keys per thread in a tile
  constexpr int DC = DV / 16;
  constexpr int QS = D + 4;          // q row stride (floats)
  constexpr int PS = BN + 4;         // p row stride (floats)
  constexpr int KS = D + kPad<T>;    // k row stride (elements)
  constexpr int VS = DV + kPad<T>;   // v row stride (elements)
  constexpr int EPC = kEpc<T>;
  constexpr int NC = D / EPC;        // 16-byte chunks in a K row
  constexpr int NCV = DV / EPC;      // 16-byte chunks in a V row
  constexpr int kStage = BN * (KS + VS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (kBM, QS)
  float* ps = qs + kBM * QS;                      // (kBM, PS)
  T* kv = reinterpret_cast<T*>(ps + kBM * PS);    // stage s: k, then v

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cgp = lane & 15;                       // key / column group
  const int rgp = (tid >> 5) * 2 + (lane >> 4);    // row group, 0..7
  const int hb = a.hq * n_b;                       // (head, batch row) pairs
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;  // heaviest first
  const int rem = static_cast<int>(blockIdx.x) % hb;
  const int h = rem % a.hq;
  const int bb = rem / a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int q0 = qt * kBM;

  const T* qg = static_cast<const T*>(a.q) + at(bb, a.q_st[0]) + at(h, a.q_st[1]);
  const T* kg = static_cast<const T*>(a.k) + at(bb, a.k_st[0]) + at(kvh, a.k_st[1]);
  const T* vg = static_cast<const T*>(a.v) + at(bb, a.v_st[0]) + at(kvh, a.v_st[1]);

  const int last_row = min(q0 + kBM, a.sq) - 1;
  const int key_end = min(a.skv, a.kv_len);
  int k_hi = key_end;
  if (a.causal) k_hi = min(k_hi, a.q_offset + last_row + 1);
  const int k_lo = a.window > 0 ? max(0, a.q_offset + q0 - a.window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int key0 = k_lo + t * BN;
      T* ks = kv + static_cast<size_t>(t & 1) * kStage;
      T* vs = ks + BN * KS;
      // a K chunk and, where V is as wide, the V chunk beside it
      for (int idx = tid; idx < BN * NC; idx += kPreThreads) {
        const int j = idx / NC, c = idx % NC;
        const int key = key0 + j;
        const bool ok = key < k_hi;
        cp_async16(ks + j * KS + c * EPC, kg + at(ok ? key : 0, a.k_st[2]) + c * EPC,
                   ok);
        if constexpr (D == DV)
          cp_async16(vs + j * VS + c * EPC,
                     vg + at(ok ? key : 0, a.v_st[2]) + c * EPC, ok);
      }
      if constexpr (D != DV) {
        for (int idx = tid; idx < BN * NCV; idx += kPreThreads) {
          const int j = idx / NCV, c = idx % NCV;
          const int key = key0 + j;
          const bool ok = key < k_hi;
          cp_async16(vs + j * VS + c * EPC,
                     vg + at(ok ? key : 0, a.v_st[2]) + c * EPC, ok);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);

  // q pre-scaled by log2(e) / sqrt(D): the softmax runs in base 2
  for (int idx = tid; idx < kBM * D; idx += kPreThreads) {
    const int r = idx / D, e = idx % D;
    qs[r * QS + e] = q0 + r < a.sq
        ? to_f32(qg[at(q0 + r, a.q_st[2]) + e]) * (a.scale * kLog2e) : 0.f;
  }

  float m[8], l[8], o[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile t (and, at t = 0, q) is in
    const T* ks = kv + static_cast<size_t>(t & 1) * kStage;
    const T* vs = ks + BN * KS;
    const int key0 = k_lo + t * BN;

    // S = Q K^T on the 8 x NT register tile, over D columns
    float s[8][NT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < NT; ++u) s[i][u] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float qv[8][4], kr[NT][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) load_f32<4>(qs + (rgp + 8 * i) * QS + e, qv[i]);
#pragma unroll
      for (int u = 0; u < NT; ++u) load_f32<4>(ks + (cgp + 16 * u) * KS + e, kr[u]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[i][u] = fmaf(qv[i][x], kr[u][x], s[i][u]);
    }

    // masks only where the tile crosses the diagonal, the window or kv_len
    const bool edge =
        key0 + BN > key_end ||
        (a.causal && key0 + BN - 1 > a.q_offset + q0) ||
        (a.window > 0 && key0 <= a.q_offset + q0 + kBM - 1 - a.window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = a.q_offset + q0 + rgp + 8 * i;
      bool vis[NT];
      float mt = kNegInf;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        vis[u] = !edge || visible(a, key0 + cgp + 16 * u, qpos, key_end);
        if (vis[u]) mt = fmaxf(mt, s[i][u]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      mt = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - mt);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const float p = vis[u] ? exp2f(s[i][u] - mt) : 0.f;
        psum += p;
        ps[(rgp + 8 * i) * PS + cgp + 16 * u] = p;
      }
      l[i] = l[i] * alpha + psum;
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // p is in

    // O += P V, over DV columns
#pragma unroll 4
    for (int j = 0; j < BN; j += 4) {
      float pv[8][4], vr[4][DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) load_f32<4>(ps + (rgp + 8 * i) * PS + j, pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) load_f32<DC>(vs + (j + u) * VS + cgp * DC, vr[u]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pv[i][u], vr[u][c], o[i][c]);
    }
    __syncthreads();  // every reader is done with this stage and with p
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(a.out) +
          (static_cast<long long>(bb) * a.hq + h) * a.sq * DV;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + rgp + 8 * i;
    if (row >= a.sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      og[static_cast<long long>(row) * DV + cgp * DC + c] = from_f32<T>(o[i][c] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// raise a kernel's dynamic shared-memory limit past the default 48 KB once
// (``allowed`` is that kernel's limit so far)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T, int R, int D, int DV>
cudaError_t launch_decode(const Args& a, int b, cudaStream_t stream) {
  const int rows_total = (a.hq / a.hkv) * a.sq;
  const int n_rg = (rows_total + R - 1) / R;
  // the widest key range of one block, for the cluster split
  const int key_end = a.skv < a.kv_len ? a.skv : a.kv_len;
  int hi = key_end;
  if (a.causal && a.q_offset + a.sq < hi) hi = a.q_offset + a.sq;
  int lo = a.window > 0 ? a.q_offset - a.window + 1 : 0;
  if (lo < 0) lo = 0;
  const int keys = hi - lo;
  const int base = b * a.hkv * n_rg;
  int cl = 1;
  while (cl < kMaxCluster && base * cl * 2 <= sm_count() &&
         keys >= cl * 2 * kMinClusterKeys) {
    cl *= 2;
  }
  const size_t smem = decode_smem(R, D, DV, sizeof(T));
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(decode_kernel<T, R, D, DV>, smem, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, n_rg * a.hkv, b);
  cfg.blockDim = dim3(32 * kDecWarps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_kernel<T, R, D, DV>, a, n_rg);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch_prefill(const Args& a, int b, cudaStream_t stream) {
  const int n_qt = (a.sq + kBM - 1) / kBM;
  const size_t smem = prefill_smem(D, DV, sizeof(T));
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(prefill_kernel<T, D, DV>, smem, allowed);
  if (e != cudaSuccess) return e;
  prefill_kernel<T, D, DV><<<n_qt * a.hq * b, kPreThreads, smem, stream>>>(
      a, n_qt, b);
  return cudaGetLastError();
}

// decode: R in {1, 4, 8} rows per block, at most 64 accumulators a lane
// (a lane holds DV / 8 output columns, 16 at DV 128: R <= 4 there)
int decode_r(int rows_total, int dv) {
  if (rows_total == 1) return 1;
  return rows_total <= 4 || dv > 64 ? 4 : 8;
}

template <typename T, int D, int DV>
cudaError_t decode_rows(const Args& a, int b, cudaStream_t stream) {
  switch (decode_r((a.hq / a.hkv) * a.sq, DV)) {
    case 1: return launch_decode<T, 1, D, DV>(a, b, stream);
    case 4: return launch_decode<T, 4, D, DV>(a, b, stream);
    default:
      if constexpr (DV <= 64) return launch_decode<T, 8, D, DV>(a, b, stream);
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  return a.sq >= 16 ? launch_prefill<T, D, DV>(a, b, stream)
                    : decode_rows<T, D, DV>(a, b, stream);
}

// the built (D, DV) pairs; any other is refused
template <typename T>
cudaError_t dispatch(const Args& a, int b, cudaStream_t stream) {
  if (a.dv == a.d) {
    switch (a.d) {
      case 16: return launch<T, 16, 16>(a, b, stream);
      case 32: return launch<T, 32, 32>(a, b, stream);
      case 64: return launch<T, 64, 64>(a, b, stream);
      case 128: return launch<T, 128, 128>(a, b, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.d == 96 && a.dv == 64) return launch<T, 96, 64>(a, b, stream);
  if (a.d == 192 && a.dv == 128) return launch<T, 192, 128>(a, b, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.  (d, dv), the
// widths of q and k and of v and out, is a built pair (dispatch); scale
// is 1 / sqrt(D) of the unpadded QK head dim.  strides: q's, k's and v's
// (batch, head, row) strides in elements, nine in all, each below 2^31 and
// each row 16-byte aligned; out is contiguous (B, Hq, Sq, dv).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int hkv, int sq, int skv, int d, int dv,
                    int causal, int window, int q_offset, int kv_len,
                    int dtype, float scale, const int* strides, void* stream) {
  if (hkv < 1 || hq % hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.dv = dv;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.q_st[i] = strides[i];
    a.k_st[i] = strides[3 + i];
    a.v_st[i] = strides[6 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, b, s));
  return static_cast<int>(dispatch<float>(a, b, s));
}

// The dynamic shared memory (bytes) of the launch flash_attention makes
// for these shapes: the build report prints it beside ptxas's figures.
int flash_attention_smem(int hq, int hkv, int sq, int d, int dv, int dtype) {
  const int elem = dtype == 1 ? 2 : 4;
  if (sq >= 16) return static_cast<int>(prefill_smem(d, dv, elem));
  return static_cast<int>(
      decode_smem(decode_r((hq / hkv) * sq, dv), d, dv, elem));
}

}  // extern "C"
