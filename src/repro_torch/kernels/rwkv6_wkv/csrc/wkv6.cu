// RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward, with the
// state carried in and out, so that a sequence split in two calls equals one
// call.
//
// Per (batch row, head), with a (Dk x Dv) float32 state S:
//   o_t = r_t^T (S + diag(u) k_t v_t^T)
//   S  <- diag(w_t) S + k_t v_t^T
// r, k, w are (BH, T, Dk), v is (BH, T, Dv), float32 or bfloat16; u is
// (H, Dk) and the states are (BH, Dk, Dv), both float32; o takes r's type.
//
// wkv6_kernel (the forward)
//   Replaces: wkv6_pallas / _wkv6_kernel
//             (src/repro/kernels/rwkv6_wkv/kernel.py:72 and :26), which
//             carries S in VMEM scratch across an in-order grid over time
//             tiles.  CUDA blocks run in no order, so the time loop lives
//             inside the block.
//   Bound:    bytes at decode (T = 1: the state is read and written once,
//             32 KB per head at 64 x 64, against 7 Dk Dv operations); a long
//             chunk by its 7 Dk Dv operations a step, none of which may be
//             fused (see Numbers).
//   Design:   one block per (batch row, head).  Each value column j has a
//             group of G lanes in one warp (G = 4 at Dk <= 64; past it 16
//             at Dv <= 64, else 8; 32 / G columns a warp), and lane g keeps rows [g R, g R + R) of
//             S[:, j] (R = Dk / G) in registers for the whole sequence, so
//             the state touches device memory only at the start and the
//             end, and a block has Dv G threads (256 at 64 x 64): 8 warps a
//             block where one thread a column gave 2, and every head's
//             block resident at once at decode (8 lanes took two waves
//             there).  r, k, w and v for a run of steps (16 at Dk 64) are
//             staged in shared memory by cp.async, double buffered, so the
//             next run's loads overlap this run's steps; a lane's R rows of
//             r, k and w are 16-byte vectors, laid out so that the G lanes
//             of a column read distinct bank groups.  o_t is staged too and
//             written a run at a time, coalesced.  Any T works (T = 1 is
//             decode); a ragged layout (a row not a multiple of 16 bytes) is
//             staged by plain loads into the same layout.
//   Numbers:  equal bit for bit to the plain version (ref.py), which fixes
//             the float32 evaluation order: every product and sum is rounded
//             on its own (__fmul_rn / __fadd_rn, never contracted to an FMA),
//             and o_t[j] sums r_i (S_ij + u_i kv_ij) over i in a pairwise tree
//             (Dk padded with zeros to a power of two).  Each lane builds the
//             pairwise tree of its R contiguous rows, and the G lanes merge
//             their block sums with __shfl_xor_sync at strides 1, 2, 4, ...:
//             a pairwise tree over contiguous power-of-two blocks is the same
//             tree, and a float sum commutes, so the result is the plain
//             version's bit for bit (the CPU tests emulate this order and
//             hold it equal to ref.tree_sum).  A random-weight 32-layer RWKV-6
//             amplifies a one-ulp difference about a thousandfold by its last
//             layer, so only bit equality lets a served run on the kernel
//             reproduce the plain run's tokens.  A chunked matmul form
//             (tensor cores over time tiles, as in chunked linear attention)
//             would change the rounding and break that equality: it is left
//             open for T > 1.
//
// wkv6_bwd_kernel and wkv6_bwd_finish (the backward)
//   Replaces: no TPU kernel.  It computes the VJP of wkv6_ref that the JAX
//             package's custom_vjp (src/repro/kernels/rwkv6_wkv/ops.py:57)
//             takes through XLA, one reverse scan, where the port otherwise
//             replays the plain recurrence as thousands of eager launches.
//             With g_t the cotangent of o_t and dS that of S_t (the final
//             state's at t = T), walking t from T down to 1:
//               dr_t[i] = sum_j g_t[j] S_{t-1}[i,j] + u_i k_i (g_t . v_t)
//               dk_t[i] = sum_j dS[i,j] v_t[j] + r_i u_i (g_t . v_t)
//               dv_t[j] = sum_i dS[i,j] k_i + g_t[j] sum_i r_i u_i k_i
//               dw_t[i] = sum_j dS[i,j] S_{t-1}[i,j]
//               du[i]  += r_i k_i (g_t . v_t)
//               dS      = r_t g_t^T + diag(w_t) dS
//             and dstate0 is the last dS.
//   Bound:    operations: about 14 a state cell and step (11 for the sums
//             above, 3 to rebuild S_{t-1}, which the forward does not keep).
//   Design:   S_{t-1} is rebuilt, never divided out of S_t (w reaches tiny
//             values).  A block takes one head's rows [i0, i0 + RB) and every
//             column (RB 32 at Dv <= 64, 16 up to 128); a thread holds one
//             row and 8 columns of S and of dS.  Phase A runs the forward
//             from state0 and writes the state at the start of every chunk of
//             8 steps to a scratch buffer (the caller's, (BH, row blocks,
//             ceil(T / 8), 2048) float32: 128 MB at (4, 64, 256, 64)).
//             Phase B walks the chunks in reverse: it rebuilds the chunk's 8
//             states from its checkpoint into shared memory (each thread its
//             own cells, 64 KB a block), then steps back through them.  The
//             row sums (dr, dk, dw) stay within a warp (a row's 8 or 16
//             lanes, xor shuffles); dv's column sums reduce the warp's rows
//             by a reduce-scatter of shuffles, then the 8 warps through
//             shared memory once a chunk.  Row blocks of one head write
//             partial dv, and batch rows partial du; wkv6_bwd_finish adds
//             them in a fixed order (no atomics), so two calls give the
//             same bits.  Accumulation is float32 (FMAs allowed: the
//             backward is held to 1e-5 of each leaf's largest value, not to
//             bit equality); each grad is written in its input's type.
//
// The C functions launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 128;
constexpr unsigned kFull = 0xffffffffu;

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
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T -> out[at], out[at + 1], ...
template <int N>
__device__ __forceinline__ void unpack16(const float* p, float (&out)[N],
                                         int at) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[at] = x.x;
  out[at + 1] = x.y;
  out[at + 2] = x.z;
  out[at + 3] = x.w;
}
template <int N>
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&out)[N], int at) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    *reinterpret_cast<unsigned*>(&pair) = words[q];
    const float2 f = __bfloat1622float2(pair);
    out[at + 2 * q] = f.x;
    out[at + 2 * q + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// DK: the padded row count (64 or 128); G: lanes a value column.
template <typename T, int DK, int G>
struct Fwd {
  using Type = T;
  static constexpr int kDk = DK, kG = G;
  static constexpr int R = DK / G;          // rows a lane keeps
  static constexpr int C = 32 / G;          // value columns a warp
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kBlockBytes = R * static_cast<int>(sizeof(T));
  static constexpr bool kVecBlock = kBlockBytes % 16 == 0;
  // a lane's block starts an odd number of 16-byte units after the last
  // one's, so the G lanes of a column read G distinct bank groups
  static constexpr int kPad = (kVecBlock && (kBlockBytes / 16) % 2 == 0)
                                  ? kVec : 0;
  static constexpr int kStride = R + kPad;  // elements, block to block
  static constexpr int kRow = G * kStride;  // elements, one staged step
  static constexpr int kSteps = DK == 64 ? 16 : 8;  // steps a stage
  static constexpr int SB = R < 8 ? R : 8;  // rows a sub-block of the tree
  static constexpr int NSB = R / SB;
  static constexpr int kMaxThreads = 128 * G < 1024 ? 128 * G : 1024;
  static_assert(R >= 1 && G <= 32 && 32 % G == 0, "lanes");
};

// A lane's R staged values of one step -> float.
template <typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, float (&out)[R]) {
  if constexpr (R * sizeof(T) % 16 == 0) {
    constexpr int kVec = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < R / kVec; ++q) unpack16(p + q * kVec, out, q * kVec);
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) out[m] = to_f32(p[m]);
  }
}

template <typename T, int DK, int G>
__global__ void __launch_bounds__(Fwd<T, DK, G>::kMaxThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ o, float* __restrict__ s_out, int n_heads,
            int t_len, int dk, int dv, int steps, int vstride, int stage_elems,
            int vec) {
  using F = Fwd<T, DK, G>;
  constexpr int R = F::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int g = lane / F::C;                         // row block of the lane
  const int j = (tid >> 5) * F::C + lane % F::C;     // value column
  const long long bh = blockIdx.x;
  const long long kbase = bh * t_len * dk;
  const long long vbase = bh * t_len * dv;

  // zero both stages: rows past dk and columns past dv stay zero
  for (int x = tid; x < 2 * stage_elems; x += nthreads) {
    smem[x] = from_f32<T>(0.f);
  }

  float s[R], uu[R];
  const float* s_in = s0 + bh * dk * dv;
  const float* u_h = u + (bh % n_heads) * dk;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int row = g * R + m;
    s[m] = (row < dk && j < dv) ? s_in[row * dv + j] : 0.f;
    uu[m] = row < dk ? u_h[row] : 0.f;
  }
  __syncthreads();

  // stage steps [chunk * steps, +n) of r, k, w and v into stage `buf`
  auto stage = [&](int chunk, int buf) {
    const int t0 = chunk * steps;
    const int n = min(steps, t_len - t0);
    T* base = smem + buf * stage_elems;
    T* vs = base + 3 * steps * F::kRow;
    const long long k0 = kbase + static_cast<long long>(t0) * dk;
    const long long v0 = vbase + static_cast<long long>(t0) * dv;
    if (vec) {
      const int per_row = dk / F::kVec, total = n * per_row;
      for (int x = tid; x < 3 * total; x += nthreads) {
        const int a = x / total, y = x - a * total;
        const int tt = y / per_row, e = (y - tt * per_row) * F::kVec;
        const T* src = (a == 0 ? r : a == 1 ? k : w) + k0 + tt * dk + e;
        cp_async16(base + (a * steps + tt) * F::kRow + (e / R) * F::kStride +
                       e % R,
                   src);
      }
      const int v_row = dv / F::kVec;
      for (int x = tid; x < n * v_row; x += nthreads) {
        const int tt = x / v_row, e = (x - tt * v_row) * F::kVec;
        cp_async16(vs + tt * vstride + e, v + v0 + tt * dv + e);
      }
    } else {
      const int total = n * dk;
      for (int x = tid; x < 3 * total; x += nthreads) {
        const int a = x / total, y = x - a * total;
        const int tt = y / dk, e = y - tt * dk;
        const T* src = (a == 0 ? r : a == 1 ? k : w) + k0 + y;
        base[(a * steps + tt) * F::kRow + (e / R) * F::kStride + e % R] = *src;
      }
      for (int x = tid; x < n * dv; x += nthreads) {
        const int tt = x / dv;
        vs[tt * vstride + x - tt * dv] = v[v0 + x];
      }
    }
    cp_async_commit();
  };

  const int n_chunks = (t_len + steps - 1) / steps;
  if (n_chunks > 0) stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    if (c + 1 < n_chunks) {
      stage(c + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage `cur` has landed for every thread
    const T* rs = smem + cur * stage_elems;
    const T* vs = rs + 3 * steps * F::kRow;
    T* os = const_cast<T*>(vs) + steps * vstride;
    const int t0 = c * steps;
    const int n = min(steps, t_len - t0);
    for (int tt = 0; tt < n; ++tt) {
      const float vj = to_f32(vs[tt * vstride + j]);
      const int at = tt * F::kRow + g * F::kStride;
      // the lane's rows in sub-blocks of SB, each summed by the plain
      // version's levels (p[0::2] + p[1::2]), then merged as a binary
      // counter: sub-block sb closes one merge per trailing one bit of sb
      float stack[log2_of(F::NSB) + 1];
#pragma unroll
      for (int sb = 0; sb < F::NSB; ++sb) {
        constexpr int SB = F::SB;
        float rr[SB], kk[SB], ww[SB], term[SB];
        load_rows<T, SB>(rs + at + sb * SB, rr);
        load_rows<T, SB>(rs + steps * F::kRow + at + sb * SB, kk);
        load_rows<T, SB>(rs + 2 * steps * F::kRow + at + sb * SB, ww);
#pragma unroll
        for (int m = 0; m < SB; ++m) {
          const int x = sb * SB + m;
          const float kv = __fmul_rn(kk[m], vj);
          const float a = __fadd_rn(s[x], __fmul_rn(uu[x], kv));
          term[m] = __fmul_rn(rr[m], a);
          s[x] = __fadd_rn(__fmul_rn(ww[m], s[x]), kv);
        }
#pragma unroll
        for (int lv = 0; lv < log2_of(SB); ++lv) {
#pragma unroll
          for (int m = 0; m < (SB >> (lv + 1)); ++m) {
            term[m] = __fadd_rn(term[2 * m], term[2 * m + 1]);
          }
        }
        float t = term[0];
        int level = 0;
#pragma unroll
        for (int l = 0; l < log2_of(F::NSB); ++l) {
          if (((sb >> l) & 1) == 0) break;
          t = __fadd_rn(stack[l], t);
          level = l + 1;
        }
        stack[level] = t;
      }
      // the G lanes' blocks: the tree's top levels
      float acc = stack[log2_of(F::NSB)];
#pragma unroll
      for (int stride = 1; stride < G; stride <<= 1) {
        acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, stride * F::C));
      }
      if (g == 0 && j < dv) os[tt * vstride + j] = from_f32<T>(acc);
    }
    __syncthreads();  // every step of the run is done with stage `cur`
    T* o_run = o + vbase + static_cast<long long>(t0) * dv;
    for (int x = tid; x < n * dv; x += nthreads) {
      const int tt = x / dv;
      o_run[x] = os[tt * vstride + x - tt * dv];
    }
  }

  float* s_fin = s_out + bh * dk * dv;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int row = g * R + m;
    if (row < dk && j < dv) s_fin[row * dv + j] = s[m];
  }
}

struct FwdPlan {
  int threads, steps, vstride, stage_elems;
  size_t smem;
};

template <typename F>
FwdPlan fwd_plan(int t_len, int dv) {
  FwdPlan p;
  const int ncols = round_up(dv, F::C);
  p.threads = ncols * F::kG;
  p.steps = t_len < F::kSteps ? (t_len > 0 ? t_len : 1) : F::kSteps;
  p.vstride = round_up(ncols, F::kVec);
  p.stage_elems = round_up(3 * p.steps * F::kRow + 2 * p.steps * p.vstride,
                           F::kVec);
  p.smem = 2 * static_cast<size_t>(p.stage_elems) * sizeof(typename F::Type);
  return p;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename F>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* o,
                       void* s_out, long long bh, int n_heads, int t_len,
                       int dk, int dv, cudaStream_t stream) {
  using T = typename F::Type;
  auto* const kernel = &wkv6_kernel<T, F::kDk, F::kG>;
  const FwdPlan p = fwd_plan<F>(t_len, dv);
  if (p.threads > F::kMaxThreads) return cudaErrorInvalidConfiguration;
  static size_t smem_set = 48 * 1024;
  if (p.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
    smem_set = p.smem;
  }
  const bool vec = F::kVecBlock && (dk * sizeof(T)) % 16 == 0 &&
                   (dv * sizeof(T)) % 16 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(v) && aligned16(w);
  kernel<<<static_cast<unsigned>(bh), p.threads, p.smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_out), n_heads, t_len, dk, dv,
      p.steps, p.vstride, p.stage_elems, vec ? 1 : 0);
  return cudaGetLastError();
}

// G from Dk and Dv: 4 lanes at Dk <= 64 (16 rows a lane), which fit every
// head's block in one wave at decode and beat 8 and 16 at the training
// chunk on the H100; past 64, 8 rows a lane: 16 lanes while Dv <= 64 (Dv x
// 16 <= 1024 threads), else 8.  Calls fn with the Fwd<T, DK, G> of the
// variant.
template <typename T, typename Fn>
cudaError_t with_fwd(int dk, int dv, Fn fn) {
  if (dk <= 64) return fn(Fwd<T, 64, 4>{});
  if (dv <= 64) return fn(Fwd<T, 128, 16>{});
  return fn(Fwd<T, 128, 8>{});
}

template <typename T>
cudaError_t dispatch_fwd(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* o,
                         void* s_out, long long bh, int n_heads, int t_len,
                         int dk, int dv, cudaStream_t s) {
  return with_fwd<T>(dk, dv, [&](auto f) {
    return launch_fwd<decltype(f)>(r, k, v, w, u, s0, o, s_out, bh, n_heads,
                                   t_len, dk, dv, s);
  });
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdSteps = 8;   // states a chunk rebuilds into shared memory
constexpr int kBwdCells = 8;   // cells a thread: one row, 8 columns
constexpr int kBwdBlockCells = kBwdThreads * kBwdCells;

// DVP: the padded column count (64 or 128).
template <int DVP>
struct Bwd {
  static constexpr int L = DVP / kBwdCells;   // lanes a row (8 or 16)
  static constexpr int RW = 32 / L;           // rows a warp (4 or 2)
  static constexpr int W = kBwdThreads / 32;  // warps a block
  static constexpr int RB = W * RW;           // rows a block (32 or 16)
  // shared memory, in floats
  static constexpr int kStash = kBwdSteps * kBwdBlockCells;
  static constexpr int kRows = kBwdSteps * RB;   // one of r, k, w
  static constexpr int kCols = kBwdSteps * DVP;  // one of v, g
  static constexpr int kFloats = kStash + 3 * kRows + 2 * kCols + RB +
                                 2 * kBwdSteps + kBwdSteps * W * DVP +
                                 3 * kRows;
  static_assert(W == kBwdSteps, "one warp a step for the step sums");
};

// the 8 columns of lane p of a row: two runs of 4 (16-byte reads of v and g
// from shared memory, the row's lanes on consecutive words)
template <int L>
__device__ __forceinline__ int bwd_col(int p, int c) {
  return (c / 4) * (4 * L) + 4 * p + (c % 4);
}

template <typename T, int DVP>
__global__ void __launch_bounds__(kBwdThreads, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ go, const float* __restrict__ gs,
                float* __restrict__ ckpt, T* __restrict__ dr,
                T* __restrict__ dk_out, T* __restrict__ dw,
                float* __restrict__ dv_part, float* __restrict__ du_part,
                float* __restrict__ ds0, int n_heads, int t_len, int dk,
                int dv, int n_rb, long long n_bh) {
  using B = Bwd<DVP>;
  constexpr int L = B::L, RB = B::RB, W = B::W;
  extern __shared__ __align__(16) float sm[];
  float* stash = sm;
  float* rs = stash + B::kStash;
  float* ks = rs + B::kRows;
  float* ws = ks + B::kRows;
  float* vs = ws + B::kRows;
  float* gsh = vs + B::kCols;
  float* us = gsh + B::kCols;
  float* gvs = us + RB;
  float* ruks = gvs + kBwdSteps;
  float* dvs = ruks + kBwdSteps;
  float* outs = dvs + kBwdSteps * W * DVP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane / L, p = lane % L;
  const int li = warp * B::RW + q;  // the thread's row in the block
  const long long bh = blockIdx.x / n_rb;
  const int rb = blockIdx.x % n_rb;
  const int i0 = rb * RB;
  const int i = i0 + li;
  const bool row_ok = i < dk;
  const long long kbase = bh * t_len * dk;
  const long long vbase = bh * t_len * dv;
  const long long cell0 = (bh * dk + i) * dv;

  for (int x = tid; x < RB; x += kBwdThreads) {
    us[x] = i0 + x < dk ? u[(bh % n_heads) * dk + i0 + x] : 0.f;
  }
  float s[kBwdCells];
#pragma unroll
  for (int c = 0; c < kBwdCells; ++c) {
    const int j = bwd_col<L>(p, c);
    s[c] = (s0 != nullptr && row_ok && j < dv) ? s0[cell0 + j] : 0.f;
  }

  // rows [i0, i0 + RB) of r/k/w and every column of v/g, steps [t0, t0 + n)
  auto stage_rows = [&](const T* src, float* dst, int t0, int n) {
    for (int x = tid; x < n * RB; x += kBwdThreads) {
      const int m = x / RB, lr = x - m * RB;
      dst[m * RB + lr] = i0 + lr < dk
          ? to_f32(src[kbase + static_cast<long long>(t0 + m) * dk + i0 + lr])
          : 0.f;
    }
  };
  auto stage_cols = [&](const T* src, float* dst, int t0, int n) {
    for (int x = tid; x < n * DVP; x += kBwdThreads) {
      const int m = x / DVP, j = x - m * DVP;
      dst[m * DVP + j] = (src != nullptr && j < dv)
          ? to_f32(src[vbase + static_cast<long long>(t0 + m) * dv + j])
          : 0.f;
    }
  };

  // phase A: the forward, the state at the start of every chunk saved
  const int n_ck = (t_len + kBwdSteps - 1) / kBwdSteps;
  float* ck = ckpt + (bh * n_rb + rb) * static_cast<long long>(n_ck) *
                         kBwdBlockCells;
  for (int c = 0; c < n_ck; ++c) {
#pragma unroll
    for (int cc = 0; cc < kBwdCells; ++cc) {
      ck[static_cast<long long>(c) * kBwdBlockCells + cc * kBwdThreads + tid] =
          s[cc];
    }
    if (c + 1 == n_ck) break;  // the last chunk's steps are not needed here
    const int t0 = c * kBwdSteps;
    __syncthreads();  // the last chunk's readers are done
    stage_rows(k, ks, t0, kBwdSteps);
    stage_rows(w, ws, t0, kBwdSteps);
    stage_cols(v, vs, t0, kBwdSteps);
    __syncthreads();
    for (int m = 0; m < kBwdSteps; ++m) {
      const float ki = ks[m * RB + li], wi = ws[m * RB + li];
#pragma unroll
      for (int cc = 0; cc < kBwdCells; ++cc) {
        const float kv = __fmul_rn(ki, vs[m * DVP + bwd_col<L>(p, cc)]);
        s[cc] = __fadd_rn(__fmul_rn(wi, s[cc]), kv);
      }
    }
  }

  // phase B: the chunks in reverse
  float d[kBwdCells];  // dS: the cotangent of the state after the step
#pragma unroll
  for (int c = 0; c < kBwdCells; ++c) {
    const int j = bwd_col<L>(p, c);
    d[c] = (gs != nullptr && row_ok && j < dv) ? gs[cell0 + j] : 0.f;
  }
  float du_acc = 0.f;
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kBwdSteps;
    const int n = min(kBwdSteps, t_len - t0);
    __syncthreads();  // the last chunk's readers of the staged arrays are done
    stage_rows(r, rs, t0, n);
    stage_rows(k, ks, t0, n);
    stage_rows(w, ws, t0, n);
    stage_cols(v, vs, t0, n);
    stage_cols(go, gsh, t0, n);
    __syncthreads();
    // warp m: the step's g . v and the block rows' sum of r u k
    if (warp < n) {
      float gv = 0.f, ruk = 0.f;
      for (int x = lane; x < DVP; x += 32) {
        gv = fmaf(gsh[warp * DVP + x], vs[warp * DVP + x], gv);
      }
      for (int x = lane; x < RB; x += 32) {
        ruk = fmaf(rs[warp * RB + x] * us[x], ks[warp * RB + x], ruk);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        gv += __shfl_xor_sync(kFull, gv, off);
        ruk += __shfl_xor_sync(kFull, ruk, off);
      }
      if (lane == 0) {
        gvs[warp] = gv;
        ruks[warp] = ruk;
      }
    }
    // rebuild the chunk's states S_{t-1} into the thread's own stash cells
    const float* ckc = ck + static_cast<long long>(c) * kBwdBlockCells;
#pragma unroll
    for (int cc = 0; cc < kBwdCells; ++cc) s[cc] = ckc[cc * kBwdThreads + tid];
    for (int m = 0; m < n; ++m) {
      const float ki = ks[m * RB + li], wi = ws[m * RB + li];
#pragma unroll
      for (int cc = 0; cc < kBwdCells; ++cc) {
        stash[(m * kBwdCells + cc) * kBwdThreads + tid] = s[cc];
        const float kv = __fmul_rn(ki, vs[m * DVP + bwd_col<L>(p, cc)]);
        s[cc] = __fadd_rn(__fmul_rn(wi, s[cc]), kv);
      }
    }
    __syncthreads();  // gvs and ruks
    const float u_i = us[li];
    for (int m = n - 1; m >= 0; --m) {
      const float r_i = rs[m * RB + li], k_i = ks[m * RB + li];
      const float w_i = ws[m * RB + li];
      float acc_r = 0.f, acc_w = 0.f, acc_k = 0.f, col[kBwdCells];
#pragma unroll
      for (int cc = 0; cc < kBwdCells; ++cc) {
        const int j = bwd_col<L>(p, cc);
        const float sp = stash[(m * kBwdCells + cc) * kBwdThreads + tid];
        const float gj = gsh[m * DVP + j], vj = vs[m * DVP + j];
        acc_r = fmaf(gj, sp, acc_r);
        acc_w = fmaf(d[cc], sp, acc_w);
        acc_k = fmaf(d[cc], vj, acc_k);
        col[cc] = d[cc] * k_i;
        d[cc] = fmaf(w_i, d[cc], r_i * gj);
      }
      // row sums over the row's L lanes
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        acc_r += __shfl_xor_sync(kFull, acc_r, off);
        acc_w += __shfl_xor_sync(kFull, acc_w, off);
        acc_k += __shfl_xor_sync(kFull, acc_k, off);
      }
      const float gv = gvs[m];
      if (p == 0) {
        outs[m * RB + li] = acc_r + u_i * k_i * gv;
        outs[B::kRows + m * RB + li] = acc_k + r_i * u_i * gv;
        outs[2 * B::kRows + m * RB + li] = acc_w;
      }
      du_acc = fmaf(r_i * k_i, gv, du_acc);
      // column sums over the warp's RW rows: a reduce-scatter, each level
      // keeps half of the values and sends the other half to its partner
      int keep = 0;
#pragma unroll
      for (int lv = 0; lv < log2_of(B::RW); ++lv) {
        const int stride = B::RW >> (lv + 1);
        const int half = kBwdCells >> (lv + 1);
        const bool upper = (q & stride) != 0;
#pragma unroll
        for (int x = 0; x < half; ++x) {
          const float send = upper ? col[x] : col[x + half];
          const float mine = upper ? col[x + half] : col[x];
          col[x] = mine + __shfl_xor_sync(kFull, send, stride * L);
        }
        if (upper) keep += half;
      }
#pragma unroll
      for (int x = 0; x < kBwdCells / B::RW; ++x) {
        dvs[(m * W + warp) * DVP + bwd_col<L>(p, keep + x)] = col[x];
      }
    }
    __syncthreads();  // outs and dvs are complete
    for (int x = tid; x < 3 * n * RB; x += kBwdThreads) {
      const int a = x / (n * RB), y = x - a * n * RB;
      const int m = y / RB, lr = y - m * RB;
      if (i0 + lr < dk) {
        T* dst = a == 0 ? dr : a == 1 ? dk_out : dw;
        dst[kbase + static_cast<long long>(t0 + m) * dk + i0 + lr] =
            from_f32<T>(outs[a * B::kRows + m * RB + lr]);
      }
    }
    float* dvp = dv_part + (rb * n_bh + bh) * t_len * dv;
    for (int x = tid; x < n * DVP; x += kBwdThreads) {
      const int m = x / DVP, j = x - m * DVP;
      if (j < dv) {
        float a = 0.f;
#pragma unroll
        for (int ww = 0; ww < W; ++ww) a += dvs[(m * W + ww) * DVP + j];
        dvp[static_cast<long long>(t0 + m) * dv + j] =
            fmaf(gsh[m * DVP + j], ruks[m], a);
      }
    }
  }
  if (p == 0 && row_ok) du_part[bh * dk + i] = du_acc;
  if (ds0 != nullptr) {
#pragma unroll
    for (int c = 0; c < kBwdCells; ++c) {
      const int j = bwd_col<L>(p, c);
      if (row_ok && j < dv) ds0[cell0 + j] = d[c];
    }
  }
}

// dv = the row blocks' partial dv, in row-block order; du[h] = the batch
// rows' partial du, in batch order.
template <typename T>
__global__ void wkv6_bwd_finish(const float* __restrict__ dv_part,
                                T* __restrict__ dv, long long n_dv, int n_rb,
                                const float* __restrict__ du_part,
                                float* __restrict__ du, int batch, int hdk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long x = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       x < n_dv; x += stride) {
    float a = 0.f;
    for (int rb = 0; rb < n_rb; ++rb) a += dv_part[rb * n_dv + x];
    dv[x] = from_f32<T>(a);
  }
  for (long long x = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       x < hdk; x += stride) {
    float a = 0.f;
    for (int b = 0; b < batch; ++b) {
      a += du_part[b * static_cast<long long>(hdk) + x];
    }
    du[x] = a;
  }
}

template <int DVP>
size_t bwd_smem() {
  return static_cast<size_t>(Bwd<DVP>::kFloats) * sizeof(float);
}

int bwd_rows(int dv) { return dv <= 64 ? Bwd<64>::RB : Bwd<128>::RB; }

template <typename T, int DVP>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       const void* go, const void* gs, void* ckpt, void* dr,
                       void* dk_out, void* dv_out, void* dw, void* dv_part,
                       void* du_part, void* du, void* ds0, long long bh,
                       int n_heads, int t_len, int dk, int dv,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem<DVP>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_rb = (dk + Bwd<DVP>::RB - 1) / Bwd<DVP>::RB;
  wkv6_bwd_kernel<T, DVP><<<static_cast<unsigned>(bh * n_rb), kBwdThreads,
                            smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const T*>(go), static_cast<const float*>(gs),
      static_cast<float*>(ckpt), static_cast<T*>(dr), static_cast<T*>(dk_out),
      static_cast<T*>(dw), static_cast<float*>(dv_part),
      static_cast<float*>(du_part), static_cast<float*>(ds0), n_heads, t_len,
      dk, dv, n_rb, bh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_dv = bh * t_len * dv;
  const int hdk = n_heads * dk;
  const long long work = n_dv > hdk ? n_dv : hdk;
  const int blocks = static_cast<int>(
      work / 256 + 1 < 4096 ? work / 256 + 1 : 4096);
  wkv6_bwd_finish<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(dv_part), static_cast<T*>(dv_out), n_dv, n_rb,
      static_cast<const float*>(du_part), static_cast<float*>(du),
      static_cast<int>(bh / n_heads), hdk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w and o); u and the states float32.
int wkv6(const void* r, const void* k, const void* v, const void* w,
         const void* u, const void* s0, void* o, void* s_out, long long bh,
         int n_heads, int t_len, int dk, int dv, int dtype, void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || n_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(dispatch_fwd<__nv_bfloat16>(
        r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len, dk, dv, s));
  }
  return static_cast<int>(dispatch_fwd<float>(
      r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len, dk, dv, s));
}

// The backward's scratch: returns the float32 count of the checkpoint
// buffer and writes the row blocks a head takes to *n_rb (dv_part is
// (n_rb, BH, T, Dv) float32, du_part (BH, Dk) float32).
long long wkv6_backward_scratch(long long bh, int t_len, int dk, int dv,
                                int* n_rb) {
  const int rows = bwd_rows(dv);
  *n_rb = (dk + rows - 1) / rows;
  const long long n_ck = (t_len + kBwdSteps - 1) / kBwdSteps;
  return bh * *n_rb * n_ck * kBwdBlockCells;
}

// go (the cotangent of o, r's type), gs (of the final state), s0 and ds0
// may be null.  dr, dk_out, dv_out and dw take r's type; du is (H, Dk)
// float32.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* go,
                  const void* gs, void* ckpt, void* dr, void* dk_out,
                  void* dv_out, void* dw, void* dv_part, void* du_part,
                  void* du, void* ds0, long long bh, int n_heads, int t_len,
                  int dk, int dv, int dtype, void* stream) {
  if (dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim || n_heads < 1 ||
      bh % n_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(
        dv <= 64 ? launch_bwd<__nv_bfloat16, 64>(
                       r, k, v, w, u, s0, go, gs, ckpt, dr, dk_out, dv_out, dw,
                       dv_part, du_part, du, ds0, bh, n_heads, t_len, dk, dv, s)
                 : launch_bwd<__nv_bfloat16, 128>(
                       r, k, v, w, u, s0, go, gs, ckpt, dr, dk_out, dv_out, dw,
                       dv_part, du_part, du, ds0, bh, n_heads, t_len, dk, dv,
                       s));
  }
  return static_cast<int>(
      dv <= 64 ? launch_bwd<float, 64>(r, k, v, w, u, s0, go, gs, ckpt, dr,
                                       dk_out, dv_out, dw, dv_part, du_part,
                                       du, ds0, bh, n_heads, t_len, dk, dv, s)
               : launch_bwd<float, 128>(r, k, v, w, u, s0, go, gs, ckpt, dr,
                                        dk_out, dv_out, dw, dv_part, du_part,
                                        du, ds0, bh, n_heads, t_len, dk, dv,
                                        s));
}

}  // extern "C"
