// Flash attention for Hopper (sm_90a): causal GQA attention with a
// streaming softmax, the forward pass of the LM substrate's attention.
//
// out[b, h, i] = softmax_j(q[b, h, i] . k[b, h/G, j] / sqrt(D)) v[b, h/G, j]
// over the keys j that row i may see: j < kv_len, j <= q_offset + i when
// causal, j > q_offset + i - window when a window is set.  A masked score
// is -1e30, as in the Pallas kernel, and the sums run in float32 whatever
// the input type (float32 or bfloat16); the output takes q's type.
//
// flash_attention_kernel
//   Replaces: flash_attention_pallas / _flash_kernel
//             (src/repro/kernels/flash_attention/kernel.py:87 and :29).
//             That kernel takes q_offset and kv_len as trace-time
//             constants; here both are runtime ints, so one build serves
//             every decode position (the reference's jitted decode cannot
//             reach its kernel at all, ROADMAP C6).
//   Bound:    bytes at decode (Sq = 1: read each visible K/V row once,
//             about 2 * kv_len * D * 4 bytes per KV head and batch row,
//             against 4 * D operations per query head); operations in a
//             long prefill (4 * D per visible (query, key) pair, in float32
//             on the CUDA cores, against 67 TFLOP/s).
//   Design:   one block per (batch row, query head, tile of R * W query
//             rows); each of the W warps owns R rows, whose running max m,
//             sum l and D-wide accumulator live in registers (lane l holds
//             columns l, l + 32, ...).  The block walks the keys in tiles of
//             32: K and V are staged in shared memory in float32 (K rows
//             padded to D + 1 words, so lane j reading key j is free of bank
//             conflicts), lane j scores key j for each of its warp's rows,
//             warp shuffles give the tile's max and sum, and the P V product
//             broadcasts p_j with a shuffle against V's row j.  GQA reads KV
//             head h / G and never copies K or V.  Tiles that no row of the
//             block can see (past kv_len, in the causal future, before the
//             window) are skipped; a skipped tile changes nothing for a row
//             that sees any key, because a masked key's weight is
//             exp(-1e30 - m) = 0 once m is a real score.  Decode gets one
//             warp per (b, h); grouping a KV head's G query heads in one
//             block, wgmma and TMA are later work.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileK = 32;   // keys per shared-memory tile: one per lane
constexpr int kMaxD = 128;   // head dims per lane: kMaxD / 32
constexpr int kMaxWarps = 4;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// R query rows per warp; blockDim.x = 32 * W with W <= kMaxWarps.
template <typename T, int R>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int hq, int hkv,
                                       int sq, int skv, int d, int causal,
                                       int window, int q_offset, int kv_len,
                                       float scale) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x >> 5;
  const int rows = R * n_warps;          // query rows of this block
  float* qs = smem;                      // (rows, d), pre-scaled
  float* ks = qs + rows * d;             // (kTileK, d + 1)
  float* vs = ks + kTileK * (d + 1);     // (kTileK, d)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bb = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * rows;

  const T* qb = q + (static_cast<long long>(bb) * hq + h) * sq * d;
  const T* kb = k + (static_cast<long long>(bb) * hkv + kvh) * skv * d;
  const T* vb = v + (static_cast<long long>(bb) * hkv + kvh) * skv * d;
  T* ob = out + (static_cast<long long>(bb) * hq + h) * sq * d;

  for (int idx = tid; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d;
    qs[idx] = (q0 + r < sq) ? to_f32(qb[(q0 + r) * d + idx % d]) * scale : 0.f;
  }

  // the keys some row of this block may see: [k_lo, k_hi)
  const int last_row = min(q0 + rows, sq) - 1;
  int k_hi = min(skv, kv_len);
  if (causal) k_hi = min(k_hi, q_offset + last_row + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int key_end = min(skv, kv_len);

  float m[R], l[R], acc[R][kMaxD / 32];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (k_lo / kTileK) * kTileK; t0 < k_hi; t0 += kTileK) {
    __syncthreads();  // the previous tile's readers are done (and qs is in)
    for (int idx = tid; idx < kTileK * d; idx += blockDim.x) {
      const int j = idx / d, e = idx % d;
      const bool in = t0 + j < skv;
      ks[j * (d + 1) + e] = in ? to_f32(kb[(t0 + j) * d + e]) : 0.f;
      vs[idx] = in ? to_f32(vb[(t0 + j) * d + e]) : 0.f;
    }
    __syncthreads();

    const int key = t0 + lane;
    const float* krow = ks + lane * (d + 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = warp * R + i;
      const int qpos = q_offset + q0 + row;
      const float* qrow = qs + row * d;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(qrow[e], krow[e], s);
      bool visible = key < key_end;
      if (causal) visible = visible && key <= qpos;
      if (window > 0) visible = visible && key > qpos - window;
      s = visible ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxD / 32; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = vs + j * d;
#pragma unroll
        for (int c = 0; c < kMaxD / 32; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[i][c] = fmaf(pj, vrow[col], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qrow = q0 + warp * R + i;
    if (qrow >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) {
      const int col = lane + 32 * c;
      if (col < d) ob[qrow * d + col] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int hq, int hkv, int sq, int skv, int d, int causal,
                   int window, int q_offset, int kv_len, cudaStream_t stream) {
  const int warps = std::min(kMaxWarps, (sq + R - 1) / R);
  const int rows = R * warps;
  const dim3 grid((sq + rows - 1) / rows, hq, b);
  const size_t smem =
      sizeof(float) * (rows * d + kTileK * (d + 1) + kTileK * d);
  flash_attention_kernel<T, R><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, d,
      causal, window, q_offset, kv_len, 1.f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          void* out, int b, int hq, int hkv, int sq, int skv,
                          int d, int causal, int window, int q_offset,
                          int kv_len, cudaStream_t stream) {
  if (sq >= 16) {
    return launch<T, 4>(q, k, v, out, b, hq, hkv, sq, skv, d, causal, window,
                        q_offset, kv_len, stream);
  }
  return launch<T, 1>(q, k, v, out, b, hq, hkv, sq, skv, d, causal, window,
                      q_offset, kv_len, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int hkv, int sq, int skv, int d,
                    int causal, int window, int q_offset, int kv_len,
                    int dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || hq % hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(dispatch_rows<__nv_bfloat16>(
        q, k, v, out, b, hq, hkv, sq, skv, d, causal, window, q_offset,
        kv_len, s));
  }
  return static_cast<int>(dispatch_rows<float>(q, k, v, out, b, hq, hkv, sq,
                                               skv, d, causal, window,
                                               q_offset, kv_len, s));
}

}  // extern "C"
