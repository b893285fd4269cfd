// RWKV-6 WKV recurrence for Hopper (sm_90a), with the state carried in and
// out, so that a sequence split in two calls equals one call.
//
// Per (batch row, head), with a (Dk x Dv) float32 state S:
//   o_t = r_t^T (S + diag(u) k_t v_t^T)
//   S  <- diag(w_t) S + k_t v_t^T
// r, k, w are (BH, T, Dk), v is (BH, T, Dv), float32 or bfloat16; u is
// (H, Dk) and the states are (BH, Dk, Dv), both float32; o takes r's type.
//
// wkv6_kernel
//   Replaces: wkv6_pallas / _wkv6_kernel
//             (src/repro/kernels/rwkv6_wkv/kernel.py:72 and :26), which
//             carries S in VMEM scratch across an in-order grid over time
//             tiles.  CUDA blocks run in no order, so the time loop lives
//             inside the block.
//   Bound:    bytes at decode (T = 1: the state is read and written once,
//             32 KB per head at 64 x 64, against 7 Dk Dv operations); a
//             long chunk is bound by its sequential steps, not the card.
//   Design:   one block per (batch row, head), one thread per value column
//             j, which keeps S[:, j] (Dk floats) in registers for the whole
//             sequence, so the state touches device memory only at the start
//             and the end.  Every 16 steps the block stages r_t, k_t and w_t
//             (coalesced) and u (once) in shared memory; each thread then
//             reads its own v_t[j] and writes o_t[j], consecutive threads on
//             consecutive words.  Any T works (T = 1 is decode); no padding.
//             A chunked matmul form (tensor cores over time tiles) is later
//             work.
//   Numbers:  equal bit for bit to the plain version (ref.py), which
//             fixes the float32 evaluation order: every product and sum is
//             rounded on its own (__fmul_rn / __fadd_rn, never contracted
//             to an FMA), and o_t[j] sums r_i (S_ij + u_i kv_ij) over i in a
//             pairwise tree (Dk padded with zeros to a power of two), which
//             the thread builds with a binary-counter stack of log2(Dk) + 1
//             partial sums.  A random-weight 32-layer RWKV-6 amplifies a
//             one-ulp difference about a thousandfold by its last layer, so
//             only bit equality lets a served run on the kernel reproduce
//             the plain run's tokens.
//
// The C function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;    // time steps staged in shared memory at once
constexpr int kMaxDv = 128;   // threads per block

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

// DK: the register array's length, a power of two >= dk (64 or 128).
// blockDim.x == dv.
template <typename T, int DK>
__global__ void wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ w,
                            const float* __restrict__ u,
                            const float* __restrict__ s0, T* __restrict__ o,
                            float* __restrict__ s_out, int n_heads, int t_len,
                            int dk, int dv) {
  constexpr int kLevels = log2_of(DK);
  __shared__ float rs[kSteps][DK];
  __shared__ float ks[kSteps][DK];
  __shared__ float ws[kSteps][DK];
  __shared__ float us[DK];

  const int j = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long kbase = bh * t_len * dk;
  const long long vbase = bh * t_len * dv;
  const float* s_in = s0 + bh * dk * dv;

  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = (i < dk) ? s_in[i * dv + j] : 0.f;
  for (int i = j; i < dk; i += dv) us[i] = u[(bh % n_heads) * dk + i];

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    const int steps = min(kSteps, t_len - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = j; idx < steps * dk; idx += dv) {
      const int tt = idx / dk, i = idx % dk;
      const long long at = kbase + static_cast<long long>(t0) * dk + idx;
      rs[tt][i] = to_f32(r[at]);
      ks[tt][i] = to_f32(k[at]);
      ws[tt][i] = to_f32(w[at]);
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const long long at = vbase + static_cast<long long>(t0 + tt) * dv + j;
      const float vj = to_f32(v[at]);
      // stack[l] holds the sum of the last complete block of 2^l terms
      float stack[kLevels + 1];
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        float term = 0.f;
        if (i < dk) {
          const float kv = __fmul_rn(ks[tt][i], vj);
          const float a = __fadd_rn(s[i], __fmul_rn(us[i], kv));
          term = __fmul_rn(rs[tt][i], a);
          s[i] = __fadd_rn(__fmul_rn(ws[tt][i], s[i]), kv);
        }
        // term i closes one block per trailing one bit of i: merge each
        // (left + right, as the plain version's p[0::2] + p[1::2])
        int level = 0;
#pragma unroll
        for (int l = 0; l < kLevels; ++l) {
          if (((i >> l) & 1) == 0) break;
          term = __fadd_rn(stack[l], term);
          level = l + 1;
        }
        stack[level] = term;
      }
      o[at] = from_f32<T>(stack[kLevels]);
    }
  }

  float* s_fin = s_out + bh * dk * dv;
#pragma unroll
  for (int i = 0; i < DK; ++i) {
    if (i < dk) s_fin[i * dv + j] = s[i];
  }
}

template <typename T, int DK>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* s_out,
                   long long bh, int n_heads, int t_len, int dk, int dv,
                   cudaStream_t stream) {
  wkv6_kernel<T, DK><<<static_cast<unsigned>(bh), dv, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_out), n_heads, t_len, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dk(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* o,
                        void* s_out, long long bh, int n_heads, int t_len,
                        int dk, int dv, cudaStream_t stream) {
  if (dk <= 64) {
    return launch<T, 64>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len, dk,
                         dv, stream);
  }
  return launch<T, 128>(r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len, dk,
                        dv, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w and o); u and the states float32.
int wkv6(const void* r, const void* k, const void* v, const void* w,
         const void* u, const void* s0, void* o, void* s_out, long long bh,
         int n_heads, int t_len, int dk, int dv, int dtype, void* stream) {
  if (dk < 1 || dk > 128 || dv < 1 || dv > kMaxDv || n_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(dispatch_dk<__nv_bfloat16>(
        r, k, v, w, u, s0, o, s_out, bh, n_heads, t_len, dk, dv, s));
  }
  return static_cast<int>(dispatch_dk<float>(r, k, v, w, u, s0, o, s_out, bh,
                                             n_heads, t_len, dk, dv, s));
}

}  // extern "C"
