// The CNI term math shared by cni_encode.cu and cni_update.cu, so a row
// digested by either kernel comes out bit for bit the same.
//
// For a row counts[0..L) (counts[l] = multiplicity of ord value l+1) the
// digest visits labels in descending ord order; for each of a label's count
// positions j = 1, 2, ... (positions at or past d_max contribute nothing)
// it adds the label to the running prefix p and gathers, at the flat index
// term_index(j, p) = j * (max_p + 1) + min(p, max_p),
//
//   the exact term  hbar(j, p) from the int64 Pascal table, folded as
//                   sat_add(acc, term) = acc + min(term, SAT64 - acc), which
//                   never forms a raw acc + term (2^62 + 2^62 overflows
//                   int64); for terms and partial sums in [0, SAT64] it is
//                   min(acc + term, SAT64), so any pairing of the fold gives
//                   the same value;
//   the log term    log hbar(j, p) from the float32 table.
//
// The log digest is log_digest(deg, m, s) = m + log(max(s, 1e-30)) with m
// the largest log term (0 when there is none, safe_max), s the sum of
// exp(t - m) over the positions taken in position order from 0.0f, and -inf
// for a row of degree 0: the plain version's formula
// (core/cni.py::cni_log_from_counts) with the sum in position order.  No
// expression holds a multiply that nvcc could fuse into an FMA, and the
// sources are built without fast math, so inf/NaN behave as in IEEE float32.
//
// encode_row is cni_encode's walk, one thread per row: a first walk for the
// degree, the exact digest and m, a second for the sum once m is known.
// cni_update.cu spreads a row over a warp's lanes with the same helpers and
// keeps only the float32 sum in position order.  The tables are read
// through the read-only path (__ldg).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace cni {

constexpr long long kSat64 = 1LL << 62;

struct RowDigest {
  int deg;        // label degree: the sum of the row
  long long cni;  // exact digest, saturating at SAT64
  float log;      // float32 log digest
};

// Flat table index of position j (1-based) at label prefix p >= 0.
__device__ __forceinline__ long long term_index(long long j, long long p,
                                                int max_p) {
  return j * (static_cast<long long>(max_p) + 1) +
         (p < max_p ? p : static_cast<long long>(max_p));
}

// The saturating fold of two values in [0, SAT64].
__device__ __forceinline__ long long sat_add(long long acc, long long term) {
  return acc + min(term, kSat64 - acc);
}

__device__ __forceinline__ float safe_max(float m) {
  return isfinite(m) ? m : 0.0f;
}

__device__ __forceinline__ float log_digest(int deg, float m_safe, float s) {
  return deg > 0 ? m_safe + logf(fmaxf(s, 1e-30f)) : -CUDART_INF_F;
}

__device__ __forceinline__ RowDigest encode_row(
    const int* row, int L, int d_max, int max_p,
    const long long* __restrict__ pascal, const float* __restrict__ log_t) {
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
      const long long idx = term_index(j, p, max_p);
      acc = sat_add(acc, __ldg(pascal + idx));
      m = fmaxf(m, __ldg(log_t + idx));
    }
  }
  // walk 2: the sum of exp(t - m) over the same positions
  const float m_safe = safe_max(m);
  float s = 0.0f;
  j = 0;
  p = 0;
  for (int l = L - 1; l >= 0 && j < d_max; --l) {
    const int c = row[l];
    for (int k = 0; k < c && j < d_max; ++k) {
      ++j;
      p += l + 1;
      s += expf(__ldg(log_t + term_index(j, p, max_p)) - m_safe);
    }
  }
  RowDigest out;
  out.deg = deg;
  out.cni = acc;
  out.log = log_digest(deg, m_safe, s);
  return out;
}

}  // namespace cni
