// The CNI row walk shared by cni_encode.cu and cni_update.cu, so a row
// digested by either kernel comes out bit for bit the same.
//
// For a row counts[0..L) (counts[l] = multiplicity of ord value l+1) the
// walk visits labels in descending ord order; for each of a label's count
// positions j = 1, 2, ... (positions at or past d_max contribute nothing)
// it adds the label to the running prefix p and gathers, at the flat index
// j * (max_p + 1) + min(p, max_p),
//
//   the exact term  hbar(j, p) from the int64 Pascal table, folded as
//                   acc += min(term, SAT64 - acc), which never forms a raw
//                   acc + term (2^62 + 2^62 overflows int64);
//   the log term    log hbar(j, p) from the float32 table.
//
// The log digest is m + log(max(sum exp(t - m), 1e-30)) with m the largest
// log term (0 when there is none), and -inf for a row of degree 0: the plain
// version's formula (core/cni.py::cni_log_from_counts) with the sum taken in
// position order.  A second walk over the row computes the sum once m is
// known; the row and its table entries are in L1/L2 by then.  No expression
// holds a multiply that nvcc could fuse into an FMA, and the sources are
// built without fast math, so inf/NaN behave as in IEEE float32.
//
// The tables are read through the read-only path (__ldg); the row is read
// with plain loads, because cni_update walks the row it has just written.

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

__device__ __forceinline__ RowDigest encode_row(
    const int* row, int L, int d_max, int max_p,
    const long long* __restrict__ pascal, const float* __restrict__ log_t) {
  const long long width = static_cast<long long>(max_p) + 1;
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
      const long long idx = j * width + min(p, max_p);
      const long long term = __ldg(pascal + idx);
      acc += min(term, kSat64 - acc);
      m = fmaxf(m, __ldg(log_t + idx));
    }
  }
  // walk 2: the sum of exp(t - m) over the same positions
  const float m_safe = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  j = 0;
  p = 0;
  for (int l = L - 1; l >= 0 && j < d_max; --l) {
    const int c = row[l];
    for (int k = 0; k < c && j < d_max; ++k) {
      ++j;
      p += l + 1;
      s += expf(__ldg(log_t + j * width + min(p, max_p)) - m_safe);
    }
  }
  RowDigest out;
  out.deg = deg;
  out.cni = acc;
  out.log = deg > 0 ? m_safe + logf(fmaxf(s, 1e-30f)) : -CUDART_INF_F;
  return out;
}

}  // namespace cni
