// The dense model of the CoGAPS Gibbs sweep, shared by csrc/sweep.cu (K1,
// K2) and csrc/span.cu (K3): s, s_mu and the pair term read from the SQ, Y
// and Z tables of one update call (noise floors 0), and
// Y[r,:] -= delta * Z[r*k+c,:] after each accepted change. Its plain
// version is ops/sweep.py with models/dense.make_model.
//
// The tables lie in global memory or (sweep.cu) in shared memory. A row
// update loads its Z and Y values before it stores any: Y and Z may
// alias as far as the compiler knows, so a loop of load-add-store would
// wait on each store's round trip before the next load.

#pragma once

#include "sweep_common.cuh"

namespace cogaps {

struct DenseModel {
  int K;
  float* Y;         // this chain's (NR, K) conditional-mean table
  const float* SQ;  // (NR, K)
  const float* Z;   // (NR * K, K)
  // Z lies in global memory and nothing writes it during the launch: it
  // is read through the read-only data path
  bool z_readonly;

  __device__ __forceinline__ float z(int i) const {
    return z_readonly ? __ldg(Z + i) : Z[i];
  }

  __device__ Alpha alpha(const Proposal& q) const {
    Alpha a = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
    if (!q.keep) return a;
    const int e1 = q.r1 * K + q.c1;
    a.s1 = SQ[e1];
    a.smu1 = Y[e1];
    if (q.is_move || q.is_exch) {
      const int e2 = q.r2 * K + q.c2;
      const float s2 = SQ[e2], smu2 = Y[e2];
      const float x = z(e1 * K + q.c2);
      const float same_row = q.r1 == q.r2 ? F(1.0) : F(0.0);
      a.s_pair = a.s1 + s2 - F(2.0) * x * same_row;
      a.smu_pair = a.smu1 - smu2;
    }
    return a;
  }

  __device__ void apply(int r, int e, float delta) const {
    constexpr int kT = 8;  // values loaded ahead of their stores
    float* y = Y + r * K;
    const int ze = e * K;
    for (int j0 = 0; j0 < K; j0 += kT) {
      float yv[kT], zv[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (j0 + t < K) {
          zv[t] = z(ze + j0 + t);
          yv[t] = y[j0 + t];
        }
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (j0 + t < K) y[j0 + t] = yv[t] + (-delta) * zv[t];
    }
  }
};

}  // namespace cogaps
