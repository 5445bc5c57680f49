// CoGAPS Gibbs sweep kernel for Hopper (sm_90a), dense-Z and tables mode.
//
// Replaces cogaps_tpu/ops/pallas_sweep.py::_kernel_b (body _sweep_b) and,
// fed the sparse model's tables (models/sparse.kernel_tables: G in the Z
// table's place), its tables mode run_updates_pallas_tables(_multi): one
// sampler's whole update(nSteps) for NCH independent chains in one
// launch. The sweep itself is sweep_common.cuh::sweep_chain; this file
// gives it the dense model: s, s_mu and the pair term read from the SQ, Y
// and Z tables (noise floors 0), and Y[r,:] -= delta * Z[r*k+c,:] after
// each accepted change. Its plain version is ops/sweep.py with
// models/dense.make_model.
//
// What bounds it on the H100: the latency of the dependent global loads
// of each lane (table picks, then SQ/Y/Z/M at the picked rows) and the
// ~20 block barriers of every sweep; the work per sweep is a few hundred
// flops per lane. One block per chain leaves most of the 132 SMs idle at
// 16 chains. The design keeps each sweep to one pass over the lanes with
// no host round trip: the fast mode draws its uniforms in the kernel
// (Philox4x32-10) and reads the budgets from device memory, so an update
// call is one launch. The tables stay in global memory (L2).

#include "sweep_common.cuh"

namespace {

using cogaps::Alpha;
using cogaps::Proposal;

struct DenseModel {
  int K;
  float* Y;         // this chain's (NR, K) conditional-mean table
  const float* SQ;  // (NR, K)
  const float* Z;   // (NR * K, K)

  __device__ Alpha alpha(const Proposal& q) const {
    Alpha a = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
    if (!q.keep) return a;
    const int e1 = q.r1 * K + q.c1;
    a.s1 = SQ[e1];
    a.smu1 = Y[e1];
    if (q.is_move || q.is_exch) {
      const int e2 = q.r2 * K + q.c2;
      const float s2 = SQ[e2], smu2 = Y[e2];
      const float x = Z[e1 * K + q.c2];
      const float same_row = q.r1 == q.r2 ? F(1.0) : F(0.0);
      a.s_pair = a.s1 + s2 - F(2.0) * x * same_row;
      a.smu_pair = a.smu1 - smu2;
    }
    return a;
  }

  __device__ void apply(int r, int e, float delta) const {
    for (int j = 0; j < K; ++j)
      Y[r * K + j] = Y[r * K + j] + (-delta) * Z[e * K + j];
  }
};

__global__ void __launch_bounds__(cogaps::kMaxB)
    sweep_kernel(const cogaps::SweepArgs p, float* Y, const float* SQ,
                 const float* Z) {
  const size_t nb = (size_t)blockIdx.x * p.NB;
  DenseModel model{p.K, Y + nb, SQ + nb, Z + nb * p.K};
  cogaps::sweep_chain(p, model);
}

}  // namespace

extern "C" int cogaps_sweep_launch(
    int nch, int B, int C, int NR, int K, int local_moves, float alpha_nb,
    float dom_len, float temp, const float* lam, const float* mgm,
    const int* budget, float* mass, int* elem, int* n, float* M, float* Y,
    const float* SQ, const float* Z, const int* colnz, int* scratch, int* out,
    const float* uni, int s_max, const long long* key0, uint32_t key1,
    void* stream) {
  if (B < 1 || B > cogaps::kMaxB || nch < 1)
    return (int)cudaErrorInvalidValue;
  const cogaps::SweepArgs p = cogaps::make_args(
      nch, B, C, NR, K, local_moves, alpha_nb, dom_len, temp, lam, mgm,
      budget, mass, elem, n, M, colnz, scratch, out, uni, s_max, key0, key1);
  const int threads = (B + 31) / 32 * 32;
  sweep_kernel<<<nch, threads, 0, (cudaStream_t)stream>>>(p, Y, SQ, Z);
  return (int)cudaGetLastError();
}
