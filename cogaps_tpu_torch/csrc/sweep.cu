// CoGAPS Gibbs sweep kernel for Hopper (sm_90a), dense-Z and tables mode.
//
// Replaces cogaps_tpu/ops/pallas_sweep.py::_kernel_b (body _sweep_b) and,
// fed the sparse model's tables (models/sparse.kernel_tables: G in the Z
// table's place), its tables mode run_updates_pallas_tables(_multi): one
// sampler's whole update(nSteps) for NCH independent chains in one
// launch. The sweep itself is sweep_common.cuh::sweep_chain; this file
// gives it the dense model (dense_model.cuh). Its plain version is
// ops/sweep.py with models/dense.make_model.
//
// What bounds it on the H100: the latency of the dependent global loads
// of each lane (table picks, then SQ/Y/Z/M at the picked rows) and the
// ~20 block barriers of every sweep; the work per sweep is a few hundred
// flops per lane. One block per chain leaves most of the 132 SMs idle at
// 16 chains. The design keeps each sweep to one pass over the lanes with
// no host round trip: the fast mode draws its uniforms in the kernel
// (Philox4x32-10) and reads the budgets from device memory, so an update
// call is one launch. The tables stay in global memory (L2).

#include "dense_model.cuh"

namespace {

__global__ void __launch_bounds__(cogaps::kMaxB)
    sweep_kernel(const cogaps::SweepArgs p, float* Y, const float* SQ,
                 const float* Z) {
  const size_t nb = (size_t)blockIdx.x * p.NB;
  cogaps::DenseModel model{p.K, Y + nb, SQ + nb, Z + nb * p.K};
  cogaps::sweep_chain(p, model, blockIdx.x);
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
