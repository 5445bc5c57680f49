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
// What bounds it on the H100: latency. A sweep is a chain of dependent
// reads (table picks, claims, then SQ/Y/Z/M at the picked rows) and block
// barriers on one SM a chain; its work is a few hundred flops a lane. So
// each block keeps its chain's state in shared memory as far as it pays:
// ops/sweep_cuda.smem_plan places the row claims, the slot claims, then
// the hole flags, atom table, Y, SQ and M together (what stays global
// needs the L1 that shared memory takes), then Z, and passes the byte
// offsets in SweepArgs.smem (-1: left in global memory). The block
// copies its chain's arrays in, clears the claims there, runs every sweep
// on the copies (shared-memory atomics for the claims), and writes mass,
// elem, M and Y back at the end. The kernel is instantiated per width
// class (B <= 32, <= 256, <= 1024), each with launch bounds of its own;
// the one-warp class synchronises with __syncwarp and ballots only. The
// fast mode draws its uniforms in the kernel (Philox4x32-10) and reads
// the budgets from device memory, so an update call is one launch.

#include "dense_model.cuh"

namespace {

using cogaps::SweepArgs;

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const __grid_constant__ SweepArgs p, float* Y,
                 const float* SQ, const float* Z) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWarp = kThreads == 32;
  const int chain = blockIdx.x;
  const size_t nb = (size_t)chain * p.NB;
  const cogaps::StagedChain st =
      cogaps::stage_chain(p, smem, chain, Y + nb, SQ + nb, Z + nb * p.K, true);
  cogaps::sweep_chain<kWarp>(p, st.ch, st.model, chain);
  // chain_end's barrier follows the last sweep
  cogaps::unstage_chain(p, st, true);
}

// One launch of the width class kThreads with `smem_bytes` of dynamic
// shared memory; a launch the card refuses returns its error.
template <int kThreads>
int launch(const SweepArgs& p, int threads, int smem_bytes, float* Y,
           const float* SQ, const float* Z, cudaStream_t stream) {
  static int allowed = -1;  // the attribute last set, for this class
  if (smem_bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return (int)e;
    }
    allowed = smem_bytes;
  }
  sweep_kernel<kThreads><<<p.nch, threads, smem_bytes, stream>>>(p, Y, SQ, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// `smem_off` holds cogaps::kNPlaced byte offsets (-1: global) in a block
// of `smem_bytes`; `scratch_layout` the scratch stride and the int offsets
// of the global row claims, slot claims and hole flags (-1: none).
extern "C" int cogaps_sweep_launch(
    int nch, int B, int C, int NR, int K, int local_moves, float alpha_nb,
    float dom_len, float temp, const float* lam, const float* mgm,
    const int* budget, float* mass, int* elem, int* n, float* M, float* Y,
    const float* SQ, const float* Z, const int* colnz, int* scratch, int* out,
    const float* uni, int s_max, const long long* key0, uint32_t key1,
    const int* smem_off, int smem_bytes, const int* scratch_layout,
    void* stream) {
  if (B < 1 || B > cogaps::kMaxB || nch < 1 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  cogaps::SweepArgs p = cogaps::make_args(
      nch, B, C, NR, K, local_moves, alpha_nb, dom_len, temp, lam, mgm,
      budget, mass, elem, n, M, colnz, scratch, out, uni, s_max, key0, key1);
  for (int i = 0; i < cogaps::kNPlaced; ++i) p.smem[i] = smem_off[i];
  p.scratch_stride = scratch_layout[0];
  p.g_rmin = scratch_layout[1];
  p.g_amin = scratch_layout[2];
  p.g_hole = scratch_layout[3];
  const int threads = (B + 31) / 32 * 32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads <= 32) return launch<32>(p, threads, smem_bytes, Y, SQ, Z, s);
  if (threads <= 256) return launch<256>(p, threads, smem_bytes, Y, SQ, Z, s);
  return launch<1024>(p, threads, smem_bytes, Y, SQ, Z, s);
}

// Static shared memory of the width class that runs batch B (bytes), or
// a negative CUDA error.
extern "C" int cogaps_sweep_static_smem(int B) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, B <= 32    ? (const void*)sweep_kernel<32>
          : B <= 256 ? (const void*)sweep_kernel<256>
                     : (const void*)sweep_kernel<1024>);
  return e == cudaSuccess ? (int)a.sharedSizeBytes : -(int)e;
}
