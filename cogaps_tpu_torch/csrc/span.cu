// K3: whole dense CoGAPS iterations for Hopper (sm_90a), one launch a span.
//
// Replaces cogaps_tpu/ops/pallas_iter.py::_kernel_span (wrapper
// run_span_fused, pallas_call at :352): n_it complete MCMC iterations of NCH
// independent chains in one launch. Each iteration does what
// cogaps_tpu_torch/engine.run_iteration does in ~80 separate launches:
//   1. temperature min(1, 2 it / N) in equilibration, 1 in sampling;
//   2. both update budgets round(lam + sqrt(lam) z), clipped at 0, with
//      lam = max(atoms, 10) from the atom counts at the start of the
//      iteration and normals z drawn before the launch
//      (engine.PhiloxRandom.budget_normals);
//   3. the A tables Y, SQ, Z and col_nz from D, invS2, M_a and M_p;
//   4. the A sweeps: sweep_common.cuh::sweep_chain on dense_model.cuh in
//      fast mode, keyed (seed, stream_key(phase, it, SAMPLER_A));
//   5. the P tables from the updated M_a and the transposed data;
//   6. the P sweeps, keyed (seed, stream_key(phase, it, SAMPLER_P));
//   7. in the sampling phase, the max-normalized posterior sums
//      (engine.accumulate_stats with no fixed matrix);
//   8. the update, sweep and proposal counters of RunStats.
// Its plain version is ops/span.py: engine.run_iteration with the same
// table rule and the plain sweep; the random numbers are the ones
// engine.PhiloxRandom gives the per-call path.
//
// Table rule: every table entry is a float64 sum over the float32 operands,
// rounded once to float32. Products of two floats are exact in float64, so
// the order of the sum (this kernel's loops, cuBLAS in the plain version)
// reaches the float32 result only when the sum lies within a few float64
// ulps of a float32 rounding boundary; decisions, which sit on float
// thresholds, then match the plain version's. The A sampler's pair term is
// a Z table (G k^2 floats), not the TPU kernel's on-the-fly dot over the
// invS2 row: the sweep is then K1's, on the same tables as its plain
// version, and the table costs G*S*k(k+1)/2 float64 multiply-adds once an
// iteration (~0.6 M at GIST, k=7) instead of S*k per accepted update.
//
// Design: one persistent block per chain (chains are independent, so no
// grid-wide synchronisation), max(B_a, B_p) threads; the block loops over
// the iterations with block barriers between the steps. Tables, the
// float64 residual and the sweeps' claim tables are per-chain scratch in
// global memory (L2-resident at GIST: ~0.4 MB a chain). A table sum is one
// thread's when a sampler has at least as many table entries as threads
// (the A side), else a warp's, split over the partner index and reduced by
// shuffles (the P side at GIST: 9 rows, sums over 1363 genes).
//
// What bounds it on the H100: the two table rebuilds, then the sweeps. At
// GIST with every budget set to 0 (no sweep) the kernel keeps about 60% of
// its iteration time (chip_smoke.py phase 3); the rebuild's ~3.3 M float64
// operations a chain run on one SM, far below its float64 rate, and the
// span's iteration grows with them (MultichainEngine's gate,
// parallel/multichain.py). The sweeps run as in K1 (dependent global
// loads, ~20 block barriers a sweep). One block per chain leaves 116 of
// the 132 SMs idle at 16 chains; what the design removes is the host: one
// launch covers a span, and nothing is read back.

#include "dense_model.cuh"

namespace {

using cogaps::kNOut;

struct SpanArgs {
  int G, S, K, n_it, phase, it0, n_iterations;
  const float* D;      // (nch, G, S)
  const float* inv;    // (nch, G, S) = 1/S^2
  const float* D_t;    // (nch, S, G)
  const float* inv_t;  // (nch, S, G)
  const float* z;      // (nch, n_it, 2) budget normals [A, P]
  float* a_sum;        // (nch, G, K) ... running sums, in place
  float* a_sumsq;
  float* p_sum;  // (nch, S, K)
  float* p_sumsq;
  int* n_stat;      // (nch,)
  long long* upd;   // (nch,)
  int* prop;        // (nch, 2, 4)
  int* acc;         // (nch, 2, 4)
  int* sweeps;      // (nch, 2)
  double* R;        // (nch, G*S) float64 residual scratch
  float* Ya;        // (nch, G, K) tables of the A sampler
  float* SQa;
  float* Za;        // (nch, G*K, K)
  float* Yp;        // (nch, S, K) tables of the P sampler
  float* SQp;
  float* Zp;        // (nch, S*K, K)
  float* norm;      // (nch, K)
  int* colnz_a;     // (nch, K), also the SweepArgs' colnz
  int* colnz_p;
  int* budget_a;    // (nch,) written here, read by sweep_chain
  int* budget_p;
};

// engine.stream_key
__device__ __forceinline__ uint32_t stream_key(int phase, int it,
                                               int stream) {
  return ((uint32_t)it * 2u + (uint32_t)phase) * 4u + (uint32_t)stream;
}

// ops/rng.poisson_fast of a normal z at lam = max(n_atoms, 10)
__device__ __forceinline__ int budget_of(float z, int n_atoms) {
  const float lam = F(max(n_atoms, 10));
  const float v = rintf(lam + sqrtf(lam) * z);  // half to even, as torch
  return (int)fmaxf(v, F(0.0));
}

// One sampler's tables under the rule above (models/dense.exact_tables):
// rows r < NR, partner index j < m, data X and weights W (NR, m), factor
// M (NR, K), partner factor O (m, K):
//   R[r,j] = (X[r,j] - sum_c M[r,c] O[j,c]) * W[r,j]
//   Y[r,c] = sum_j R[r,j] O[j,c]       SQ[r,c] = sum_j W[r,j] O[j,c]^2
//   Z[r*K+c, c'] = sum_j W[r,j] O[j,c] O[j,c']   (symmetric: c <= c')
//   colnz[c] = any_j O[j,c] > 0
// Every thread of the block calls it, after a barrier that follows the
// writes of M and O; it ends with a block barrier.
__device__ void rebuild(int NR, int m, int K, const float* X, const float* W,
                        const float* M, const float* O, double* R, float* Y,
                        float* SQ, float* Z, int* colnz) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int c = t; c < K; c += nt) colnz[c] = 0;
  const int n_rm = NR * m;
  for (int e = t; e < n_rm; e += nt) {
    const int r = e / m, j = e - r * m;
    double ap = 0.0;
    for (int c = 0; c < K; ++c)
      ap = ap + (double)M[r * K + c] * (double)O[j * K + c];
    R[e] = ((double)X[e] - ap) * (double)W[e];
  }
  __syncthreads();
  for (int e = t; e < m * K; e += nt)
    if (O[e] > F(0.0)) colnz[e % K] = 1;

  // outputs of a row: Y (K), SQ (K), then the pairs c <= c' of Z
  const int per_row = 2 * K + K * (K + 1) / 2;
  const int n_out = NR * per_row;
  const int gs = n_out >= nt ? 1 : 32;  // threads summing one output
  const int lane = t % gs, n_grp = nt / gs;
  for (int o0 = 0; o0 < n_out; o0 += n_grp) {
    const int o = o0 + t / gs;
    const bool valid = o < n_out;
    int r = 0, kind = 0, c = 0, c2 = 0;
    if (valid) {
      r = o / per_row;
      int q = o - r * per_row;
      if (q < K) {
        c = q;
      } else if (q < 2 * K) {
        kind = 1;
        c = q - K;
      } else {
        kind = 2;
        q -= 2 * K;
        while (q >= K - c) {
          q -= K - c;
          ++c;
        }
        c2 = c + q;
      }
    }
    double acc = 0.0;
    if (valid) {
      const float* Wr = W + (size_t)r * m;
      const double* Rr = R + (size_t)r * m;
      for (int j = lane; j < m; j += gs) {
        const double oc = (double)O[j * K + c];
        if (kind == 0)
          acc = acc + Rr[j] * oc;
        else if (kind == 1)
          acc = acc + (double)Wr[j] * (oc * oc);
        else
          acc = acc + (double)Wr[j] * (oc * (double)O[j * K + c2]);
      }
    }
    if (gs > 1)  // a group is a whole warp, and `valid` is warp-uniform
      for (int off = 16; off > 0; off >>= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
    if (valid && lane == 0) {
      const float v = (float)acc;
      if (kind == 0) {
        Y[r * K + c] = v;
      } else if (kind == 1) {
        SQ[r * K + c] = v;
      } else {
        Z[((size_t)r * K + c) * K + c2] = v;
        Z[((size_t)r * K + c2) * K + c] = v;
      }
    }
  }
  __syncthreads();
}

// add one sampler call's counters (sweep_chain's out row) to RunStats
__device__ void fold_counts(const SpanArgs& s, int chain, int row,
                            const int* out) {
  const int* o = out + (size_t)chain * kNOut;
  s.upd[chain] += (long long)o[0];
  s.sweeps[chain * 2 + row] += o[1];
  for (int j = 0; j < 4; ++j) {
    s.prop[(chain * 2 + row) * 4 + j] += o[2 + j];
    s.acc[(chain * 2 + row) * 4 + j] += o[6 + j];
  }
}

__global__ void __launch_bounds__(cogaps::kMaxB)
    span_kernel(const SpanArgs s, const cogaps::SweepArgs pa0,
                const cogaps::SweepArgs pp0) {
  const int chain = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int G = s.G, S = s.S, K = s.K;
  const size_t GS = (size_t)G * S, GK = (size_t)G * K, SK = (size_t)S * K;
  const float* D = s.D + chain * GS;
  const float* inv = s.inv + chain * GS;
  const float* D_t = s.D_t + chain * GS;
  const float* inv_t = s.inv_t + chain * GS;
  float* Ma = pa0.M + chain * GK;
  float* Mp = pp0.M + chain * SK;
  double* R = s.R + chain * GS;
  float* Ya = s.Ya + chain * GK;
  float* SQa = s.SQa + chain * GK;
  float* Za = s.Za + chain * GK * K;
  float* Yp = s.Yp + chain * SK;
  float* SQp = s.SQp + chain * SK;
  float* Zp = s.Zp + chain * SK * K;
  int* colnz_a = s.colnz_a + chain * K;
  int* colnz_p = s.colnz_p + chain * K;
  float* norm = s.norm + chain * K;
  cogaps::DenseModel model_a{K, Ya, SQa, Za};
  cogaps::DenseModel model_p{K, Yp, SQp, Zp};

  for (int i = 0; i < s.n_it; ++i) {
    const int it = s.it0 + i;
    const float temp = s.phase == 0
                           ? fminf(F(1.0), F(2 * it) / F(s.n_iterations))
                           : F(1.0);
    if (t == 0) {  // read by sweep_chain after the rebuild's barriers
      const float* z = s.z + ((size_t)chain * s.n_it + i) * 2;
      s.budget_a[chain] = budget_of(z[0], pa0.n[chain]);
      s.budget_p[chain] = budget_of(z[1], pp0.n[chain]);
    }

    rebuild(G, S, K, D, inv, Ma, Mp, R, Ya, SQa, Za, colnz_a);
    cogaps::SweepArgs pa = pa0;
    pa.temp = temp;
    pa.key1 = stream_key(s.phase, it, 0);
    cogaps::sweep_chain(pa, model_a);
    __syncthreads();
    if (t == 0) fold_counts(s, chain, 0, pa0.out);

    rebuild(S, G, K, D_t, inv_t, Mp, Ma, R, Yp, SQp, Zp, colnz_p);
    cogaps::SweepArgs pp = pp0;
    pp.temp = temp;
    pp.key1 = stream_key(s.phase, it, 1);
    cogaps::sweep_chain(pp, model_p);
    __syncthreads();
    if (t == 0) fold_counts(s, chain, 1, pp0.out);

    if (s.phase == 1) {  // GapsStatistics.h:130-149
      for (int c = t; c < K; c += nt) {
        float mx = Mp[c];
        for (int r = 1; r < S; ++r) mx = fmaxf(mx, Mp[r * K + c]);
        norm[c] = mx == F(0.0) ? F(1.0) : mx;
      }
      __syncthreads();
      float* ps = s.p_sum + chain * SK;
      float* pq = s.p_sumsq + chain * SK;
      for (size_t e = t; e < SK; e += nt) {
        const float q = Mp[e] / norm[e % K];
        ps[e] = ps[e] + q;
        pq[e] = pq[e] + q * q;
      }
      float* as = s.a_sum + chain * GK;
      float* aq = s.a_sumsq + chain * GK;
      for (size_t e = t; e < GK; e += nt) {
        const float prod = Ma[e] * norm[e % K];
        as[e] = as[e] + prod;
        aq[e] = aq[e] + prod * prod;
      }
      if (t == 0) s.n_stat[chain] += 1;
    }
    __syncthreads();
  }
}

// The tables of both samplers from one state, without sweeping: the
// counterpart of tools/probe_rebuild.py's check of the TPU kernel's
// in-kernel rebuild contractions.
__global__ void __launch_bounds__(cogaps::kMaxB)
    rebuild_kernel(int G, int S, int K, const float* D, const float* inv,
                   const float* D_t, const float* inv_t, const float* Ma,
                   const float* Mp, double* R, float* Ya, float* SQa,
                   float* Za, int* colnz_a, float* Yp, float* SQp, float* Zp,
                   int* colnz_p) {
  const size_t c = blockIdx.x;
  const size_t GS = (size_t)G * S, GK = (size_t)G * K, SK = (size_t)S * K;
  rebuild(G, S, K, D + c * GS, inv + c * GS, Ma + c * GK, Mp + c * SK,
          R + c * GS, Ya + c * GK, SQa + c * GK, Za + c * GK * K,
          colnz_a + c * K);
  rebuild(S, G, K, D_t + c * GS, inv_t + c * GS, Mp + c * SK, Ma + c * GK,
          R + c * GS, Yp + c * SK, SQp + c * SK, Zp + c * SK * K,
          colnz_p + c * K);
}

int block_threads(int B_a, int B_p) {
  return ((B_a > B_p ? B_a : B_p) + 31) / 32 * 32;
}

}  // namespace

extern "C" int cogaps_span_launch(
    int nch, int G, int S, int K, int n_it, int phase, int it0,
    int n_iterations, int B_a, int C_a, int B_p, int C_p, int local_moves,
    float alpha_nb_a, float dom_len_a, float alpha_nb_p, float dom_len_p,
    const float* lam_a, const float* mgm_a, const float* lam_p,
    const float* mgm_p, const float* D, const float* inv,
    const float* D_t, const float* inv_t, const float* z, float* mass_a,
    int* elem_a, int* n_a,
    float* mass_p, int* elem_p, int* n_p, float* Ma, float* Mp, float* a_sum,
    float* a_sumsq, float* p_sum, float* p_sumsq, int* n_stat,
    long long* upd, int* prop, int* acc, int* sweeps, double* R, float* Ya,
    float* SQa, float* Za, float* Yp, float* SQp, float* Zp, float* norm,
    int* colnz_a, int* colnz_p, int* budget_a, int* budget_p, int* out_a,
    int* out_p, int* claims_a, int* claims_p, const long long* key0,
    void* stream) {
  if (nch < 1 || B_a < 1 || B_a > cogaps::kMaxB || B_p < 1 ||
      B_p > cogaps::kMaxB || n_it < 1)
    return (int)cudaErrorInvalidValue;
  SpanArgs s;
  s.G = G;
  s.S = S;
  s.K = K;
  s.n_it = n_it;
  s.phase = phase;
  s.it0 = it0;
  s.n_iterations = n_iterations;
  s.D = D;
  s.inv = inv;
  s.D_t = D_t;
  s.inv_t = inv_t;
  s.z = z;
  s.a_sum = a_sum;
  s.a_sumsq = a_sumsq;
  s.p_sum = p_sum;
  s.p_sumsq = p_sumsq;
  s.n_stat = n_stat;
  s.upd = upd;
  s.prop = prop;
  s.acc = acc;
  s.sweeps = sweeps;
  s.R = R;
  s.Ya = Ya;
  s.SQa = SQa;
  s.Za = Za;
  s.Yp = Yp;
  s.SQp = SQp;
  s.Zp = Zp;
  s.norm = norm;
  s.colnz_a = colnz_a;
  s.colnz_p = colnz_p;
  s.budget_a = budget_a;
  s.budget_p = budget_p;
  const cogaps::SweepArgs pa = cogaps::make_args(
      nch, B_a, C_a, G, K, local_moves, alpha_nb_a, dom_len_a, F(1.0), lam_a,
      mgm_a, budget_a, mass_a, elem_a, n_a, Ma, colnz_a, claims_a, out_a,
      nullptr, 0, key0, 0u);
  const cogaps::SweepArgs pp = cogaps::make_args(
      nch, B_p, C_p, S, K, local_moves, alpha_nb_p, dom_len_p, F(1.0), lam_p,
      mgm_p, budget_p, mass_p, elem_p, n_p, Mp, colnz_p, claims_p, out_p,
      nullptr, 0, key0, 0u);
  span_kernel<<<nch, block_threads(B_a, B_p), 0, (cudaStream_t)stream>>>(
      s, pa, pp);
  return (int)cudaGetLastError();
}

extern "C" int cogaps_span_rebuild(
    int nch, int G, int S, int K, int threads, const float* D,
    const float* inv, const float* D_t, const float* inv_t,
    const float* Ma, const float* Mp, double* R, float* Ya, float* SQa,
    float* Za, int* colnz_a, float* Yp, float* SQp, float* Zp, int* colnz_p,
    void* stream) {
  if (nch < 1 || threads < 32 || threads > cogaps::kMaxB || threads % 32)
    return (int)cudaErrorInvalidValue;
  rebuild_kernel<<<nch, threads, 0, (cudaStream_t)stream>>>(
      G, S, K, D, inv, D_t, inv_t, Ma, Mp, R, Ya, SQa, Za, colnz_a, Yp, SQp,
      Zp, colnz_p);
  return (int)cudaGetLastError();
}
