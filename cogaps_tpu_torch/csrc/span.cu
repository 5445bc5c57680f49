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
// the order of the sum (this kernel's tiles and cluster ranks, cuBLAS in
// the plain version) reaches the float32 result only when the sum lies
// within a few float64 ulps of a float32 rounding boundary; decisions,
// which sit on float thresholds, then match the plain version's. The A
// sampler's pair term is a Z table (G k^2 floats), not the TPU kernel's
// on-the-fly dot over the invS2 row: the sweep is then K1's, on the same
// tables as its plain version.
//
// Design: one thread-block cluster of CL CTAs per chain
// (span_cuda.cluster_size: the largest power of two <= 8 with every
// chain's cluster resident; chains are independent, so nothing waits on
// another cluster). The sweeps are sequential and run on the cluster's
// rank-0 CTA as in K1, one thread a proposal lane; the table rebuilds,
// which are float64 contractions, run on every CTA of the cluster, and
// cluster barriers separate the steps. One sampler's rebuild (rows r <
// NR, partners j < m, data X and weights W (NR, m), factor M (NR, k),
// partner factor O (m, k)) forms, per row,
//   Y[r,c]  = sum_j R[r,j] O[j,c],  R[r,j] = (X[r,j] - M[r,:].O[j,:]) W[r,j]
//   Z[r,c,c'] = sum_j W[r,j] O[j,c] O[j,c']  (c <= c'; SQ[r,c] = Z[r,c,c])
// as one product of [R | W] with the staged columns [O | O_c O_c'] in
// float64 (span_cuda.rebuild_plan sets the split):
//   - the rows (A side: genes) or the partners (P side: genes again) are
//     split over the cluster's CTAs, whichever dimension is longer;
//   - a CTA stages a tile of partners (O and its pair products; once, if
//     all its partners fit) and of rows (W and the residual R, formed
//     there: no R in device memory) in shared memory, and each thread
//     accumulates a 2-row x 4-column register tile over the tile's
//     partners, `lanes` threads splitting the partner sum only where rows
//     are few; the tile's sums leave through shared memory, row by row;
//   - a partner split writes float64 partials to its CTA's own slots,
//     added after a cluster barrier in rank order (no atomics: two runs
//     give the same bits) and rounded once.
// What bounds it on the H100 (chip_smoke.py phase 3, PERF.md): at GIST
// x16 the sweeps, ~80% of an iteration (dependent global loads and ~20
// block barriers a sweep, on one SM a chain); the rebuild is latency
// bound there (~9 partners a gene). At 20000 x 100 the rebuild's float64
// operations and its staging take most of the span; 16 chains get
// clusters of 4 (the card keeps fewer than 16 clusters of 8 resident),
// so half the SMs idle.

#include <cooperative_groups.h>

#include "dense_model.cuh"

namespace cg = cooperative_groups;

namespace {

using cogaps::kNOut;

// staged entries a thread loads before it uses them: global reads in
// flight together instead of one round trip each
constexpr int kUnroll = 4;

// One sampler's rebuild split (span_cuda.rebuild_plan).
struct SidePlan {
  int split_rows;  // rows over the cluster (else partners)
  int per_rank;    // rows or partners of one CTA
  int tile_rows;   // rows staged a pass (even)
  int tile_j;      // partners staged a pass
  int lanes;       // threads splitting one output's partner sum
};

// Both samplers' rebuilds of every chain.
struct Rebuild {
  int G, S, K;
  SidePlan a, p;
  const float* D;      // (nch, G, S)
  const float* inv;    // (nch, G, S) = 1/S^2
  const float* D_t;    // (nch, S, G)
  const float* inv_t;  // (nch, S, G)
  double* part;        // (nch, CL, min(G, S), npad) partner-split partials
  float* Ya;           // (nch, G, K) tables of the A sampler
  float* SQa;
  float* Za;  // (nch, G*K, K)
  float* Yp;  // (nch, S, K) tables of the P sampler
  float* SQp;
  float* Zp;  // (nch, S*K, K)
  int* colnz_a;  // (nch, K), also the SweepArgs' colnz
  int* colnz_p;
};

struct SpanArgs {
  int n_it, phase, it0, n_iterations;
  Rebuild rb;
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
  int* budget_a;    // (nch,) written here, read by sweep_chain
  int* budget_p;
};

// Output columns of a row: Y in column groups [0, gy), the pairs c <= c'
// of Z in [gy, gy + gz), four columns a group.
struct Cols {
  int K, kp, gy, ng, npad;
  __device__ explicit Cols(int K_) : K(K_), kp(K_ * (K_ + 1) / 2) {
    gy = (K + 3) / 4;
    ng = gy + (kp + 3) / 4;
    npad = 4 * ng;
  }
};

// The CTA's shared memory: the pair table, col_nz flags and column norms,
// then one sampler's staged tiles.
struct Smem {
  int* pair;      // (kp,) c | c' << 16
  int* flags;     // (K,) O[j, c] > 0 for one of this CTA's partners
  float* norm;    // (K,) the sampling phase's column maxima of M_p
  double* tiles;
};

extern __shared__ __align__(16) char smem[];

__device__ Smem carve(int K) {
  const int kp = K * (K + 1) / 2;
  char* base = smem;
  Smem s;
  s.pair = (int*)base;
  s.flags = s.pair + kp;
  s.norm = (float*)(s.flags + K);
  s.tiles = (double*)(base + (((size_t)4 * (kp + 2 * K) + 15) & ~(size_t)15));
  return s;
}

__device__ void fill_pairs(int K) {
  const Smem sm = carve(K);
  for (int q = threadIdx.x; q < K * (K + 1) / 2; q += blockDim.x) {
    int c = 0, r = q;
    while (r >= K - c) {
      r -= K - c;
      ++c;
    }
    sm.pair[q] = c | ((c + r) << 16);
  }
  __syncthreads();
}

// Output column `col` of row r, rounded once to float32.
__device__ __forceinline__ void put(const Cols& cc, const int* pair, int r,
                                    int col, double v, float* Y, float* SQ,
                                    float* Z) {
  const int K = cc.K;
  const float f = (float)v;
  if (col < 4 * cc.gy) {
    if (col < K) Y[(size_t)r * K + col] = f;
    return;
  }
  const int q = col - 4 * cc.gy;
  if (q >= cc.kp) return;
  const int c = pair[q] & 0xffff, c2 = pair[q] >> 16;
  Z[((size_t)r * K + c) * K + c2] = f;
  Z[((size_t)r * K + c2) * K + c] = f;
  if (c == c2) SQ[(size_t)r * K + c] = f;
}

// Index of the pair c <= c2 among a row's Z columns (fill_pairs' order).
__device__ __forceinline__ int pair_index(int K, int c, int c2) {
  return c * K - c * (c - 1) / 2 + c2 - c;
}

// Rows [0, nr) of a tile's sums (Os, (nr, npad)) rounded once into the
// tables Y, SQ and Z of those rows, each written in its own order.
__device__ void write_tables(const Cols& cc, const double* Os, int nr,
                             float* Y, float* SQ, float* Z) {
  const int K = cc.K, ny = 4 * cc.gy, t = threadIdx.x, nt = blockDim.x;
  for (int e = t; e < nr * K; e += nt) {
    const int row = e / K, c = e - row * K;
    const double* o = Os + (size_t)row * cc.npad;
    Y[e] = (float)o[c];
    SQ[e] = (float)o[ny + pair_index(K, c, c)];
  }
  for (int e = t; e < nr * K * K; e += nt) {
    const int row = e / (K * K), c = (e / K) % K, c2 = e % K;
    Z[e] = (float)Os[(size_t)row * cc.npad + ny +
                     pair_index(K, min(c, c2), max(c, c2))];
  }
}

// One sampler's tables (the rule and the split above) by every CTA of the
// cluster: called by all their threads after a cluster barrier that
// follows the writes of M and O; ends with a cluster barrier.
__device__ void rebuild(const SidePlan& pl, int NR, int m, int K,
                        const float* X, const float* W, const float* M,
                        const float* O, float* Y, float* SQ, float* Z,
                        int* colnz, double* part) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const Cols cc(K);
  const Smem sm = carve(K);
  // an odd row stride: a warp's 64-bit reads down a column of the row
  // tiles hit distinct banks
  const int bstride = cc.npad + 2, astride = pl.tile_j | 1;
  double* Bs = sm.tiles;                            // (tile_j, bstride)
  double* Rs = Bs + (size_t)pl.tile_j * bstride;    // (tile_rows, astride)
  double* Ws = Rs + (size_t)pl.tile_rows * astride;
  double* Ms = Ws + (size_t)pl.tile_rows * astride;  // (tile_rows, K)
  double* Os = Ms + (size_t)pl.tile_rows * K;        // (tile_rows, npad)
  int r_lo = 0, r_hi = NR, j_lo = 0, j_hi = m;
  if (pl.split_rows) {
    r_lo = min(NR, rank * pl.per_rank);
    r_hi = min(NR, r_lo + pl.per_rank);
  } else {
    j_lo = min(m, rank * pl.per_rank);
    j_hi = min(m, j_lo + pl.per_rank);
  }
  for (int c = t; c < K; c += nt) sm.flags[c] = 0;
  // this thread's item: row pair (rp, rp + half), column group g, lane
  // jl; a warp's lanes run over rows and partners at one column group, so
  // its partner-tile reads are broadcasts
  const int L = pl.lanes, half = pl.tile_rows / 2;
  const int jl = t % L, rp = (t / L) % half, g = t / L / half;
  const bool active = g < cc.ng;
  const double* A = g < cc.gy ? Rs : Ws;
  const int col0 = 4 * g;

  // a CTA whose partners fit one tile stages them once
  const bool one_tile = j_hi - j_lo <= pl.tile_j;
  for (int rt0 = r_lo; rt0 < r_hi; rt0 += pl.tile_rows) {
    const int nr = min(pl.tile_rows, r_hi - rt0);
    double acc0[4] = {0.0, 0.0, 0.0, 0.0}, acc1[4] = {0.0, 0.0, 0.0, 0.0};
    __syncthreads();  // the last pass's reads of Ms and the flags' reset
    for (int e = t; e < pl.tile_rows * K; e += nt) {
      const int row = e / K;
      Ms[e] = row < nr ? (double)M[(size_t)(rt0 + row) * K + e - row * K]
                       : 0.0;
    }
    for (int jt0 = j_lo; jt0 < j_hi; jt0 += pl.tile_j) {
      const int nj = min(pl.tile_j, j_hi - jt0);
      __syncthreads();  // Bs, Rs and Ws are free
      if (!one_tile || rt0 == r_lo) {
        // the partner values, then their pair products from them
        const int ny = 4 * cc.gy;
        for (int e0 = t; e0 < nj * ny; e0 += kUnroll * nt) {
          float o[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {  // the loads first
            const int e = e0 + u * nt, j = e / ny, c = e - j * ny;
            o[u] = e < nj * ny && c < K ? O[(size_t)(jt0 + j) * K + c]
                                        : F(0.0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int e = e0 + u * nt, j = e / ny, c = e - j * ny;
            if (e >= nj * ny) break;
            if (o[u] > F(0.0)) sm.flags[c] = 1;
            Bs[(size_t)j * bstride + c] = (double)o[u];
          }
        }
        __syncthreads();
        const int nz = cc.npad - ny;
        for (int e = t; e < nj * nz; e += nt) {
          const int j = e / nz, q = e - j * nz;
          double* Bj = Bs + (size_t)j * bstride;
          double v = 0.0;
          if (q < cc.kp) {
            const int pq = sm.pair[q];
            v = Bj[pq & 0xffff] * Bj[pq >> 16];  // exact
          }
          Bj[ny + q] = v;
        }
      }
      // the row tiles: W, and R from the partner values staged above
      for (int e0 = t; e0 < pl.tile_rows * nj; e0 += kUnroll * nt) {
        float x[kUnroll], w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {  // the loads first
          const int e = e0 + u * nt, row = e / nj;
          const size_t at = (size_t)(rt0 + row) * m + jt0 + e - row * nj;
          const bool in = e < pl.tile_rows * nj && row < nr;
          x[u] = in ? X[at] : F(0.0);
          w[u] = in ? W[at] : F(0.0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * nt, row = e / nj, j = e - row * nj;
          if (e >= pl.tile_rows * nj) break;
          const double* Mr = Ms + row * K;
          const double* Oj = Bs + (size_t)j * bstride;
          double ap = 0.0;
          for (int c = 0; c < K; ++c) ap = __fma_rn(Mr[c], Oj[c], ap);
          const double wd = (double)w[u];
          Rs[(size_t)row * astride + j] = ((double)x[u] - ap) * wd;
          Ws[(size_t)row * astride + j] = wd;
        }
      }
      __syncthreads();
      if (active) {
        const double* a0 = A + (size_t)rp * astride;
        const double* a1 = A + (size_t)(rp + half) * astride;
        for (int j = jl; j < nj; j += L) {
          const double x0 = a0[j], x1 = a1[j];
          const double2* b =
              (const double2*)(Bs + (size_t)j * bstride + col0);
          const double2 b01 = b[0], b23 = b[1];
          acc0[0] = __fma_rn(x0, b01.x, acc0[0]);
          acc0[1] = __fma_rn(x0, b01.y, acc0[1]);
          acc0[2] = __fma_rn(x0, b23.x, acc0[2]);
          acc0[3] = __fma_rn(x0, b23.y, acc0[3]);
          acc1[0] = __fma_rn(x1, b01.x, acc1[0]);
          acc1[1] = __fma_rn(x1, b01.y, acc1[1]);
          acc1[2] = __fma_rn(x1, b23.x, acc1[2]);
          acc1[3] = __fma_rn(x1, b23.y, acc1[3]);
        }
      }
    }
    // the lanes' sums into lane 0, in a fixed order (lanes divides 32)
    for (int off = L / 2; off > 0; off >>= 1)
      for (int q = 0; q < 4; ++q) {
        acc0[q] = acc0[q] + __shfl_xor_sync(0xffffffffu, acc0[q], off);
        acc1[q] = acc1[q] + __shfl_xor_sync(0xffffffffu, acc1[q], off);
      }
    // the tile's sums through shared memory, then out row by row
    if (active && jl == 0)
      for (int q = 0; q < 4; ++q) {
        Os[(size_t)rp * cc.npad + col0 + q] = acc0[q];
        Os[(size_t)(rp + half) * cc.npad + col0 + q] = acc1[q];
      }
    __syncthreads();
    if (pl.split_rows)
      write_tables(cc, Os, nr, Y + (size_t)rt0 * K, SQ + (size_t)rt0 * K,
                   Z + (size_t)rt0 * K * K);
    else
      for (int e = t; e < nr * cc.npad; e += nt)
        part[((size_t)rank * NR + rt0) * cc.npad + e] = Os[e];
  }
  if (pl.split_rows) {  // every CTA saw every partner: rank 0's flags do
    __syncthreads();
    if (rank == 0)
      for (int c = t; c < K; c += nt) colnz[c] = sm.flags[c];
  } else {
    cluster.sync();  // every rank's partials and flags are written
    if (rank == 0)
      for (int c = t; c < K; c += nt) {
        int any = 0;
        for (int q = 0; q < CL; ++q) any |= *cluster.map_shared_rank(
                                                &sm.flags[c], q);
        colnz[c] = any;
      }
    const size_t n_out = (size_t)NR * cc.npad;
    for (size_t e = (size_t)rank * nt + t; e < n_out; e += (size_t)CL * nt) {
      double v = __ldcg(part + e);
      for (int q = 1; q < CL; ++q) v = v + __ldcg(part + q * n_out + e);
      put(cc, sm.pair, (int)(e / cc.npad), (int)(e % cc.npad), v, Y, SQ, Z);
    }
  }
  cluster.sync();
}

// The A (a_side) or P tables of this cluster's chain from the factors
// M_a, M_p (chain-stacked).
__device__ void rebuild_side(const Rebuild& rb, bool a_side,
                             const float* M_a, const float* M_p) {
  const int CL = (int)cg::this_cluster().num_blocks();
  const size_t chain = blockIdx.x / CL;
  const int G = rb.G, S = rb.S, K = rb.K;
  const size_t GS = (size_t)G * S, GK = (size_t)G * K, SK = (size_t)S * K;
  double* part = rb.part + chain * CL * min(G, S) * Cols(K).npad;
  const float* Ma = M_a + chain * GK;
  const float* Mp = M_p + chain * SK;
  if (a_side)
    rebuild(rb.a, G, S, K, rb.D + chain * GS, rb.inv + chain * GS, Ma, Mp,
            rb.Ya + chain * GK, rb.SQa + chain * GK, rb.Za + chain * GK * K,
            rb.colnz_a + chain * K, part);
  else
    rebuild(rb.p, S, G, K, rb.D_t + chain * GS, rb.inv_t + chain * GS, Mp,
            Ma, rb.Yp + chain * SK, rb.SQp + chain * SK,
            rb.Zp + chain * SK * K, rb.colnz_p + chain * K, part);
}

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

// Rank 0's sweeps of the A (a_side) or P sampler in iteration it, and
// their counters. A call of its own: ptxas then spills ~270 bytes in it
// and ~300 in the kernel, against ~900-1000 with the sweeps inlined
// beside the rebuilds, and on an H100 the sweeps ran as fast or up to 9%
// faster. It takes everything from the kernel's arguments, which are
// __grid_constant__ so that nothing is copied for the call (copied, the
// sweeps ran 7% slower).
__device__ __noinline__ void sweep_side(const SpanArgs& s,
                                        const cogaps::SweepArgs& p0,
                                        bool a_side, int it) {
  const int chain = blockIdx.x / (int)cg::this_cluster().num_blocks();
  const int K = s.rb.K;
  const size_t nb = (size_t)(a_side ? s.rb.G : s.rb.S) * K;
  cogaps::DenseModel model{K, (a_side ? s.rb.Ya : s.rb.Yp) + chain * nb,
                           (a_side ? s.rb.SQa : s.rb.SQp) + chain * nb,
                           (a_side ? s.rb.Za : s.rb.Zp) + chain * nb * K};
  cogaps::SweepArgs p = p0;
  p.temp = s.phase == 0 ? fminf(F(1.0), F(2 * it) / F(s.n_iterations))
                        : F(1.0);
  p.key1 = stream_key(s.phase, it, a_side ? 0 : 1);
  cogaps::sweep_chain(p, model, chain);
  __syncthreads();
  if (threadIdx.x == 0) fold_counts(s, chain, a_side ? 0 : 1, p0.out);
}

// The sampling phase's max-normalized posterior sums of this cluster's
// chain (GapsStatistics.h:130-149), over the cluster's CTAs.
__device__ void accumulate(const SpanArgs& s, const float* M_a,
                           const float* M_p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t chain = blockIdx.x / CL;
  const int t = threadIdx.x, nt = blockDim.x, S = s.rb.S, K = s.rb.K;
  const size_t GK = (size_t)s.rb.G * K, SK = (size_t)S * K;
  const float* Ma = M_a + chain * GK;
  const float* Mp = M_p + chain * SK;
  float* norm = carve(K).norm;
  for (int c = t; c < K; c += nt) {
    float mx = Mp[c];
    for (int r = 1; r < S; ++r) mx = fmaxf(mx, Mp[r * K + c]);
    norm[c] = mx == F(0.0) ? F(1.0) : mx;
  }
  __syncthreads();
  const size_t first = (size_t)rank * nt + t, step = (size_t)CL * nt;
  float* ps = s.p_sum + chain * SK;
  float* pq = s.p_sumsq + chain * SK;
  for (size_t e = first; e < SK; e += step) {
    const float q = Mp[e] / norm[e % K];
    ps[e] = ps[e] + q;
    pq[e] = pq[e] + q * q;
  }
  float* as = s.a_sum + chain * GK;
  float* aq = s.a_sumsq + chain * GK;
  for (size_t e = first; e < GK; e += step) {
    const float prod = Ma[e] * norm[e % K];
    as[e] = as[e] + prod;
    aq[e] = aq[e] + prod * prod;
  }
  if (rank == 0 && t == 0) s.n_stat[chain] += 1;
}

__global__ void __launch_bounds__(cogaps::kMaxB)
    span_kernel(const __grid_constant__ SpanArgs s,
                const __grid_constant__ cogaps::SweepArgs pa0,
                const __grid_constant__ cogaps::SweepArgs pp0) {
  cg::cluster_group cluster = cg::this_cluster();
  const bool rank0 = cluster.block_rank() == 0;
  fill_pairs(s.rb.K);
  for (int i = 0; i < s.n_it; ++i) {
    if (rank0 && threadIdx.x == 0) {  // read by sweep_side after a barrier
      const int chain = blockIdx.x / (int)cluster.num_blocks();
      const float* z = s.z + ((size_t)chain * s.n_it + i) * 2;
      s.budget_a[chain] = budget_of(z[0], pa0.n[chain]);
      s.budget_p[chain] = budget_of(z[1], pp0.n[chain]);
    }
    rebuild_side(s.rb, true, pa0.M, pp0.M);
    if (rank0) sweep_side(s, pa0, true, s.it0 + i);
    cluster.sync();
    rebuild_side(s.rb, false, pa0.M, pp0.M);
    if (rank0) sweep_side(s, pp0, false, s.it0 + i);
    cluster.sync();
    if (s.phase == 1) accumulate(s, pa0.M, pp0.M);
  }
}

// The tables of both samplers from one state, without sweeping: the
// counterpart of tools/probe_rebuild.py's check of the TPU kernel's
// in-kernel rebuild contractions.
__global__ void __launch_bounds__(cogaps::kMaxB)
    rebuild_kernel(const Rebuild rb, const float* Ma, const float* Mp) {
  fill_pairs(rb.K);
  rebuild_side(rb, true, Ma, Mp);
  rebuild_side(rb, false, Ma, Mp);
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int n_ctas,
                                  int cl, int threads, int smem,
                                  void* stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One cluster of `cl` CTAs a chain; a launch the card refuses returns its
// error (nothing falls back).
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int nch, int cl, int threads,
                    int smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)  // the rest of the SM's 256 KB stays L1 for the sweeps
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, nch * cl, cl, threads, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

SidePlan side_plan(const int* v) {
  return SidePlan{v[0], v[1], v[2], v[3], v[4]};
}

Rebuild make_rebuild(int G, int S, int K, const int* plan, const float* D,
                     const float* inv, const float* D_t, const float* inv_t,
                     double* part, float* Ya, float* SQa, float* Za,
                     float* Yp, float* SQp, float* Zp, int* colnz_a,
                     int* colnz_p) {
  Rebuild rb;
  rb.G = G;
  rb.S = S;
  rb.K = K;
  rb.a = side_plan(plan);
  rb.p = side_plan(plan + 5);
  rb.D = D;
  rb.inv = inv;
  rb.D_t = D_t;
  rb.inv_t = inv_t;
  rb.part = part;
  rb.Ya = Ya;
  rb.SQa = SQa;
  rb.Za = Za;
  rb.Yp = Yp;
  rb.SQp = SQp;
  rb.Zp = Zp;
  rb.colnz_a = colnz_a;
  rb.colnz_p = colnz_p;
  return rb;
}

bool bad_shape(int nch, int cl, int threads) {
  return nch < 1 || cl < 1 || threads < 32 || threads > cogaps::kMaxB ||
         threads % 32;
}

}  // namespace

// How many clusters of `cl` CTAs of `threads` threads and `smem` bytes of
// dynamic shared memory the card keeps resident at once: of span_kernel
// (kernel 0) or rebuild_kernel (1).
extern "C" int cogaps_span_max_clusters(int kernel, int cl, int threads,
                                        int smem, int* n_clusters) {
  const void* fn = kernel == 0 ? (const void*)span_kernel
                               : (const void*)rebuild_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, cl, cl, threads, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, fn, &cfg);
}

// plan: the A side's then the P side's SidePlan fields, five ints each.
extern "C" int cogaps_span_launch(
    int nch, int G, int S, int K, int n_it, int phase, int it0,
    int n_iterations, int B_a, int C_a, int B_p, int C_p, int local_moves,
    int threads, int cl, int smem, const int* plan, float alpha_nb_a,
    float dom_len_a, float alpha_nb_p, float dom_len_p, const float* lam_a,
    const float* mgm_a, const float* lam_p, const float* mgm_p,
    const float* D, const float* inv, const float* D_t, const float* inv_t,
    const float* z, float* mass_a, int* elem_a, int* n_a, float* mass_p,
    int* elem_p, int* n_p, float* Ma, float* Mp, float* a_sum,
    float* a_sumsq, float* p_sum, float* p_sumsq, int* n_stat,
    long long* upd, int* prop, int* acc, int* sweeps, double* part,
    float* Ya, float* SQa, float* Za, float* Yp, float* SQp, float* Zp,
    int* colnz_a, int* colnz_p, int* budget_a, int* budget_p, int* out_a,
    int* out_p, int* claims_a, int* claims_p, const long long* key0,
    void* stream) {
  if (bad_shape(nch, cl, threads) || B_a < 1 || B_a > threads || B_p < 1 ||
      B_p > threads || n_it < 1)
    return (int)cudaErrorInvalidValue;
  SpanArgs s;
  s.n_it = n_it;
  s.phase = phase;
  s.it0 = it0;
  s.n_iterations = n_iterations;
  s.rb = make_rebuild(G, S, K, plan, D, inv, D_t, inv_t, part, Ya, SQa, Za,
                      Yp, SQp, Zp, colnz_a, colnz_p);
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
  return launch_clusters(span_kernel, nch, cl, threads, smem, stream, s, pa,
                         pp);
}

extern "C" int cogaps_span_rebuild(
    int nch, int G, int S, int K, int threads, int cl, int smem,
    const int* plan, const float* D, const float* inv, const float* D_t,
    const float* inv_t, const float* Ma, const float* Mp, double* part,
    float* Ya, float* SQa, float* Za, int* colnz_a, float* Yp, float* SQp,
    float* Zp, int* colnz_p, void* stream) {
  if (bad_shape(nch, cl, threads)) return (int)cudaErrorInvalidValue;
  const Rebuild rb = make_rebuild(G, S, K, plan, D, inv, D_t, inv_t, part,
                                  Ya, SQa, Za, Yp, SQp, Zp, colnz_a, colnz_p);
  return launch_clusters(rebuild_kernel, nch, cl, threads, smem, stream, rb,
                         Ma, Mp);
}
