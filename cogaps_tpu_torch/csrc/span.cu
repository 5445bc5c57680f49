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
// rounded once to float32. The order of every sum follows from the
// sampler's shape (rows NR, partners m, k) alone -- never from the cluster
// size, the chain count or a chain's index -- so a chain's tables have the
// same bits alone and beside any other chains. The order reaches the
// float32 result only when a sum lies within a few float64 ulps of a
// float32 rounding boundary; decisions, which sit on float thresholds,
// then match the plain version's (cuBLAS in float64). The A sampler's pair
// term is a Z table (G k^2 floats), not the TPU kernel's on-the-fly dot
// over the invS2 row: the sweep is then K1's, on the same tables as its
// plain version.
//
// Design: one thread-block cluster of CL CTAs per chain
// (span_cuda.cluster_size: the largest of 16 -- a non-portable size --
// 8, 4, 2 and 1 whose chains the card keeps resident, one CTA an SM;
// chains are independent, so nothing waits on another cluster). Cluster
// barriers separate the steps; the shared memory past a small fixed part
// is one region that the rebuild's tiles and the sweep's staged state
// take in turn.
//   - The table rebuilds, float64 contractions, run on every CTA of the
//     cluster. One sampler's rebuild (rows r < NR, partners j < m, data X
//     and weights W (NR, m), factor M (NR, k), partner factor O (m, k))
//     forms, per row,
//       Y[r,c]  = sum_j R[r,j] O[j,c],  R[r,j] = (X[r,j] - M[r,:].O[j,:]) W[r,j]
//       Z[r,c,c'] = sum_j W[r,j] O[j,c] O[j,c']  (c <= c'; SQ[r,c] = Z[r,c,c])
//     as one product of [R | W] with the columns [O | O_c O_c'] (Y's k
//     columns, then the k(k+1)/2 pairs, each part padded to 8) on the FP64
//     tensor cores: mma.sync m16n8k4 .f64, a warp an item of 16 rows by up
//     to kNTW column tiles of 8, accumulating in registers over the
//     partners 4 at a time in order (the instruction adds its four
//     products one at a time, each rounded as by an FMA: a sum is the
//     chain of FMAs over its partners in order). span_cuda.rebuild_plan sets the
//     work: the partners fall into chunks (one below 256 partners where
//     rows are many) whose float64 partials are added in chunk order after
//     a cluster barrier (no atomics); units of (row tile, chunk) are dealt
//     to the cluster's CTAs in contiguous runs of equal length. A CTA
//     stages a unit's partner values, their pair products and a tile of
//     rows (W, and the residual R formed there: no R in device memory) in
//     shared memory, the partners tile_j at a time; a chunk that fits one
//     tile is staged once for the CTA's units that share it.
//   - The sweeps are sequential and run on the cluster's rank-0 CTA, one
//     thread a proposal lane, on K1's staged state: span_cuda.sweep_plan
//     places claims, hole flags, the atom table, Y, SQ, M and Z in shared
//     memory as ops/sweep_cuda.smem_plan does for K1, dense_model.cuh's
//     stage_chain copies them in after the rebuild, and mass, elem and M
//     go back to device memory after the sweeps (Y is rebuilt, not kept).
//     A sampler of at most 32 lanes sweeps on one warp (sweep_chain's
//     one-warp form), the CTA's other warps waiting at the barrier after.
// What bounds it on the H100 (chip_smoke.py phase 3, PERF.md): at GIST
// x16 the sweeps, dependent reads and block barriers on one SM a chain;
// at 20000 x 100 the rebuild's float64 operations and its staging.

#include <cooperative_groups.h>

#include "dense_model.cuh"

namespace cg = cooperative_groups;

namespace {

using cogaps::kNOut;

// staged entries a thread loads before it uses them: global reads in
// flight together instead of one round trip each
constexpr int kUnroll = 4;
// column tiles of 8 a warp's item holds (span_cuda.NTW)
constexpr int kNTW = 3;
// ints of one sampler's launch plan: SidePlan, then the sweep's placement
constexpr int kPlanInts = 6 + cogaps::kNPlaced;

// One sampler's rebuild plan (span_cuda.rebuild_plan).
struct SidePlan {
  int cj;         // partners of a chunk (a multiple of 4; the last shorter)
  int nchunk;     // chunks, their partials added in chunk order
  int tile_rows;  // rows of a unit (a multiple of 16: 16 a warp item)
  int tile_j;     // partners staged a pass (a multiple of 4)
  int cb_wave;    // column blocks a pass over the partners takes
  int ncb;        // column blocks of the [O | O_c O_c'] columns
};

// Both samplers' rebuilds of every chain.
struct Rebuild {
  int G, S, K;
  SidePlan a, p;
  const float* D;      // (nch, G, S)
  const float* inv;    // (nch, G, S) = 1/S^2
  const float* D_t;    // (nch, S, G)
  const float* inv_t;  // (nch, S, G)
  double* part;        // (nch, part_stride) chunk partials
  long long part_stride;
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

// Output columns of a row: Y's k in column tiles [0, ny), then the pairs
// c <= c' of Z in [ny, nt), eight columns a tile.
struct Cols {
  int K, kp, ny, nt, ncols;
  __device__ explicit Cols(int K_) : K(K_), kp(K_ * (K_ + 1) / 2) {
    ny = (K + 7) / 8;
    nt = ny + (kp + 7) / 8;
    ncols = 8 * nt;
  }
};

// first column tile of column block b of ncb (span_cuda.block_start)
__device__ __forceinline__ int block_start(int nt, int ncb, int b) {
  return b * nt / ncb;
}

// The CTA's shared memory: the pair table, col_nz flags and column norms,
// then the region the rebuild's tiles and the sweep's state take in turn.
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
  if (col < 8 * cc.ny) {
    if (col < K) Y[(size_t)r * K + col] = f;
    return;
  }
  const int q = col - 8 * cc.ny;
  if (q >= cc.kp) return;
  const int c = pair[q] & 0xffff, c2 = pair[q] >> 16;
  Z[((size_t)r * K + c) * K + c2] = f;
  Z[((size_t)r * K + c2) * K + c] = f;
  if (c == c2) SQ[(size_t)r * K + c] = f;
}

// c += a b on the FP64 tensor cores, the products added to c one at a
// time in k order, each rounded as by an FMA: a warp's 16 x 4 tile of A
// (row-major: a thread's a0 at row lane / 4, column lane % 4, a1 eight
// rows down) times its 4 x 8 tile of B (b at row lane % 4, column lane /
// 4) into its 16 x 8 tile of C (c0, c1 at row lane / 4, columns
// 2 (lane % 4) and one more; c2, c3 eight rows down).
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One sampler's tables (the rule and the plan above) by every CTA of the
// cluster: called by all their threads after a cluster barrier that
// follows the writes of M and O; ends with a cluster barrier. A call of
// its own: ptxas spills less (~300 bytes in it, ~250 in the kernels,
// against ~800 inlined) and on an H100 the rebuild ran up to 15% faster.
__device__ __noinline__ void rebuild(const SidePlan& pl, int NR, int m,
                                     int K, const float* X, const float* W,
                                     const float* M, const float* O,
                                     float* Y, float* SQ, float* Z,
                                     int* colnz, double* part) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, nth = blockDim.x;
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const Cols cc(K);
  const Smem sm = carve(K);
  // row strides of 4 mod 8 doubles: a warp's fragment reads hit distinct
  // banks in each half-warp; factor rows and partner values padded with
  // zeros to kp4 columns, the residual's products four at a time
  const int kp4 = (K + 3) & ~3, kstride = 8 * ((kp4 + 7) / 8) + 4;
  const int astride = 8 * ((pl.tile_j + 7) / 8) + 4;
  const int wave_nt = pl.cb_wave * ((cc.nt + pl.ncb - 1) / pl.ncb);
  const int bstride = 8 * wave_nt + 4;
  double* Ms = sm.tiles;                             // (tile_rows, kstride)
  double* Ov = Ms + (size_t)pl.tile_rows * kstride;  // (tile_j, kstride)
  double* Bs = Ov + (size_t)pl.tile_j * kstride;     // (tile_j, bstride)
  double* Rs = Bs + (size_t)pl.tile_j * bstride;     // (tile_rows, astride)
  double* Ws = Rs + (size_t)pl.tile_rows * astride;  // (tile_rows, astride)
  for (int c = t; c < K; c += nth) sm.flags[c] = 0;
  const int n_rt = (NR + pl.tile_rows - 1) / pl.tile_rows;
  const int n_units = n_rt * pl.nchunk;
  const int u_lo = rank * n_units / CL, u_hi = (rank + 1) * n_units / CL;
  const int n_waves = (pl.ncb + pl.cb_wave - 1) / pl.cb_wave;
  const int nsub = pl.tile_rows / 16;
  // this warp's item in a pass: rows [16 sub, 16 sub + 16) of the unit,
  // column block wcb of the pass's
  const int warp = t >> 5, g = (t & 31) >> 2, tq = t & 3;
  const int sub = warp % nsub, wcb = warp / nsub;
  int staged = -1;  // the (chunk, pass) whose partners Ov and Bs hold
  for (int u = u_lo; u < u_hi; ++u) {
    const int ch = u / n_rt, r0 = (u - ch * n_rt) * pl.tile_rows;
    const int nr = min(pl.tile_rows, NR - r0);
    const int j0 = ch * pl.cj, nj_ch = min(pl.cj, m - j0);
    const bool one_tile = nj_ch <= pl.tile_j;
    for (int wave = 0; wave < n_waves; ++wave) {
      const int cb0 = wave * pl.cb_wave;
      const int cb1 = min(pl.ncb, cb0 + pl.cb_wave);
      const int wn0 = block_start(cc.nt, pl.ncb, cb0);
      const int wcols = 8 * (block_start(cc.nt, pl.ncb, cb1) - wn0);
      const bool need_r = wn0 < cc.ny;  // Y's columns in this pass
      const int cb = cb0 + wcb;
      const bool active = wcb < pl.cb_wave && cb < cb1;
      const int n_lo = active ? block_start(cc.nt, pl.ncb, cb) : 0;
      const int n_cnt = active ? block_start(cc.nt, pl.ncb, cb + 1) - n_lo : 0;
      const bool item_r = n_lo < cc.ny, item_w = n_lo + n_cnt > cc.ny;
      double acc[kNTW][4];
#pragma unroll
      for (int n = 0; n < kNTW; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
      for (int jt = 0; jt < nj_ch; jt += pl.tile_j) {
        const int nj = min(pl.tile_j, nj_ch - jt), nj4 = (nj + 3) & ~3;
        const int njb = (nj + 7) / 8;  // blocks of 8 partners, zero-padded
        const int jg = j0 + jt, key = ch * n_waves + wave;
        const bool stage_b = !one_tile || staged != key;
        const bool first = wave == 0 && jt == 0;  // the unit's first pass
        __syncthreads();  // the tiles are free
        if (first)  // the unit's factor rows
          for (int e = t; e < pl.tile_rows * kp4; e += nth) {
            const int row = e / kp4, c = e - row * kp4;
            Ms[(size_t)row * kstride + c] =
                row < nr && c < K ? (double)M[(size_t)(r0 + row) * K + c]
                                  : 0.0;
          }
        if (stage_b)  // the partner values
          for (int e = t; e < 8 * njb * kp4; e += nth) {
            const int j = e / kp4, c = e - j * kp4;
            const float o =
                j < nj && c < K ? O[(size_t)(jg + j) * K + c] : F(0.0);
            if (o > F(0.0)) sm.flags[c] = 1;
            Ov[(size_t)j * kstride + c] = (double)o;
          }
        if (first || stage_b) __syncthreads();
        if (stage_b) {  // the pass's columns from the partner values
          for (int e = t; e < nj4 * wcols; e += nth) {
            const int j = e / wcols, col = 8 * wn0 + e - j * wcols;
            const double* o = Ov + (size_t)j * kstride;
            double v = 0.0;
            if (col < 8 * cc.ny) {
              if (col < K) v = o[col];
            } else if (col - 8 * cc.ny < cc.kp) {
              const int pq = sm.pair[col - 8 * cc.ny];
              v = o[pq & 0xffff] * o[pq >> 16];  // exact
            }
            Bs[(size_t)j * bstride + e - j * wcols] = v;
          }
          staged = one_tile ? key : -1;
        }
        // the row tiles: W, and the residual R = (X - M O^T) W, its
        // products M O^T on the tensor cores (the chain over c in order),
        // a warp 16 rows by 8 partners at a time
        for (int it = warp; it < nsub * njb; it += nth >> 5) {
          const int rs = 16 * (it % nsub), js = 8 * (it / nsub);
          float x[4], w[4];  // rows rs + g and 8 down, partners js + 2 tq
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // the loads first
            const int row = rs + g + 8 * (i >> 1), j = js + 2 * tq + (i & 1);
            const size_t at = (size_t)(r0 + row) * m + jg + j;
            const bool in = row < nr && j < nj;
            x[i] = in && need_r ? X[at] : F(0.0);
            w[i] = in ? W[at] : F(0.0);
          }
          double ap[4] = {0.0, 0.0, 0.0, 0.0};
          if (need_r) {
            const double* ma = Ms + (size_t)(rs + g) * kstride + tq;
            const double* ob = Ov + (size_t)(js + g) * kstride + tq;
            for (int q = 0; q < kp4; q += 4)
              dmma(ap, ma[q], ma[q + 8 * kstride], ob[q]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)(rs + g + 8 * h) * astride + js + 2 * tq;
            const double w0 = (double)w[2 * h], w1 = (double)w[2 * h + 1];
            if (need_r)
              *(double2*)(Rs + at) =
                  make_double2(((double)x[2 * h] - ap[2 * h]) * w0,
                               ((double)x[2 * h + 1] - ap[2 * h + 1]) * w1);
            *(double2*)(Ws + at) = make_double2(w0, w1);
          }
        }
        __syncthreads();
        if (active) {
          const double* ra = Rs + (size_t)(16 * sub + g) * astride + tq;
          const double* wa = Ws + (size_t)(16 * sub + g) * astride + tq;
          const double* bb = Bs + (size_t)tq * bstride + 8 * (n_lo - wn0) + g;
          const size_t a8 = (size_t)8 * astride;
          for (int kk = 0; kk < nj4; kk += 4) {
            const double r0v = item_r ? ra[kk] : 0.0;
            const double r1v = item_r ? ra[kk + a8] : 0.0;
            const double w0v = item_w ? wa[kk] : 0.0;
            const double w1v = item_w ? wa[kk + a8] : 0.0;
            const double* b = bb + (size_t)kk * bstride;
#pragma unroll
            for (int n = 0; n < kNTW; ++n)
              if (n < n_cnt) {
                const bool y = n_lo + n < cc.ny;
                dmma(acc[n], y ? r0v : w0v, y ? r1v : w1v, b[8 * n]);
              }
          }
        }
      }
      // this warp's sums: the tables where the chunk is the only one,
      // else the chunk's float64 partials
      if (active) {
#pragma unroll
        for (int n = 0; n < kNTW; ++n) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int row = 16 * sub + 8 * mt + g;
            const int col = 8 * (n_lo + n) + 2 * tq;
            if (n >= n_cnt || row >= nr) continue;
            const double v0 = acc[n][2 * mt], v1 = acc[n][2 * mt + 1];
            if (pl.nchunk == 1) {
              put(cc, sm.pair, r0 + row, col, v0, Y, SQ, Z);
              put(cc, sm.pair, r0 + row, col + 1, v1, Y, SQ, Z);
            } else {
              *(double2*)(part + ((size_t)ch * NR + r0 + row) * cc.ncols +
                          col) = make_double2(v0, v1);
            }
          }
        }
      }
    }
  }
  cluster.sync();  // every rank's partials and flags are written
  if (rank == 0)
    for (int c = t; c < K; c += nth) {
      int any = 0;
      for (int q = 0; q < CL; ++q)
        any |= *cluster.map_shared_rank(&sm.flags[c], q);
      colnz[c] = any;
    }
  if (pl.nchunk > 1) {  // the chunks' partials in chunk order, rounded once
    const size_t n_out = (size_t)NR * cc.ncols;
    for (size_t e = (size_t)rank * nth + t; e < n_out;
         e += (size_t)CL * nth) {
      const int col = (int)(e % cc.ncols);
      if (col < 8 * cc.ny ? col >= K : col - 8 * cc.ny >= cc.kp) continue;
      double v = __ldcg(part + e);
      int q = 1;
      for (; q + 8 <= pl.nchunk; q += 8) {  // eight loads in flight at once
        double r[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) r[i] = __ldcg(part + (q + i) * n_out + e);
#pragma unroll
        for (int i = 0; i < 8; ++i) v = v + r[i];
      }
      for (; q < pl.nchunk; ++q) v = v + __ldcg(part + q * n_out + e);
      put(cc, sm.pair, (int)(e / cc.ncols), col, v, Y, SQ, Z);
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
  double* part = rb.part + chain * rb.part_stride;
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


// Rank 0's sweeps of the A (a_side) or P sampler in iteration it, on the
// state p0.smem places in shared memory, and their counters. A call of
// its own: ptxas then spills less in it and in the kernel than with the
// sweeps inlined beside the rebuilds. It takes everything from the
// kernel's arguments, which are __grid_constant__ so that nothing is
// copied for the call.
__device__ __noinline__ void sweep_side(const SpanArgs& s,
                                        const cogaps::SweepArgs& p0,
                                        bool a_side, int it) {
  __shared__ cogaps::SweepShared sh;  // one for both samplers and forms
  const int chain = blockIdx.x / (int)cg::this_cluster().num_blocks();
  const int K = s.rb.K;
  const size_t nb = (size_t)(a_side ? s.rb.G : s.rb.S) * K;
  cogaps::SweepArgs p = p0;
  p.temp = s.phase == 0 ? fminf(F(1.0), F(2 * it) / F(s.n_iterations))
                        : F(1.0);
  p.key1 = stream_key(s.phase, it, a_side ? 0 : 1);
  // the tables were written by the cluster's CTAs in this launch: Z that
  // stays global is read through L1, not the read-only path
  const cogaps::StagedChain st = cogaps::stage_chain(
      p, reinterpret_cast<unsigned char*>(carve(K).tiles), chain,
      (a_side ? s.rb.Ya : s.rb.Yp) + chain * nb,
      (a_side ? s.rb.SQa : s.rb.SQp) + chain * nb,
      (a_side ? s.rb.Za : s.rb.Zp) + chain * nb * K, false);
  __syncthreads();  // every thread's copies, for the sweeping threads
  if (p.B <= 32) {
    if (threadIdx.x < 32)
      cogaps::sweep_chain<true>(p, st.ch, st.model, chain, sh);
  } else {
    cogaps::sweep_chain<false>(p, st.ch, st.model, chain, sh);
  }
  __syncthreads();
  cogaps::unstage_chain(p, st, false);
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

__global__ void __launch_bounds__(cogaps::kMaxB, 1)
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
__global__ void __launch_bounds__(cogaps::kMaxB, 1)
    rebuild_kernel(const Rebuild rb, const float* Ma, const float* Mp) {
  fill_pairs(rb.K);
  rebuild_side(rb, true, Ma, Mp);
  rebuild_side(rb, false, Ma, Mp);
}

const void* kernel_fn(int kernel) {
  return kernel == 0 ? (const void*)span_kernel : (const void*)rebuild_kernel;
}

// Sizes past the portable 8 are allowed; the shared memory asked for.
cudaError_t set_attributes(const void* fn, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return e;
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
  cudaError_t e = set_attributes((const void*)kernel, smem);
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
  return SidePlan{v[0], v[1], v[2], v[3], v[4], v[5]};
}

Rebuild make_rebuild(int G, int S, int K, const int* plan, const float* D,
                     const float* inv, const float* D_t, const float* inv_t,
                     double* part, long long part_stride, float* Ya,
                     float* SQa, float* Za, float* Yp, float* SQp, float* Zp,
                     int* colnz_a, int* colnz_p) {
  Rebuild rb;
  rb.G = G;
  rb.S = S;
  rb.K = K;
  rb.a = side_plan(plan);
  rb.p = side_plan(plan + kPlanInts);
  rb.D = D;
  rb.inv = inv;
  rb.D_t = D_t;
  rb.inv_t = inv_t;
  rb.part = part;
  rb.part_stride = part_stride;
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
  const void* fn = kernel_fn(kernel);
  const cudaError_t e = set_attributes(fn, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, cl, cl, threads, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_clusters, fn, &cfg);
}

// Static shared memory of span_kernel (kernel 0) or rebuild_kernel (1), in
// bytes, or a negative CUDA error.
extern "C" int cogaps_span_static_smem(int kernel) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_fn(kernel));
  return e == cudaSuccess ? (int)a.sharedSizeBytes : -(int)e;
}

// plan: the A side's then the P side's kPlanInts ints: SidePlan's fields,
// then the sweep's kNPlaced byte offsets (-1: global).
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
    long long part_stride, float* Ya, float* SQa, float* Za, float* Yp,
    float* SQp, float* Zp, int* colnz_a, int* colnz_p, int* budget_a,
    int* budget_p, int* out_a, int* out_p, int* claims_a, int* claims_p,
    const long long* key0, void* stream) {
  if (bad_shape(nch, cl, threads) || B_a < 1 || B_a > threads || B_p < 1 ||
      B_p > threads || n_it < 1)
    return (int)cudaErrorInvalidValue;
  SpanArgs s;
  s.n_it = n_it;
  s.phase = phase;
  s.it0 = it0;
  s.n_iterations = n_iterations;
  s.rb = make_rebuild(G, S, K, plan, D, inv, D_t, inv_t, part, part_stride,
                      Ya, SQa, Za, Yp, SQp, Zp, colnz_a, colnz_p);
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
  cogaps::SweepArgs pa = cogaps::make_args(
      nch, B_a, C_a, G, K, local_moves, alpha_nb_a, dom_len_a, F(1.0), lam_a,
      mgm_a, budget_a, mass_a, elem_a, n_a, Ma, colnz_a, claims_a, out_a,
      nullptr, 0, key0, 0u);
  cogaps::SweepArgs pp = cogaps::make_args(
      nch, B_p, C_p, S, K, local_moves, alpha_nb_p, dom_len_p, F(1.0), lam_p,
      mgm_p, budget_p, mass_p, elem_p, n_p, Mp, colnz_p, claims_p, out_p,
      nullptr, 0, key0, 0u);
  for (int i = 0; i < cogaps::kNPlaced; ++i) {
    pa.smem[i] = plan[6 + i];
    pp.smem[i] = plan[kPlanInts + 6 + i];
  }
  return launch_clusters(span_kernel, nch, cl, threads, smem, stream, s, pa,
                         pp);
}

extern "C" int cogaps_span_rebuild(
    int nch, int G, int S, int K, int threads, int cl, int smem,
    const int* plan, const float* D, const float* inv, const float* D_t,
    const float* inv_t, const float* Ma, const float* Mp, double* part,
    long long part_stride, float* Ya, float* SQa, float* Za, int* colnz_a,
    float* Yp, float* SQp, float* Zp, int* colnz_p, void* stream) {
  if (bad_shape(nch, cl, threads)) return (int)cudaErrorInvalidValue;
  const Rebuild rb =
      make_rebuild(G, S, K, plan, D, inv, D_t, inv_t, part, part_stride, Ya,
                   SQa, Za, Yp, SQp, Zp, colnz_a, colnz_p);
  return launch_clusters(rebuild_kernel, nch, cl, threads, smem, stream, rb,
                         Ma, Mp);
}
