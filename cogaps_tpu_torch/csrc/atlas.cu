// CoGAPS sparse-model sweep kernel for Hopper (sm_90a), over CSR rows.
//
// Replaces cogaps_tpu/ops/pallas_atlas.py::_kernel_atlas (body
// _sweep_atlas, wrapper run_updates_atlas): one sampler's whole
// update(nSteps) of the sparse normal model for NCH chains in one launch,
// with no per-row tables. It computes the function of ops/sweep.py with
// models/sparse.make_model (its plain version): the sweep is
// sweep_common.cuh::sweep_chain, and this file gives it the sparse
// model's alphaParameters. For a kept lane with rows r1, r2 and columns
// c1, c2, one warp walks the nonzeros j of row r1 (and of r2 when it
// differs), its 32 threads striding over them: each gathers the partner
// row other[idx_j] (k floats) and d_j, forms ap = other[idx_j] . M[r1],
// and accumulates sum v^2, sum (v/d)^2, sum (v/d + (v - (v/d)/d) ap) and
// the pre-cancellation magnitudes of the noise floor, plus the same-row
// pair sums over v1 - v2. Warp shuffles reduce them; the Z2-side dots
// M[r] . Z2[:, c] are split over the warp the same way. The closed forms
// then follow models/sparse.py with its stable regroupings and floors.
// An accepted change writes only M (kept lanes' rows are disjoint); the
// partner factor is frozen for the call, so nothing per nonzero changes.
// The TPU kernel's paired 128-lane planes, mirror metadata lanes and
// per-phase plane rebuild exist for Mosaic's DMA rules and are not
// carried over: the warp reads the partner rows through the CSR column
// indices.
//
// Each float operation follows the plain version's order (d divides, as
// there), and the file is compiled with -fmad=false; only the sums over a
// row's nonzeros and over k are taken in another order than torch.sum,
// so kernel and plain version agree to rounding, not bit for bit.
//
// What bounds it on the H100: per kept lane, a row's nnz partner rows of
// k floats (1,000 x 50 at the atlas shape) are read from L2 (the
// 50,000 x 50 partner factor is 10 MB and stays there), so a sweep of
// 512 lanes gathers ~100 MB through one SM's load units, at L2 latency:
// one block per chain uses one SM of 132 at NCH = 1. The block runs 32
// warps whatever B is, holds the factor row in registers (k <= 64) and
// keeps four partner loads in flight per thread. Its time is in PERF.md
// beside its bound; spreading a sweep's lanes over the card is later
// work.

#include "sweep_common.cuh"

namespace {

using cogaps::Alpha;
using cogaps::kMaxB;
using cogaps::Proposal;

constexpr int kMaxK = 64;  // a factor row is two registers per thread
constexpr float kBeta = 100.0f;      // models/sparse.BETA
constexpr float kNoiseEps = 1.0e-6f;  // models/sparse.NOISE_EPS

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element kk of a factor row held as m_lo = row[lane], m_hi =
// row[lane + 32] across the warp
__device__ __forceinline__ float bcast(float m_lo, float m_hi, int kk) {
  return __shfl_sync(0xffffffffu, kk < 32 ? m_lo : m_hi, kk & 31);
}

struct CsrModel {
  int B, K;
  const float* M;      // this chain's (NR, K) factor, read at sweep start
  const float* other;  // (m, K) frozen partner factor
  const float* Z2;     // (K, K) = other^T other
  const long long* indptr;  // (NR + 1) offsets into idx/val
  const int* idx;
  const float* val;

  // one pass over the nonzeros of row r for column c (and the same-row
  // pair sums for column c2 when `same`), on the calling warp's threads.
  // The factor row M[r] sits in two registers per thread (k <= 64) and
  // is broadcast by shuffles; ap is summed in four independent partial
  // sums so that a thread keeps several partner loads in flight, two
  // floats a load when k is even.
  __device__ void row_pass(int r, int c, int c2, bool same, float* a) const {
    const int wl = threadIdx.x & 31;
    const float* Mr = M + (size_t)r * K;
    const float m_lo = wl < K ? Mr[wl] : F(0.0);
    const float m_hi = wl + 32 < K ? Mr[wl + 32] : F(0.0);
    const long long start = indptr[r], end = indptr[r + 1];
    for (long long base = start; base < end; base += 32) {  // warp-uniform
      const long long j = base + wl;
      const bool valid = j < end;
      const float* o = other + (size_t)(valid ? idx[j] : 0) * K;
      float p[4] = {F(0.0), F(0.0), F(0.0), F(0.0)};
      int kk = 0;
      if ((K & 1) == 0) {  // rows are 8-byte aligned: two floats a load
        const float2* o2 = reinterpret_cast<const float2*>(o);
        for (; kk + 4 <= K; kk += 4) {
          const float2 x = o2[kk >> 1], y = o2[(kk >> 1) + 1];
          p[0] = p[0] + x.x * bcast(m_lo, m_hi, kk);
          p[1] = p[1] + x.y * bcast(m_lo, m_hi, kk + 1);
          p[2] = p[2] + y.x * bcast(m_lo, m_hi, kk + 2);
          p[3] = p[3] + y.y * bcast(m_lo, m_hi, kk + 3);
        }
        if (kk < K) {  // k = 2 mod 4
          const float2 x = o2[kk >> 1];
          p[0] = p[0] + x.x * bcast(m_lo, m_hi, kk);
          p[1] = p[1] + x.y * bcast(m_lo, m_hi, kk + 1);
          kk += 2;
        }
      }
      for (; kk + 4 <= K; kk += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = p[i] + o[kk + i] * bcast(m_lo, m_hi, kk + i);
      }
      for (; kk < K; ++kk) p[0] = p[0] + o[kk] * bcast(m_lo, m_hi, kk);
      if (!valid) continue;
      const float ap = (p[0] + p[1]) + (p[2] + p[3]);
      const float d = val[j];
      const float v = o[c];
      const float t1 = v / d;
      a[0] += v * v;
      a[1] += t1 * t1;
      a[2] += t1 + (v - t1 / d) * ap;
      a[3] += t1 + (v + t1 / d) * ap;
      if (same) {
        const float v12 = o[c2];
        const float dr = F(1.0) / d;
        const float w = F(1.0) - dr * dr;
        const float vdiff = v - v12;
        const float vdr = vdiff * dr;
        a[4] += vdiff * vdiff;
        a[5] += vdr * vdr;
        a[6] += vdiff * (ap * w + dr);
        a[7] += (v + v12) * (ap * (F(1.0) + dr * dr) + dr);
      }
    }
  }

  __device__ Alpha alpha(const Proposal& q) const {
    __shared__ int s_r1[kMaxB], s_r2[kMaxB], s_c1[kMaxB], s_c2[kMaxB];
    __shared__ float s_out[6][kMaxB];
    const int lane = threadIdx.x;
    if (lane < B) {
      s_r1[lane] = q.keep ? q.r1 : -1;
      s_r2[lane] = (q.is_move || q.is_exch) ? q.r2 : -1;  // -1: no pair
      s_c1[lane] = q.c1;
      s_c2[lane] = q.c2;
    }
    __syncthreads();
    const int wid = lane >> 5, wl = lane & 31, nw = blockDim.x >> 5;
    for (int L = wid; L < B; L += nw) {
      const int r1 = s_r1[L];
      if (r1 < 0) continue;  // warp-uniform
      const int r2 = s_r2[L], c1 = s_c1[L], c2 = s_c2[L];
      const bool pair = r2 >= 0;
      const bool same = pair && r2 == r1;
      float a[8] = {F(0.0), F(0.0), F(0.0), F(0.0),
                    F(0.0), F(0.0), F(0.0), F(0.0)};
      row_pass(r1, c1, c2, same, a);
      if (pair && !same) {  // row r2's single-element sums into a[4:8]
        float b[8] = {F(0.0), F(0.0), F(0.0), F(0.0),
                      F(0.0), F(0.0), F(0.0), F(0.0)};
        row_pass(r2, c2, c2, false, b);
        for (int i = 0; i < 4; ++i) a[4 + i] = b[i];
      }
      // Z2-side dots: z[0] = M[r1].Z2[:,c1]; same row: z[1], z[2] =
      // M[r1].(Z2[:,c1] -/+ Z2[:,c2]); other row: z[1] = M[r2].Z2[:,c2]
      float z[3] = {F(0.0), F(0.0), F(0.0)};
      const float* M1 = M + (size_t)r1 * K;
      for (int kk = wl; kk < K; kk += 32) {
        const float zc1 = Z2[kk * K + c1];
        z[0] += M1[kk] * zc1;
        if (same) {
          const float zc2 = Z2[kk * K + c2];
          z[1] += M1[kk] * (zc1 - zc2);
          z[2] += M1[kk] * (zc1 + zc2);
        } else if (pair) {
          z[1] += M[(size_t)r2 * K + kk] * Z2[kk * K + c2];
        }
      }
      for (int i = 0; i < 8; ++i) a[i] = warp_sum(a[i]);
      for (int i = 0; i < 3; ++i) z[i] = warp_sum(z[i]);
      if (wl == 0) {
        const float z1c1 = Z2[c1 * K + c1], z1c2 = Z2[c2 * K + c2];
        const float s1 = fmaxf(z1c1 - a[0], F(0.0)) + a[1];
        const float smu1 = -z[0] + a[2];
        const float err1 = kNoiseEps * (z[0] + a[3]);
        float s_pair = F(0.0), smu_pair = F(0.0), err_pair = F(0.0);
        if (same) {
          const float s_zero = z1c1 - F(2.0) * Z2[c1 * K + c2] + z1c2 - a[4];
          s_pair = fmaxf(s_zero, F(0.0)) + a[5];
          smu_pair = -z[1] + a[6];
          err_pair = kNoiseEps * (z[2] + a[7]);
        } else if (pair) {
          const float s2 = fmaxf(z1c2 - a[4], F(0.0)) + a[5];
          const float smu2 = -z[1] + a[6];
          const float err2 = kNoiseEps * (z[1] + a[7]);
          s_pair = s1 + s2;
          smu_pair = smu1 - smu2;
          err_pair = err1 + err2;
        }
        s_out[0][L] = kBeta * s1;
        s_out[1][L] = kBeta * smu1;
        s_out[2][L] = kBeta * s_pair;
        s_out[3][L] = kBeta * smu_pair;
        s_out[4][L] = kBeta * err1;
        s_out[5][L] = kBeta * err_pair;
      }
    }
    __syncthreads();
    Alpha ab = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
    if (q.keep) {
      ab.s1 = s_out[0][lane];
      ab.smu1 = s_out[1][lane];
      ab.s_pair = s_out[2][lane];
      ab.smu_pair = s_out[3][lane];
      ab.err1 = s_out[4][lane];
      ab.err_pair = s_out[5][lane];
    }
    return ab;
  }

  __device__ void apply(int, int, float) const {}  // no cache: M only
};

__global__ void __launch_bounds__(kMaxB)
    atlas_kernel(const cogaps::SweepArgs p, int m, const float* other,
                 const float* Z2, const long long* indptr, const int* idx,
                 const float* val) {
  const int c = blockIdx.x;
  CsrModel model{p.B,
                 p.K,
                 p.M + (size_t)c * p.NB,
                 other + (size_t)c * m * p.K,
                 Z2 + (size_t)c * p.K * p.K,
                 indptr + (size_t)c * (p.NR + 1),
                 idx,
                 val};
  cogaps::sweep_chain(p, model);
}

}  // namespace

extern "C" int cogaps_atlas_launch(
    int nch, int B, int C, int NR, int K, int m, int local_moves,
    float alpha_nb, float dom_len, float temp, const float* lam,
    const float* mgm, const int* budget, float* mass, int* elem, int* n,
    float* M, const float* other, const float* Z2, const long long* indptr,
    const int* idx, const float* val, const int* colnz, int* scratch,
    int* out, const float* uni, int s_max, const long long* key0,
    uint32_t key1, void* stream) {
  if (B < 1 || B > kMaxB || nch < 1 || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const cogaps::SweepArgs p = cogaps::make_args(
      nch, B, C, NR, K, local_moves, alpha_nb, dom_len, temp, lam, mgm,
      budget, mass, elem, n, M, colnz, scratch, out, uni, s_max, key0, key1);
  // all 32 warps work on the alpha terms; lanes >= B propose nothing
  atlas_kernel<<<nch, kMaxB, 0, (cudaStream_t)stream>>>(p, m, other, Z2,
                                                          indptr, idx, val);
  return (int)cudaGetLastError();
}
