// CoGAPS sparse-model sweep kernel for Hopper (sm_90a), over CSR rows.
//
// Replaces cogaps_tpu/ops/pallas_atlas.py::_kernel_atlas (body
// _sweep_atlas, wrapper run_updates_atlas): one sampler's whole
// update(nSteps) of the sparse normal model for NCH chains in one launch,
// with no per-row tables. It computes the function of ops/sweep.py with
// models/sparse.make_model (its plain version): the sweep halves of
// sweep_common.cuh around the sparse model's alphaParameters. For a kept
// lane with rows r1, r2 and columns c1, c2 these are sums over the
// nonzeros j of row r1 (and of r2 when it differs): with the partner row
// o = other[idx_j], d_j, ap = o . M[r1] and v = o[c1], the terms v^2,
// (v/d)^2, v/d + (v - (v/d)/d) ap and the noise floor's pre-cancellation
// magnitudes, plus the same-row pair terms over v1 - v2; then the Z2-side
// dots M[r] . Z2[:, c] and the closed forms of models/sparse.py with its
// stable regroupings and floors. An accepted change writes only M (kept
// lanes' rows are disjoint); the partner factor is frozen for the call.
// The TPU kernel's paired 128-lane planes, mirror metadata lanes and
// per-phase plane rebuild exist for Mosaic's DMA rules and are not
// carried over: the rows are read through the CSR column indices.
//
// What bounds it on the H100: gathers of partner rows from L2. A sweep
// of the atlas A sampler (30,000 x 50,000, k = 50, B = 512) keeps ~650
// rows of ~1,000 nonzeros, each naming one 200-byte row of the 10 MB
// partner factor, which stays in L2: ~130 MB of scattered L2 reads a
// sweep, against a few microseconds of proposal and accept work. So the
// gathers are spread over every SM, and the sweep's serial parts stay
// on one block per chain. One persistent cooperative kernel, as many
// 1024-thread blocks as stay resident (the occupancy query times the
// SM count), runs the sweeps of every chain in three parts split by
// grid-wide barriers:
//   (a) block c < NCH runs sweep_front for chain c: uniforms, types,
//       picks, first-wins claims, capacity and budget truncation. Each
//       lane writes its proposal, its draws and its rows' CSR extents to
//       a lane table in global memory (field-major, so every field is
//       one coalesced store), and a block scan of the lanes' item counts
//       gives each lane's inclusive item offset. A kept lane's row pass
//       (two when a pair has two rows) is cut into work items of at most
//       `chunk` nonzeros; a pass has at least one item, maybe empty.
//   (b) every warp of the grid takes items in a grid-stride loop over
//       all chains. It finds its chain by a binary search in the chains'
//       item offsets, its lane by a 32-wide search in the lanes' offsets
//       (two ballots), and its row and chunk from the lane's fields. Its
//       32 threads stride over the item's nonzeros, each gathering whole
//       partner rows (two floats a load); a warp reduction gives the
//       item's eight partial sums, written to the item's own slot. The
//       first item of a pass also forms that pass's Z2-side dots.
//   (c) block c: each kept lane adds its items' slots in chunk order
//       (no float atomics anywhere, so two runs on the same inputs give
//       the same bits), forms the closed forms, and sweep_back applies
//       the sweep. The loop ends for the whole grid once no chain has
//       budget left (or, in exact mode, its slab of uniforms is spent).
// Data that one block writes and another reads inside the launch (lane
// table, slots, dots, chain totals, M) is read with ld.global.cg, past
// L1. A lane's proposal crosses the barriers in the lane table, not in
// registers. Tensor cores do not help: each nonzero's ap is a gather-GEMV
// with no reuse (rows are disjoint across kept lanes and the partner
// factor is frozen), so the levers are SM count and loads in flight; and
// TMA has no row gather on sm_90a. Block 0 reads %globaltimer at the
// barriers into the wrapper's counters: the time of parts (a), (b), (c).
// Registers: a 1024-thread block has 64 a thread, and ptxas reports
// ~200 bytes of spill stores a thread (chip_smoke.py phase 2 prints it).
// A build whose parts (a) and (c) are stubbed out spills nothing: the
// spills sit in the serial parts, per-sweep scalars of the proposal and
// accept code stored and reloaded through L1-resident local memory by
// one block, a few hundred kilobytes a sweep against the ~130 MB of row
// gathers in part (b), whose loop keeps its registers. Parts (a) and (c)
// are timed on their own (PERF.md).
//
// Each float operation follows the plain version's order (d divides, as
// there), and the file is compiled with -fmad=false; only the sums over a
// row's nonzeros and over k are taken in another order than torch.sum,
// so kernel and plain version agree to rounding, not bit for bit.

#include <cooperative_groups.h>

#include "sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

using cogaps::Alpha;
using cogaps::kMaxB;
using cogaps::Proposal;

constexpr int kMaxK = 64;  // a factor row is two registers per thread
constexpr float kBeta = 100.0f;      // models/sparse.BETA
constexpr float kNoiseEps = 1.0e-6f;  // models/sparse.NOISE_EPS

// A lane's fields in the lane table, a (kFields, kMaxB) int32 array per
// chain: written by part (a), one coalesced store per field, and read by
// parts (b) and (c). Floats are kept as their bits.
enum LaneField {
  kFlags,   // keep, is_birth, is_death, is_move, is_exch: bits 0-4
  kA1c, kA2c, kEBirth, kElem1, kElem2, kR1, kC1, kR2, kC2,
  kM1, kM2, kUGibbs, kUExp, kUAcc,
  kIncl,    // inclusive prefix of the chain's item counts by lane
  kSt1Lo, kSt1Hi, kLen1,  // row r1's nonzeros: first (int64), count
  kSt2Lo, kSt2Hi, kLen2,  // row r2's, for a pair on two rows
  kFields
};

struct AtlasArgs {
  int m, chunk, cap;         // partner rows; nonzeros an item; items a chain
  const float* other;        // (nch, m, K) frozen partner factor
  const float* Z2;           // (nch, K, K) = other^T other
  const long long* indptr;   // (nch, NR + 1) offsets into idx/val
  const int* idx;
  const float* val;
  int* lanes;                // (nch, kFields, kMaxB) the lane table
  float* sums;               // (nch, cap, 8) each item's partial sums
  float* zdots;              // (nch, kMaxB, 3) each lane's Z2-side dots
  int* totals;               // (nch) items of the sweep, -1: chain done
  unsigned long long* timing;  // ns in (a), (b) and (c), sweeps
};

struct NoCache {  // the sparse model keeps no table: M only
  __device__ void apply(int, int, float) const {}
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element kk of a factor row held as m_lo = row[lane], m_hi =
// row[lane + 32] across the warp
__device__ __forceinline__ float bcast(float m_lo, float m_hi, int kk) {
  return __shfl_sync(0xffffffffu, kk < 32 ? m_lo : m_hi, kk & 31);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long join64(int lo, int hi) {
  return (long long)(((unsigned long long)(unsigned)hi << 32) |
                     (unsigned long long)(unsigned)lo);
}

// Part (b) for one item on the calling warp: each thread's partial sums
// over its nonzeros (every 32nd of `count` from `start`) into a[8], for
// column c (and, for the r1 pass of a same-row pair, column c2). The
// factor row M[row] sits in two registers per thread (k <= 64) and is
// broadcast by shuffles; ap is summed in four independent partial sums
// so that a thread keeps several partner loads in flight, two floats a
// load when k is even.
__device__ void item_pass(int K, const float* other, const float* Mr,
                          const int* idx, const float* val, long long start,
                          int count, int c, int c2, bool same, float* a) {
  const int wl = threadIdx.x & 31;
  const float m_lo = wl < K ? __ldcg(Mr + wl) : F(0.0);
  const float m_hi = wl + 32 < K ? __ldcg(Mr + wl + 32) : F(0.0);
  for (int base = 0; base < count; base += 32) {  // warp-uniform
    const long long j = start + base + wl;
    const bool valid = base + wl < count;
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

// Part (b): every warp of the grid, items in a grid-stride loop. Item i
// of the sweep is item j of chain c (the last chain whose items start at
// or before i) and item k of lane L (the first lane whose inclusive item
// offset exceeds j, found by the warp in two 32-wide steps); the lane's
// row r1 has max(1, ceil(len1 / chunk)) items, then come row r2's.
__device__ void row_sums(const cogaps::SweepArgs& p, const AtlasArgs& a,
                         const int* s_base) {
  const unsigned all = 0xffffffffu;
  const int K = p.K;
  const int wl = threadIdx.x & 31;
  const int total = s_base[p.nch];
  const int nw = (gridDim.x * blockDim.x) >> 5;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < total;
       i += nw) {
    int lo = 0, hi = p.nch - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_base[mid] <= i) lo = mid;
      else hi = mid - 1;
    }
    const int c = lo;
    const int j = i - s_base[c];
    const int* tab = a.lanes + (size_t)c * kFields * kMaxB;
    const int* incl = tab + kIncl * kMaxB;
    const int g_end = __ldcg(incl + 32 * wl + 31);
    const int g = __ffs(__ballot_sync(all, g_end > j)) - 1;
    const int v = __ldcg(incl + 32 * g + wl);
    const int t = __ffs(__ballot_sync(all, v > j)) - 1;
    const int prev_v = __shfl_sync(all, v, max(t - 1, 0));
    const int prev_g = __shfl_sync(all, g_end, max(g - 1, 0));
    const int L = 32 * g + t;
    const int k = j - (t > 0 ? prev_v : (g > 0 ? prev_g : 0));
    const int* f = tab + L;
    const int flags = __ldcg(f + kFlags * kMaxB);
    const int r1 = __ldcg(f + kR1 * kMaxB), r2 = __ldcg(f + kR2 * kMaxB);
    const int c1 = __ldcg(f + kC1 * kMaxB), c2 = __ldcg(f + kC2 * kMaxB);
    const int len1 = __ldcg(f + kLen1 * kMaxB);
    const int n1 = max(1, (len1 + a.chunk - 1) / a.chunk);
    const bool second = k >= n1;
    const int kc = second ? k - n1 : k;  // the chunk within its pass
    const int len = second ? __ldcg(f + kLen2 * kMaxB) : len1;
    const long long st =
        second ? join64(__ldcg(f + kSt2Lo * kMaxB), __ldcg(f + kSt2Hi * kMaxB))
               : join64(__ldcg(f + kSt1Lo * kMaxB), __ldcg(f + kSt1Hi * kMaxB));
    const bool pair = (flags & (8 | 16)) != 0;
    const bool same = pair && r2 == r1;  // one pass over r1 for both
    const int row = second ? r2 : r1, col = second ? c2 : c1;
    const float* Mr = p.M + (size_t)c * p.NB + (size_t)row * K;
    float s[8] = {F(0.0), F(0.0), F(0.0), F(0.0),
                  F(0.0), F(0.0), F(0.0), F(0.0)};
    item_pass(K, a.other + (size_t)c * a.m * K, Mr, a.idx, a.val,
              st + (long long)kc * a.chunk, min(a.chunk, len - kc * a.chunk),
              col, c2, same && !second, s);
    for (int q = 0; q < 8; ++q) s[q] = warp_sum(s[q]);
    float4* out = reinterpret_cast<float4*>(
        a.sums + ((size_t)c * a.cap + j) * 8);
    if (wl == 0) {  // a pass over r2 gives the pair's sums, a[4:8]
      out[0] = second ? make_float4(F(0.0), F(0.0), F(0.0), F(0.0))
                      : make_float4(s[0], s[1], s[2], s[3]);
      out[1] = second ? make_float4(s[0], s[1], s[2], s[3])
                      : make_float4(s[4], s[5], s[6], s[7]);
    }
    if (kc == 0) {
      // Z2-side dots: the r1 pass z0 = M[r1].Z2[:,c1] (same row: also
      // z1, z2 = M[r1].(Z2[:,c1] -/+ Z2[:,c2])); the r2 pass z1 =
      // M[r2].Z2[:,c2]
      const float* Z2 = a.Z2 + (size_t)c * K * K;
      const bool both = same && !second;
      float z[3] = {F(0.0), F(0.0), F(0.0)};
      for (int kk = wl; kk < K; kk += 32) {
        const float mk = __ldcg(Mr + kk);
        const float zc = Z2[kk * K + col];
        z[0] += mk * zc;
        if (both) {
          const float zc2 = Z2[kk * K + c2];
          z[1] += mk * (zc - zc2);
          z[2] += mk * (zc + zc2);
        }
      }
      for (int q = 0; q < 3; ++q) z[q] = warp_sum(z[q]);
      if (wl == 0) {
        float* zd = a.zdots + ((size_t)c * kMaxB + L) * 3;
        if (second) {
          zd[1] = z[0];
        } else {
          zd[0] = z[0];
          if (both) {
            zd[1] = z[1];
            zd[2] = z[2];
          }
        }
      }
    }
  }
}

// Part (c): a kept lane's alphaParameters from its items' slots, added in
// chunk order, and its Z2-side dots (the closed forms of models/sparse.py).
__device__ Alpha lane_alpha(const cogaps::SweepArgs& p, const AtlasArgs& a,
                            int chain, const Proposal& q, int first,
                            int n_items) {
  const int K = p.K;
  float s[8] = {F(0.0), F(0.0), F(0.0), F(0.0),
                F(0.0), F(0.0), F(0.0), F(0.0)};
  const float4* src = reinterpret_cast<const float4*>(
      a.sums + ((size_t)chain * a.cap + first) * 8);
#pragma unroll 4
  for (int i = 0; i < n_items; ++i) {
    const float4 x = __ldcg(src + 2 * i), y = __ldcg(src + 2 * i + 1);
    s[0] += x.x;
    s[1] += x.y;
    s[2] += x.z;
    s[3] += x.w;
    s[4] += y.x;
    s[5] += y.y;
    s[6] += y.z;
    s[7] += y.w;
  }
  const bool pair = q.is_move || q.is_exch;
  const bool same = pair && q.r2 == q.r1;
  const float* zd = a.zdots + ((size_t)chain * kMaxB + threadIdx.x) * 3;
  const float z0 = __ldcg(zd);
  const float z1 = pair ? __ldcg(zd + 1) : F(0.0);
  const float z2 = same ? __ldcg(zd + 2) : F(0.0);
  const float* Z2 = a.Z2 + (size_t)chain * K * K;
  const int c1 = q.c1, c2 = q.c2;
  const float z1c1 = Z2[c1 * K + c1], z1c2 = Z2[c2 * K + c2];
  const float s1 = fmaxf(z1c1 - s[0], F(0.0)) + s[1];
  const float smu1 = -z0 + s[2];
  const float err1 = kNoiseEps * (z0 + s[3]);
  float s_pair = F(0.0), smu_pair = F(0.0), err_pair = F(0.0);
  if (same) {
    const float s_zero = z1c1 - F(2.0) * Z2[c1 * K + c2] + z1c2 - s[4];
    s_pair = fmaxf(s_zero, F(0.0)) + s[5];
    smu_pair = -z1 + s[6];
    err_pair = kNoiseEps * (z2 + s[7]);
  } else if (pair) {
    const float s2 = fmaxf(z1c2 - s[4], F(0.0)) + s[5];
    const float smu2 = -z1 + s[6];
    const float err2 = kNoiseEps * (z1 + s[7]);
    s_pair = s1 + s2;
    smu_pair = smu1 - smu2;
    err_pair = err1 + err2;
  }
  return Alpha{kBeta * s1,       kBeta * smu1, kBeta * s_pair,
               kBeta * smu_pair, kBeta * err1, kBeta * err_pair};
}

// Part (a) after sweep_front, every thread of block `chain`: its lane's
// proposal, draws and rows' extents into the lane table, and the block
// scan of the item counts (a kept lane: max(1, ceil(len / chunk)) items
// for row r1, the same for r2 when a pair has two rows). Returns the
// chain's item count.
__device__ int place_lane(const cogaps::SweepArgs& p, const AtlasArgs& a,
                          cogaps::SweepShared& sh, int chain, bool live,
                          const Proposal& q, const cogaps::Draws& d) {
  int* f = a.lanes + (size_t)chain * kFields * kMaxB + threadIdx.x;
  const bool kept = live && q.keep;
  const bool pair = kept && (q.is_move || q.is_exch);
  const bool two = pair && q.r2 != q.r1;
  long long st1 = 0, st2 = 0;
  int len1 = 0, len2 = 0;
  if (kept) {
    const long long* ip = a.indptr + (size_t)chain * (p.NR + 1);
    st1 = ip[q.r1];
    len1 = (int)(ip[q.r1 + 1] - st1);
    if (two) {
      st2 = ip[q.r2];
      len2 = (int)(ip[q.r2 + 1] - st2);
    }
  }
  if (live) {
    f[kFlags * kMaxB] = (int)q.keep | ((int)q.is_birth << 1) |
                        ((int)q.is_death << 2) | ((int)q.is_move << 3) |
                        ((int)q.is_exch << 4);
    f[kA1c * kMaxB] = q.a1c;
    f[kA2c * kMaxB] = q.a2c;
    f[kEBirth * kMaxB] = q.e_birth;
    f[kElem1 * kMaxB] = q.elem1;
    f[kElem2 * kMaxB] = q.elem2;
    f[kR1 * kMaxB] = q.r1;
    f[kC1 * kMaxB] = q.c1;
    f[kR2 * kMaxB] = q.r2;
    f[kC2 * kMaxB] = q.c2;
    f[kM1 * kMaxB] = __float_as_int(q.m1);
    f[kM2 * kMaxB] = __float_as_int(q.m2);
    f[kUGibbs * kMaxB] = __float_as_int(d.gibbs);
    f[kUExp * kMaxB] = __float_as_int(d.exp);
    f[kUAcc * kMaxB] = __float_as_int(d.acc);
    f[kSt1Lo * kMaxB] = (int)(st1 & 0xffffffffll);
    f[kSt1Hi * kMaxB] = (int)(st1 >> 32);
    f[kLen1 * kMaxB] = len1;
    f[kSt2Lo * kMaxB] = (int)(st2 & 0xffffffffll);
    f[kSt2Hi * kMaxB] = (int)(st2 >> 32);
    f[kLen2 * kMaxB] = len2;
  }
  const int n_items = kept ? max(1, (len1 + a.chunk - 1) / a.chunk) +
                                 (two ? max(1, (len2 + a.chunk - 1) /
                                                   a.chunk)
                                      : 0)
                           : 0;
  int total;
  f[kIncl * kMaxB] = cogaps::block_scan(n_items, sh.warp_sums, total);
  return total;
}

// Part (c), every thread of block `chain`: its lane's proposal and draws
// back from the lane table, and its items' span.
__device__ void lane_back(const AtlasArgs& a, int chain, Proposal& q,
                          cogaps::Draws& d, int& first, int& n_items) {
  const int* f = a.lanes + (size_t)chain * kFields * kMaxB + threadIdx.x;
  const int flags = f[kFlags * kMaxB];
  q.keep = flags & 1;
  q.is_birth = (flags >> 1) & 1;
  q.is_death = (flags >> 2) & 1;
  q.is_move = (flags >> 3) & 1;
  q.is_exch = (flags >> 4) & 1;
  q.a1c = f[kA1c * kMaxB];
  q.a2c = f[kA2c * kMaxB];
  q.e_birth = f[kEBirth * kMaxB];
  q.elem1 = f[kElem1 * kMaxB];
  q.elem2 = f[kElem2 * kMaxB];
  q.r1 = f[kR1 * kMaxB];
  q.c1 = f[kC1 * kMaxB];
  q.r2 = f[kR2 * kMaxB];
  q.c2 = f[kC2 * kMaxB];
  q.m1 = __int_as_float(f[kM1 * kMaxB]);
  q.m2 = __int_as_float(f[kM2 * kMaxB]);
  d.gibbs = __int_as_float(f[kUGibbs * kMaxB]);
  d.exp = __int_as_float(f[kUExp * kMaxB]);
  d.acc = __int_as_float(f[kUAcc * kMaxB]);
  const int incl = f[kIncl * kMaxB];
  first = threadIdx.x > 0 ? f[kIncl * kMaxB - 1] : 0;
  n_items = incl - first;
}

__global__ void __launch_bounds__(kMaxB, 1)
    atlas_kernel(const cogaps::SweepArgs p, const AtlasArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ cogaps::SweepShared sh;
  __shared__ int s_base[kMaxB + 1];  // each chain's first item of the sweep
  __shared__ int s_go;
  __shared__ unsigned long long s_t[5];  // block 0: mark, (a), (b), (c), sweeps
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
  const bool owner = chain < p.nch;
  const bool timer = chain == 0 && lane == 0 && a.timing != nullptr;
  if (owner) cogaps::chain_begin(p, cogaps::chain_of(p, chain), sh, chain);
  if (timer) s_t[1] = s_t[2] = s_t[3] = s_t[4] = 0;
  bool running = owner;
  int s_end = 0;
  int s = 0;
  for (;; ++s) {
    if (timer) s_t[0] = globaltimer();
    // ---- (a) block `chain`: the sweep's proposals and their item counts
    bool live = false;
    if (owner) {
      const cogaps::Chain ch = cogaps::chain_of(p, chain);
      Proposal q;
      cogaps::Draws d;
      live = running && cogaps::sweep_front(p, ch, sh, chain, s, q, d);
      if (running && !live) {
        running = false;
        s_end = s;
      }
      const int total = place_lane(p, a, sh, chain, live, q, d);
      if (lane == 0) a.totals[chain] = live ? total : -1;
    }
    grid.sync();
    if (lane == 0) {
      int base = 0;
      bool any = false;
      for (int c = 0; c < p.nch; ++c) {
        const int t = __ldcg(a.totals + c);
        s_base[c] = base;
        base += max(t, 0);
        any = any || t >= 0;
      }
      s_base[p.nch] = base;
      s_go = any;
    }
    __syncthreads();
    if (timer) {
      const unsigned long long t = globaltimer();
      s_t[1] += t - s_t[0];
      s_t[0] = t;
    }
    if (!s_go) break;
    // ---- (b) every warp of the grid: the items' partial sums
    row_sums(p, a, s_base);
    grid.sync();
    if (timer) {
      const unsigned long long t = globaltimer();
      s_t[2] += t - s_t[0];
      s_t[0] = t;
    }
    // ---- (c) block `chain`: alphaParameters, then the sweep's second half
    if (live) {
      Proposal q;
      cogaps::Draws d;
      int first, n_items;
      lane_back(a, chain, q, d, first, n_items);
      const Alpha ab = q.keep ? lane_alpha(p, a, chain, q, first, n_items)
                              : Alpha{F(0.0), F(0.0), F(0.0),
                                      F(0.0), F(0.0), F(0.0)};
      NoCache model;
      cogaps::sweep_back(p, cogaps::chain_of(p, chain), sh, q, d, ab, model);
    }
    if (timer) {
      s_t[3] += globaltimer() - s_t[0];
      s_t[4] += 1;
    }
  }
  if (owner) cogaps::chain_end(p, sh, chain, running ? s : s_end);
  if (timer)
    for (int i = 0; i < 4; ++i) a.timing[i] += s_t[1 + i];
}

constexpr size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// the workspace's parts, in order: lane table, sums, zdots, totals
void workspace_parts(int nch, int cap, size_t* sizes) {
  sizes[0] = align256((size_t)nch * kFields * kMaxB * sizeof(int));
  sizes[1] = align256((size_t)nch * cap * 8 * sizeof(float));
  sizes[2] = align256((size_t)nch * kMaxB * 3 * sizeof(float));
  sizes[3] = align256((size_t)nch * sizeof(int));
}

// resident blocks of atlas_kernel on the current device: the occupancy
// query times the SM count (once per device)
int resident_blocks(int* blocks) {
  static int cached_dev = -1, cached = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != cached_dev) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, atlas_kernel,
                                                      kMaxB, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    cached = per_sm * sms;
    cached_dev = dev;
  }
  *blocks = cached;
  return 0;
}

}  // namespace

// Bytes of scratch a launch of nch chains with `cap` items a chain needs.
extern "C" long long cogaps_atlas_workspace(int nch, int cap) {
  size_t sizes[4];
  workspace_parts(nch, cap, sizes);
  return (long long)(sizes[0] + sizes[1] + sizes[2] + sizes[3]);
}

// The grid of a launch: atlas_kernel's resident blocks on the device.
extern "C" int cogaps_atlas_grid(int* blocks) {
  return resident_blocks(blocks);
}

extern "C" int cogaps_atlas_launch(
    int nch, int B, int C, int NR, int K, int m, int local_moves,
    float alpha_nb, float dom_len, float temp, const float* lam,
    const float* mgm, const int* budget, float* mass, int* elem, int* n,
    float* M, const float* other, const float* Z2, const long long* indptr,
    const int* idx, const float* val, const int* colnz, int* scratch,
    int* out, const float* uni, int s_max, const long long* key0,
    uint32_t key1, int chunk, int cap, void* work,
    unsigned long long* timing, void* stream) {
  if (B < 1 || B > kMaxB || nch < 1 || nch > kMaxB || K < 1 || K > kMaxK ||
      chunk < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  int grid;
  const int err = resident_blocks(&grid);
  if (err != 0) return err;
  // more chains than resident blocks: the runtime refuses the launch
  grid = max(grid, nch);
  AtlasArgs a;
  a.m = m;
  a.chunk = chunk;
  a.cap = cap;
  a.other = other;
  a.Z2 = Z2;
  a.indptr = indptr;
  a.idx = idx;
  a.val = val;
  size_t sizes[4];
  workspace_parts(nch, cap, sizes);
  char* w = static_cast<char*>(work);
  a.lanes = reinterpret_cast<int*>(w);
  a.sums = reinterpret_cast<float*>(w + sizes[0]);
  a.zdots = reinterpret_cast<float*>(w + sizes[0] + sizes[1]);
  a.totals = reinterpret_cast<int*>(w + sizes[0] + sizes[1] + sizes[2]);
  a.timing = timing;
  const cogaps::SweepArgs p = cogaps::make_args(
      nch, B, C, NR, K, local_moves, alpha_nb, dom_len, temp, lam, mgm,
      budget, mass, elem, n, M, colnz, scratch, out, uni, s_max, key0, key1);
  void* args[] = {(void*)&p, (void*)&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)atlas_kernel, dim3(grid), dim3(kMaxB), args, 0,
      (cudaStream_t)stream);
  // read the launch status back so that a refused launch leaves no error
  // behind for the next kernel on the device
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
