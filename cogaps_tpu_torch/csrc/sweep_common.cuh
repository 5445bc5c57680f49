// The Gibbs sweep shared by the two CoGAPS sweep kernels for Hopper:
// csrc/sweep.cu (dense-Z and tables mode, replacing cogaps_tpu/ops/
// pallas_sweep.py::_kernel_b) and csrc/atlas.cu (the CSR sparse sweep,
// replacing cogaps_tpu/ops/pallas_atlas.py::_kernel_atlas).
//
// sweep_chain<Model> is one thread block's whole update(nSteps) for its
// chain: every sweep until the budget is spent. Its semantics are those
// of the plain version, cogaps_tpu_torch/ops/sweep.py::sweep: one
// (16, B) uniform block per sweep; type draw; rank picks in the compact
// atom table; exact first-wins conflicts on rows and atoms (a choice
// that depends on proposal randomness only: first-accepted-wins is not
// pi-invariant); capacity and budget truncation; alphaParameters from the
// Model; truncated-normal Gibbs, exponential and truncated-gamma(2)
// draws with the Model's noise floors; Metropolis accepts; clamped M
// deltas; births appended and holes refilled from the tail. Each float
// operation is written in the order of the plain version and the files
// are compiled with -fmad=false, so a kernel and its plain version make
// the same decisions on the same uniforms.
//
// A Model provides
//   Alpha alpha(const Proposal&)  -- called by every thread of the block
//                                    (it may synchronise the block); the
//                                    result matters for kept lanes only
//   void apply(int r, int e, float a) -- after M[e] (row r) changed by a
// and is built per chain by the kernel.
//
// Design: one thread block per chain, one thread per proposal lane
// (B <= 1024); the block loops over sweeps itself. Conflicts are
// atomicMin claims of the lane id in per-chain row and slot tables; the
// lanes that claimed reset their entries after the keep test. A Chain's
// arrays (claims, hole flags, atom table, M) lie wherever its pointers
// say: csrc/sweep.cu and span.cu point them at staged copies in shared
// memory where a plan puts them (dense_model.cuh's stage_chain), atlas.cu
// at the update call's global arrays. The four
// inclusive prefix sums of a sweep are block scans (warp shuffles plus
// one shared array of warp totals), the last two with two counts each in
// the halves of an int; the counters are warp ballots added to shared
// memory once a sweep.
//
// Every function that synchronises the block takes kWarp: true when the
// block is a single warp (B <= 32). Its barriers are then __syncwarp and
// its scans one warp scan: the same integers, so the same decisions, and
// no __syncthreads.
//
// A sweep is sweep_front (draws, types, picks, claims, truncation: the
// kept proposals), the alphaParameters, then sweep_back (draws, accepts,
// M writes, atom table, compaction). sweep_chain composes them in one
// block; csrc/atlas.cu runs the same two halves around alphaParameters
// computed by the whole grid.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace cogaps {

constexpr int kMaxB = 1024;
constexpr int kBig = 0x7fffffff;
constexpr double kEps = 1.0e-10;  // the reference's gaps::epsilon
constexpr int kNOut = 10;  // done, sweeps, processed[4], accepted[4]

// The chain-state arrays that csrc/sweep.cu may stage in shared memory,
// in ops/sweep_cuda.PLACED's order.
enum Placed { kRmin, kAmin, kHole, kMass, kElem, kY, kSQ, kM, kZ, kNPlaced };

// What both kernels share: sampler constants, the per-chain state and
// the random source. Arrays carry a leading chain dimension.
struct SweepArgs {
  int nch, B, C, NR, K, NB, local_moves, s_max;
  float alpha_nb, dom_len, temp;
  const float* lam;
  const float* mgm;
  const int* budget;
  float* mass;
  int* elem;
  int* n;
  float* M;
  const int* colnz;
  // (nch, scratch_stride) ints: a chain's row claims (NR + 1 ints at
  // g_rmin), slot claims (C + 1 at g_amin) and hole flags (C bytes at
  // int offset g_hole); an offset is -1 for a table kept elsewhere
  int* scratch;
  int scratch_stride, g_rmin, g_amin, g_hole;
  // byte offset in dynamic shared memory of each Placed array of the
  // block's chain, or -1 for one left in global memory (sweep.cu only)
  int smem[kNPlaced];
  int* out;      // (nch, kNOut)
  const float* uni;  // exact mode: (nch, s_max * 16, B); fast mode: null
  const long long* key0;
  uint32_t key1;
};

// One lane's proposal after the conflict rule.
struct Proposal {
  bool keep, is_birth, is_death, is_move, is_exch;
  int a1c, a2c, e_birth, elem1, elem2, r1, c1, r2, c2;
  float m1, m2;
};

// alphaParameters of one lane with their noise floors
// (ops/sweep.py: AlphaBatch).
struct Alpha {
  float s1, smu1, s_pair, smu_pair, err1, err_pair;
};

// Philox4x32-10 (Salmon et al., SC'11); ops/rng.py::philox4x32 is the
// same function.
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t w) {
  return F(w >> 8) * F(5.9604644775390625e-08);  // 2^-24, exact
}

// ops/rng.py::ndtr: 0.5 * erfc(x * (-1/sqrt 2))
__device__ __forceinline__ float ndtr(float x) {
  return F(0.5) * erfcf(x * F(-0.7071067811865476));
}

// ops/rng.py::ndtri: Acklam's rational approximation on p = min(q, 1-q),
// then one Halley step on ndtr(x) = p
__device__ float ndtri(float q) {
  const bool upper = q > F(0.5);
  const float p = upper ? F(1.0) - q : q;
  float x;
  if (p < F(0.02425)) {
    const float t = sqrtf(F(-2.0) * logf(p));
    float num = F(-7.784894002430293e-03) * t + F(-3.223964580411365e-01);
    num = num * t + F(-2.400758277161838e+00);
    num = num * t + F(-2.549732539343734e+00);
    num = num * t + F(4.374664141464968e+00);
    num = num * t + F(2.938163982698783e+00);
    float den = F(7.784695709041462e-03) * t + F(3.224671290700398e-01);
    den = den * t + F(2.445134137142996e+00);
    den = den * t + F(3.754408661907416e+00);
    x = num / (den * t + F(1.0));
  } else {
    const float h = p - F(0.5);
    const float r = h * h;
    float num = F(-3.969683028665376e+01) * r + F(2.209460984245205e+02);
    num = num * r + F(-2.759285104469687e+02);
    num = num * r + F(1.383577518672690e+02);
    num = num * r + F(-3.066479806614716e+01);
    num = num * r + F(2.506628277459239e+00);
    float den = F(-5.447609879822406e+01) * r + F(1.615858368580409e+02);
    den = den * r + F(-1.556989798598866e+02);
    den = den * r + F(6.680131188771972e+01);
    den = den * r + F(-1.328068155288572e+01);
    x = num * h / (den * r + F(1.0));
  }
  const float e = ndtr(x) - p;
  const float u = e * F(2.5066282746310002) * expf(x * x * F(0.5));
  x = x - u / (F(1.0) + x * u * F(0.5));
  return upper ? -x : x;
}

// ops/rng.py::trunc_normal
__device__ float trunc_normal(float u, float a, float b, float mean, float sd,
                              bool& ok) {
  sd = fmaxf(sd, F(1e-30));
  const float p_lower = ndtr((a - mean) / sd);
  const float p_upper = ndtr((b - mean) / sd);
  ok = !((p_lower > F(0.95)) || (p_upper < F(0.05)));
  float q = p_lower + u * (p_upper - p_lower);
  q = fminf(fmaxf(q, F(1e-7)), F(1.0 - 1e-7));
  const float z = mean + sd * ndtri(q);
  return fminf(fmaxf(z, a), b);
}

// ops/rng.py::gibbs_mass; lam = 0 gives the exchange form exactly
__device__ float gibbs_mass(float u, float s, float s_mu, float a, float b,
                            float lam, bool& ok) {
  const float s_safe = fmaxf(s, F(kEps));
  const float mu = (s_mu - lam) / s_safe;
  const float sd = F(1.0) / sqrtf(s_safe);
  const float v = trunc_normal(u, a, b, mu, sd, ok);
  ok = ok && (s > F(kEps));
  return v;
}

// ops/rng.py::trunc_gamma2_y
__device__ float trunc_gamma2_y(float u, float b) {
  b = fmaxf(b, F(1e-6));
  const float upper = F(1.0) - expf(-b) * (F(1.0) + b);
  const float q = fmaxf(u * upper, F(1e-12));
  float y = fminf(fmaxf(sqrtf(F(2.0) * q), F(1e-6)), b);
  for (int i = 0; i < 12; ++i) {
    const float ey = expf(-y);
    const float h = F(1.0) - ey * (F(1.0) + y);
    const float dh = fmaxf(ey * y, F(1e-30));
    y = fminf(fmaxf(y - (h - q) / dh, F(1e-7)), b);
  }
  return y;
}

// The block's barrier: __syncwarp for a one-warp block.
template <bool kWarp>
__device__ __forceinline__ void block_sync() {
  if constexpr (kWarp)
    __syncwarp();
  else
    __syncthreads();
}

// Inclusive prefix sum of v over the block; `total` gets the block sum.
// Every thread of the block must call it, and it is a block barrier.
template <bool kWarp = false>
__device__ int block_scan(int v, int* warp_sums, int& total) {
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (wl >= o) x += y;
  }
  if constexpr (kWarp) {
    total = __shfl_sync(0xffffffffu, x, 31);
    __syncwarp();  // the shuffles alone order no memory
    return x;
  } else {
    if (wl == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int w = wl < nw ? warp_sums[wl] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (wl >= o) w += y;
      }
      if (wl < nw) warp_sums[wl] = w;
    }
    __syncthreads();
    const int prefix = wid > 0 ? warp_sums[wid - 1] : 0;
    total = warp_sums[nw - 1];
    __syncthreads();  // warp_sums is reused by the next scan
    return x + prefix;
  }
}

// One chain's arrays and constants: slices of the update call's arrays,
// or (csrc/sweep.cu) staged copies of them in shared memory.
struct Chain {
  float* mass;
  int* elem;
  float* M;
  const int* colnz;
  int* rmin;                 // (NR + 1) row claims
  int* amin;                 // (C + 1) slot claims
  unsigned char* hole_flag;  // (C)
  float lam, mgm;
  int budget;
  uint32_t key0;
};

__device__ inline Chain chain_of(const SweepArgs& p, int chain) {
  Chain ch;
  ch.mass = p.mass + (size_t)chain * p.C;
  ch.elem = p.elem + (size_t)chain * p.C;
  ch.M = p.M + (size_t)chain * p.NB;
  ch.colnz = p.colnz + (size_t)chain * p.K;
  int* s = p.scratch + (size_t)chain * p.scratch_stride;
  ch.rmin = p.g_rmin < 0 ? nullptr : s + p.g_rmin;
  ch.amin = p.g_amin < 0 ? nullptr : s + p.g_amin;
  ch.hole_flag = p.g_hole < 0
                     ? nullptr
                     : reinterpret_cast<unsigned char*>(s + p.g_hole);
  ch.lam = p.lam[chain];
  ch.mgm = p.mgm[chain];
  ch.budget = p.budget[chain];
  ch.key0 =
      p.key0 ? (uint32_t)((unsigned long long)p.key0[chain] & 0xffffffffull)
             : 0u;
  return ch;
}

// The block's state across a chain's sweeps, in shared memory.
struct SweepShared {
  int warp_sums[32];
  int rank_to_src[kMaxB + 1];
  int n, done, n_processed;
  int cnt[8];  // processed[4], accepted[4]
};

// The uniforms of a sweep that its second half reads (rows 2-4).
struct Draws {
  float gibbs, exp, acc;
};

// adds how many threads of the warp hold `flag` to *slot; every thread
// of the warp calls it
__device__ __forceinline__ void tally(bool flag, int* slot) {
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(slot, __popc(b));
}

// Claim tables cleared and counters zeroed before a chain's first sweep.
// A one-warp sweep (kWarp) runs on the block's first warp, which may be
// one of several (csrc/span.cu): its loops stride by 32.
template <bool kWarp = false>
__device__ __forceinline__ void chain_begin(const SweepArgs& p,
                                            const Chain& ch, SweepShared& sh,
                                            int chain) {
  const int lane = threadIdx.x, nt = kWarp ? 32 : (int)blockDim.x;
  for (int i = lane; i <= p.NR; i += nt) ch.rmin[i] = kBig;
  for (int i = lane; i <= p.C; i += nt) ch.amin[i] = kBig;
  for (int i = lane; i < p.C; i += nt) ch.hole_flag[i] = 0;
  if (lane == 0) {
    sh.n = p.n[chain];
    sh.done = 0;
  }
  if (lane < 8) sh.cnt[lane] = 0;
  block_sync<kWarp>();
}

// The chain's atom count and counters after its last sweep; s sweeps ran.
template <bool kWarp = false>
__device__ __forceinline__ void chain_end(const SweepArgs& p,
                                          const SweepShared& sh, int chain,
                                          int s) {
  block_sync<kWarp>();
  if (threadIdx.x == 0) {
    p.n[chain] = sh.n;
    int* o = p.out + (size_t)chain * kNOut;
    o[0] = sh.done;
    o[1] = s;
    for (int j = 0; j < 8; ++j) o[2 + j] = sh.cnt[j];
  }
}

// The first half of sweep s: uniforms, types, picks, first-wins claims,
// capacity and budget truncation. Returns false on every thread when the
// chain's budget is spent or (exact mode) its uniform slab is used up.
// Otherwise q is this thread's proposal, its type flags cleared unless
// it is kept, and sh.n_processed the number kept.
template <bool kWarp = false>
__device__ __forceinline__ bool sweep_front(const SweepArgs& p,
                                            const Chain& ch, SweepShared& sh,
                                            int chain, int s, Proposal& q,
                                            Draws& d) {
  const int lane = threadIdx.x;
  const int B = p.B, C = p.C, K = p.K, NB = p.NB;
  const bool in_batch = lane < B;
  const int n = sh.n;
  const int remaining = ch.budget - sh.done;
  if (remaining <= 0) return false;
  if (p.uni != nullptr && s >= p.s_max) return false;

  // ---- the sweep's uniforms: rows 0-8 of its (16, B) block
  float u[12];
  if (p.uni != nullptr) {
    const float* blk = p.uni + ((size_t)chain * p.s_max + s) * 16 * B;
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = in_batch ? blk[j * B + lane] : F(0.0);
  } else {
    // the counter holds no chain index: a chain's stream is its seed
    // word's, so chains of one seed draw alike (engine.PhiloxRandom)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const uint4 w = philox(
          make_uint4((uint32_t)lane, (uint32_t)g, (uint32_t)s, 0u),
          ch.key0, p.key1);
      u[4 * g] = to_unit(w.x);
      u[4 * g + 1] = to_unit(w.y);
      u[4 * g + 2] = to_unit(w.z);
      u[4 * g + 3] = to_unit(w.w);
    }
  }

  // ---- proposal types (SingleThreadedGibbsSampler.h:95-111)
  const bool active = in_batch && lane < min(remaining, B);
  const bool small = n < 2;
  const float n_f = F(n);
  const float numer = n_f * p.dom_len;
  const float dp = numer / (numer + p.alpha_nb * (p.dom_len - n_f));
  const bool is_bd = u[0] < F(0.5);
  q.is_death = active && is_bd && (u[1] < dp) && !small;
  q.is_birth = active && ((is_bd && (u[1] >= dp)) || small);
  q.is_move = active && !small && (u[0] >= F(0.5)) && (u[0] < F(0.75));
  q.is_exch = active && !small && (u[0] >= F(0.75));

  // ---- picks in the compact table
  const int n_c = max(n, 1);
  const float nf = F(n_c);
  const int a1r = min((int)(u[5] * nf), n_c - 1);
  const int n1 = max(n - 1, 1);
  const int a2rr = min((int)(u[6] * F(n1)), n1 - 1);
  const int a2r = a2rr + (a2rr >= a1r ? 1 : 0);
  q.a1c = a1r & (C - 1);
  q.a2c = min(a2r, n_c - 1) & (C - 1);
  q.e_birth = min((int)(u[7] * F(NB)), NB - 1);

  q.elem1 = q.is_birth ? q.e_birth : max(ch.elem[q.a1c], 0);
  q.m1 = q.is_birth ? F(0.0) : ch.mass[q.a1c];
  int e_move;
  if (p.local_moves) {
    const float W_f = fmaxf(floorf(F(NB) / nf), F(1.0));
    const float t2m = u[8] * F(2.0);
    const float sgn = t2m < F(1.0) ? F(-1.0) : F(1.0);
    const float frac = t2m - floorf(t2m);
    const float mag = fminf(floorf(frac * W_f) + F(1.0), W_f);
    float r = fmodf(F(q.elem1) + sgn * mag, F(NB));  // floor-mod
    if (r < F(0.0)) r += F(NB);
    e_move = (int)r;
  } else {
    e_move = min((int)(u[8] * F(NB)), NB - 1);
  }
  q.elem2 = q.is_move ? e_move : max(ch.elem[q.a2c], 0);
  q.m2 = ch.mass[q.a2c];
  q.r1 = q.elem1 / K;
  q.c1 = q.elem1 - q.r1 * K;
  q.r2 = q.elem2 / K;
  q.c2 = q.elem2 - q.r2 * K;
  const bool uses2 = q.is_move || q.is_exch;
  const bool uses_a1 = q.is_death || q.is_move || q.is_exch;

  // ---- conflicts: the earliest active lane on each row and slot wins
  int* rmin = ch.rmin;
  int* amin = ch.amin;
  if (active) atomicMin(&rmin[q.r1], lane);
  if (active && uses2) atomicMin(&rmin[q.r2], lane);
  if (active && uses_a1) atomicMin(&amin[q.a1c], lane);
  if (active && q.is_exch) atomicMin(&amin[q.a2c], lane);
  block_sync<kWarp>();
  bool keep = active && rmin[q.r1] >= lane &&
              (!uses2 || rmin[q.r2] >= lane) &&
              (!uses_a1 || amin[q.a1c] >= lane) &&
              (!q.is_exch || amin[q.a2c] >= lane);

  // capacity guard (conservative pre-rank), then budget truncation
  int total;
  const int pre_birth_rank =
      block_scan<kWarp>(keep && q.is_birth, sh.warp_sums, total);
  keep = keep && (!q.is_birth || (n + pre_birth_rank - 1 < C));
  // every lane has read its claims: release them
  if (active) rmin[q.r1] = kBig;
  if (active && uses2) rmin[q.r2] = kBig;
  if (active && uses_a1) amin[q.a1c] = kBig;
  if (active && q.is_exch) amin[q.a2c] = kBig;
  const int rank = block_scan<kWarp>(keep, sh.warp_sums, total);
  keep = keep && rank <= remaining;
  if (lane == 0) sh.n_processed = min(total, remaining);

  q.keep = keep;
  q.is_birth = q.is_birth && keep;
  q.is_death = q.is_death && keep;
  q.is_move = q.is_move && keep;
  q.is_exch = q.is_exch && keep;
  d.gibbs = u[2];
  d.exp = u[3];
  d.acc = u[4];
  return true;
}

// The second half of a sweep, given every lane's alphaParameters at the
// sweep-start state: evaluate and apply the kept proposals, write the
// atom table, compact it, count. Kept lanes touch disjoint rows, and
// every alpha has been read before any write.
template <bool kWarp = false, class Model>
__device__ __forceinline__ void sweep_back(const SweepArgs& p,
                                           const Chain& ch, SweepShared& sh,
                                           const Proposal& q, const Draws& d,
                                           const Alpha& ab, Model& model) {
  const int lane = threadIdx.x;
  const int C = p.C, K = p.K;
  const int n = sh.n;
  float* mass = ch.mass;
  int* elem = ch.elem;
  float* M = ch.M;
  const bool keep = q.keep;

  bool birth_acc = false, death_kill = false, death_rebirth = false;
  bool move_acc = false, ex_acc = false;
  float b_mass = F(0.0), rebirth = F(0.0), nm1 = F(0.0), nm2 = F(0.0);
  const bool same_elem = q.elem1 == q.elem2;
  if (keep) {
    const int e1 = q.r1 * K + q.c1, e2 = q.r2 * K + q.c2;
    const float m1 = q.m1, m2 = q.m2;
    const bool can1 = ch.colnz[q.c1] != 0;
    const float log_u = logf(fmaxf(d.acc, F(1e-37)));
    // The truncated-normal Gibbs draw of a birth (h:131-149), a death
    // (h:154-188) or an exchange (h:228-257), in one call for the three
    // kinds, so that a warp's lanes make it together instead of once per
    // kind; a move (h:192-223) draws none.
    float g_s, g_smu, g_a = F(0.0), g_b = ch.mgm, g_lam = ch.lam;
    if (q.is_birth) {
      g_s = ab.s1 * p.temp;
      g_smu = ab.smu1 * p.temp;
    } else if (q.is_death) {
      g_s = ab.s1 * p.temp;
      g_smu = (ab.smu1 + m1 * ab.s1) * p.temp;
    } else {
      g_s = ab.s_pair * p.temp;
      g_smu = ab.smu_pair * p.temp;
      g_a = -m1;
      g_b = m2;
      g_lam = F(0.0);
    }
    bool g_ok = false;
    float g_mass = F(0.0);
    if (!q.is_move)
      g_mass = gibbs_mass(d.gibbs, g_s, g_smu, g_a, g_b, g_lam, g_ok);
    if (q.is_birth) {
      const float e_mass = -logf(fmaxf(d.exp, F(1e-30))) / ch.lam;
      b_mass = can1 ? g_mass : e_mass;
      const bool b_has = can1 ? (g_ok && fabsf(ab.smu1) > ab.err1) : true;
      birth_acc = b_has && (b_mass > F(kEps));
    } else if (q.is_death) {
      const bool rel_d = fabsf(ab.smu1 + m1 * ab.s1) > ab.err1;
      rebirth = (can1 && g_ok && rel_d) ? g_mass : m1;
      const float dll = rebirth * (g_smu - g_s * rebirth * F(0.5));
      death_rebirth = log_u < dll;
      death_kill = !death_rebirth;
    } else if (q.is_move) {
      const float dll = -m1 * (g_smu + g_s * m1 * F(0.5));
      move_acc = !same_elem && (log_u < dll);
    } else {
      const float new_sb =
          trunc_gamma2_y(d.gibbs, (m1 + m2) * ch.lam) / ch.lam;
      const float d_sb = m1 > m2 ? new_sb - m1 : m2 - new_sb;
      nm1 = same_elem ? m1 + d_sb : m1 + g_mass;
      nm2 = same_elem ? m2 - d_sb : m2 - g_mass;
      const bool can2 = ch.colnz[q.c2] != 0;
      const bool ex_ok =
          same_elem ||
          ((can1 || can2) && g_ok && fabsf(ab.smu_pair) > ab.err_pair);
      ex_acc = ex_ok && (nm1 > F(kEps)) && (nm2 > F(kEps));
    }

    // matrix deltas, clamped like safelyChangeMatrix
    float d1 = F(0.0), d2 = F(0.0);
    bool v1 = true, v2 = false;
    if (birth_acc) {
      d1 = b_mass;
    } else if (death_kill) {
      d1 = -m1;
    } else if (death_rebirth) {
      d1 = rebirth - m1;
    } else if (move_acc) {
      d1 = -m1;
      d2 = m1;
      v2 = true;
    } else if (ex_acc && !same_elem) {
      d1 = nm1 - m1;
      d2 = nm2 - m2;
      v2 = true;
    } else {
      v1 = false;
    }
    const float old1 = M[e1], old2 = M[e2];
    if (v1) {
      const float a1 = fmaxf(old1 + d1, F(0.0)) - old1;
      M[e1] = old1 + a1;
      model.apply(q.r1, e1, a1);
    }
    if (v2) {  // after stream 1: a same-row pair adds in this order
      const float a2 = fmaxf(old2 + d2, F(0.0)) - old2;
      M[e2] = old2 + a2;
      model.apply(q.r2, e2, a2);
    }
  }

  // ---- atom table: in-place writes, exchange partners and births
  // target disjoint slots. One scan gives the births' ranks and count
  // (low 16 bits) and the deaths' count (high bits: B <= 1024); the
  // hole flags, set before it, are read by the compaction after its
  // barriers.
  if (death_kill) ch.hole_flag[q.a1c] = 1;
  int n_bd;
  const int birth_rank =
      block_scan<kWarp>((birth_acc ? 1 : 0) | (death_kill ? 1 << 16 : 0),
                        sh.warp_sums, n_bd) &
      0xffff;
  const int n_b = n_bd & 0xffff, n_d = n_bd >> 16;
  if (death_kill || death_rebirth || move_acc || ex_acc) {
    mass[q.a1c] = death_kill      ? F(0.0)
                  : death_rebirth ? rebirth
                  : ex_acc        ? nm1
                                  : q.m1;
    elem[q.a1c] = death_kill ? -1 : (move_acc ? q.elem2 : q.elem1);
  }
  if (ex_acc) mass[q.a2c] = nm2;
  if (birth_acc) {
    const int slot = (n + birth_rank - 1) & (C - 1);
    mass[slot] = b_mass;
    elem[slot] = q.e_birth;
  }

  // ---- swap-with-back compaction: the k-th hole below the new
  // boundary takes the k-th live atom of the tail [n_new, n + n_b)
  const int n_new = n + n_b - n_d;
  const bool t_valid = lane < n_d;
  const int t_slot = (n_new + lane) & (C - 1);
  const bool t_filler = t_valid && ch.hole_flag[t_slot] == 0;
  const bool hole = death_kill && q.a1c < n_new;
  int unused;  // the fillers' ranks (low 16 bits) and the holes' in one scan
  const int fh_rank = block_scan<kWarp>(
      (t_filler ? 1 : 0) | (hole ? 1 << 16 : 0), sh.warp_sums, unused);
  const int f_rank = fh_rank & 0xffff, h_rank = fh_rank >> 16;
  if (t_filler) sh.rank_to_src[f_rank] = t_slot;
  block_sync<kWarp>();
  int fill_elem = -1;
  float fill_mass = F(0.0);
  if (hole) {  // read the tail after the births, before any hole write
    const int src = sh.rank_to_src[min(h_rank, p.B)] & (C - 1);
    fill_elem = elem[src];
    fill_mass = mass[src];
  }
  block_sync<kWarp>();
  if (hole) {
    elem[q.a1c] = fill_elem;
    mass[q.a1c] = fill_mass;
  }
  block_sync<kWarp>();
  if (t_valid) {  // clear the discarded tail last
    elem[t_slot] = -1;
    mass[t_slot] = F(0.0);
  }
  if (death_kill) ch.hole_flag[q.a1c] = 0;

  tally(q.is_birth, &sh.cnt[0]);
  tally(q.is_death, &sh.cnt[1]);
  tally(q.is_move, &sh.cnt[2]);
  tally(q.is_exch, &sh.cnt[3]);
  tally(birth_acc, &sh.cnt[4]);
  tally(death_kill || death_rebirth, &sh.cnt[5]);
  tally(move_acc, &sh.cnt[6]);
  tally(ex_acc, &sh.cnt[7]);
  if (lane == 0) {
    sh.n = n_new;
    sh.done = sh.done + sh.n_processed;
  }
  block_sync<kWarp>();
}

// One block's whole update(nSteps) for `chain` on the arrays of `ch`:
// every sweep until the budget is spent, its state across sweeps in sh.
template <bool kWarp = false, class Model>
__device__ void sweep_chain(const SweepArgs& p, const Chain& ch,
                            Model& model, int chain, SweepShared& sh) {
  chain_begin<kWarp>(p, ch, sh, chain);
  int s = 0;
  for (;; ++s) {
    Proposal q;
    Draws d;
    if (!sweep_front<kWarp>(p, ch, sh, chain, s, q, d)) break;
    const Alpha ab = model.alpha(q);
    sweep_back<kWarp>(p, ch, sh, q, d, ab, model);
  }
  chain_end<kWarp>(p, sh, chain, s);
}

// The same with a SweepShared of its own.
template <bool kWarp = false, class Model>
__device__ void sweep_chain(const SweepArgs& p, const Chain& ch,
                            Model& model, int chain) {
  __shared__ SweepShared sh;
  sweep_chain<kWarp>(p, ch, model, chain, sh);
}

// Fills the SweepArgs fields every launch passes in the same order.
inline SweepArgs make_args(int nch, int B, int C, int NR, int K,
                           int local_moves, float alpha_nb, float dom_len,
                           float temp, const float* lam, const float* mgm,
                           const int* budget, float* mass, int* elem, int* n,
                           float* M, const int* colnz, int* scratch, int* out,
                           const float* uni, int s_max, const long long* key0,
                           uint32_t key1) {
  SweepArgs p;
  p.nch = nch;
  p.B = B;
  p.C = C;
  p.NR = NR;
  p.K = K;
  p.NB = NR * K;
  p.local_moves = local_moves;
  p.s_max = s_max;
  p.alpha_nb = alpha_nb;
  p.dom_len = dom_len;
  p.temp = temp;
  p.lam = lam;
  p.mgm = mgm;
  p.budget = budget;
  p.mass = mass;
  p.elem = elem;
  p.n = n;
  p.M = M;
  p.colnz = colnz;
  p.scratch = scratch;
  p.scratch_stride = NR + 2 * C + 2;
  p.g_rmin = 0;
  p.g_amin = NR + 1;
  p.g_hole = NR + C + 2;
  for (int i = 0; i < kNPlaced; ++i) p.smem[i] = -1;
  p.out = out;
  p.uni = uni;
  p.key0 = key0;
  p.key1 = key1;
  return p;
}

}  // namespace cogaps
