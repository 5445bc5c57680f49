// CoGAPS Gibbs sweep kernel for Hopper (sm_90a).
//
// Replaces cogaps_tpu/ops/pallas_sweep.py::_kernel_b (body _sweep_b):
// one sampler's whole update(nSteps) — every sweep until the update
// budget is spent — for NCH independent chains in one launch. The
// semantics are those of the plain version, cogaps_tpu_torch/ops/
// sweep.py::sweep (itself the counterpart of cogaps_tpu/ops/sweep.py):
// one (16, B) uniform block per sweep; type draw; rank picks in the
// compact atom table; exact first-wins conflicts on rows and atoms;
// capacity and budget truncation; s, s_mu and the pair term read from
// the SQ, Y and Z tables; truncated-normal Gibbs, exponential and
// truncated-gamma(2) draws; Metropolis accepts; clamped M deltas;
// Y[r,:] -= delta * Z[r*k+c,:]; births appended and holes refilled from
// the tail. Each float operation is written in the order of the plain
// version and the file is compiled with -fmad=false, so the kernel and
// the plain version make the same decisions on the same uniforms.
//
// Design: one thread block per chain, one thread per proposal lane
// (B <= 1024). The block loops over sweeps itself. Conflicts are
// atomicMin claims of the lane id in per-chain row and slot tables in
// global memory; the lanes that claimed reset their entries after the
// keep test. The five inclusive prefix sums of a sweep are block scans
// (warp shuffles plus one shared array of warp totals). The atom
// tables, M, Y, SQ and Z stay in global memory (L2); shared memory holds
// the scan buffer and the rank-to-slot table of the hole refill.
//
// What bounds it on the H100: the latency of the dependent global loads
// of each lane (table picks, then SQ/Y/Z/M at the picked rows) and the
// ~20 block barriers of every sweep; the work per sweep is a few hundred
// flops per lane. One block per chain leaves most of the 132 SMs idle at
// 16 chains. The design keeps each sweep to one pass over the lanes with
// no host round trip: the fast mode draws its uniforms in the kernel
// (Philox4x32-10) and reads the budgets from device memory, so an update
// call is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr int kMaxB = 1024;
constexpr int kBig = 0x7fffffff;
constexpr double kEps = 1.0e-10;  // the reference's gaps::epsilon

struct Params {
  int nch, B, C, NR, K, NB, local_moves, s_max;
  float alpha_nb, dom_len, temp;
  const float* lam;
  const float* mgm;
  const int* budget;
  float* mass;
  int* elem;
  int* n;
  float* M;
  float* Y;
  const float* SQ;
  const float* Z;
  const int* colnz;
  int* scratch;
  int* out;
  const float* uni;
  const long long* key0;
  uint32_t key1;
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

// Inclusive prefix sum of v over the block; `total` gets the block sum.
// Every thread of the block must call it.
__device__ int block_scan(int v, int* warp_sums, int& total) {
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (wl >= o) x += y;
  }
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

__global__ void __launch_bounds__(kMaxB) sweep_kernel(const Params p) {
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
  const int B = p.B, C = p.C, K = p.K, NB = p.NB;
  const bool in_batch = lane < B;

  float* mass = p.mass + (size_t)chain * C;
  int* elem = p.elem + (size_t)chain * C;
  float* M = p.M + (size_t)chain * NB;
  float* Y = p.Y + (size_t)chain * NB;
  const float* SQ = p.SQ + (size_t)chain * NB;
  const float* Z = p.Z + (size_t)chain * NB * K;
  const int* colnz = p.colnz + (size_t)chain * K;
  int* rmin = p.scratch + (size_t)chain * (p.NR + 2 * C + 2);
  int* amin = rmin + p.NR + 1;
  int* hole_flag = amin + C + 1;
  const float lam = p.lam[chain];
  const float mgm = p.mgm[chain];
  const int budget = p.budget[chain];
  const uint32_t key0 =
      p.key0 ? (uint32_t)((unsigned long long)p.key0[chain] & 0xffffffffull)
             : 0u;

  __shared__ int warp_sums[32];
  __shared__ int rank_to_src[kMaxB + 1];
  __shared__ int sh_n, sh_done;
  __shared__ int sh_cnt[8];

  for (int i = lane; i <= p.NR; i += blockDim.x) rmin[i] = kBig;
  for (int i = lane; i <= C; i += blockDim.x) amin[i] = kBig;
  for (int i = lane; i < C; i += blockDim.x) hole_flag[i] = 0;
  if (lane == 0) {
    sh_n = p.n[chain];
    sh_done = 0;
  }
  if (lane < 8) sh_cnt[lane] = 0;
  __syncthreads();

  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int s = 0;
  for (;; ++s) {
    const int n = sh_n;
    const int done = sh_done;
    const int remaining = budget - done;
    if (remaining <= 0) break;
    if (p.uni != nullptr && s >= p.s_max) break;

    // ---- the sweep's uniforms: rows 0-8 of its (16, B) block
    float u[12];
    if (p.uni != nullptr) {
      const float* blk = p.uni + ((size_t)chain * p.s_max + s) * 16 * B;
#pragma unroll
      for (int j = 0; j < 9; ++j) u[j] = in_batch ? blk[j * B + lane] : F(0.0);
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const uint4 w = philox(
            make_uint4((uint32_t)lane, (uint32_t)g, (uint32_t)s,
                       (uint32_t)chain),
            key0, p.key1);
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
    bool is_death = active && is_bd && (u[1] < dp) && !small;
    bool is_birth = active && ((is_bd && (u[1] >= dp)) || small);
    bool is_move = active && !small && (u[0] >= F(0.5)) && (u[0] < F(0.75));
    bool is_exch = active && !small && (u[0] >= F(0.75));

    // ---- picks in the compact table
    const int n_c = max(n, 1);
    const float nf = F(n_c);
    const int a1r = min((int)(u[5] * nf), n_c - 1);
    const int n1 = max(n - 1, 1);
    const int a2rr = min((int)(u[6] * F(n1)), n1 - 1);
    const int a2r = a2rr + (a2rr >= a1r ? 1 : 0);
    const int a1c = a1r & (C - 1);
    const int a2c = min(a2r, n_c - 1) & (C - 1);
    const int e_birth = min((int)(u[7] * F(NB)), NB - 1);

    const int elem1 = is_birth ? e_birth : max(elem[a1c], 0);
    const float m1 = is_birth ? F(0.0) : mass[a1c];
    int e_move;
    if (p.local_moves) {
      const float W_f = fmaxf(floorf(F(NB) / nf), F(1.0));
      const float t2m = u[8] * F(2.0);
      const float sgn = t2m < F(1.0) ? F(-1.0) : F(1.0);
      const float frac = t2m - floorf(t2m);
      const float mag = fminf(floorf(frac * W_f) + F(1.0), W_f);
      float r = fmodf(F(elem1) + sgn * mag, F(NB));  // floor-mod
      if (r < F(0.0)) r += F(NB);
      e_move = (int)r;
    } else {
      e_move = min((int)(u[8] * F(NB)), NB - 1);
    }
    const int elem2 = is_move ? e_move : max(elem[a2c], 0);
    const float m2 = mass[a2c];
    const int r1 = elem1 / K, c1 = elem1 - r1 * K;
    const int r2 = elem2 / K, c2 = elem2 - r2 * K;
    const bool uses2 = is_move || is_exch;
    const bool uses_a1 = is_death || is_move || is_exch;

    // ---- conflicts: the earliest active lane on each row and slot wins
    if (active) atomicMin(&rmin[r1], lane);
    if (active && uses2) atomicMin(&rmin[r2], lane);
    if (active && uses_a1) atomicMin(&amin[a1c], lane);
    if (active && is_exch) atomicMin(&amin[a2c], lane);
    __syncthreads();
    bool keep = active && rmin[r1] >= lane &&
                (!uses2 || rmin[r2] >= lane) &&
                (!uses_a1 || amin[a1c] >= lane) &&
                (!is_exch || amin[a2c] >= lane);

    // capacity guard (conservative pre-rank), then budget truncation
    int total;
    const int pre_birth_rank = block_scan(keep && is_birth, warp_sums, total);
    keep = keep && (!is_birth || (n + pre_birth_rank - 1 < C));
    // every lane has read its claims: release them
    if (active) rmin[r1] = kBig;
    if (active && uses2) rmin[r2] = kBig;
    if (active && uses_a1) amin[a1c] = kBig;
    if (active && is_exch) amin[a2c] = kBig;
    const int rank = block_scan(keep, warp_sums, total);
    keep = keep && rank <= remaining;
    const int n_processed = min(total, remaining);

    is_birth = is_birth && keep;
    is_death = is_death && keep;
    is_move = is_move && keep;
    is_exch = is_exch && keep;

    // ---- evaluate and apply the kept proposals. Kept lanes touch
    // disjoint rows, so each reads its rows of SQ/Y/M before writing.
    bool birth_acc = false, death_kill = false, death_rebirth = false;
    bool move_acc = false, ex_acc = false;
    float b_mass = F(0.0), rebirth = F(0.0), nm1 = F(0.0), nm2 = F(0.0);
    const bool same_elem = elem1 == elem2;
    if (keep) {
      const int e1 = r1 * K + c1, e2 = r2 * K + c2;
      const float s1 = SQ[e1], smu1 = Y[e1];
      const bool can1 = colnz[c1] != 0;
      const float log_u = logf(fmaxf(u[4], F(1e-37)));
      if (is_birth) {  // h:131-149
        const float b_s = s1 * p.temp;
        const float b_smu = smu1 * p.temp;
        bool g_ok;
        const float g_mass =
            gibbs_mass(u[2], b_s, b_smu, F(0.0), mgm, lam, g_ok);
        const float e_mass = -logf(fmaxf(u[3], F(1e-30))) / lam;
        b_mass = can1 ? g_mass : e_mass;
        const bool b_has = can1 ? (g_ok && fabsf(smu1) > F(0.0)) : true;
        birth_acc = b_has && (b_mass > F(kEps));
      } else if (is_death) {  // h:154-188
        const float d_s = s1 * p.temp;
        const float d_smu = (smu1 + m1 * s1) * p.temp;
        const bool rel_d = fabsf(smu1 + m1 * s1) > F(0.0);
        bool d_gok;
        const float d_gm =
            gibbs_mass(u[2], d_s, d_smu, F(0.0), mgm, lam, d_gok);
        rebirth = (can1 && d_gok && rel_d) ? d_gm : m1;
        const float dll = rebirth * (d_smu - d_s * rebirth * F(0.5));
        death_rebirth = log_u < dll;
        death_kill = !death_rebirth;
      } else {  // move (h:192-223) or exchange (h:228-257)
        const float s2 = SQ[e2], smu2 = Y[e2];
        const float x = Z[e1 * K + c2];
        const float same_row = r1 == r2 ? F(1.0) : F(0.0);
        const float s_pair = s1 + s2 - F(2.0) * x * same_row;
        const float smu_pair = smu1 - smu2;
        const float p_s = s_pair * p.temp;
        const float p_smu = smu_pair * p.temp;
        if (is_move) {
          const float dll = -m1 * (p_smu + p_s * m1 * F(0.5));
          move_acc = !same_elem && (log_u < dll);
        } else {
          bool x_ok;
          const float x_mass =
              gibbs_mass(u[2], p_s, p_smu, -m1, m2, F(0.0), x_ok);
          const float new_sb = trunc_gamma2_y(u[2], (m1 + m2) * lam) / lam;
          const float d_sb = m1 > m2 ? new_sb - m1 : m2 - new_sb;
          nm1 = same_elem ? m1 + d_sb : m1 + x_mass;
          nm2 = same_elem ? m2 - d_sb : m2 - x_mass;
          const bool can2 = colnz[c2] != 0;
          const bool ex_ok =
              same_elem ||
              ((can1 || can2) && x_ok && fabsf(smu_pair) > F(0.0));
          ex_acc = ex_ok && (nm1 > F(kEps)) && (nm2 > F(kEps));
        }
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
        for (int j = 0; j < K; ++j)
          Y[r1 * K + j] = Y[r1 * K + j] + (-a1) * Z[e1 * K + j];
      }
      if (v2) {  // after stream 1: a same-row pair adds in this order
        const float a2 = fmaxf(old2 + d2, F(0.0)) - old2;
        M[e2] = old2 + a2;
        for (int j = 0; j < K; ++j)
          Y[r2 * K + j] = Y[r2 * K + j] + (-a2) * Z[e2 * K + j];
      }
    }

    // ---- atom table: in-place writes, exchange partners and births
    // target disjoint slots
    int n_b;
    const int birth_rank = block_scan(birth_acc, warp_sums, n_b);
    if (death_kill || death_rebirth || move_acc || ex_acc) {
      mass[a1c] = death_kill      ? F(0.0)
                  : death_rebirth ? rebirth
                  : ex_acc        ? nm1
                                  : m1;
      elem[a1c] = death_kill ? -1 : (move_acc ? elem2 : elem1);
    }
    if (ex_acc) mass[a2c] = nm2;
    if (birth_acc) {
      const int slot = (n + birth_rank - 1) & (C - 1);
      mass[slot] = b_mass;
      elem[slot] = e_birth;
    }
    if (death_kill) hole_flag[a1c] = 1;
    const int n_d = __syncthreads_count(death_kill);

    // ---- swap-with-back compaction: the k-th hole below the new
    // boundary takes the k-th live atom of the tail [n_new, n + n_b)
    const int n_new = n + n_b - n_d;
    const bool t_valid = lane < n_d;
    const int t_slot = (n_new + lane) & (C - 1);
    const bool t_filler = t_valid && hole_flag[t_slot] == 0;
    int unused;
    const int f_rank = block_scan(t_filler, warp_sums, unused);
    const bool hole = death_kill && a1c < n_new;
    const int h_rank = block_scan(hole, warp_sums, unused);
    if (t_filler) rank_to_src[f_rank] = t_slot;
    __syncthreads();
    int fill_elem = -1;
    float fill_mass = F(0.0);
    if (hole) {  // read the tail after the births, before any hole write
      const int src = rank_to_src[min(h_rank, B)] & (C - 1);
      fill_elem = elem[src];
      fill_mass = mass[src];
    }
    __syncthreads();
    if (hole) {
      elem[a1c] = fill_elem;
      mass[a1c] = fill_mass;
    }
    __syncthreads();
    if (t_valid) {  // clear the discarded tail last
      elem[t_slot] = -1;
      mass[t_slot] = F(0.0);
    }
    if (death_kill) hole_flag[a1c] = 0;

    cnt[0] += is_birth;
    cnt[1] += is_death;
    cnt[2] += is_move;
    cnt[3] += is_exch;
    cnt[4] += birth_acc;
    cnt[5] += death_kill || death_rebirth;
    cnt[6] += move_acc;
    cnt[7] += ex_acc;
    if (lane == 0) {
      sh_n = n_new;
      sh_done = done + n_processed;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (cnt[j]) atomicAdd(&sh_cnt[j], cnt[j]);
  __syncthreads();
  if (lane == 0) {
    p.n[chain] = sh_n;
    int* o = p.out + (size_t)chain * 10;
    o[0] = sh_done;
    o[1] = s;
    for (int j = 0; j < 8; ++j) o[2 + j] = sh_cnt[j];
  }
}

}  // namespace

extern "C" int cogaps_sweep_launch(
    int nch, int B, int C, int NR, int K, int local_moves, float alpha_nb,
    float dom_len, float temp, const float* lam, const float* mgm,
    const int* budget, float* mass, int* elem, int* n, float* M, float* Y,
    const float* SQ, const float* Z, const int* colnz, int* scratch, int* out,
    const float* uni, int s_max, const long long* key0, uint32_t key1,
    void* stream) {
  if (B < 1 || B > kMaxB || nch < 1) return (int)cudaErrorInvalidValue;
  Params p;
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
  p.Y = Y;
  p.SQ = SQ;
  p.Z = Z;
  p.colnz = colnz;
  p.scratch = scratch;
  p.out = out;
  p.uni = uni;
  p.key0 = key0;
  p.key1 = key1;
  const int threads = (B + 31) / 32 * 32;
  sweep_kernel<<<nch, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
