// The sparse model's per-call tables for Hopper (sm_90a), one cooperative
// launch a sampler's update call for every chain of the call, straight
// from the data rows in CSR order.
//
// Replaces the XLA dots of cogaps_tpu/models/sparse.py:246 (kernel_tables)
// and :269 (kernel_tables_ell), which have no Pallas kernel: the JAX
// package forms U as a product of dense (NR x m) weights, 98% zeros at the
// atlas's density, with the (m x k^2) Gram rows, because a TPU gathers
// badly; the port ran the same products on cuBLAS. Here the rows' nonzeros
// are gathered instead. For the sampled factor's row r (its nonzeros j
// with value d_j, partner row o_j = O[idx_j] of the frozen factor O (m, k),
// the factor's row M[r]), per chain:
//   U[r]  = sum_j w_j o_j o_j^T,   w_j = 1 - 1/d_j^2
//   T4[r] = sum_j (1/d_j) o_j
//   Z2    = O^T O
//   G[r]  = beta (Z2 - U[r]),  SQ[r] = diag G[r]
//   Y0[r] = beta T4[r] - G[r] M[r]
// in float32, as models/sparse.sparse_tables_plain forms them.
//
// What bounds it on the H100: at k = 10 (phases 7, 8, 11, 13: 6,620 of the
// main path's 6,780 launches) the bytes (8 of idx and val a nonzero, 400 of
// G a row) put the bound near 6 us, so the time is latency, instruction
// issue and fixed costs: a block a row with barriers between a segment's
// loads, sums and reductions left most of it waiting. Above k ~ 16 the
// FP32 operations bound it (k(k+1)/2 fmaf a nonzero: 1275 at k = 50), and
// the limit is how many instructions issue for each fmaf. Three forms,
// all from k alone (ops/sparse_tables_cuda.sparse_plan):
//
// lanes_kernel<K>, k <= 16: a warp a row, a lane a nonzero. Lane l sums
// nonzeros l, l + 32, ... of its row, every entry of U's upper triangle and
// T4 in its own registers (k(k+1)/2 + k fmaf and k products w o_i a
// nonzero: nothing computed twice). Its partner rows come by 16-byte
// cp.async from a copy of O padded to KP = 4 ceil(k/4) floats, which the
// launch makes first; they go into a ring of D = 4 stages of the warp's
// shared memory, each lane into its own slots, the idx and val of a stage
// D stages before its row: the next rows, the rest of this row's and the
// next row's, are in flight behind the sums, and no lane waits on another
// (no barrier but the warp's own). At the row's end the lanes' sums are
// added by a butterfly of shuffles at lane distance 16, 8, 4, 2, 1 (a
// reduce-scatter: each level halves what a lane holds), and all 32 lanes
// write G, Y0 and SQ. The warps walk the (chain, row) items by a stride of
// the grid, so a short row holds one warp, not a block.
//
// tiles_kernel, 16 < k <= 172: a block a row; a thread holds an 8 x 8
// tile (a, b), a <= b, of U's upper triangle (k padded to KP = 8
// ceil(k/8)) and the 8 T4 entries of its tile row: per nonzero 64 + 8
// fmaf for 4 16-byte loads of the staged row, 8 products w o and one load
// of (w, 1/d), where 4 x 4 tiles took 16 fmaf for 2 loads and 4 products.
// Up to 16 tiles (k <= 40) a block is two warps of G groups of the P =
// nt(nt+1)/2 tiles, the groups splitting each segment of SEG = G SUB
// nonzeros; above, one group of as many warps as the tiles fill (one at
// k = 50: a row's barriers are a warp's, and its sums need no reduction
// across groups, which is what short rows, 150 nonzeros a row at phase
// 15 (c)'s P side, pay for). The segment after the current one is staged
// behind its sums (idx and val two on), one barrier a segment. A thread's
// fmaf chain runs over FL segments (CHAIN = 32 nonzeros at least) and is
// then added into its running sums in shared memory; the groups' sums are
// added in group order at the row's end. G goes out from each tile's own
// sums (a pair and its mirror from one sum), with Y0's partial sums over
// the tile's 8 columns, added in column-block order. What bounds it: the
// FP32 pipe and the instructions issued a fmaf, then shared memory's
// bandwidth (64 bytes a thread a nonzero) and the latency of the staging
// at few warps an SM. Tried and dropped, slower: a deeper ring (rows two
// segments ahead), a bulk copy (TMA) a staged row, G written in address
// order. The 3xTF32 mma.sync form of U_r = (w o)^T o was not taken: it
// computes the full k x k tile three times (the split operands' products)
// where these tiles do the upper triangle once, and would need each
// nonzero's row split and staged for the tensor cores' fragments; it is
// the untried alternative above k ~ 64.
//
// slabs_kernel, k > 172 (on no phase of the main path): the first design
// of this kernel, kept: 4 x 4 tiles over a block of up to 1024 threads in
// S slabs, each slab over all the row's nonzeros, a row a block; Z2 in
// chunks first, then two grid barriers.
//
// Z2 = O^T O (lanes and tiles): the first items of the walk are Z2's
// chunks (a chunk of ZSEG partners an item, at most 32 chunks a chain, from
// k and m alone), summed as rows are, their partials written out; the unit
// that completes a chain's last chunk (an integer counter) adds the
// partials in chunk order and releases the chain's flag. A row's sums do
// not wait for Z2: only its epilogue G = beta (Z2 - U) does, on the flag.
// The one grid barrier left is after the padded copy of O, which every
// row's staging reads. The launch stays cooperative because the flag
// waits need every block resident (a unit waits only after its own chunks,
// so all chunks are taken by running units).
//
// Order: every entry of a chain's tables is summed in an order fixed by k
// and its row's nonzeros alone (ops/sparse_tables_cuda.segments), Z2's by
// k and m alone; the walk over the items moves no sum, so a chain's tables
// are the same bits alone and beside any others. No float atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBeta = 100.0f;  // models/sparse.BETA: 1/0.1^2
constexpr int kLaneStages = 4;   // the lanes form's ring (D)
constexpr int kLaneThreads = 128;
constexpr int kMaxChunks = 32;   // Z2's chunks a chain, lanes and tiles
constexpr int kTileAhead = 1;    // the tiles form's rows staged ahead

struct Args {
  const long long* indptr;  // (nch, NR + 1) offsets into idx and val
  const int* idx;           // partner rows
  const float* val;         // nonzeros d > 0
  const float* O;           // (m, k) a chain, cO floats apart (0: shared)
  const float* M;           // (NR, k) a chain, cM floats apart (0: shared)
  long long cO, cM;
  float* SQ;     // (nch, NR, k)
  float* Y0;     // (nch, NR, k)
  float* Gtab;   // (nch, NR k, k)
  float* zpart;  // Z2's chunk partials, upper triangle
  float* Z2;     // (nch, k, k)
  float* Opad;   // (nO, m, KP): O padded with zeros (lanes, tiles)
  int* sync;     // (2, nch): chunks done, Z2 ready (lanes, tiles)
  int nch, NR, m, k, KP, RS, nt, npair, P, G, SUB, SEG, FL, S, ZSEG, nzc,
      NZ4, nO;
  int kkp;  // a chain's Z2 floats apart (lanes, tiles: k^2 up to 32)
};

// ---------------------------------------------------------------------
// asynchronous copies and flags
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// the same through L1, where the partner rows repeat across a warp's
// stages
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src,
                                              bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// n <= 8 consecutive floats out, in pairs where the address allows
__device__ __forceinline__ void store8(float* dst, const float* v, int n) {
  if (((uintptr_t)dst & 7) == 0) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (j + 1 < n)
        *reinterpret_cast<float2*>(dst + j) = make_float2(v[j], v[j + 1]);
      else if (j < n)
        dst[j] = v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) dst[j] = v[j];
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Spins until chain ch's Z2 is out (one thread of the unit calls it)
__device__ __forceinline__ void wait_z2(const Args& p, int ch) {
  while (ld_acquire(p.sync + p.nch + ch) == 0) __nanosleep(64);
}

// A chain's Z2 entry from its chunk partials (NZ4 floats apart from the
// entry's first, chunks 0 .. nzc - 1 contiguous), added in chunk order
__device__ __forceinline__ float chunk_sum(const float* part, int nzc) {
  float4 v[kMaxChunks / 4];
#pragma unroll
  for (int i = 0; i < kMaxChunks / 4; ++i)
    v[i] = 4 * i < nzc ? __ldcg(reinterpret_cast<const float4*>(part) + i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  float z = v[0].x;
#pragma unroll
  for (int q = 1; q < kMaxChunks; ++q) {
    const float4 x = v[q / 4];
    const float e = q % 4 == 0 ? x.x : q % 4 == 1 ? x.y : q % 4 == 2 ? x.z
                                                                    : x.w;
    if (q < nzc) z = __fadd_rn(z, e);
  }
  return z;
}

// The padded copy of O (zeros past k), the counters and flags reset (Z2
// zero and ready where m is 0); every block, before the one grid barrier
__device__ __forceinline__ void pad_and_reset(const Args& p) {
  const unsigned gt = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nth = gridDim.x * blockDim.x;
  const unsigned total = (unsigned)p.nO * (unsigned)p.m * (unsigned)p.KP;
  for (unsigned e = gt; e < total; e += nth) {
    const unsigned row = e / (unsigned)p.KP;
    const unsigned c = e - row * (unsigned)p.KP;
    p.Opad[e] = c < (unsigned)p.k ? __ldg(p.O + (size_t)row * p.k + c) : 0.f;
  }
  for (unsigned e = gt; e < 2u * p.nch; e += nth)
    p.sync[e] = e >= (unsigned)p.nch && p.nzc == 0 ? 1 : 0;
  if (p.nzc == 0)
    for (unsigned e = gt; e < (unsigned)(p.nch * p.kkp); e += nth)
      p.Z2[e] = 0.f;
}

// ---------------------------------------------------------------------
// the walk: a unit's items (Z2's chunks first, then the (chain, row)
// items), `stride` apart, each cut into stages of `per` nonzeros
// ---------------------------------------------------------------------
struct Walk {
  int u;           // item
  long long lo;    // its first nonzero (or partner)
  int n, nst, st;  // its nonzeros (partners), stages, current stage
  int ch, r;       // chain; row, or chunk of a Z2 item
  bool z;          // a Z2 chunk
};

// w at item w.u, at its first stage
__device__ __forceinline__ void walk_load(const Args& p, Walk& w, int nZ,
                                          int per) {
  w.z = w.u < nZ;
  const int v = w.z ? w.u : w.u - nZ;
  const int div = w.z ? p.nzc : p.NR;
  w.ch = (unsigned)v / (unsigned)div;
  w.r = v - w.ch * div;
  if (w.z) {
    w.lo = (long long)w.r * p.ZSEG;
    w.n = min(p.ZSEG, p.m - w.r * p.ZSEG);
  } else {
    const long long* ptr = p.indptr + (size_t)w.ch * (p.NR + 1) + w.r;
    w.lo = __ldg(ptr);
    w.n = (int)(__ldg(ptr + 1) - w.lo);
  }
  w.nst = (w.n + per - 1) / per;
  w.st = 0;
}

// w on to the item `stride` on (w.u past `total` at the end)
__device__ __forceinline__ void walk_next(const Args& p, Walk& w, int nZ,
                                          int total, int stride, int per) {
  w.u += stride;
  if (w.u < total) walk_load(p, w, nZ, per);
}

// Moves w on to the next stage there is (past items with none)
__device__ __forceinline__ void walk_settle(const Args& p, Walk& w, int nZ,
                                            int total, int stride, int per) {
  while (w.u < total && w.st >= w.nst) walk_next(p, w, nZ, total, stride, per);
}

// w at item `start`, at its first stage if `settle` (past items with
// none), else at the item itself
__device__ __forceinline__ void walk_start(const Args& p, Walk& w, int start,
                                           int nZ, int total, int stride,
                                           int per, bool settle) {
  w.u = start;
  w.st = w.nst = 0;
  if (start < total) walk_load(p, w, nZ, per);
  if (settle) walk_settle(p, w, nZ, total, stride, per);
}

// w and 1/d of a staged nonzero (1 and 0 for a Z2 partner, 0 and 0 past
// the stage's end)
__device__ __forceinline__ void coeffs(bool z, bool ok, float d, float& w,
                                       float& r) {
  if (z) {
    w = ok ? 1.0f : 0.0f;
    r = 0.0f;
  } else {
    w = ok ? __fsub_rn(1.0f, __frcp_rn(__fmul_rn(d, d))) : 0.0f;
    r = ok ? __frcp_rn(d) : 0.0f;
  }
}

// ---------------------------------------------------------------------
// lanes_kernel<K>: a warp a row, a lane a nonzero (k <= 16)
// ---------------------------------------------------------------------
template <int K>
struct Lane {
  static constexpr int KP = 4 * ((K + 3) / 4);
  // a staged row's stride: 8 lanes' 16-byte loads on distinct banks
  static constexpr int RS = KP % 8 == 4 ? KP : KP + 4;
  static constexpr int EU = K * (K + 1) / 2;
  static constexpr int E = EU + K;  // U's upper triangle, then T4
  static constexpr int D = kLaneStages;
  // the butterfly's sizes: each level halves a lane's entries
  static constexpr int H1 = (E + 1) / 2, H2 = (H1 + 1) / 2,
                       H3 = (H2 + 1) / 2, H4 = (H3 + 1) / 2,
                       H5 = (H4 + 1) / 2;
  // a warp's shared memory (floats, a multiple of 4): D stages of 32
  // rows, 2D of 32 idx and val, U and T4 (E), G (K^2)
  static constexpr int WARP = (D * 32 * RS + 2 * 2 * D * 32 + E + K * K +
                               3) / 4 * 4;
  static constexpr int REGS = E + KP + 40;
  static constexpr int MINB = 512 / REGS < 1 ? 1 : 512 / REGS > 8 ? 8
                                                                  : 512 / REGS;
};

// U's upper-triangle entry (i, j), i <= j, in a lane's order
template <int K>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * K - i * (i - 1) / 2 + (j - i);
}

// One level of the butterfly: the pairs of lanes `OFF` apart add N
// entries, the lane with the bit clear keeping the first ceil(N/2)
template <int N, int OFF>
__device__ __forceinline__ void halve(float* v, int lane) {
  constexpr int H = (N + 1) / 2;
  const bool hi = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float a = v[i];
    const float b = i + H < N ? v[i + H] : 0.0f;
    const float send = hi ? a : b;
    const float keep = hi ? b : a;
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
  }
}

template <int K>
__global__ void __launch_bounds__(kLaneThreads, Lane<K>::MINB)
    lanes_kernel(const __grid_constant__ Args p) {
  using L = Lane<K>;
  constexpr int D = L::D, KP = L::KP, RS = L::RS, EU = L::EU, E = L::E;
  constexpr int KK = K * K;
  extern __shared__ float4 smem4[];
  pad_and_reset(p);
  cg::this_grid().sync();

  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(smem4) + (size_t)wib * L::WARP;
  float* sRows = base;                                     // D x 32 x RS
  int* sIdx = reinterpret_cast<int*>(base + D * 32 * RS);  // 2D x 32
  float* sVal = base + D * 32 * RS + 2 * D * 32;           // 2D x 32
  float* sU = sVal + 2 * D * 32;                           // E
  float* sG = sU + E;                                      // K^2

  const int W = gridDim.x * (blockDim.x >> 5);
  const int wid = blockIdx.x * (blockDim.x >> 5) + wib;
  const int nZ = p.nch * p.nzc, total = nZ + p.nch * p.NR;
  const long long mKP = (long long)p.m * KP;

  Walk mw, rw;  // the idx/val producer (2D stages ahead), the rows' (D)
  walk_start(p, mw, wid, nZ, total, W, 32, true);
  rw = mw;

  // idx and val of mw's stage into meta slot ms (a Z2 partner's index
  // directly)
  auto meta_issue = [&](int ms) {
    if (mw.u >= total) return;
    const int off = mw.st * 32 + lane;
    const bool ok = off < mw.n;
    const long long j = mw.lo + off;
    int* di = sIdx + ms * 32 + lane;
    float* dv = sVal + ms * 32 + lane;
    if (mw.z) {
      *di = ok ? (int)j : 0;
      *dv = 1.0f;
    } else {
      cp_async4(di, p.idx + (ok ? j : 0), ok);
      cp_async4(dv, p.val + (ok ? j : 0), ok);
    }
    ++mw.st;
    walk_settle(p, mw, nZ, total, W, 32);
  };
  // the partner row of rw's stage into row slot rs (zeros past the end)
  auto rows_issue = [&](int rs, int ms) {
    if (rw.u >= total) return;
    const bool ok = rw.st * 32 + lane < rw.n;
    const int q = ok ? sIdx[ms * 32 + lane] : 0;
    const float* src = p.Opad + (p.cO ? rw.ch * mKP : 0) + (size_t)q * KP;
    float* dst = sRows + (rs * 32 + lane) * RS;
#pragma unroll
    for (int c4 = 0; c4 < KP / 4; ++c4)
      cp_async16_l1(dst + 4 * c4, src + 4 * c4, ok);
    ++rw.st;
    walk_settle(p, rw, nZ, total, W, 32);
  };

  // the ring's first stages: idx and val of D, then their rows beside the
  // next D idx and val, a group a stage
#pragma unroll
  for (int i = 0; i < D; ++i) meta_issue(i);
  cp_async_commit();
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < D; ++i) {
    rows_issue(i, i);
    meta_issue(D + i);
    cp_async_commit();
  }

  constexpr int NT = (KK + 31) / 32;  // G's entries a lane
  float zr[NT];  // the lane's entries of its chain's Z2, once a chain
  int pos = 0, seen = -1;
  Walk c;  // the sums' item
  for (walk_start(p, c, wid, nZ, total, W, 32, false); c.u < total;
       walk_next(p, c, nZ, total, W, 32)) {
    // M[r]'s entry `lane`, for Y0 by shuffles
    const float mv = !c.z && lane < K
                         ? __ldg(p.M + (size_t)c.ch * p.cM +
                                 (size_t)c.r * K + lane)
                         : 0.0f;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
    for (int st = 0; st < c.nst; ++st, ++pos) {
      cp_async_wait<D - 1>();  // this stage's row, and idx D stages on
      const int rs = pos % D, ms = pos % (2 * D);
      const float4* o4 =
          reinterpret_cast<const float4*>(sRows + (rs * 32 + lane) * RS);
      float o[KP];
#pragma unroll
      for (int q = 0; q < KP / 4; ++q) {
        const float4 v = o4[q];
        o[4 * q] = v.x;
        o[4 * q + 1] = v.y;
        o[4 * q + 2] = v.z;
        o[4 * q + 3] = v.w;
      }
      float w, r;
      coeffs(c.z, st * 32 + lane < c.n, sVal[ms * 32 + lane], w, r);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float wo = __fmul_rn(w, o[i]);
#pragma unroll
        for (int j = i; j < K; ++j)
          acc[tri<K>(i, j)] = __fmaf_rn(wo, o[j], acc[tri<K>(i, j)]);
      }
#pragma unroll
      for (int i = 0; i < K; ++i)
        acc[EU + i] = __fmaf_rn(r, o[i], acc[EU + i]);
      // the slot just read takes the stage D on, its idx the meta slot
      // D on; the meta slot just read takes the stage 2D on
      rows_issue(rs, (pos + D) % (2 * D));
      meta_issue(ms);
      cp_async_commit();
    }

    // the lanes' sums added: lane l ends with n entries from eb (at each
    // level the lane with the bit set keeps the upper part of its range)
    halve<E, 16>(acc, lane);
    halve<L::H1, 8>(acc, lane);
    halve<L::H2, 4>(acc, lane);
    halve<L::H3, 2>(acc, lane);
    halve<L::H4, 1>(acc, lane);
    int eb = 0, n = E;
    const int hs[5] = {L::H1, L::H2, L::H3, L::H4, L::H5};
#pragma unroll
    for (int lv = 0; lv < 5; ++lv) {
      if (lane & (16 >> lv)) {
        eb += hs[lv];
        n = max(0, n - hs[lv]);
      } else {
        n = min(hs[lv], n);
      }
    }
#pragma unroll
    for (int t = 0; t < L::H5; ++t)
      if (t < n) sU[eb + t] = acc[t];
    __syncwarp();

    if (c.z) {  // a Z2 chunk: its partials out; the chain's last adds them
      float* zp = p.zpart + (size_t)c.ch * KK * p.NZ4 + c.r;
      for (int e2 = lane; e2 < KK; e2 += 32) {
        const int i = e2 / K, j = e2 - (e2 / K) * K;
        if (i <= j) zp[(size_t)e2 * p.NZ4] = sU[tri<K>(i, j)];
      }
      __threadfence();
      __syncwarp();
      int done = 0;
      if (lane == 0) done = atomicAdd(p.sync + c.ch, 1);
      done = __shfl_sync(0xffffffffu, done, 0);
      if (done == p.nzc - 1) {
        __threadfence();
        float* z2 = p.Z2 + (size_t)c.ch * p.kkp;
        const float* part = p.zpart + (size_t)c.ch * KK * p.NZ4;
        for (int e2 = lane; e2 < KK; e2 += 32) {
          const int i = e2 / K, j = e2 - (e2 / K) * K;
          if (i <= j) {
            const float z = chunk_sum(part + (size_t)e2 * p.NZ4, p.nzc);
            z2[i * K + j] = z;
            z2[j * K + i] = z;
          }
        }
        __threadfence();
        __syncwarp();
        if (lane == 0) st_release(p.sync + p.nch + c.ch, 1);
      }
      __syncwarp();
      continue;
    }

    // a row: G = beta (Z2 - U), a pair and its mirror from one sum, out
    // in address order; SQ its diagonal; Y0 = beta T4 - G M
    if (c.ch != seen) {
      if (lane == 0) wait_z2(p, c.ch);
      __syncwarp();
      const float* z2 = p.Z2 + (size_t)c.ch * p.kkp;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        zr[t] = lane + 32 * t < KK ? z2[lane + 32 * t] : 0.0f;
      seen = c.ch;
    }
    const size_t rowg = (size_t)c.ch * p.NR + c.r;
    float* Gg = p.Gtab + rowg * KK;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int e2 = lane + 32 * t;
      if (e2 < KK) {
        const int i = e2 / K, j = e2 - (e2 / K) * K;
        const float uv = sU[i <= j ? tri<K>(i, j) : tri<K>(j, i)];
        const float g = __fmul_rn(kBeta, __fsub_rn(zr[t], uv));
        Gg[e2] = g;
        sG[e2] = g;
      }
    }
    __syncwarp();
    {
      const int i = lane < K ? lane : 0;
      float mg = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        mg = __fmaf_rn(__shfl_sync(0xffffffffu, mv, j), sG[i * K + j], mg);
      if (lane < K)
        p.Y0[rowg * K + lane] =
            __fsub_rn(__fmul_rn(kBeta, sU[EU + lane]), mg);
      else if (lane >= 16 && lane - 16 < K)
        p.SQ[rowg * K + lane - 16] = sG[(lane - 16) * (K + 1)];
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// tiles_kernel: a block a row, 8 x 8 tiles of U's upper triangle a thread
// (16 < k <= 172)
// ---------------------------------------------------------------------
template <int MaxThreads, int MinBlocks>
__global__ void __launch_bounds__(MaxThreads, MinBlocks)
    tiles_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem4[];
  pad_and_reset(p);
  cg::this_grid().sync();

  const int tid = threadIdx.x, T = blockDim.x;
  const int k = p.k, kk = k * k, KP = p.KP, RS = p.RS, nt = p.nt;
  const int P = p.P, SEG = p.SEG, SUB = p.SUB, FL = p.FL, KP4 = KP / 4;
  // the thread's group and tile (a, b), a <= b
  const int g = tid / P;
  const bool active = g < p.G;
  int a = 0, b = tid - g * P;
  while (b >= nt - a) {
    b -= nt - a;
    ++a;
  }
  b += a;
  // shared memory: the running sums [18][T] float4 (acc rows 0..15, T4
  // 16..17), the ring's rows [R][SEG][RS] and (w, 1/d) [R][SEG] (the
  // rows L segments ahead of the sums), idx and val [2L][SEG] (2L
  // ahead), Y0's partial sums [KP][nt], a flag
  constexpr int L = kTileAhead, R = L + 1, MS = 2 * L;
  float4* sTot = smem4;
  float* sRows = reinterpret_cast<float*>(sTot + 18 * T);
  float2* sWR = reinterpret_cast<float2*>(sRows + R * SEG * RS);
  int* sIdx = reinterpret_cast<int*>(sWR + R * SEG);
  float* sVal = reinterpret_cast<float*>(sIdx + MS * SEG);
  float* sPart = sVal + MS * SEG;  // [KP][nt]: Y0's sums by column block
  int* sMisc = reinterpret_cast<int*>(sPart + KP * nt);
  const float* tf = reinterpret_cast<const float*>(sTot);
  // the (tile, entry) of U's (c, c2), c <= c2, and of T4's c, in tf
  auto u_at = [&](int c, int c2) {
    const int ta = c >> 3, tb = c2 >> 3;
    const int item = ta * nt - ta * (ta - 1) / 2 + (tb - ta);
    const int e = (c & 7) * 8 + (c2 & 7);
    return tf[((e >> 2) * T + item) * 4 + (e & 3)];
  };
  auto t4_at = [&](int c) {
    const int ta = c >> 3;
    const int item = ta * nt - ta * (ta - 1) / 2;
    const int e = 64 + (c & 7);
    return tf[((e >> 2) * T + item) * 4 + (e & 3)];
  };

  const int nZ = p.nch * p.nzc, total = nZ + p.nch * p.NR;
  const long long mKP = (long long)p.m * KP;
  Walk mw, rw;  // idx/val 2L segments ahead, rows L
  walk_start(p, mw, blockIdx.x, nZ, total, gridDim.x, SEG, true);
  rw = mw;

  auto meta_issue = [&](int ms) {
    if (mw.u >= total) return;
    for (int t = tid; t < SEG; t += T) {
      const int off = mw.st * SEG + t;
      const bool ok = off < mw.n;
      const long long j = mw.lo + off;
      if (mw.z) {
        sIdx[ms * SEG + t] = ok ? (int)j : 0;
        sVal[ms * SEG + t] = 1.0f;
      } else {
        cp_async4(sIdx + ms * SEG + t, p.idx + (ok ? j : 0), ok);
        cp_async4(sVal + ms * SEG + t, p.val + (ok ? j : 0), ok);
      }
    }
    ++mw.st;
    walk_settle(p, mw, nZ, total, gridDim.x, SEG);
  };
  // the thread's first 16-byte piece of a staged segment, and its step
  const int l0 = tid / KP4, c40 = tid - l0 * KP4;
  const int dl = T / KP4, dc = T - dl * KP4;
  auto rows_issue = [&](int rs, int ms) {
    if (rw.u >= total) return;
    const int nseg = min(SEG, rw.n - rw.st * SEG);
    const float* src0 = p.Opad + (p.cO ? rw.ch * mKP : 0);
    for (int l = l0, c4 = c40; l < nseg;) {
      const int q = sIdx[ms * SEG + l];
      cp_async16(sRows + (rs * SEG + l) * RS + 4 * c4,
                 src0 + (size_t)q * KP + 4 * c4, true);
      l += dl;
      c4 += dc;
      if (c4 >= KP4) {
        c4 -= KP4;
        ++l;
      }
    }
    for (int t = tid; t < nseg; t += T) {
      float w, r;
      coeffs(rw.z, true, sVal[ms * SEG + t], w, r);
      sWR[rs * SEG + t] = make_float2(w, r);
    }
    ++rw.st;
    walk_settle(p, rw, nZ, total, gridDim.x, SEG);
  };

  // the ring's first segments: idx and val of L, then their rows beside
  // the next L idx and val, a group a segment
  for (int i = 0; i < L; ++i) meta_issue(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < L; ++i) {
    rows_issue(i, i);
    meta_issue(L + i);
    cp_async_commit();
  }

  int pos = 0, seen = -1;
  Walk c;  // the sums' item
  for (walk_start(p, c, blockIdx.x, nZ, total, gridDim.x, SEG, false);
       c.u < total; walk_next(p, c, nZ, total, gridDim.x, SEG)) {
    float acc[8][8], t4[8];
    for (int st = 0; st < c.nst; ++st, ++pos) {
      cp_async_wait<L - 1>();
      __syncthreads();  // this segment's rows, idx and val L on, landed
      const int rs = pos % R;
      rows_issue((pos + L) % R, (pos + L) % MS);
      meta_issue(pos % MS);
      cp_async_commit();
      if (!active) continue;
      if (st % FL == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t4[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        }
      }
      const int nseg = min(SEG, c.n - st * SEG);
      const int lo = min(nseg, g * SUB), hi = min(nseg, lo + SUB);
      const float* rows = sRows + (size_t)rs * SEG * RS;
#pragma unroll 2
      for (int l = lo; l < hi; ++l) {
        const float4* row = reinterpret_cast<const float4*>(rows + l * RS);
        const float4 x0 = row[2 * a], x1 = row[2 * a + 1];
        const float4 y0 = row[2 * b], y1 = row[2 * b + 1];
        const float2 wr = sWR[rs * SEG + l];
        float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t4[i] = __fmaf_rn(wr.y, x[i], t4[i]);
          x[i] = __fmul_rn(wr.x, x[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
      }
      if (st % FL == FL - 1 || st == c.nst - 1) {  // the chain's end
        const bool first = st < FL;
#pragma unroll
        for (int q = 0; q < 18; ++q) {
          float4 s;
          if (q < 16)
            s = make_float4(acc[q >> 1][4 * (q & 1)],
                            acc[q >> 1][4 * (q & 1) + 1],
                            acc[q >> 1][4 * (q & 1) + 2],
                            acc[q >> 1][4 * (q & 1) + 3]);
          else
            s = make_float4(t4[4 * (q - 16)], t4[4 * (q - 16) + 1],
                            t4[4 * (q - 16) + 2], t4[4 * (q - 16) + 3]);
          if (!first) {
            const float4 o = sTot[q * T + tid];
            s = make_float4(__fadd_rn(o.x, s.x), __fadd_rn(o.y, s.y),
                            __fadd_rn(o.z, s.z), __fadd_rn(o.w, s.w));
          }
          sTot[q * T + tid] = s;
        }
      }
    }
    if (c.nst == 0) {  // an empty row: its sums are zero
      __syncthreads();
      if (active)
        for (int q = 0; q < 18; ++q)
          sTot[q * T + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (p.G > 1) {  // the groups' sums, in group order, into group 0's
      for (int x = tid; x < 18 * P; x += T) {
        const int q = x / P, i = x - (x / P) * P;
        float4 v = sTot[q * T + i];
        for (int gg = 1; gg < p.G; ++gg) {
          const float4 o = sTot[q * T + gg * P + i];
          v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y),
                          __fadd_rn(v.z, o.z), __fadd_rn(v.w, o.w));
        }
        sTot[q * T + i] = v;
      }
      __syncthreads();
    }

    if (c.z) {  // a Z2 chunk: its partials out; the chain's last adds them
      float* zp = p.zpart + (size_t)c.ch * kk * p.NZ4 + c.r;
      for (int e2 = tid; e2 < kk; e2 += T) {
        const int i = e2 / k, j = e2 - (e2 / k) * k;
        if (i <= j) zp[(size_t)e2 * p.NZ4] = u_at(i, j);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) sMisc[0] = atomicAdd(p.sync + c.ch, 1);
      __syncthreads();
      if (sMisc[0] == p.nzc - 1) {
        __threadfence();
        float* z2 = p.Z2 + (size_t)c.ch * p.kkp;
        const float* part = p.zpart + (size_t)c.ch * kk * p.NZ4;
        for (int e2 = tid; e2 < kk; e2 += T) {
          const int i = e2 / k, j = e2 - (e2 / k) * k;
          if (i <= j) {
            const float z = chunk_sum(part + (size_t)e2 * p.NZ4, p.nzc);
            z2[i * k + j] = z;
            z2[j * k + i] = z;
          }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) st_release(p.sync + p.nch + c.ch, 1);
      }
      continue;  // the next segment's barrier orders sTot and sMisc
    }

    if (c.ch != seen) {
      if (tid == 0) wait_z2(p, c.ch);
      __syncthreads();
      seen = c.ch;
    }
    // G = beta (Z2 - U) from each tile's sums: group g takes the tile's
    // rows g, g + G, ... and, off the diagonal, its columns alike (the
    // mirror rows), a pair and its mirror from one sum and Z2's one
    // value; each such row of 8 also its fmaf chain of G M over the 8
    // columns, Y0's partial for that column block
    const size_t rowg = (size_t)c.ch * p.NR + c.r;
    float* Gg = p.Gtab + rowg * kk;
    const float* z2 = p.Z2 + (size_t)c.ch * p.kkp;
    const float* mr = p.M + (size_t)c.ch * p.cM + (size_t)c.r * k;
    if (active) {
      const int item = tid - g * P;
      const float* ut = tf + (size_t)item * 4;  // entry e at ut[(e>>2)*4T + (e&3)]
#define UT(e) ut[((e) >> 2) * 4 * T + ((e) & 3)]
      float ma[8], mb[8];  // M at the tile's rows 8a + i and columns 8b + j
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ma[i] = 8 * a + i < k ? __ldg(mr + 8 * a + i) : 0.0f;
        mb[i] = 8 * b + i < k ? __ldg(mr + 8 * b + i) : 0.0f;
      }
      for (int rr = g; rr < 8; rr += p.G) {
        const int ci = 8 * a + rr, cm = 8 * b + rr;
        const bool row = ci < k, mir = a != b && cm < k;
        float zv[8], zw[8], gr[8], gm[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          zv[j] = row && 8 * b + j < k ? z2[ci * k + 8 * b + j] : 0.0f;
          zw[j] = mir && 8 * a + j < k ? z2[cm * k + 8 * a + j] : 0.0f;
        }
        if (row) {  // tile row rr: (ci, 8b + j)
          float mg = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float uv = a == b && j < rr ? UT(j * 8 + rr) : UT(rr * 8 + j);
            gr[j] = __fmul_rn(kBeta, __fsub_rn(zv[j], uv));
            if (8 * b + j < k) mg = __fmaf_rn(mb[j], gr[j], mg);
          }
          if (a == b) p.SQ[rowg * k + ci] = gr[rr];
          sPart[ci * nt + b] = mg;
        }
        if (mir) {  // the mirror row cm: (cm, 8a + i)
          float mg = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            gm[i] = __fmul_rn(kBeta, __fsub_rn(zw[i], UT(i * 8 + rr)));
            if (8 * a + i < k) mg = __fmaf_rn(ma[i], gm[i], mg);
          }
          sPart[cm * nt + a] = mg;
        }
        if (row) store8(Gg + ci * k + 8 * b, gr, min(8, k - 8 * b));
        if (mir) store8(Gg + cm * k + 8 * a, gm, min(8, k - 8 * a));
      }
#undef UT
    }
    __syncthreads();
    // Y0 = beta T4 - G M, the column blocks' partials added in order
    for (int i = tid; i < k; i += T) {
      float mg = sPart[i * nt];
      for (int bb = 1; bb < nt; ++bb) mg = __fadd_rn(mg, sPart[i * nt + bb]);
      p.Y0[rowg * k + i] = __fsub_rn(__fmul_rn(kBeta, t4_at(i)), mg);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// slabs_kernel: k > 172, 4 x 4 tiles in S slabs
// ---------------------------------------------------------------------
// A thread's place in slab s: its group and item (i); (a, b) of a pair
// tile, or the strip t of T4
struct Item {
  int group, i, a, b;
  bool active, pair;
};

__device__ __forceinline__ Item item_of(const Args& p, int tid, int s) {
  Item it;
  const int e = s * (int)blockDim.x + tid;
  it.group = e / p.P;
  int i = e - it.group * p.P;
  it.i = i;
  it.active = it.group < p.G;
  it.pair = i < p.npair;
  it.a = it.b = 0;
  if (it.pair) {
    int a = 0;
    while (i >= p.nt - a) {
      i -= p.nt - a;
      ++a;
    }
    it.a = a;
    it.b = a + i;
  } else {
    it.a = it.b = i - p.npair;
  }
  return it;
}

// One segment's sums of a thread's item over the n nonzeros staged at
// (sO, sW, sR) for its group, each entry an fmaf chain from zero in the
// nonzeros' order: pair tiles acc[i][j] += (w o_{4a+i}) o_{4b+j}, T4
// strips acc[0][j] += (1/d) o_{4t+j}
__device__ __forceinline__ void segment_sums(const float* sO,
                                             const float* sW,
                                             const float* sR, int KP, int n,
                                             const Item& it,
                                             float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const float* oa = sO + 4 * it.a;
  if (it.pair) {
    const float* ob = sO + 4 * it.b;
#pragma unroll 2
    for (int l = 0; l < n; ++l) {
      const float4 x = *reinterpret_cast<const float4*>(oa + l * KP);
      const float4 y = *reinterpret_cast<const float4*>(ob + l * KP);
      const float w = sW[l];
      const float wx[4] = {__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                           __fmul_rn(w, x.z), __fmul_rn(w, x.w)};
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(wx[i], yv[j], acc[i][j]);
    }
  } else {
    for (int l = 0; l < n; ++l) {
      const float4 x = *reinterpret_cast<const float4*>(oa + l * KP);
      const float r = sR[l];
      acc[0][0] = __fmaf_rn(r, x.x, acc[0][0]);
      acc[0][1] = __fmaf_rn(r, x.y, acc[0][1]);
      acc[0][2] = __fmaf_rn(r, x.z, acc[0][2]);
      acc[0][3] = __fmaf_rn(r, x.w, acc[0][3]);
    }
  }
}

// Stages n nonzeros from `start`: their partner rows' indices (a row
// segment's idx, or a Z2 chunk's partners start ..), w and 1/d (1 and
// unused for Z2), then the rows (zeros past k) by cp.async, a warp a
// row; ends after a barrier with everything in shared memory.
__device__ __forceinline__ void stage(const Args& p, float* sO, int* sIdx,
                                      float* sW, float* sR, const float* O,
                                      long long start, int n, bool zrows) {
  const int k = p.k, KP = p.KP;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const long long e = start + q;
    if (zrows) {
      sIdx[q] = (int)e;
      sW[q] = 1.0f;
    } else {
      sIdx[q] = __ldg(p.idx + e);
      const float d = __ldg(p.val + e);
      sW[q] = __fsub_rn(1.0f, __frcp_rn(__fmul_rn(d, d)));
      sR[q] = __frcp_rn(d);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < n; l += blockDim.x >> 5) {
    const float* src = O + (size_t)sIdx[l] * k;
    float* dst = sO + (size_t)l * KP;
    for (int c = lane; c < KP; c += 32)
      cp_async4(dst + c, src + (c < k ? c : 0), c < k);
  }
  cp_async_wait_all();
  __syncthreads();
}

// A segment's sums of the block's threads (one group: the slabs' plan has
// G = 1), added into tot: the segment's sums where `first`, else tot +
// them. Ends after a barrier.
__device__ __forceinline__ void block_segment(const Args& p, const float* sO,
                                              const float* sW,
                                              const float* sR, int n,
                                              const Item& it, bool first,
                                              float tot[4][4]) {
  float acc[4][4];
  const int lo = min(n, it.group * p.SUB), hi = min(n, lo + p.SUB);
  segment_sums(sO + (size_t)lo * p.KP, sW + lo, sR + lo, p.KP,
               it.active ? hi - lo : 0, it, acc);
  if (it.group == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tot[i][j] = first ? acc[i][j] : __fadd_rn(tot[i][j], acc[i][j]);
  __syncthreads();
}

// The sums of a thread's item over n nonzeros (or Z2's partners) from
// `start`, staged and summed SEG at a time, the segments' sums added in
// order into tot (zeros where n is 0). Ends after a barrier.
__device__ __forceinline__ void run_sums(const Args& p, float* sO, int* sIdx,
                                         float* sW, float* sR,
                                         const float* O, long long start,
                                         int n, bool zrows, const Item& it,
                                         float tot[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.0f;
  for (int sg = 0; sg * p.SEG < n; ++sg) {
    const int len = min(p.SEG, n - sg * p.SEG);
    stage(p, sO, sIdx, sW, sR, O, start + (long long)sg * p.SEG, len,
          zrows);
    block_segment(p, sO, sW, sR, len, it, sg == 0, tot);
  }
}

// The whole call: Z2's chunk partials, their ordered sums, the rows, each
// row's slabs in turn. Dynamic shared memory (floats): sO SEG x KP, sW, sR
// and sIdx SEG each, sT KP (beta T4).
__global__ void __launch_bounds__(1024, 1)
    slabs_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem4[];
  float* sO = reinterpret_cast<float*>(smem4);
  float* sW = sO + (size_t)p.SEG * p.KP;
  float* sR = sW + p.SEG;
  int* sIdx = reinterpret_cast<int*>(sR + p.SEG);
  float* sT = reinterpret_cast<float*>(sIdx + p.SEG);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, k = p.k, ZSEG = p.ZSEG;
  const int kk = k * k;
  float tot[4][4];

  // 1. Z2's chunk partials: items (chain, chunk of ZSEG partners)
  const long long zitems = (long long)p.nch * p.nzc;
  for (long long z = blockIdx.x; z < zitems; z += gridDim.x) {
    const int ch = (int)(z / p.nzc);
    const int q = (int)(z - (long long)ch * p.nzc);
    const int n = min(ZSEG, p.m - q * ZSEG);
    for (int s = 0; s < p.S; ++s) {
      const Item it = item_of(p, tid, s);
      run_sums(p, sO, sIdx, sW, sR, p.O + ch * p.cO, (long long)q * ZSEG, n,
               true, it, tot);
      if (it.group == 0 && it.pair) {
        float* out = p.zpart + ((size_t)ch * p.nzc + q) * (size_t)kk;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 4 * it.a + i, c2 = 4 * it.b + j;
            if (c < k && c2 < k && c <= c2) out[c * k + c2] = tot[i][j];
          }
      }
    }
  }
  grid.sync();

  // 2. Z2: each upper entry's chunk partials added in chunk order, and
  // mirrored
  {
    const long long n = (long long)p.nch * kk;
    for (long long e = (long long)blockIdx.x * blockDim.x + tid; e < n;
         e += (long long)gridDim.x * blockDim.x) {
      const int ch = (int)(e / kk), r = (int)(e - (long long)ch * kk);
      const int c = r / k, c2 = r - c * k;
      if (c > c2) continue;
      const float* part = p.zpart + (size_t)ch * p.nzc * kk + c * k + c2;
      float z = 0.0f;
      for (int q = 0; q < p.nzc; ++q)
        z = q == 0 ? part[0] : __fadd_rn(z, part[(size_t)q * kk]);
      p.Z2[(size_t)ch * kk + c * k + c2] = z;
      p.Z2[(size_t)ch * kk + c2 * k + c] = z;
    }
  }
  grid.sync();

  // 3. the rows: items (chain, row); each slab writes its entries of G
  // straight out, and Y0 reads them back after a barrier
  const long long ritems = (long long)p.nch * p.NR;
  for (long long g = blockIdx.x; g < ritems; g += gridDim.x) {
    const int ch = (int)(g / p.NR), r = (int)(g - (long long)ch * p.NR);
    const long long* ptr = p.indptr + (size_t)ch * (p.NR + 1) + r;
    const long long lo = ptr[0];
    const int n = (int)(ptr[1] - lo);
    const float* O = p.O + ch * p.cO;
    const size_t rowg = (size_t)ch * p.NR + r;
    float* Gg = p.Gtab + rowg * kk;
    for (int s = 0; s < p.S; ++s) {
      const Item it = item_of(p, tid, s);
      run_sums(p, sO, sIdx, sW, sR, O, lo, n, false, it, tot);
      if (it.group == 0) {
        if (it.pair) {
          const float* z2 = p.Z2 + (size_t)ch * kk;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 4 * it.a + i, c2 = 4 * it.b + j;
              if (c < k && c2 < k && c <= c2) {
                const float v =
                    __fmul_rn(kBeta, __fsub_rn(z2[c * k + c2], tot[i][j]));
                Gg[c * k + c2] = v;
                Gg[c2 * k + c] = v;
              }
            }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 4 * it.a + j;
            if (c < k) sT[c] = __fmul_rn(kBeta, tot[0][j]);
          }
        }
      }
    }
    __syncthreads();

    // SQ, Y0 from G as written
    const float* mr = p.M + ch * p.cM + (size_t)r * k;
    for (int c = tid; c < k; c += blockDim.x) {
      const float* gr = Gg + c * k;
      float mg = 0.0f;
      for (int c2 = 0; c2 < k; ++c2) mg = __fmaf_rn(mr[c2], gr[c2], mg);
      p.Y0[rowg * k + c] = __fsub_rn(sT[c], mg);
      p.SQ[rowg * k + c] = gr[c];
    }
    __syncthreads();  // the next row's staging overwrites sT
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------
struct Occupancy {
  int dev = -1, smem = -1, threads = -1, grid = 0, set_dev = -1,
      set_smem = -1;
};

// One cooperative launch of `kernel` on as many blocks as the card holds
// at once; the launch status read back so that a refused launch leaves
// no error behind for the next kernel on the device
int cooperative(const void* kernel, Occupancy& oc, const Args& a,
                int threads, int smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev != oc.set_dev || smem > oc.set_smem)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    oc.set_dev = dev;
    oc.set_smem = smem;
  }
  if (dev != oc.dev || smem != oc.smem || threads != oc.threads) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    oc.grid = per_sm * sms;
    oc.dev = dev;
    oc.smem = smem;
    oc.threads = threads;
  }
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(oc.grid), dim3(threads),
                                    args, (size_t)smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int K>
int launch_lanes(const Args& a, int smem, cudaStream_t s) {
  static Occupancy oc;
  if (smem != (kLaneThreads / 32) * Lane<K>::WARP * 4 || a.KP != Lane<K>::KP ||
      a.RS != Lane<K>::RS)
    return (int)cudaErrorInvalidValue;
  return cooperative((const void*)lanes_kernel<K>, oc, a, kLaneThreads, smem,
                     s);
}

int launch_lanes_k(const Args& a, int smem, cudaStream_t s) {
  switch (a.k) {
    case 1: return launch_lanes<1>(a, smem, s);
    case 2: return launch_lanes<2>(a, smem, s);
    case 3: return launch_lanes<3>(a, smem, s);
    case 4: return launch_lanes<4>(a, smem, s);
    case 5: return launch_lanes<5>(a, smem, s);
    case 6: return launch_lanes<6>(a, smem, s);
    case 7: return launch_lanes<7>(a, smem, s);
    case 8: return launch_lanes<8>(a, smem, s);
    case 9: return launch_lanes<9>(a, smem, s);
    case 10: return launch_lanes<10>(a, smem, s);
    case 11: return launch_lanes<11>(a, smem, s);
    case 12: return launch_lanes<12>(a, smem, s);
    case 13: return launch_lanes<13>(a, smem, s);
    case 14: return launch_lanes<14>(a, smem, s);
    case 15: return launch_lanes<15>(a, smem, s);
    case 16: return launch_lanes<16>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan's fields (ops/sparse_tables_cuda.sparse_plan from k alone, and
// z2_chunks from k and m), the tensors and one float32 scratch buffer of
// `scratch_floats` floats (ops/sparse_tables_cuda.scratch_floats: Z2's
// chunk partials, Z2, the padded copy of O, the counters and flags).
// form: 0 lanes, 1 tiles, 2 slabs.
extern "C" int cogaps_sparse_tables_launch(
    int form, int nch, int NR, int m, int k, int KP, int RS, int P, int G,
    int SUB, int SEG, int FL, int S, int ZSEG, int nzc, int threads,
    int smem, const long long* indptr, const int* idx, const float* val,
    const float* O, long long cO, const float* M, long long cM, float* SQ,
    float* Y0, float* G_out, float* scratch, long long scratch_floats,
    void* stream) {
  if (nch < 1 || NR < 1 || m < 0 || k < 1 || G < 1 || SUB < 1 || S < 1 ||
      ZSEG < 1 || nzc != (m + ZSEG - 1) / ZSEG || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  Args a{};  // fields a form does not read stay zero
  a.indptr = indptr;
  a.idx = idx;
  a.val = val;
  a.O = O;
  a.M = M;
  a.cO = cO;
  a.cM = cM;
  a.SQ = SQ;
  a.Y0 = Y0;
  a.Gtab = G_out;
  a.nch = nch;
  a.NR = NR;
  a.m = m;
  a.k = k;
  a.KP = KP;
  a.RS = RS;
  a.P = P;
  a.G = G;
  a.SUB = SUB;
  a.SEG = SEG;
  a.FL = FL;
  a.S = S;
  a.ZSEG = ZSEG;
  a.nzc = nzc;
  a.nO = cO ? nch : 1;
  const long long kk = (long long)k * k;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 2) {  // slabs: 4 x 4 tiles over S slabs of one group
    const int nt = KP / 4;
    if (KP != 4 * ((k + 3) / 4) || P != nt * (nt + 1) / 2 + nt || G != 1 ||
        SEG != SUB || (long long)(S - 1) * threads >= P ||
        (long long)S * threads < P || ZSEG % SEG != 0 ||
        scratch_floats < (long long)nch * (nzc + 1) * kk)
      return (int)cudaErrorInvalidValue;
    a.nt = nt;
    a.npair = nt * (nt + 1) / 2;
    a.zpart = scratch;
    a.Z2 = scratch + (size_t)nch * nzc * kk;
    a.kkp = (int)kk;
    static Occupancy oc;
    return cooperative((const void*)slabs_kernel, oc, a, threads, smem, s);
  }
  // lanes and tiles: zpart (nch, k, k, NZ4), Z2 (nch, kkp), Opad (nO, m,
  // KP) from a multiple of 4 floats, then 2 nch ints. A chain's Z2 starts
  // a 128-byte line of its own, so that its reads may go through L1
  // once its flag is out: no line of it is read before.
  if (nzc > kMaxChunks ||
      (long long)nch * nzc + (long long)nch * NR >= (1ll << 31) - 1024 * 132)
    return (int)cudaErrorInvalidValue;
  a.NZ4 = 4 * ((nzc + 3) / 4);
  a.kkp = (int)(32 * ((kk + 31) / 32));
  const long long zf = (long long)nch * kk * a.NZ4;
  const long long z2_at = (zf + 31) / 32 * 32;
  const long long opad_at = z2_at + (long long)nch * a.kkp;
  const long long sync_at = opad_at + (long long)a.nO * m * KP;
  if (scratch_floats < sync_at + 2 * nch ||
      (long long)a.nO * m * KP >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.zpart = scratch;
  a.Z2 = scratch + z2_at;
  a.Opad = scratch + opad_at;
  a.sync = reinterpret_cast<int*>(scratch + sync_at);
  if (form == 0) {
    if (k > 16 || threads != kLaneThreads || G != 1 || SEG != 32 ||
        ZSEG % 32 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_lanes_k(a, smem, s);
  }
  if (form != 1) return (int)cudaErrorInvalidValue;
  const int nt = KP / 8;
  if (KP != 8 * ((k + 7) / 8) || RS != KP + 4 || P != nt * (nt + 1) / 2 ||
      (long long)G * P > threads || SEG != G * SUB || FL < 1 ||
      ZSEG % SEG != 0 ||
      smem != 4 * (72 * threads + (kTileAhead + 1) * SEG * (RS + 2) +
                   4 * kTileAhead * SEG + KP * nt + 16))
    return (int)cudaErrorInvalidValue;
  a.nt = nt;
  if (threads == 32) {  // a warp a row: its registers need no cap below 255
    static Occupancy oc1;
    return cooperative((const void*)tiles_kernel<32, 8>, oc1, a, threads,
                       smem, s);
  }
  if (threads <= 128) {
    static Occupancy oc;
    return cooperative((const void*)tiles_kernel<128, 3>, oc, a, threads,
                       smem, s);
  }
  if (threads > 256) return (int)cudaErrorInvalidValue;
  static Occupancy oc2;
  return cooperative((const void*)tiles_kernel<256, 1>, oc2, a, threads,
                     smem, s);
}
