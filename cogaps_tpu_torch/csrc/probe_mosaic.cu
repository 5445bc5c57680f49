// The Mosaic probes' functions as kernels for Hopper (sm_90a).
//
// Replaces the pallas_call sites of tools/probe_mosaic.py (:51 k_batched,
// :72 k_unroll, :92 k_one, :116 k_while, :131 k_red, :145 k_min, :163
// k_prng, :187 k_elem, :213 k_match), tools/probe_mosaic2.py (:33 the
// bdot/tri/match/elem/ohmin cases, :197 the array-carry while loop, :214
// the PRNG retest), tools/probe_mosaic3.py (:33 k1-k3, :85 the marginal
// cases), tools/probe_mosaic4.py (:35) and the match-count kernel of
// tools/probe_mosaic5.py (:27 k_match). Those kernels measured what
// Mosaic makes of a few primitives on the TPU; each function here is one
// such primitive, with its plain PyTorch version and wrapper in
// cogaps_tpu_torch/probes/mosaic.py. Not carried over: the fori_loop
// repetitions and R1/R2 slopes (CUDA events time a launch directly), the
// identity-matmul transposes and the (B, B) / (NR, B) one-hot tensors
// the TPU needed for a compare or a min.
//
//   F1 bdot        out[c,i,b] = sum_t a[c,t,i] b[c,t,b] in float32, every
//                  product an FMA (fmaf: full float32 on the FMA units; TF32
//                  would keep ~3 digits). Two regimes, chosen with every
//                  tile size, T split and grid by probes/mosaic.bdot_plan:
//                  * bytes (K <= 16): 4(T K + T B + K B) bytes a chain
//                    against 2 T K B operations, at most 8 operations a
//                    byte, so reading a and b once, at the memory's rate,
//                    bounds it. A block of 256 covers all K rows and a
//                    strip of 8 column units (a unit 4 columns where B % 4
//                    == 0, read 16 bytes a thread, else 1); its 32 t rows
//                    keep K sums a column, each thread eight b rows in
//                    flight, a warp four 128-byte rows at a time, and
//                    read a's T chunk, one contiguous range, from shared
//                    memory (cp.async, double-buffered). T is split so
//                    that NCH x strips x splits fills the SMs, up to two
//                    blocks each; the t rows' sums meet by shuffles and
//                    in shared memory in a fixed order.
//                  * operations (K > 16): ~K/2 operations a byte, above
//                    the card's 20. A register-tiled product: a (64 or 32)
//                    square tile of (K, B) a block, a 4 x 4 tile a thread,
//                    32-t chunks of a and b (contiguous rows) staged by
//                    cp.async, two or four chunks in flight, each t's
//                    fragments two 16-byte shared loads for 16 FMAs, loaded
//                    while the previous t's products run. The
//                    32-square tiles that fill the SMs where NCH x 64-tiles
//                    is under a wave split each chunk's t among four
//                    thread groups, and T splits fill the rest.
//                  Where T is split, each split's (K, B) partial goes to
//                  scratch and bdot_reduce_kernel adds the splits in
//                  order: no float atomics, so calls repeat bit for bit.
//                  That second pass is launched as a programmatic
//                  dependent of the first (cudaLaunchKernelEx), so its
//                  launch overlaps the first pass instead of following it.
//   F2 prefix      inclusive prefix sum along lanes: one block a chain,
//                  warp shuffles and one shared array of warp totals, as
//                  sweep_common.cuh::block_scan (in float32). Bytes.
//   F3 first_wins  the count of earlier lanes of the chain holding the same
//                  value. B(B-1)/2 compares a chain would bound it by
//                  operations at B = 1024, and a thread a lane comparing
//                  with every earlier lane makes the last lane's 1,023
//                  dependent compares the kernel's time. So nothing is
//                  compared pairwise: one block a chain, a warp's equal
//                  lanes grouped by __match_any_sync, each group counted
//                  into its key's slot of a hash table in shared memory, a
//                  byte a warp; a lane's count is the lanes of its group
//                  below it plus the slot's bytes of the earlier warps.
//                  O(1) steps a lane (probing aside) at any B.
//   F4 claim_min   row form: claim[c,row] = the least lane holding row
//                  (else B), as K1 claims rows (sweep_common.cuh::
//                  sweep_chain). The rows of a chain are split over up
//                  to four blocks (probes/mosaic.claim_plan); a block
//                  sets its rows' claims to B in shared memory, scans its
//                  chain's B lanes (its first four a thread loaded before
//                  the table is set), takes a shared-memory atomicMin of
//                  the lane id for each lane whose row is in its range,
//                  and writes its rows out once, coalesced (one block a
//                  chain with the table in device memory sent every
//                  claim to L2; PERF.md section 6 times both designs). Lane form: hit[c,lane] = lane if the lane's
//                  value is a row in [0, NR) (else B), the closed form of
//                  the TPU's min over an (NR, B) one-hot. Bytes.
//   F5 elem_chain  n times x = x * 1.0001 + 0.001, a thread an element.
//   F6 while_sum   a loop whose trip count is read from device memory: the
//                  "count" form adds sum(x) while i < x[0,0]; the "until"
//                  form adds x while sum(a) < 100, a += 1. One block; the
//                  sums are block reductions in a fixed order.
//   F7 reduce3d    sum over the middle axis of x*x (float64 products and
//                  sums rounded once, the plain version's rule) and min
//                  over the minor axis (a warp an output). Bytes. The sum
//                  splits the middle axis over a block's row groups, four
//                  16-byte loads in flight a thread, the groups' float64
//                  partials added in a fixed order (shuffles, then the
//                  warps in order): not one thread an output walking M
//                  dependent loads and adds.
//   F8 uniform     word 0 of Philox4x32-10 (sweep_common.cuh::philox) of
//                  the counter (lane, row, 0, 0) under the key (seed, 0),
//                  mapped to [0, 1) as ((w >> 9) | 0x3F800000) - 1, the
//                  probe's mapping. ~103 integer operations a value, so
//                  operations bound it.
//
// Every kernel but F1's is small: its launch, not its bound, sets its time
// at the probes' shapes. Compiled with -fmad=false like the other sources,
// so F5 and F8 are bit-equal to their plain versions; F1 asks for its FMAs
// by name.

#include "sweep_common.cuh"

namespace {

// ---- F1: cp.async, 4 or 16 bytes; a copy that is not `ok` writes zeros
// (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float get(float v, int) { return v; }
};
template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ float get(float4 v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};

// probes/mosaic.py mirrors these (SKINNY_K, SKINNY_THREADS, SKINNY_TX,
// SKINNY_CHUNK) and bdot_tile_kernel's shapes (TILES)
constexpr int kSkinnyK = 16;         // the bytes regime's largest K
constexpr int kSkinnyThreads = 256;  // a block
constexpr int kSkinnyTX = 8;         // its column units; 32 t rows
constexpr int kSkinnyChunk = 256;    // t of a staged at a time
constexpr int kBatch = 8;            // loads a thread keeps in flight

// Programmatic dependent launch: a grid launched after this one with
// cudaLaunchAttributeProgrammaticStreamSerialization may start as soon as
// every block of this one has passed here, and waits for this one's
// results at grid_dependency_wait. The launch overlaps this kernel.
__device__ __forceinline__ void dependents_may_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// This block's chain c and T split p of gridDim.z = nch * splits, and the
// split's t range [t_lo, t_lo + n) with t_lo = T p / splits (the plan's).
// Nothing is divided with one split, and in 32 bits where T splits fits:
// the first loads wait on this, and at the launch floor a division on
// the way to them shows in the time.
struct Split {
  int nch, c, p, n;
  long long t_lo;
};

__device__ __forceinline__ Split split_of(int T, int splits) {
  if (splits == 1) return {(int)gridDim.z, (int)blockIdx.z, 0, T, 0};
  const int c = blockIdx.z / splits, p = blockIdx.z - c * splits;
  const int nch = gridDim.z / splits;
  if ((long long)T * splits <= 0x7fffffffLL) {
    const int lo = T * p / splits;
    return {nch, c, p, T * (p + 1) / splits - lo, lo};
  }
  const long long lo = (long long)T * p / splits;
  return {nch, c, p, (int)((long long)T * (p + 1) / splits - lo), lo};
}

// every group but the n newest has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The bytes regime. Block (strip, 0, chain * splits + split) of
// kSkinnyThreads: thread tid is column unit u = strip * kSkinnyTX + tid %
// kSkinnyTX (V columns) and t row ty = tid / kSkinnyTX, summing the t of
// its split with t % 32 == ty in each chunk; a warp reads four t
// rows of 128 bytes of b at a time. dst is out (one split) or the
// (splits, NCH, K, B) scratch.
template <int K, int V>
__global__ void __launch_bounds__(kSkinnyThreads, 2)
    bdot_skinny_kernel(int T, int B, int splits, const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ dst) {
  using VT = typename Vec<V>::type;
  constexpr int kTY = kSkinnyThreads / kSkinnyTX, kCols = kSkinnyTX * V;
  constexpr int kWarps = kSkinnyThreads / 32;
  __shared__ __align__(16) float a_s[2][kSkinnyChunk * K];
  __shared__ float red[kWarps][K][kCols];
  if (splits > 1) dependents_may_launch();  // the second pass may start
  const int tid = threadIdx.x, tx = tid % kSkinnyTX, ty = tid / kSkinnyTX;
  const Split sp = split_of(T, splits);
  const int nch = sp.nch, c = sp.c, p = sp.p;
  const int u = blockIdx.x * kSkinnyTX + tx;
  const bool active = u < B / V;
  const long long t_lo = sp.t_lo;
  const int n = sp.n;
  const float* ac = a + ((size_t)c * T + t_lo) * K;
  const int row_v = B / V;  // b's row in VT
  const VT* bc = reinterpret_cast<const VT*>(b + ((size_t)c * T + t_lo) * B) +
                 (active ? u : 0);
  float acc[K][V];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;

  const int n_chunks = (n + kSkinnyChunk - 1) / kSkinnyChunk;
  auto stage = [&](int ch) {
    const int t0 = ch * kSkinnyChunk;
    const int m = min(kSkinnyChunk, n - t0) * K;
    const float* src = ac + (size_t)t0 * K;
    float* d = a_s[ch & 1];
    for (int q = tid; q < m; q += kSkinnyThreads)
      cp_async4(d + q, src + q, true);
  };
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) stage(ch + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch is in a_s[ch & 1] for every thread
    const float* as = a_s[ch & 1];
    const int t0 = ch * kSkinnyChunk;
    const int m = min(kSkinnyChunk, n - t0);
    for (int tt = ty; tt < m; tt += kBatch * kTY) {
      VT bv[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int t2 = tt + q * kTY;
        bv[q] = active && t2 < m ? __ldg(bc + (size_t)(t0 + t2) * row_v)
                                 : Vec<V>::zero();
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int t2 = tt + q * kTY;
        if (t2 < m) {
          const float* ar = as + t2 * K;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const float av = ar[i];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[i][v] = fmaf(av, Vec<V>::get(bv[q], v), acc[i][v]);
          }
        }
      }
    }
    __syncthreads();  // a_s[ch & 1] is staged again at ch + 2
  }

  // each column's kTY sums in a fixed order: the warp's four t rows by
  // shuffles, then the warps' sums in warp order
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float x = acc[i][v];
      x = x + __shfl_xor_sync(0xffffffffu, x, kSkinnyTX);
      x = x + __shfl_xor_sync(0xffffffffu, x, 2 * kSkinnyTX);
      acc[i][v] = x;
    }
  const int w = tid / 32;
  if (tid % 32 < kSkinnyTX)
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) red[w][i][tx * V + v] = acc[i][v];
  __syncthreads();
  float* out = dst + ((size_t)p * nch + c) * K * B;
  const int j0 = blockIdx.x * kCols;
  for (int q = tid; q < K * kCols; q += kSkinnyThreads) {
    const int i = q / kCols, col = q % kCols;
    float s = 0.0f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) s = s + red[x][i][col];
    if (j0 + col < B) out[(size_t)i * B + j0 + col] = s;
  }
}

// The operations regime. Block (column tile, row tile, chain * splits +
// split) covers BM x BM of (K, B) with KG groups of (BM / 4)^2 threads,
// each thread a 4 x 4 tile: rows i0 + 4 ty + r, columns j0 + 4 tx + v,
// over the t of each chunk with t % KG == its group (KG > 1
// gives a small tile the warps to hide its shared loads' latency; the
// groups' sums meet in shared memory in group order). kStages chunks of
// TT t are in flight at once (cp.async), so a chunk's wait overlaps the
// products of the ones before it. kVec: K and B multiples of 4 and a, b
// 16-byte aligned, so each staged piece is a whole float4.
template <int BM, int KG, int TT, int kStages, bool kVec>
__global__ void __launch_bounds__(BM * BM / 16 * KG)
    bdot_tile_kernel(int T, int K, int B, int splits,
                     const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ dst) {
  constexpr int BN = BM, TM = 4, TN = 4;
  constexpr int kCols = BN / TN, kGroup = BM / TM * kCols;
  constexpr int kThreads = kGroup * KG;
  constexpr int kStaged = kStages * TT * (BM + BN);  // floats
  static_assert(KG == 1 || KG * BM * BN <= kStaged, "sums fit the stages");
  __shared__ __align__(16) float smem[kStaged];
  float(*As)[TT][BM] = reinterpret_cast<float(*)[TT][BM]>(smem);
  float(*Bs)[TT][BN] =
      reinterpret_cast<float(*)[TT][BN]>(smem + kStages * TT * BM);
  if (splits > 1) dependents_may_launch();  // the second pass may start
  const int tid = threadIdx.x, g = tid / kGroup;
  const int tx = tid % kGroup % kCols, ty = tid % kGroup / kCols;
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM;
  const Split sp = split_of(T, splits);
  const int nch = sp.nch, c = sp.c, p = sp.p;
  const long long t_lo = sp.t_lo;
  const int n = sp.n;
  const float* ac = a + ((size_t)c * T + t_lo) * K;
  const float* bc = b + ((size_t)c * T + t_lo) * B;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[r][v] = 0.0f;

  const int n_chunks = (n + TT - 1) / TT;
  constexpr int kW = kVec ? 4 : 1;  // floats a copy
  // rows t0 .. t0 + TT of src's columns x0 .. x0 + W into dst, zeros
  // past n, past `lim` columns
  auto copy = [&](float* dst, const float* src, int ld, int x0, int lim,
                  int t0, int W) {
    for (int q = tid; q < TT * W / kW; q += kThreads) {
      const int tt = q / (W / kW), x = q % (W / kW) * kW;
      const bool ok = t0 + tt < n && x0 + x < lim;
      const float* sp = ok ? src + (size_t)(t0 + tt) * ld + x0 + x : src;
      if (kVec)
        cp_async16(dst + tt * W + x, sp, ok);
      else
        cp_async4(dst + tt * W + x, sp, ok);
    }
  };
  auto stage = [&](int ch) {  // one commit group, empty past the end
    if (ch < n_chunks) {
      const int buf = ch % kStages;
      copy(&As[buf][0][0], ac, K, i0, K, ch * TT, BM);
      copy(&Bs[buf][0][0], bc, B, j0, B, ch * TT, BN);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) stage(ch);
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    // chunk ch is staged for every thread, and every thread is done with
    // chunk ch - 1, whose buffer the next stage takes
    __syncthreads();
    stage(ch + kStages - 1);
    const int buf = ch % kStages;
    // the group's t: tt = g + k KG; the fragments of the next t are
    // loaded while this one's products run
    float ar[2][TM], br[2][TN];
    auto fragments = [&](int tt, int f) {
#pragma unroll
      for (int q = 0; q < TM; q += 4)
        *reinterpret_cast<float4*>(&ar[f][q]) =
            *reinterpret_cast<const float4*>(&As[buf][tt][TM * ty + q]);
#pragma unroll
      for (int q = 0; q < TN; q += 4)
        *reinterpret_cast<float4*>(&br[f][q]) =
            *reinterpret_cast<const float4*>(&Bs[buf][tt][TN * tx + q]);
    };
    fragments(g, 0);
#pragma unroll
    for (int k = 0; k < TT / KG; ++k) {
      if (k + 1 < TT / KG) fragments(g + (k + 1) * KG, (k + 1) & 1);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int v = 0; v < TN; ++v)
          acc[r][v] = fmaf(ar[k & 1][r], br[k & 1][v], acc[r][v]);
    }
  }

  float* out = dst + ((size_t)p * nch + c) * K * B;
  if constexpr (KG > 1) {
    float(*red)[BM * BN] = reinterpret_cast<float(*)[BM * BN]>(smem);
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the stages
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        red[g][(TM * ty + r) * BN + TN * tx + v] = acc[r][v];
    __syncthreads();
    for (int q = tid; q < BM * BN; q += kThreads) {
      const int i = i0 + q / BN, j = j0 + q % BN;
      float s = 0.0f;
#pragma unroll
      for (int x = 0; x < KG; ++x) s = s + red[x][q];
      if (i < K && j < B) out[(size_t)i * B + j] = s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = i0 + TM * ty + r;
      if (i < K) {
#pragma unroll
        for (int q = 0; q < TN; q += 4) {
          const int j = j0 + TN * tx + q;
          float* o = out + (size_t)i * B + j;
          if (kVec) {
            if (j < B)
              *reinterpret_cast<float4*>(o) = make_float4(
                  acc[r][q], acc[r][q + 1], acc[r][q + 2], acc[r][q + 3]);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (j + v < B) o[v] = acc[r][q + v];
          }
        }
      }
    }
  }
}

// The second pass: out[e] = the sum of part[s, e] over s = 0, 1, .. in
// that order, for the n values of an (NCH, K, B) output in V-wide pieces
template <int V>
__global__ void bdot_reduce_kernel(long long n_pieces, int splits,
                                   const float* __restrict__ part,
                                   float* __restrict__ out) {
  using VT = typename Vec<V>::type;
  grid_dependency_wait();  // the first pass's partial sums are written
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_pieces) return;
  const VT* pv = reinterpret_cast<const VT*>(part) + e;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.0f;
  for (int q0 = 0; q0 < splits; q0 += kBatch) {
    VT x[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      x[q] = q0 + q < splits ? __ldg(pv + (size_t)(q0 + q) * n_pieces)
                             : Vec<V>::zero();
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q0 + q < splits)
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = s[v] + Vec<V>::get(x[q], v);
  }
  VT* o = reinterpret_cast<VT*>(out) + e;
  if constexpr (V == 4)
    *o = make_float4(s[0], s[1], s[2], s[3]);
  else
    *o = s[0];
}

__global__ void prefix_kernel(int B, const float* __restrict__ x,
                              float* __restrict__ out) {
  __shared__ float warp_sums[32];
  const int c = blockIdx.x, l = threadIdx.x;
  const int wl = l & 31, wid = l >> 5, nw = blockDim.x >> 5;
  float v = l < B ? x[(size_t)c * B + l] : 0.0f;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, o);
    if (wl >= o) v = v + y;
  }
  if (wl == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float s = wl < nw ? warp_sums[wl] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, s, o);
      if (wl >= o) s = s + y;
    }
    if (wl < nw) warp_sums[wl] = s;
  }
  __syncthreads();
  if (wid > 0) v = v + warp_sums[wid - 1];
  if (l < B) out[(size_t)c * B + l] = v;
}

// ---- F3: a lane's value as a key whose bits are equal exactly where the
// floats compare equal: -0 as +0, and a NaN (equal to nothing) as a NaN
// pattern of its own lane, which no other key takes
constexpr unsigned kNoKey = 0xffffffffu;  // a NaN pattern no key takes
constexpr int kMinLogSlots = 6;

__device__ __forceinline__ unsigned match_key(float v, int j) {
  if (v != v) return 0x7fc00000u | (unsigned)j;
  return v == 0.0f ? 0u : __float_as_uint(v);
}

__device__ __forceinline__ unsigned mix(unsigned k) {  // murmur3's finaliser
  k ^= k >> 16;
  k *= 0x85ebca6bu;
  k ^= k >> 13;
  k *= 0xc2b2ae35u;
  return k ^ (k >> 16);
}

// One block a chain, a thread a lane. The warp's lanes of one key find
// each other with __match_any_sync; its first lane claims the key's slot
// of an open-addressing table in shared memory (2^log_slots >= 4B slots,
// linear probing) and, after a barrier, writes the group's size into the
// slot's byte for its warp (the slot's claimer zeroed its 32 bytes before
// the barrier: only the key table is set up front). After a second
// barrier a lane's count is the lanes of its group below it plus the
// slot's bytes of the earlier warps: two 16-byte reads and eight byte sums,
// whatever B. The table and its bytes are dynamic shared memory, 4 + 32
// bytes a slot. Above a launch, its time is the grouping (__match_any_sync
// in all 32 warps of one SM) and the inserts, more with more distinct
// keys; spreading a chain's warps over 2-8 blocks (each then inserts the
// earlier lanes' keys too), grouping by 32 ballots, or reading a slot
// before its compare-and-swap were each slower on the H100 (PERF.md §6).
__global__ void first_wins_kernel(int B, int log_slots,
                                  const float* __restrict__ r,
                                  int* __restrict__ count) {
  extern __shared__ uint4 fw_smem[];
  const int slots = 1 << log_slots;
  uint4* bytes = fw_smem;                             // (slots, 2): a byte a warp
  unsigned* keys = (unsigned*)(fw_smem + 2 * slots);  // (slots)
  const int c = blockIdx.x, j = threadIdx.x, w = j >> 5, lane = j & 31;
  const bool in = j < B;
  const float v = in ? r[(size_t)c * B + j] : 0.0f;
  for (int s = j; s < slots; s += blockDim.x) keys[s] = kNoKey;
  __syncthreads();
  const unsigned act = __ballot_sync(0xffffffffu, in);
  unsigned group = 0u, slot = 0u;
  int first = 0;
  if (in) {
    const unsigned key = match_key(v, j);
    group = __match_any_sync(act, key);
    first = __ffs(group) - 1;
    if (lane == first) {
      unsigned s = mix(key) >> (32 - log_slots), old;
      while ((old = atomicCAS(&keys[s], kNoKey, key)) != kNoKey && old != key)
        s = (s + 1u) & (unsigned)(slots - 1);
      slot = s;
      if (old == kNoKey)  // this lane claimed the slot
        bytes[2 * s] = bytes[2 * s + 1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();  // every claimed slot's bytes are zero
  if (in) {
    if (lane == first)
      reinterpret_cast<unsigned char*>(bytes)[32 * slot + w] =
          (unsigned char)__popc(group);
    slot = __shfl_sync(act, slot, first);
  }
  __syncthreads();
  if (!in) return;
  int n = __popc(group & ((1u << lane) - 1u));
  const uint4 lo = bytes[2 * slot], hi = bytes[2 * slot + 1];
  const unsigned word[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // the bytes of warps 4q .. 4q+3 below w
    const int b = min(max(w - 4 * q, 0), 4);
    const unsigned keep = b == 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
    n += (int)__dp4a(word[q] & keep, 0x01010101u, 0u);
  }
  count[(size_t)c * B + j] = n;
}

// 2^log_slots slots, at least four times the lanes: at B = 1024 mostly
// distinct keys probe measurably longer in a table of twice the lanes
inline int first_wins_log_slots(int B) {
  int log_slots = kMinLogSlots;
  while ((1 << log_slots) < 4 * B) ++log_slots;
  return log_slots;
}

inline size_t first_wins_smem(int log_slots) {
  return (size_t)(1 << log_slots) * (2 * sizeof(uint4) + sizeof(unsigned));
}

// v is a row of [0, NR): integer-valued and in range
__device__ __forceinline__ bool is_row(float v, int NR) {
  return v >= 0.0f && v < (float)NR && v == floorf(v);
}

// row form: blockIdx.x takes rows [x rows, (x + 1) rows) of chain
// blockIdx.y; a thread's first kClaimLanes lanes are loaded before the
// table is set, so their latency overlaps it
constexpr int kClaimLanes = 4;

__global__ void __launch_bounds__(cogaps::kMaxB)
    claim_rows_kernel(int B, int NR, int rows, const float* __restrict__ r,
                      int* __restrict__ out) {
  extern __shared__ int claim[];
  const int c = blockIdx.y, lo = blockIdx.x * rows;
  const int n = min(rows, NR - lo);
  const float* rc = r + (size_t)c * B;
  float v[kClaimLanes];
#pragma unroll
  for (int j = 0; j < kClaimLanes; ++j) {
    const int l = threadIdx.x + j * blockDim.x;
    v[j] = l < B ? rc[l] : -1.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) claim[i] = B;
  __syncthreads();  // the table is set before any claim
  auto take = [&](float x, int l) {
    if (is_row(x, NR)) {
      const int row = (int)x - lo;
      if (row >= 0 && row < n) atomicMin(&claim[row], l);
    }
  };
#pragma unroll
  for (int j = 0; j < kClaimLanes; ++j)
    take(v[j], threadIdx.x + j * blockDim.x);
  for (int l = threadIdx.x + kClaimLanes * blockDim.x; l < B;
       l += blockDim.x)
    take(rc[l], l);
  __syncthreads();
  int* oc = out + (size_t)c * NR + lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) oc[i] = claim[i];
}

// lane form
__global__ void claim_lanes_kernel(int B, int NR,
                                   const float* __restrict__ r,
                                   int* __restrict__ out) {
  const int c = blockIdx.x;
  const float* rc = r + (size_t)c * B;
  for (int l = threadIdx.x; l < B; l += blockDim.x)
    out[(size_t)c * B + l] = is_row(rc[l], NR) ? l : B;
}

__global__ void elem_chain_kernel(int n, int n_ops,
                                  const float* __restrict__ x,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int s = 0; s < n_ops; ++s) v = v * 1.0001f + 0.001f;
  out[i] = v;
}

// the block's sum of v, the same value in every thread, added in warp
// order; every thread of the block must call it
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = blockDim.x >> 5;
  __syncthreads();  // the last call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < nw; ++w) t = t + red[w];
  return t;
}

__global__ void while_sum_kernel(int form, int n, const float* __restrict__ x,
                                 float* __restrict__ out) {
  __shared__ float red[32];
  const int l = threadIdx.x;
  const float xv = l < n ? x[l] : 0.0f;
  if (form == 0) {
    const float s = block_sum(xv, red);
    if (l == 0) {
      const float trip = x[0];
      float i = 0.0f, acc = 0.0f;
      while (i < trip) {
        i = i + 1.0f;
        acc = acc + s;
      }
      out[0] = acc;
    }
  } else {
    float a = 0.0f, acc = 0.0f;
    while (block_sum(l < n ? a : 0.0f, red) < 100.0f) {
      a = a + 1.0f;
      acc = acc + xv;
    }
    if (l < n) out[l] = acc;
  }
}

// ---- F7 "sum". Block (strip, chain) of kReduceThreads: thread t is column
// unit tx = t % TX (V columns, read 16 bytes at a time where V = 4) of the
// strip and row group ty = t / TX, summing the rows ty, ty + TY, ... in
// float64, kReduceRows loads in flight. A warp's row groups meet by
// shuffles, the block's warps in shared memory in warp order: a fixed order,
// so calls repeat bit for bit. Narrow strips (16 columns where V = 4) give
// more blocks and fewer rows a thread: of the strip widths, depths and
// block sizes tried on the H100, the quickest at the probes' shape and at
// larger ones.
constexpr int kReduceThreads = 256;
constexpr int kReduceRows = 2;
template <int V>
constexpr int kReduceTX = V == 4 ? 4 : 32;

template <int V>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_sum_kernel(int M, int L, const float* __restrict__ x,
                      float* __restrict__ out) {
  constexpr int TX = kReduceTX<V>;
  constexpr int TY = kReduceThreads / TX, NW = kReduceThreads / 32;
  using T = typename Vec<V>::type;
  __shared__ double warp_sums[NW][TX * V];
  const int c = blockIdx.y, tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int col = (blockIdx.x * TX + tx) * V;
  const bool in = col < L;
  const float* xc = x + (size_t)c * M * L + (in ? col : 0);
  double s[V];
#pragma unroll
  for (int q = 0; q < V; ++q) s[q] = 0.0;
  for (int i0 = ty; i0 < M; i0 += kReduceRows * TY) {
    T v[kReduceRows];
#pragma unroll
    for (int u = 0; u < kReduceRows; ++u) {  // the loads first
      const int i = i0 + u * TY;
      v[u] = in && i < M ? __ldg(reinterpret_cast<const T*>(
                               xc + (size_t)i * L))
                         : Vec<V>::zero();
    }
#pragma unroll
    for (int u = 0; u < kReduceRows; ++u)
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const double d = Vec<V>::get(v[u], q);
        s[q] = s[q] + d * d;
      }
  }
#pragma unroll
  for (int off = TX; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < V; ++q)
      s[q] = s[q] + __shfl_xor_sync(0xffffffffu, s[q], off);
  if ((threadIdx.x & 31) < TX)
#pragma unroll
    for (int q = 0; q < V; ++q) warp_sums[threadIdx.x >> 5][tx * V + q] = s[q];
  __syncthreads();
  const int e = threadIdx.x, j = blockIdx.x * TX * V + e;
  if (e < TX * V && j < L) {
    double t = warp_sums[0][e];
    for (int wp = 1; wp < NW; ++wp) t = t + warp_sums[wp][e];
    out[(size_t)c * L + j] = (float)t;
  }
}

__global__ void empty_kernel() {}

__global__ void reduce_min_kernel(int rows, int L, const float* __restrict__ x,
                                  float* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * L;
  float m = __int_as_float(0x7f800000);  // +inf
  for (int j = lane; j < L; j += 32) m = fminf(m, xr[j]);
  for (int o = 16; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) out[row] = m;
}

__global__ void uniform_kernel(int rows, int lanes,
                               const int* __restrict__ seed,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * lanes) return;
  const uint32_t row = i / lanes, lane = i % lanes;
  const uint4 w = cogaps::philox(make_uint4(lane, row, 0u, 0u),
                                 (uint32_t)seed[0], 0u);
  out[i] = __uint_as_float((w.x >> 9) | 0x3F800000u) - 1.0f;
}

inline int launched() { return (int)cudaGetLastError(); }

constexpr int kBad = (int)cudaErrorInvalidValue;
constexpr int kClaimRows = 12288;  // probes/mosaic.CLAIM_ROWS: 48 KB

template <int K>
cudaError_t skinny_launch(dim3 grid, cudaStream_t s, int vec, int T, int B,
                          int splits, const float* a, const float* b,
                          float* dst) {
  if (vec)
    bdot_skinny_kernel<K, 4><<<grid, kSkinnyThreads, 0, s>>>(T, B, splits, a,
                                                              b, dst);
  else
    bdot_skinny_kernel<K, 1><<<grid, kSkinnyThreads, 0, s>>>(T, B, splits, a,
                                                              b, dst);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// F1 by the plan probes/mosaic.bdot_plan gives: regime 0 (bytes) or 1
// (operations), the rows and columns a block covers, 16-byte loads or
// not, and the T splits (their partial sums in `part`, (splits, nch, K, B),
// then added in order into `out` by a second launch).
extern "C" int probe_bdot(int nch, int T, int K, int B, int regime,
                          int tile_k, int tile_b, int vec, int splits,
                          const float* a, const float* b, float* part,
                          float* out, void* stream) {
  if (nch < 1 || T < 1 || K < 1 || B < 1 || splits < 1 || splits > T ||
      (long long)nch * splits > 65535 || (splits > 1 && part == nullptr))
    return kBad;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = splits > 1 ? part : out;
  const int V = vec ? 4 : 1;
  if (vec && (B % 4 || !aligned16(b) || !aligned16(dst) || !aligned16(out)))
    return kBad;
  cudaError_t err;
  if (regime == 0) {
    if (K > kSkinnyK || tile_k != K || tile_b != kSkinnyTX * V) return kBad;
    const dim3 grid((B + tile_b - 1) / tile_b, 1, nch * splits);
    switch (K) {
#define F1_SKINNY(k)                                                       \
  case k:                                                                  \
    err = skinny_launch<k>(grid, s, vec, T, B, splits, a, b, dst);        \
    break;
      F1_SKINNY(1) F1_SKINNY(2) F1_SKINNY(3) F1_SKINNY(4) F1_SKINNY(5)
      F1_SKINNY(6) F1_SKINNY(7) F1_SKINNY(8) F1_SKINNY(9) F1_SKINNY(10)
      F1_SKINNY(11) F1_SKINNY(12) F1_SKINNY(13) F1_SKINNY(14) F1_SKINNY(15)
      F1_SKINNY(16)
#undef F1_SKINNY
      default:
        return kBad;
    }
  } else if (regime == 1) {
    if (tile_k != tile_b || (vec && (K % 4 || !aligned16(a))))
      return kBad;
    const dim3 grid((B + tile_b - 1) / tile_b, (K + tile_k - 1) / tile_k,
                    nch * splits);
    // the shapes of probes/mosaic.py's TILES
    if (tile_k == 64 && vec)
      bdot_tile_kernel<64, 1, 32, 2, true><<<grid, 256, 0, s>>>(
          T, K, B, splits, a, b, dst);
    else if (tile_k == 64)
      bdot_tile_kernel<64, 1, 32, 2, false><<<grid, 256, 0, s>>>(
          T, K, B, splits, a, b, dst);
    else if (tile_k == 32 && vec)
      bdot_tile_kernel<32, 4, 32, 4, true><<<grid, 256, 0, s>>>(
          T, K, B, splits, a, b, dst);
    else if (tile_k == 32)
      bdot_tile_kernel<32, 4, 32, 4, false><<<grid, 256, 0, s>>>(
          T, K, B, splits, a, b, dst);
    else
      return kBad;
    err = cudaGetLastError();
  } else {
    return kBad;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  // the second pass, launched while the first runs (dependents_may_launch)
  const long long pieces = (long long)nch * K * B / V;  // V = 4 divides B
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((pieces + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)(vec ? cudaLaunchKernelEx(&cfg, bdot_reduce_kernel<4>, pieces,
                                        splits, (const float*)part, out)
                   : cudaLaunchKernelEx(&cfg, bdot_reduce_kernel<1>, pieces,
                                        splits, (const float*)part, out));
}

extern "C" int probe_prefix(int nch, int B, const float* x, float* out,
                            void* stream) {
  if (nch < 1 || B < 1 || B > cogaps::kMaxB) return kBad;
  prefix_kernel<<<nch, (B + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(B, x,
                                                                      out);
  return launched();
}

extern "C" int probe_first_wins(int nch, int B, const float* r, int* count,
                                void* stream) {
  if (nch < 1 || B < 1 || B > cogaps::kMaxB) return kBad;
  const int log_slots = first_wins_log_slots(B);
  const size_t smem = first_wins_smem(log_slots);
  if (smem > 48 * 1024) {  // above the default: asked for by name
    const cudaError_t err = cudaFuncSetAttribute(
        first_wins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  first_wins_kernel<<<nch, (B + 31) / 32 * 32, smem,
                      (cudaStream_t)stream>>>(B, log_slots, r, count);
  return launched();
}

// rows, threads: the row form's rows and threads a block
// (probes/mosaic.claim_plan), at most kClaimRows and kMaxB
extern "C" int probe_claim_min(int form, int nch, int B, int NR, int rows,
                               int threads, const float* r, int* out,
                               void* stream) {
  if (nch < 1 || nch > 65535 || B < 1 || NR < 1 || (form != 0 && form != 1))
    return kBad;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    const int lanes = B < cogaps::kMaxB ? (B + 31) / 32 * 32 : cogaps::kMaxB;
    claim_lanes_kernel<<<nch, lanes, 0, s>>>(B, NR, r, out);
    return launched();
  }
  if (rows < 1 || rows > kClaimRows || threads < 32 || threads % 32 ||
      threads > cogaps::kMaxB)
    return kBad;
  const dim3 grid((NR + rows - 1) / rows, nch);
  claim_rows_kernel<<<grid, threads, rows * sizeof(int), s>>>(B, NR, rows, r,
                                                             out);
  return launched();
}

extern "C" int probe_elem_chain(int n, int n_ops, const float* x, float* out,
                                void* stream) {
  if (n < 1 || n_ops < 0) return kBad;
  elem_chain_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, n_ops, x, out);
  return launched();
}

extern "C" int probe_while_sum(int form, int n, const float* x, float* out,
                               void* stream) {
  if (n < 1 || n > cogaps::kMaxB || (form != 0 && form != 1)) return kBad;
  while_sum_kernel<<<1, (n + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(form, n,
                                                                       x, out);
  return launched();
}

extern "C" int probe_reduce3d(int form, int nch, int M, int L, const float* x,
                              float* out, void* stream) {
  if (nch < 1 || nch > 65535 || M < 1 || L < 1) return kBad;
  if (form == 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (L % 4 == 0 && aligned16(x)) {
      const int cols = kReduceTX<4> * 4;
      reduce_sum_kernel<4><<<dim3((L + cols - 1) / cols, nch),
                             kReduceThreads, 0, s>>>(M, L, x, out);
    } else {
      const int cols = kReduceTX<1>;
      reduce_sum_kernel<1><<<dim3((L + cols - 1) / cols, nch),
                             kReduceThreads, 0, s>>>(M, L, x, out);
    }
  } else if (form == 1) {
    const int rows = nch * M;
    reduce_min_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        rows, L, x, out);
  } else {
    return kBad;
  }
  return launched();
}

// No work: the time of a launch, the floor under every probe's time
extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return launched();
}

extern "C" int probe_uniform(int rows, int lanes, const int* seed, float* out,
                             void* stream) {
  if (rows < 1 || lanes < 1 || (long long)rows * lanes > 0x7fffffffLL)
    return kBad;
  const int n = rows * lanes;
  uniform_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      rows, lanes, seed, out);
  return launched();
}
