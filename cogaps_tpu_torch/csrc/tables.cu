// The dense model's per-call tables for Hopper (sm_90a), one launch a
// sampler's update call for every chain of the call.
//
// Replaces the XLA dots that build an update call's tables in
// cogaps_tpu/models/dense.py:108-150 (make_phase, residual, rebuild_cache;
// they have no Pallas counterpart), which the port ran as batched cuBLAS
// products (models/dense.tables_plain); on the fused route K3's
// rebuild_kernel (csrc/span.cu:517) builds the same tables under the
// float64 rule. For one sampler (rows r < R, partners i < m, data X and
// weights W (R, m), factor M (R, k), partner factor O (m, k)), per chain:
//   Y[r,c]    = sum_i (X[r,i] - M[r,:].O[i,:]) W[r,i] O[i,c]
//   Z[r,c,c'] = sum_i W[r,i] Q[i,(c,c')],  Q[i,(c,c')] = O[i,c] O[i,c']
//               (c <= c'; mirrored)
//   SQ[r,c]   = Z[r,c,c],   col_nz[c] = max_i O[i,c] > 0
// in float32, as models/dense.tables_plain forms them.
//
// Its summation order is the plan's alone (ops/tables_cuda.tables_plan:
// R, m, k and the SM count, never the chain count or a chain's index), so
// a chain's bits do not follow the chains that share its call; cuBLAS picks
// its kernel, and with it a float32 sum's order, by the batch count. The
// grid is (row tiles x accumulator tiles, contraction splits, chains): more
// chains add blocks and change no block's work. A block covers RT rows of
// one chain and the partners of one fixed chunk of the contraction, staged
// in shared memory while the block works on earlier ones. Four kernels,
// as the plan says:
//   - mma_kernel<K> (k <= 12, m >= 64, R >= 2): the products on the
//     tensor cores in TF32 with the 3xTF32 split (x = big + small, both
//     TF32 by cvt.rna; small.big + big.small + big.big), which keeps
//     float32 accuracy: (X W) O, and Z = W Q; then Y = (X W) O - M Z row
//     by row (sum_i (M O^T)[r,i] W[r,i] O[i,c] = sum_c' M[r,c'] Z[r,c',c]),
//     so that no thread forms the residual. Four warps a block: the
//     tensor-core form (R > 32) is one warpgroup of 64 rows on wgmma
//     (B from shared memory by descriptor), the short-row form (R <= 32)
//     16 or 32 rows with the partners split over 4 or 2 warps on
//     mma.sync m16n8k8, added in warp order. A ring of three stages of
//     L partners holds X, W and O's rows: in the tensor-core form one
//     thread fills a stage with two TMA tensor copies (zeros past m and
//     R) and a bulk copy of O's rows, counted on the slot's mbarrier;
//     else every thread by cp.async. Per stage each warp forms a
//     quarter of [O | Q]'s columns for the stage's partners (the padding
//     columns zeroed once), split into TF32 halves, as core matrices of
//     8 columns x 4 partners (what ldmatrix and wgmma read); M's rows are
//     loaded at the start, for the end. Partners sit permuted inside
//     each group of 16
//     (partner 4t + e at place 4e + t), so that a thread's float4 of X
//     and W is its two k-steps' A fragments. A group's six products a
//     product start from zero and are then added to the accumulators in
//     float32 round-to-nearest, so long sums round as fmaf chains do.
//     The block's sums are staged in shared memory for coalesced writes.
//   - mma_tiles_kernel<NCT, NS> (k > 12, m >= 64, R >= 2; the short-row
//     form up to k = 64): the same forms and arithmetic, every entry's
//     sum in the same order, with [O | Q]'s 8 ceil(k/8) + 8
//     ceil(k(k+1)/16) columns cut into column tiles of 8 NCT, a block's:
//     64 (a thread's sums and a group's products in 32 registers each,
//     and both fragments, under the 170 registers of three blocks an
//     SM), or in the tensor-core form above k = 28 128 (two blocks an SM,
//     W staged and split half as often a column). The ring holds NS
//     stages: three, or two where three would cost the SM its second
//     block (O's rows grow with k: above k = 74). The grid's accumulator
//     tiles are the column tiles, next to each other in blockIdx.x so
//     that a row tile's X and W come from L2 after its first tile. A
//     block forms only its tile's columns, a warp a quarter of its
//     n-blocks, the lane's column codes in registers; on wgmma it forms
//     the stage's second group of 16 partners while the first group's
//     products run. Y's ceil(k/8) n-blocks fill the first tiles (all in
//     tile 0 up to k = 128): those alone stage X and run X W's products,
//     beside W's, and the one holding Y's last n-blocks also takes Z's
//     first pairs. A tile writes its Z entries in the order of their
//     addresses (ops/tables_cuda.tile_list), SQ and its columns of (X W)
//     O; the last of a row tile's tiles to finish (a second integer
//     counter, left 0) reads the row tile's Z back and forms Y = (X W) O
//     - M Z with M Z's fmaf chain over c' as mma_kernel's;
//   - rows_kernel<K> (k <= 12, the rest): a thread a row, K + K(K+1)/2
//     float accumulators, the partner's row in registers; per partner
//     t O_c for Y and (W O_c) O_c' for Z, one fmaf each;
//   - quads_kernel<PQ> (k > 12 where m < 64 or R = 1, the short-row
//     form's R <= 32 above k = 64, which only a direct call reaches, and
//     past the k whose column tile fits a block, ~614): after
//     O's rows, a row of "columns" a partner, [O_c | O_c O_c'], formed
//     once a partner and block, and each thread PQ quads of them (float4
//     accumulators), G threads sharing a row where its quads exceed PQ or
//     the rows are too few to fill the block; one fmaf a column, a
//     16-byte broadcast load for four. Above G = 32 (k > ~35) the
//     accumulators are tiled over blocks too, each forming the residual
//     again.
// A contraction split into S chunks writes its partials, and the last
// block of its (chain, tile) to finish (an integer counter, left 0) adds
// them in split order, 0 to S - 1 (mma_kernel: every thread a few
// entries, many loads in flight); no float atomics, so two runs give the
// same bits.
//
// What bounds it on the H100: bytes at k <= 12, the tensor cores above.
// X and W are read once, 8 bytes an element, against 2 + 4k + k(k+1)
// float32 operations (152 at k=10: 19 a byte against the CUDA cores' 67e12
// / 3.35e12 = 20, so rows_kernel could meet its bound only with the FMA
// pipe and HBM both at peak). mma_kernel puts 130 of the 152 on the
// tensor cores (three TF32 products each, against 495e12 dense TF32;
// mma.sync's TF32 products measured ~80e12 a second here, wgmma's are
// the card's full rate) and drops the residual's 2k, which leaves the
// CUDA cores the products X W, the splits and the adds of a group's
// sums: the card's bytes stay the bound. At 4 x 5000 x 2000 k=10 both
// samplers move 0.64 GB: ~0.19 ms at the 3.35 TB/s of the H100 SXM data
// sheet. At k=20 the same calls' 3xTF32 products take 0.112 ms at
// 495e12 against 0.107 ms of bytes, and at k=50 0.642 ms: the tensor
// cores bound it, and on the CUDA cores quads_kernel took 2.76 ms at k=20
// and 39 ms at k=50 (NVIDIA H100 80GB HBM3, 700 W; kernel_times.py
// --tables on the parent of mma_tiles_kernel). What is left is each
// stage's forming of [O | Q] (per 64 rows, now per column tile), the
// per-stage barriers, each column tile's own W and A fragments, and with
// short rows the partials of the splits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // ops/tables_cuda.THREADS
constexpr int kY = 0xFFFF;     // a column code's partner for a Y column
constexpr int kRowsMaxK = 12;  // ops/tables_cuda.ROWS_MAX_K
constexpr int kStages = 3;     // ops/tables_cuda.STAGES: mma_kernel's ring
constexpr int kMmaWarps = kThreads / 32;  // ops/tables_cuda.MMA_WARPS

struct Args {
  const float* D;
  const float* W;
  const float* M;
  const float* O;
  long long cD, cW, cM, cO;  // chain strides in floats (0: one for all)
  float* Y;
  float* SQ;
  float* Z;
  unsigned char* col_nz;
  float* part;    // (chains, tiles, S, accumulators, kThreads) partials
  int* flags;     // (chains, S, 2, k): positive seen, NaN seen
  int* counters;  // (chains, tiles) blocks done, then mma_tiles_kernel's
                  // (chains, row tiles) column tiles done; left 0
  const int* zlist;  // mma_tiles_kernel: each column tile's Z entries
  int R, m, k, qy, npairs;
  int G, RT, TQ, acc_tiles, S, CH, L, smq;
  int RW;   // mma_kernel's row warps
  int vec;  // X and W rows in 16-byte pieces: m % 4 == 0, aligned (1),
            // and O's rows too, mma_kernel's tensor copies (2)
};

// mma_kernel's parameters: with vec 2, X's and W's (m, R, chains) maps for
// the copy engine (TMA), kept out of the other kernels' launches
struct MmaArgs {
  Args a;
  CUtensorMap mapD, mapW;
};

// (c, c') of pair p of the upper triangle c <= c' < k, row-major
__device__ __forceinline__ void decode_pair(int p, int k, int& c, int& c2) {
  const float b = 2.0f * k + 1.0f;
  int r = (int)floorf(0.5f * (b - sqrtf(fmaxf(b * b - 8.0f * p, 0.0f))));
  r = max(0, min(r, k - 1));
  auto start = [k](int c) { return c * k - c * (c - 1) / 2; };
  while (r + 1 < k && start(r + 1) <= p) ++r;
  while (r > 0 && start(r) > p) --r;
  c = r;
  c2 = r + (p - start(r));
}

// 4 bytes global -> shared, asynchronously; a copy that is not `ok`
// writes zeros (src must still be a valid address)
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float s, const float4& v, float4& acc) {
  acc.x = __fmaf_rn(s, v.x, acc.x);
  acc.y = __fmaf_rn(s, v.y, acc.y);
  acc.z = __fmaf_rn(s, v.z, acc.z);
  acc.w = __fmaf_rn(s, v.w, acc.w);
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc = acc + v; }

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x = acc.x + v.x;
  acc.y = acc.y + v.y;
  acc.z = acc.z + v.z;
  acc.w = acc.w + v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// What both kernels share: the block's place in the grid, its chain's
// inputs, the staging of X, W and O's rows into two buffers, the col_nz
// flags and the sum of the splits.
struct Block {
  const Args& a;
  int chain, s, tile, rt, at, tid, lo, hi, L, LP, ty;
  bool flag_block;
  const float *D, *W, *O;
  float4* sO;  // 2 x L x qy quads: O's rows
  float* sD;   // 2 x RT x LP each: X and W, rows L + 4 apart (16-byte
               // pieces, conflict-free 16-byte loads of a thread's row)
  float* sW;
  int* sFlag;  // 2k
  int* sLast;

  __device__ Block(const Args& args, float4* sO_, float* sD_, int* sFlag_)
      : a(args), chain(blockIdx.z), s(blockIdx.y), tile(blockIdx.x),
        rt(blockIdx.x / args.acc_tiles),
        at(blockIdx.x - rt * args.acc_tiles), tid(threadIdx.x),
        lo(blockIdx.y * args.CH), hi(min(lo + args.CH, args.m)), L(args.L),
        LP(args.L + 4), ty(4 * args.qy), flag_block(blockIdx.x == 0),
        D(args.D + blockIdx.z * args.cD), W(args.W + blockIdx.z * args.cW),
        O(args.O + blockIdx.z * args.cO), sO(sO_), sD(sD_),
        sW(sD_ + 2 * args.RT * (args.L + 4)), sFlag(sFlag_),
        sLast(sFlag_ + 2 * args.k) {
    for (int c = tid; c < 2 * a.k; c += kThreads) sFlag[c] = 0;
  }

  __device__ int n_sub() const { return hi > lo ? (hi - lo + L - 1) / L : 0; }

  // sub-tile [i0, i0 + L) into buffer b, in flight until the next wait
  __device__ void stage(int i0, int b) const {
    float* d = sD + b * a.RT * LP;
    float* w = sW + b * a.RT * LP;
    if (a.vec) {  // hi and i0 are multiples of 4: a piece is in or out
      const int L4 = L / 4;
      for (int e = tid; e < a.RT * L4; e += kThreads) {
        const int rr = e / L4, ii = 4 * (e - rr * L4);
        const int row = rt * a.RT + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        cp_async16(d + rr * LP + ii, D + off, ok);
        cp_async16(w + rr * LP + ii, W + off, ok);
      }
    } else {
      for (int e = tid; e < a.RT * L; e += kThreads) {
        const int rr = e / L, ii = e - rr * L;
        const int row = rt * a.RT + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        cp_async4(d + rr * LP + ii, D + off, ok);
        cp_async4(w + rr * LP + ii, W + off, ok);
      }
    }
    float* o = reinterpret_cast<float*>(sO + (size_t)b * L * a.qy);
    for (int e = tid; e < L * ty; e += kThreads) {
      const int ii = e / ty, c = e - ii * ty, i = i0 + ii;
      const bool ok = c < a.k && i < hi;
      cp_async4(o + e, O + (ok ? (size_t)i * a.k + c : 0), ok);
    }
    cp_async_commit();
  }

  // waits for sub-tile t (buffer t & 1) and starts t + 1; every thread
  // is then past sub-tile t - 1
  __device__ void advance(int t) const {
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_sub()) stage(lo + (t + 1) * L, (t + 1) & 1);
    if (flag_block) {
      const float* of = reinterpret_cast<const float*>(sO + (size_t)(t & 1) *
                                                       L * a.qy);
      const int i0 = lo + t * L;
      for (int e = tid; e < L * ty; e += kThreads) {
        const int ii = e / ty, c = e - ii * ty;
        if (c < a.k && i0 + ii < hi) {
          const float v = of[e];
          if (v > 0.0f) sFlag[c] = 1;
          if (v != v) sFlag[a.k + c] = 1;
        }
      }
    }
  }

  // With one split: true. Else this block's partials go to part; false
  // in every block but the last of its tile to finish, which gets every
  // split's sums in acc, added in split order, and the flags of all.
  template <typename T, int N>
  __device__ bool sums(T (&acc)[N]) const {
    __syncthreads();  // sFlag is whole
    if (a.S == 1) return true;
    const int blk = chain * gridDim.x + tile;
    T* mine = reinterpret_cast<T*>(a.part) + (size_t)blk * a.S * N * kThreads;
#pragma unroll
    for (int j = 0; j < N; ++j)
      mine[((size_t)s * N + j) * kThreads + tid] = acc[j];
    const int k2 = 2 * a.k;
    if (flag_block)
      for (int c = tid; c < k2; c += kThreads)
        a.flags[((size_t)chain * a.S + s) * k2 + c] = sFlag[c];
    __threadfence();
    __syncthreads();
    if (tid == 0) *sLast = atomicAdd(&a.counters[blk], 1) == a.S - 1;
    __syncthreads();
    if (!*sLast) return false;
    __threadfence();
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] = __ldcg(&mine[(size_t)j * kThreads + tid]);
#pragma unroll 2
    for (int s2 = 1; s2 < a.S; ++s2)
#pragma unroll
      for (int j = 0; j < N; ++j)
        add_to(acc[j], __ldcg(&mine[((size_t)s2 * N + j) * kThreads + tid]));
    if (flag_block)
      for (int c = tid; c < k2; c += kThreads) {
        int any = 0;
        for (int s2 = 0; s2 < a.S; ++s2)
          any |= __ldcg(&a.flags[((size_t)chain * a.S + s2) * k2 + c]);
        sFlag[c] = any;
      }
    if (tid == 0) a.counters[blk] = 0;
    __syncthreads();
    return true;
  }

  __device__ void write_col_nz() const {
    if (flag_block)
      for (int c = tid; c < a.k; c += kThreads)
        a.col_nz[(size_t)chain * a.k + c] = sFlag[c] && !sFlag[a.k + c];
  }

  // Z[r, c, c2] and its mirror, SQ on the diagonal
  __device__ void put_pair(int r, int c, int c2, float v) const {
    const int k = a.k;
    float* Z = a.Z + (size_t)chain * a.R * k * k;
    Z[((size_t)r * k + c) * k + c2] = v;
    if (c == c2)
      a.SQ[((size_t)chain * a.R + r) * k + c] = v;
    else
      Z[((size_t)r * k + c2) * k + c] = v;
  }
};

// A thread a row, K <= kRowsMaxK (G = 1, one accumulator tile).
template <int K>
__global__ void __launch_bounds__(kThreads, 3)
    rows_kernel(const __grid_constant__ Args a) {
  constexpr int NZ = K * (K + 1) / 2, QY = (K + 3) / 4;
  constexpr int OUT = K * K + K + 1;  // a row's Z and Y, staged to write
  extern __shared__ float4 smem4[];
  float4* sO = smem4;
  float* sD = reinterpret_cast<float*>(sO + (size_t)2 * a.L * QY);
  const int staged = 4 * 2 * a.L * QY + 4 * a.RT * (a.L + 4);
  float* sOut = reinterpret_cast<float*>(smem4);  // after the last sum
  int* sFlag = reinterpret_cast<int*>(sOut + max(staged, a.RT * OUT));
  const Block b(a, sO, sD, sFlag);
  const int r = b.rt * a.RT + b.tid;
  const int n_sub = b.n_sub();
  if (n_sub > 0) b.stage(b.lo, 0);

  float mr[K], acc[K + NZ];
  const float* M = a.M + b.chain * a.cM;
#pragma unroll
  for (int c = 0; c < K; ++c) mr[c] = r < a.R ? M[(size_t)r * K + c] : 0.0f;
#pragma unroll
  for (int j = 0; j < K + NZ; ++j) acc[j] = 0.0f;

  for (int t = 0; t < n_sub; ++t) {
    b.advance(t);
    const int buf = t & 1;
    const float* dr = b.sD + (buf * a.RT + b.tid) * b.LP;
    const float* wr = b.sW + (buf * a.RT + b.tid) * b.LP;
    const float4* oq = sO + (size_t)buf * a.L * QY;
    for (int i4 = 0; i4 < a.L; i4 += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(dr + i4);
      const float4 w4 = *reinterpret_cast<const float4*>(wr + i4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float o[4 * QY];
#pragma unroll
        for (int q = 0; q < QY; ++q) {
          const float4 v = oq[(i4 + e) * QY + q];
          o[4 * q] = v.x;
          o[4 * q + 1] = v.y;
          o[4 * q + 2] = v.z;
          o[4 * q + 3] = v.w;
        }
        const float w = lane_of(w4, e);
        float mo = 0.0f;
#pragma unroll
        for (int c = 0; c < K; ++c) mo = __fmaf_rn(mr[c], o[c], mo);
        const float t_r = (lane_of(d4, e) - mo) * w;
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = __fmaf_rn(t_r, o[c], acc[c]);
        int p = K;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float wo = w * o[c];
#pragma unroll
          for (int c2 = c; c2 < K; ++c2, ++p)
            acc[p] = __fmaf_rn(wo, o[c2], acc[p]);
        }
      }
    }
  }

  if (!b.sums(acc)) return;
  b.write_col_nz();
  // the block's rows of Z, Y and SQ are contiguous in each: staged here
  // (OUT apart, odd), then written by the whole block, coalesced
  float* row_out = sOut + b.tid * OUT;
  int p = K;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    row_out[K * K + c] = acc[c];
#pragma unroll
    for (int c2 = c; c2 < K; ++c2, ++p) {
      row_out[c * K + c2] = acc[p];
      row_out[c2 * K + c] = acc[p];
    }
  }
  __syncthreads();
  const int n = min(a.RT, a.R - b.rt * a.RT);
  const size_t row0 = (size_t)b.chain * a.R + b.rt * a.RT;
  float* Z = a.Z + row0 * K * K;
  for (int e = b.tid; e < n * K * K; e += kThreads)
    Z[e] = sOut[e / (K * K) * OUT + e % (K * K)];
  float* Y = a.Y + row0 * K;
  float* SQ = a.SQ + row0 * K;
  for (int e = b.tid; e < n * K; e += kThreads) {
    const float* o = sOut + e / K * OUT;
    Y[e] = o[K * K + e % K];
    SQ[e] = o[e % K * (K + 1)];
  }
}

// PQ quads of columns a thread, G threads a row, any k.
template <int PQ>
__global__ void __launch_bounds__(kThreads)
    quads_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float4* sTab = smem4;                      // L x TQ quads: the columns
  float4* sO = sTab + (size_t)a.L * a.TQ;    // 2 x L x qy quads
  float4* sM = sO + (size_t)2 * a.L * a.qy;  // RT x smq quads: M's rows
  float* sD = reinterpret_cast<float*>(sM + (size_t)a.RT * a.smq);
  int* sCode = reinterpret_cast<int*>(sD + 4 * a.RT * (a.L + 4));  // 4 TQ
  int* sFlag = sCode + 4 * a.TQ;
  const Block b(a, sO, sD, sFlag);
  const int k = a.k, tt = 4 * a.TQ, ty = b.ty;
  const int g = b.tid % a.G, rl = b.tid / a.G;
  const int r = b.rt * a.RT + rl;
  const int n_sub = b.n_sub();
  if (n_sub > 0) b.stage(b.lo, 0);

  // the tile's columns: entry e < 4 qy is Y's column e, the rest pairs
  for (int el = b.tid; el < tt; el += kThreads) {
    const int e = b.at * tt + el;
    int code = -1;
    if (e < ty) {
      if (e < k) code = (e << 16) | kY;
    } else if (e - ty < a.npairs) {
      int c, c2;
      decode_pair(e - ty, k, c, c2);
      code = (c << 16) | c2;
    }
    sCode[el] = code;
  }
  const float* M = a.M + b.chain * a.cM;
  float* sMf = reinterpret_cast<float*>(sM);
  for (int e = b.tid; e < a.RT * 4 * a.smq; e += kThreads) {
    const int rr = e / (4 * a.smq), c = e - rr * 4 * a.smq;
    const int row = b.rt * a.RT + rr;
    sMf[e] = (row < a.R && c < k) ? M[(size_t)row * k + c] : 0.0f;
  }

  // a thread's quads are g PQ .. g PQ + PQ - 1 of the tile
  bool is_y[PQ];
#pragma unroll
  for (int j = 0; j < PQ; ++j) is_y[j] = b.at * a.TQ + g * PQ + j < a.qy;
  float4 acc[PQ];
#pragma unroll
  for (int j = 0; j < PQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* mr = sM + rl * a.smq;
  float* sTabf = reinterpret_cast<float*>(sTab);

  for (int t = 0; t < n_sub; ++t) {
    b.advance(t);
    const int buf = t & 1;
    const float4* oq = sO + (size_t)buf * a.L * a.qy;
    const float* of = reinterpret_cast<const float*>(oq);
    for (int e = b.tid; e < a.L * tt; e += kThreads) {
      const int ii = e / tt, el = e - ii * tt;
      const int code = sCode[el];
      float v = 0.0f;
      if (code >= 0) {
        const float* orow = of + ii * ty;
        const int c = code >> 16, c2 = code & 0xFFFF;
        v = c2 == kY ? orow[c] : orow[c] * orow[c2];
      }
      sTabf[e] = v;
    }
    __syncthreads();
    const float* dr = b.sD + (buf * a.RT + rl) * b.LP;
    const float* wr = b.sW + (buf * a.RT + rl) * b.LP;
    for (int ii = 0; ii < a.L; ++ii) {
      const float w = wr[ii];
      float mo = 0.0f;
      const float4* orow = oq + ii * a.qy;
      for (int q = 0; q < a.qy; ++q) {
        const float4 mv = mr[q], ov = orow[q];
        mo = __fmaf_rn(mv.x, ov.x, mo);
        mo = __fmaf_rn(mv.y, ov.y, mo);
        mo = __fmaf_rn(mv.z, ov.z, mo);
        mo = __fmaf_rn(mv.w, ov.w, mo);
      }
      const float t_r = (dr[ii] - mo) * w;
      const float4* trow = sTab + ii * a.TQ + g * PQ;
#pragma unroll
      for (int j = 0; j < PQ; ++j) fma4(is_y[j] ? t_r : w, trow[j], acc[j]);
    }
  }

  if (!b.sums(acc)) return;
  b.write_col_nz();
  if (r >= a.R) return;
  float* Y = a.Y + ((size_t)b.chain * a.R + r) * k;
#pragma unroll
  for (int j = 0; j < PQ; ++j) {
    for (int e = 0; e < 4; ++e) {
      const int code = sCode[4 * (g * PQ + j) + e];
      if (code < 0) continue;
      const int c = code >> 16, c2 = code & 0xFFFF;
      const float v = lane_of(acc[j], e);
      if (c2 == kY)
        Y[c] = v;
      else
        b.put_pair(r, c, c2, v);
    }
  }
}

// ---------------------------------------------------------------------
// mma_kernel<K>: Y and Z on the tensor cores
// ---------------------------------------------------------------------

template <int K>
struct MmaShape {
  static constexpr int NP = K * (K + 1) / 2;  // Z's pairs c <= c'
  static constexpr int NY = (K + 7) / 8;      // n-blocks of 8 columns: Y
  static constexpr int NZ = (NP + 7) / 8;     // and Z
  static constexpr int NT = NY + NZ;
  static constexpr int NT8 = 8 * NT;          // columns of [O | Q]
};

// (c, c') of pair p of the upper triangle c <= c' < k, row-major, for
// indices known when the loops that use them are unrolled
__host__ __device__ constexpr int pair_row(int p, int k) {
  int c = 0;
  while (c + 1 < k && p >= k - c) p -= k - c++;
  return c;
}

__host__ __device__ constexpr int pair_col(int p, int k) {
  int c = 0;
  while (c + 1 < k && p >= k - c) p -= k - c++;
  return c + p;
}

// [O | Q] in shared memory as core matrices of 8 columns x 4 partners
// (128 bytes, what one ldmatrix matrix and one wgmma core matrix read),
// kCM floats apart along the partners: the 16 bytes of padding put the 8
// core matrices a warp's lanes write (a partner a lane) in 32 banks
constexpr int kCM = 36;

// mma_kernel's shared memory in floats (ops/tables_cuda._mma_floats): the
// ring's X and W (kStages x RT rows of L) and O's rows (kStages x L x K),
// the stage's [O | Q] as TF32 halves (2 x NT n-blocks
// x L / 4 core matrices); after the loop the block's partials (KW x RT
// rows, PP apart) and its M rows (RT x k) in the same space (three blocks
// an SM at k=10 hold 76,800 bytes each); then the flags (2k), one int
// and the ring's mbarriers. A stage is 16 KW partners a
// warp group: two groups of 16 a warp where the warps split the rows, one
// where they split the partners.
struct MmaLayout {
  int RT, KW, L, lgL, KC, PP, w, o, b, half, m, flag, bar, floats;
};

__host__ __device__ inline MmaLayout mma_layout(int k, int RW) {
  const int np = k * (k + 1) / 2;
  const int nt = (k + 7) / 8 + (np + 7) / 8;
  MmaLayout l;
  l.KW = kMmaWarps / RW;
  l.RT = 16 * RW;
  l.L = 16 * l.KW * (l.KW == 1 ? 2 : 1);
  l.lgL = l.L == 32 ? 5 : 6;
  l.KC = l.L / 4;
  l.PP = 8 * nt + 1;
  l.w = kStages * l.RT * l.L;
  l.o = 2 * l.w;
  l.b = l.o + kStages * l.L * k;
  l.half = nt * l.KC * kCM;
  const int staging = l.b + 2 * l.half;
  l.m = l.KW * l.RT * l.PP;  // M's rows after the partials
  const int after = l.m + l.RT * k;
  l.flag = staging > after ? staging : after;
  l.bar = (l.flag + 2 * k + 2) / 2 * 2;  // 8-byte aligned
  l.floats = l.bar + 2 * kStages;
  return l;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// this thread's arrival, and the bytes the phase's copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits for the phase of the given parity to complete; a wait past two
// seconds (a copy that never lands) traps, and the launch's error says
// so, where it would otherwise hold the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  unsigned long long t0 = 0;
  for (int n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (n == 0) t0 = now;
    if (now - t0 > 2000000000ull) asm volatile("trap;");
  }
}

// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared,
// counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box at (c0, c1, c2) of a tensor map global -> shared, counted on
// bar; what lies past the tensor's edges arrives as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (the 3xTF32 split)
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += A B over one k-step of 8 partners (m16n8k8, TF32 in, float32 out)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma.mma_async m64nNk8 in TF32, A from registers (each warp's 16 rows
// as the m16n8k8 A fragment), B by its shared-memory descriptor, float32
// D of N / 2 registers a thread: D = A B + (scale_d ? D : 0). N is Y's 8
// NY or Z's 8 NZ for k = 1 .. 12.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void run(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11"
        "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<40> {
  static __device__ __forceinline__ void run(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<56> {
  static __device__ __forceinline__ void run(float (&d)[28],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void run(float (&d)[36],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// keeps the compiler from moving reads of d above the wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a wgmma descriptor of a K-major operand without swizzle: core matrices
// lbo bytes apart along K and sbo apart along N
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// The A fragments of a group of 16 partners: [0] X W for the Y columns,
// [1] W for the Z columns; big and small halves, k-steps 0, 1
struct GroupA {
  uint32_t big[2][2][4], small[2][2][4];
};

// mma.sync (the short-row form): one group (two k-steps), each
// n-block's six products of the 3xTF32 split, small ones first, from
// zero, then added to acc in float32. hb and hs: the group's first core
// matrix of n-block 0 in the big and small halves, this lane's row of it
// (ldmatrix: k-step s in registers 2s, 2s + 1); n-blocks sbo floats
// apart.
template <int NY, int NT>
__device__ __forceinline__ void group_mma(float (&acc)[NT][4],
                                          const GroupA& A,
                                          const uint32_t* hb,
                                          const uint32_t* hs, int sbo) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int y = j < NY ? 0 : 1;  // T's fragments, or W's
    uint32_t bb[4], bs[4];
    ldmatrix_x4(bb, hb + j * sbo);
    ldmatrix_x4(bs, hs + j * sbo);
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mma_tf32(d, A.small[y][s], bb[2 * s], bb[2 * s + 1]);
      mma_tf32(d, A.big[y][s], bs[2 * s], bs[2 * s + 1]);
      mma_tf32(d, A.big[y][s], bb[2 * s], bb[2 * s + 1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], d[e]);
  }
}

// wgmma (the tensor-core form, the block's four warps one warpgroup of
// 64 rows): one group's Y and Z products, six each (the 3xTF32 split,
// small ones first, from zero), then added to acc in float32. b: the
// big half's first core matrix of the group; the small half `half`
// floats on, n-blocks sbo floats apart.
template <int K>
__device__ __forceinline__ void group_wgmma(
    float (&acc)[MmaShape<K>::NT][4], const GroupA& A, const uint32_t* b,
    int half, int sbo) {
  using Sh = MmaShape<K>;
  constexpr int NY = Sh::NY, NZ = Sh::NZ;
  float dy[4 * NY], dz[4 * NZ];
#pragma unroll
  for (int e = 0; e < 4 * NY; ++e) dy[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 4 * NZ; ++e) dz[e] = 0.0f;
  const int lbo = 4 * kCM, sbo_b = 4 * sbo;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t* bb = b + 2 * s * kCM;  // k-step s: core matrices 2s, +1
    const uint32_t* bs = bb + half;
    const uint64_t yb = gmma_desc(bb, lbo, sbo_b);
    const uint64_t ys = gmma_desc(bs, lbo, sbo_b);
    const uint64_t zb = gmma_desc(bb + NY * sbo, lbo, sbo_b);
    const uint64_t zs = gmma_desc(bs + NY * sbo, lbo, sbo_b);
    Wgmma<8 * NY>::run(dy, A.small[0][s], yb, s);
    Wgmma<8 * NZ>::run(dz, A.small[1][s], zb, s);
    Wgmma<8 * NY>::run(dy, A.big[0][s], ys, 1);
    Wgmma<8 * NZ>::run(dz, A.big[1][s], zs, 1);
    Wgmma<8 * NY>::run(dy, A.big[0][s], yb, 1);
    Wgmma<8 * NZ>::run(dz, A.big[1][s], zb, 1);
  }
  wgmma_commit_wait();
  fence_operands(dy);
  fence_operands(dz);
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = __fadd_rn(acc[j][e], dy[4 * j + e]);
#pragma unroll
  for (int j = 0; j < NZ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[NY + j][e] = __fadd_rn(acc[NY + j][e], dz[4 * j + e]);
}

// The stage's [O | Q] in TF32 halves, its padding columns left as the
// kernel zeroed them: warp W a quarter of the k + k(k+1)/2 columns, a
// lane a partner place (its O row in registers, every column's (c, c')
// known once unrolled); col_nz's flags from Y's columns.
template <int K, int W>
__device__ __forceinline__ void form_b(uint32_t* sB, const float* o, int L,
                                       int half, int sbo, bool flag_block,
                                       int* sFlag, int lane) {
  using Sh = MmaShape<K>;
  constexpr int NY = Sh::NY, NREAL = K + Sh::NP, C = (NREAL + 3) / 4;
  constexpr int Q0 = W * C, Q1 = Q0 + C < NREAL ? Q0 + C : NREAL;
  for (int pos = lane; pos < L; pos += 32) {
    // place pos of a group of 16 holds partner 4 (pos % 4) + pos / 4
    const float* orow =
        o + ((pos & ~15) + 4 * (pos & 3) + ((pos >> 2) & 3)) * K;
    float ov[K];
#pragma unroll
    for (int c = 0; c < K; ++c) ov[c] = orow[c];
    uint32_t* cell = sB + (pos >> 2) * kCM + (pos & 3);
#pragma unroll
    for (int q = Q0; q < Q1; ++q) {
      const int n = q < K ? q : 8 * NY + q - K;  // Y's column, or a pair
      float v;
      if (q < K) {
        v = ov[q < K ? q : 0];
        if (flag_block) {
          if (v > 0.0f) sFlag[q] = 1;
          if (v != v) sFlag[K + q] = 1;
        }
      } else {
        const int p = q - K;
        v = __fmul_rn(ov[pair_row(p, K)], ov[pair_col(p, K)]);
      }
      uint32_t big, small;
      tf32_split(v, big, small);
      cell[(n >> 3) * sbo + 4 * (n & 7)] = big;
      cell[half + (n >> 3) * sbo + 4 * (n & 7)] = small;
    }
  }
}

// Four warps, RW x KW; see the file's note. In [O | Q], partners inside
// a group of 16 sit permuted: partner 4t + e at place 4e + t, so that
// k-step s takes partners 4t + 2s (A column t, B row t) and 4t + 2s + 1
// (column and row t + 4), and a thread's float4 of X holds both.
template <int K>
__global__ void __launch_bounds__(kThreads, 3)
    mma_kernel(const __grid_constant__ MmaArgs p) {
  const Args& a = p.a;
  using Sh = MmaShape<K>;
  constexpr int NY = Sh::NY, NT = Sh::NT, NT8 = Sh::NT8;
  const MmaLayout ly = mma_layout(K, a.RW);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sX = sm;
  float* sW = sm + ly.w;
  float* sO = sm + ly.o;
  uint32_t* sB = reinterpret_cast<uint32_t*>(sm + ly.b);
  int* sFlag = reinterpret_cast<int*>(sm + ly.flag);
  int* sLast = sFlag + 2 * K;
  const int RT = ly.RT, KW = ly.KW, L = ly.L, lgL = ly.lgL, PP = ly.PP;
  const int half = ly.half, sbo = ly.KC * kCM;
  const bool wg = a.RW == kMmaWarps;  // the tensor-core form: wgmma
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp / KW, kw = warp - rw * KW;
  const int chain = blockIdx.z, s = blockIdx.y, tile = blockIdx.x;
  const int row0 = tile * RT;
  const int lo = s * a.CH, hi = min(lo + a.CH, a.m);
  const bool flag_block = tile == 0;
  const float* D = a.D + chain * a.cD;
  const float* W = a.W + chain * a.cW;
  const float* O = a.O + chain * a.cO;
  const float* M = a.M + chain * a.cM;
  for (int c = tid; c < 2 * K; c += kThreads) sFlag[c] = 0;
  // [O | Q]'s padding columns (Y's past k, Z's past its pairs): zeros,
  // which no stage writes again
  constexpr int YPAD = 8 * NY - K, NPAD = NT8 - K - Sh::NP;
  for (int e = tid; e < NPAD * L; e += kThreads) {
    const int j = e / L, pos = e - j * L;
    const int n = j < YPAD ? K + j : 8 * NY + Sh::NP + j - YPAD;
    const int off = (n >> 3) * sbo + (pos >> 2) * kCM + 4 * (n & 7) + (pos & 3);
    sB[off] = 0u;
    sB[half + off] = 0u;
  }
  // the tile's M rows, for Y = (X W) O - M Z at the end: loaded now,
  // their latency behind the stages
  const int nrows = min(RT, a.R - row0);  // the tile's rows in R
  float mreg[(K + 1) / 2];  // RT x K over kThreads, RT <= 64
#pragma unroll
  for (int j = 0; j < (K + 1) / 2; ++j) {
    const int e = tid + kThreads * j;
    mreg[j] = e < nrows * K ? M[(size_t)row0 * K + e] : 0.0f;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  const int n_sub = hi > lo ? (hi - lo + L - 1) / L : 0;
  const bool bulk = a.vec == 2;
  uint64_t* sBar = reinterpret_cast<uint64_t*>(sm + ly.bar);
  if (bulk && tid == 0) {
    for (int q = 0; q < kStages; ++q) mbar_init(sBar + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (bulk) __syncthreads();
  // stage t: partners [lo + t L, + L) into ring slot t % kStages: X and W
  // rows L apart, O's rows K apart (zeros past hi and past R)
  auto stage = [&](int t) {
    const int slot = t % kStages, i0 = lo + t * L;
    const int nval = min(L, hi - i0);
    float* x = sX + slot * RT * L;
    float* w = sW + slot * RT * L;
    float* o = sO + slot * L * K;
    if (bulk) {  // one thread: X's and W's tiles by TMA, O's rows in bulk
      if (tid != kThreads - 32) return;  // warp 3 forms the fewest n-blocks
      for (int e = nval * K; e < L * K; e++) o[e] = 0.0f;  // past m
      mbar_expect_tx(sBar + slot, 8u * RT * L + 4u * nval * K);
      tma_load_3d(x, &p.mapD, i0, row0, a.cD ? chain : 0, sBar + slot);
      tma_load_3d(w, &p.mapW, i0, row0, a.cW ? chain : 0, sBar + slot);
      bulk_copy(o, O + (size_t)i0 * K, 4u * nval * K, sBar + slot);
      return;
    }
    if (a.vec) {  // hi and i0 are multiples of 4: a piece is in or out
      for (int e = tid; e < RT * L / 4; e += kThreads) {
        const int rr = e >> (lgL - 2), ii = 4 * (e & (L / 4 - 1));
        const int row = row0 + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        cp_async16(x + rr * L + ii, D + off, ok);
        cp_async16(w + rr * L + ii, W + off, ok);
      }
    } else {
      for (int e = tid; e < RT * L; e += kThreads) {
        const int rr = e >> lgL, ii = e & (L - 1);
        const int row = row0 + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        cp_async4(x + rr * L + ii, D + off, ok);
        cp_async4(w + rr * L + ii, W + off, ok);
      }
    }
    for (int e = tid; e < L * K; e += kThreads) {
      const bool ok = e < nval * K;
      cp_async4(o + e, O + (ok ? (size_t)i0 * K + e : 0), ok);
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_sub)
      stage(t);
    else if (!bulk)
      cp_async_commit();
  }
  for (int t = 0; t < n_sub; ++t) {
    if (bulk)
      mbar_wait(sBar + t % kStages, (t / kStages) & 1);
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t is in; every thread is past stage t - 1
    if (t + kStages - 1 < n_sub)
      stage(t + kStages - 1);  // into stage t - 1's slot
    else if (!bulk)
      cp_async_commit();
    const int slot = t % kStages;
    const float* o = sO + slot * L * K;
    switch (warp) {
      case 0:
        form_b<K, 0>(sB, o, L, half, sbo, flag_block, sFlag, lane);
        break;
      case 1:
        form_b<K, 1>(sB, o, L, half, sbo, flag_block, sFlag, lane);
        break;
      case 2:
        form_b<K, 2>(sB, o, L, half, sbo, flag_block, sFlag, lane);
        break;
      default:
        form_b<K, 3>(sB, o, L, half, sbo, flag_block, sFlag, lane);
    }
    // the tensor cores read [O | Q] through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* xr = sX + (slot * RT + 16 * rw + gq) * L;
    const float* wr = sW + (slot * RT + 16 * rw + gq) * L;
    for (int grp = kw; grp < L / 16; grp += KW) {  // this warp's groups
      // this thread's X and W: rows 16 rw + gq (+ 8); partners 4 tq + e
      const int col = 16 * grp + 4 * tq;
      const float4 xa = *reinterpret_cast<const float4*>(xr + col);
      const float4 xb = *reinterpret_cast<const float4*>(xr + 8 * L + col);
      const float4 wa = *reinterpret_cast<const float4*>(wr + col);
      const float4 wb = *reinterpret_cast<const float4*>(wr + 8 * L + col);
      float ta[4], tb[4];  // X W: Y = (X W) O - M Z, row by row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ta[e] = __fmul_rn(lane_of(xa, e), lane_of(wa, e));
        tb[e] = __fmul_rn(lane_of(xb, e), lane_of(wb, e));
      }
      // A fragments of k-step s: (row gq, 4 tq + 2s), (gq + 8, 4 tq +
      // 2s), (gq, 4 tq + 2s + 1), (gq + 8, 4 tq + 2s + 1)
      GroupA A;
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        tf32_split(ta[2 * s2], A.big[0][s2][0], A.small[0][s2][0]);
        tf32_split(tb[2 * s2], A.big[0][s2][1], A.small[0][s2][1]);
        tf32_split(ta[2 * s2 + 1], A.big[0][s2][2], A.small[0][s2][2]);
        tf32_split(tb[2 * s2 + 1], A.big[0][s2][3], A.small[0][s2][3]);
        tf32_split(lane_of(wa, 2 * s2), A.big[1][s2][0], A.small[1][s2][0]);
        tf32_split(lane_of(wb, 2 * s2), A.big[1][s2][1], A.small[1][s2][1]);
        tf32_split(lane_of(wa, 2 * s2 + 1), A.big[1][s2][2],
                   A.small[1][s2][2]);
        tf32_split(lane_of(wb, 2 * s2 + 1), A.big[1][s2][3],
                   A.small[1][s2][3]);
      }
      const uint32_t* b = sB + 4 * grp * kCM;  // the group's core matrices
      if (wg) {
        group_wgmma<K>(acc, A, b, half, sbo);
      } else {
        // ldmatrix rows: lane l gives row l % 8 of matrix l / 8
        const uint32_t* hb = b + (lane >> 3) * kCM + 4 * (lane & 7);
        group_mma<NY, NT>(acc, A, hb, hb + half, sbo);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: the block's partials go there

  // warp (rw, kw)'s fragments at rows kw RT + 16 rw + gq (+ 8)
  float* sP = sm;
  {
    float* p0 = sP + (kw * RT + 16 * rw + gq) * PP + 2 * tq;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      p0[8 * j] = acc[j][0];
      p0[8 * j + 1] = acc[j][1];
      p0[8 * PP + 8 * j] = acc[j][2];
      p0[8 * PP + 8 * j + 1] = acc[j][3];
    }
  }
  __syncthreads();
  const int ent = nrows * NT8;  // the block's entries: rows x columns
  for (int e = tid; KW > 1 && e < ent; e += kThreads) {  // warps in order
    const int r = e / NT8, n = e - r * NT8;
    float v = sP[r * PP + n];
    for (int q = 1; q < KW; ++q) v = v + sP[(q * RT + r) * PP + n];
    sP[r * PP + n] = v;
  }

  if (a.S > 1) {
    const int blk = chain * gridDim.x + tile;
    const size_t slab = (size_t)RT * NT8;  // a split's partials
    float* base = a.part + (size_t)blk * a.S * slab;
    float* mine = base + (size_t)s * slab;
    for (int e = tid; e < ent; e += kThreads) {
      const int r = e / NT8;
      mine[e] = sP[r * PP + e - r * NT8];
    }
    const int k2 = 2 * K;
    if (flag_block)
      for (int c = tid; c < k2; c += kThreads)
        a.flags[((size_t)chain * a.S + s) * k2 + c] = sFlag[c];
    __threadfence();
    __syncthreads();
    if (tid == 0) *sLast = atomicAdd(&a.counters[blk], 1) == a.S - 1;
    __syncthreads();
    if (!*sLast) return;
    __threadfence();
    // every split's partials, added in split order: a thread two quads of
    // entries, eight splits' loads in flight before their adds
    const float4* b4 = reinterpret_cast<const float4*>(base);
    const size_t slab4 = slab / 4;
    const int ent4 = ent / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e4 = tid; e4 < ent4; e4 += 2 * kThreads) {
      const int f4 = e4 + kThreads;
      const bool two = f4 < ent4;
      float4 va = __ldcg(b4 + e4);
      float4 vb = two ? __ldcg(b4 + f4) : zero;
      int s2 = 1;
      for (; s2 + 8 <= a.S; s2 += 8) {
        float4 xa[8], xb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          xa[u] = __ldcg(b4 + (s2 + u) * slab4 + e4);
          xb[u] = two ? __ldcg(b4 + (s2 + u) * slab4 + f4) : zero;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          add_to(va, xa[u]);
          add_to(vb, xb[u]);
        }
      }
      for (; s2 < a.S; ++s2) {
        add_to(va, __ldcg(b4 + s2 * slab4 + e4));
        if (two) add_to(vb, __ldcg(b4 + s2 * slab4 + f4));
      }
      // four entries of one row (NT8 is a multiple of 8)
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const int e = 4 * (h == 0 ? e4 : f4);
        const int r = e / NT8, n = e - r * NT8;
        const float4 v = h == 0 ? va : vb;
        float* p = sP + r * PP + n;
        p[0] = v.x;
        p[1] = v.y;
        p[2] = v.z;
        p[3] = v.w;
      }
    }
    if (flag_block)
      for (int c = tid; c < k2; c += kThreads) {
        int any = 0;
        for (int s3 = 0; s3 < a.S; ++s3)
          any |= __ldcg(&a.flags[((size_t)chain * a.S + s3) * k2 + c]);
        sFlag[c] = any;
      }
    if (tid == 0) a.counters[blk] = 0;
  }
  __syncthreads();

  if (flag_block)
    for (int c = tid; c < K; c += kThreads)
      a.col_nz[(size_t)chain * K + c] = sFlag[c] && !sFlag[K + c];
  // the rows' Z, Y and SQ, contiguous in each: coalesced writes, Z a
  // warp a row, each lane the same entries of every row
  constexpr int KK = K * K, PER = (KK + 31) / 32;
  const size_t rowg = (size_t)chain * a.R + row0;
  int src[PER];  // this lane's Z entries' columns of the block's sums
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int cc = lane + 32 * j, c = cc / K, c2 = cc - c * K;
    const int l = min(c, c2), h = max(c, c2);
    src[j] = cc < KK ? 8 * NY + l * K - l * (l - 1) / 2 + (h - l) : -1;
  }
  for (int r = warp; r < nrows; r += kMmaWarps) {
    const float* pr = sP + r * PP;
    float* zr = a.Z + (rowg + r) * KK;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (src[j] >= 0) zr[lane + 32 * j] = pr[src[j]];
  }
  // Y = (X W) O - M Z: the residual's part, sum_i (M O^T)[r,i] W[r,i]
  // O[i,c] = sum_c' M[r,c'] Z[r,c',c], from the block's Z (fmaf over c'
  // ascending, then one subtraction); the tile's M rows staged first
  float* sM = sm + ly.m;
#pragma unroll
  for (int j = 0; j < (K + 1) / 2; ++j) {
    const int e = tid + kThreads * j;
    if (e < nrows * K) sM[e] = mreg[j];
  }
  __syncthreads();
  float* Y = a.Y + rowg * K;
  float* SQ = a.SQ + rowg * K;
  for (int e = tid; e < nrows * K; e += kThreads) {
    const int r = e / K, c = e - r * K;
    const float* zr = sP + r * PP + 8 * NY;
    float mz = 0.0f;
#pragma unroll
    for (int c2 = 0; c2 < K; ++c2) {
      const int l = min(c, c2), h = max(c, c2);
      mz = __fmaf_rn(sM[r * K + c2], zr[l * K - l * (l - 1) / 2 + (h - l)],
                     mz);
    }
    Y[e] = __fsub_rn(sP[r * PP + c], mz);
    SQ[e] = zr[c * K - c * (c - 1) / 2];
  }
}

// ---------------------------------------------------------------------
// mma_tiles_kernel<NCT, NS>: k > 12, [O | Q] in column tiles
// ---------------------------------------------------------------------

// a tile's Z list packs a column of the tile (7 bits), the diagonal's
// mark and an address in a row's k x k (23 bits): k up to 2896
constexpr int kListMaxKK = 1 << 23;

// mma_tiles_kernel's shared memory in floats (ops/tables_cuda.
// _tile_floats): a ring of NS stages of X, W and O's rows, then one
// column tile's [O | Q] in TF32 halves (2 x NCT n-blocks x L / 4 core
// matrices) and its column codes (8 NCT ints); after the loop the block's
// partials (KW x RT rows, PP apart) in the same space; then the flags
// (2k), two ints and the ring's mbarriers.
struct TileLayout {
  int RT, KW, L, lgL, KC, PP, w, o, b, half, code, flag, bar, floats;
};

__host__ __device__ inline TileLayout tile_layout(int k, int RW, int NCT,
                                                  int NS) {
  TileLayout l;
  l.KW = kMmaWarps / RW;
  l.RT = 16 * RW;
  l.L = 16 * l.KW * (l.KW == 1 ? 2 : 1);
  l.lgL = l.L == 32 ? 5 : 6;
  l.KC = l.L / 4;
  l.PP = 8 * NCT + 1;
  l.w = NS * l.RT * l.L;
  l.o = 2 * l.w;
  l.b = l.o + NS * l.L * k;
  l.half = NCT * l.KC * kCM;
  l.code = l.b + 2 * l.half;
  const int staging = l.code + 8 * NCT;
  const int after = l.KW * l.RT * l.PP;
  l.flag = staging > after ? staging : after;
  l.bar = (l.flag + 2 * k + 2) / 2 * 2;  // 8-byte aligned
  l.floats = l.bar + 2 * NS;
  return l;
}

// wgmma, one group's products over a column tile of NCT n-blocks, six
// (the 3xTF32 split, small ones first, from zero) with A fragments y (0:
// X W's, 1: W's), into d, committed and not waited for
template <int NCT>
__device__ __forceinline__ void tile_issue(float (&d)[4 * NCT],
                                           const GroupA& A, int y,
                                           const uint32_t* b, int half,
                                           int sbo) {
  const int lbo = 4 * kCM, sbo_b = 4 * sbo;
#pragma unroll
  for (int e = 0; e < 4 * NCT; ++e) d[e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t* bb = b + 2 * s * kCM;
    const uint64_t db = gmma_desc(bb, lbo, sbo_b);
    const uint64_t ds = gmma_desc(bb + half, lbo, sbo_b);
    Wgmma<8 * NCT>::run(d, y ? A.small[1][s] : A.small[0][s], db, s);
    Wgmma<8 * NCT>::run(d, y ? A.big[1][s] : A.big[0][s], ds, 1);
    Wgmma<8 * NCT>::run(d, y ? A.big[1][s] : A.big[0][s], db, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits for tile_issue's products and adds those of the n-blocks that
// take them (y 0: Y's, the tile's first ny; 1: the rest) to acc
template <int NCT>
__device__ __forceinline__ void tile_finish(float (&acc)[NCT][4],
                                            float (&d)[4 * NCT], int y,
                                            int ny) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
#pragma unroll
  for (int j = 0; j < NCT; ++j)
    if ((j < ny) == (y == 0))
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fadd_rn(acc[j][e], d[4 * j + e]);
}

// mma.sync (the short-row form), one group over a column tile: n-block j
// takes X W's fragments where j < ny, else W's (group_mma's products)
template <int NCT>
__device__ __forceinline__ void group_mma_tile(float (&acc)[NCT][4],
                                               const GroupA& A,
                                               const uint32_t* hb,
                                               const uint32_t* hs, int sbo,
                                               int ny) {
#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    const bool y = j < ny;
    uint32_t bb[4], bs[4];
    ldmatrix_x4(bb, hb + j * sbo);
    ldmatrix_x4(bs, hs + j * sbo);
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t as[4], ab[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        as[e] = y ? A.small[0][s][e] : A.small[1][s][e];
        ab[e] = y ? A.big[0][s][e] : A.big[1][s][e];
      }
      mma_tf32(d, as, bb[2 * s], bb[2 * s + 1]);
      mma_tf32(d, ab, bs[2 * s], bs[2 * s + 1]);
      mma_tf32(d, ab, bb[2 * s], bb[2 * s + 1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], d[e]);
  }
}

// mma_kernel's design with k a parameter, a ring of NS stages and [O |
// Q]'s NT8 columns in acc_tiles column tiles of 8 NCT: a block (row tile,
// column tile, split, chain) forms only its tile's columns a stage, and
// stages X only where its tile holds Y's columns (Y's ceil(k / 8)
// n-blocks from tile 0 on, NCT a tile). A tile's sums (its splits added
// in split order by the last of them, as mma_kernel does) go out at once:
// Z's entries of the tile in the order of their addresses (the plan's
// list, ops/tables_cuda.tile_list), SQ, and its columns of (X W) O into
// Y; the last of a row tile's column tiles to finish (a second counter)
// then forms Y = (X W) O - M Z from them, as mma_kernel does in-block.
template <int NCT, int NS>
__global__ void __launch_bounds__(kThreads, NCT > 8 ? 2 : 3)
    mma_tiles_kernel(const __grid_constant__ MmaArgs p) {
  const Args& a = p.a;
  constexpr int NC = 8 * NCT, LIST = 2 * NC / 32;  // a lane's list entries
  const int k = a.k;
  const TileLayout ly = tile_layout(k, a.RW, NCT, NS);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sX = sm;
  float* sW = sm + ly.w;
  float* sO = sm + ly.o;
  uint32_t* sB = reinterpret_cast<uint32_t*>(sm + ly.b);
  int* sCode = reinterpret_cast<int*>(sm + ly.code);
  int* sFlag = reinterpret_cast<int*>(sm + ly.flag);
  int* sLast = sFlag + 2 * k;
  const int RT = ly.RT, KW = ly.KW, L = ly.L, lgL = ly.lgL, PP = ly.PP;
  const int half = ly.half, sbo = ly.KC * kCM;
  const bool wg = a.RW == kMmaWarps;  // the tensor-core form: wgmma
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp / KW, kw = warp - rw * KW;
  const int chain = blockIdx.z, s = blockIdx.y, tile = blockIdx.x;
  const int rt = tile / a.acc_tiles, at = tile - rt * a.acc_tiles;
  const int row0 = rt * RT;
  const int lo = s * a.CH, hi = min(lo + a.CH, a.m);
  const int NY = (k + 7) / 8;
  // the tile's n-blocks of Y: its first ny, in the first ytiles tiles
  const int ytiles = (NY + NCT - 1) / NCT;
  const int ny = at < ytiles ? min(NY - at * NCT, NCT) : 0;
  const bool has_y = ny > 0;
  // col_nz's flags of tile 0's Y columns, set as it forms them (a test
  // of blockIdx.x alone: deriving it from ytiles in the forming cost
  // 0.7308 -> 0.7830 ms at 4 x 5000 x 2000 A k=20, NVIDIA H100 80GB HBM3,
  // 700 W); Y's other tiles' after the loop
  const bool flag_block = tile == 0;
  const float* D = a.D + chain * a.cD;
  const float* W = a.W + chain * a.cW;
  const float* O = a.O + chain * a.cO;
  for (int c = tid; c < 2 * k; c += kThreads) sFlag[c] = 0;
  // the tile's columns: Y's column c as (c << 16) | kY, pair (c, c') as
  // (c << 16) | c', padding -1
  for (int j = tid; j < NC; j += kThreads) {
    const int n = at * NC + j;
    int code = -1;
    if (n < 8 * NY) {
      if (n < k) code = (n << 16) | kY;
    } else if (n - 8 * NY < a.npairs) {
      int c, c2;
      decode_pair(n - 8 * NY, k, c, c2);
      code = (c << 16) | c2;
    }
    sCode[j] = code;
  }
  __syncthreads();
  // this lane's columns of the forming: n-block warp + 4 jj, column l / 4
  // of it; c < 0 past the last pair, c2 kY for Y's columns
  static_assert(NCT % kMmaWarps == 0, "n-blocks spread evenly");
  constexpr int NJ = NCT / kMmaWarps;
  int fc[NJ], fc2[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int code = sCode[8 * (warp + kMmaWarps * jj) + (lane >> 2)];
    fc[jj] = code < 0 ? -1 : code >> 16;
    fc2[jj] = code < 0 ? 0 : code & 0xFFFF;
  }

  float acc[NCT][4];
#pragma unroll
  for (int j = 0; j < NCT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  const int n_sub = hi > lo ? (hi - lo + L - 1) / L : 0;
  const bool bulk = a.vec == 2;
  uint64_t* sBar = reinterpret_cast<uint64_t*>(sm + ly.bar);
  if (bulk && tid == 0) {
    for (int q = 0; q < NS; ++q) mbar_init(sBar + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (bulk) __syncthreads();
  // stage t: partners [lo + t L, + L) into ring slot t % NS: X (where
  // the tile holds Y) and W rows L apart, O's rows k apart (zeros past hi
  // and past R)
  auto stage = [&](int t) {
    const int slot = t % NS, i0 = lo + t * L;
    const int nval = min(L, hi - i0);
    float* x = sX + slot * RT * L;
    float* w = sW + slot * RT * L;
    float* o = sO + slot * L * k;
    if (bulk) {  // one thread: X's and W's tiles by TMA, O's rows in bulk
      if (tid != kThreads - 32) return;
      for (int e = nval * k; e < L * k; e++) o[e] = 0.0f;  // past m
      mbar_expect_tx(sBar + slot,
                     (has_y ? 8u : 4u) * RT * L + 4u * nval * k);
      if (has_y)
        tma_load_3d(x, &p.mapD, i0, row0, a.cD ? chain : 0, sBar + slot);
      tma_load_3d(w, &p.mapW, i0, row0, a.cW ? chain : 0, sBar + slot);
      bulk_copy(o, O + (size_t)i0 * k, 4u * nval * k, sBar + slot);
      return;
    }
    if (a.vec) {  // hi and i0 are multiples of 4: a piece is in or out
      for (int e = tid; e < RT * L / 4; e += kThreads) {
        const int rr = e >> (lgL - 2), ii = 4 * (e & (L / 4 - 1));
        const int row = row0 + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        if (has_y) cp_async16(x + rr * L + ii, D + off, ok);
        cp_async16(w + rr * L + ii, W + off, ok);
      }
    } else {
      for (int e = tid; e < RT * L; e += kThreads) {
        const int rr = e >> lgL, ii = e & (L - 1);
        const int row = row0 + rr, i = i0 + ii;
        const bool ok = row < a.R && i < hi;
        const size_t off = ok ? (size_t)row * a.m + i : 0;
        if (has_y) cp_async4(x + rr * L + ii, D + off, ok);
        cp_async4(w + rr * L + ii, W + off, ok);
      }
    }
    for (int e = tid; e < L * k; e += kThreads) {
      const bool ok = e < nval * k;
      cp_async4(o + e, O + (ok ? (size_t)i0 * k + e : 0), ok);
    }
    cp_async_commit();
  };

  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_sub)
      stage(t);
    else if (!bulk)
      cp_async_commit();
  }
  for (int t = 0; t < n_sub; ++t) {
    if (bulk)
      mbar_wait(sBar + t % NS, (t / NS) & 1);
    else
      cp_async_wait<NS - 2>();
    __syncthreads();  // stage t is in; every thread is past stage t - 1
    if (t + NS - 1 < n_sub)
      stage(t + NS - 1);  // into stage t - 1's slot
    else if (!bulk)
      cp_async_commit();
    const int slot = t % NS;
    const float* o = sO + slot * L * k;
    // the tile's [O | Q] for places [4 cm0, 4 cm1) of the stage: warp w
    // n-blocks w + 4 jj, a core matrix at a time, lane l at column l / 4
    // and place 4 cm + l % 4 (partner 4 (l % 4) + cm % 4 of its group of
    // 16), its 32 words in 32 banks; then the fence and barrier after
    // which the tensor cores may read them
    auto form = [&](int cm0, int cm1) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = fc[jj], c2 = fc2[jj];
        const bool pad = c < 0, y = c2 == kY;
        const int oc1 = pad ? 0 : c, oc2 = pad || y ? 0 : c2;
        uint32_t* cell = sB + (warp + kMmaWarps * jj) * sbo + lane;
#pragma unroll 4
        for (int cm = cm0; cm < cm1; ++cm) {
          const float* orow =
              o + (16 * (cm >> 2) + 4 * (lane & 3) + (cm & 3)) * k;
          const float a1 = orow[oc1];
          const float a2 = y ? 1.0f : orow[oc2];
          const float v = pad ? 0.0f : __fmul_rn(a1, a2);  // Y's: a1
          if (flag_block && y) {
            if (v > 0.0f) sFlag[c] = 1;
            if (v != v) sFlag[k + c] = 1;
          }
          uint32_t big, small;
          tf32_split(v, big, small);
          cell[cm * kCM] = big;
          cell[cm * kCM + half] = small;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    };
    const float* xr = sX + (slot * RT + 16 * rw + gq) * L;
    const float* wr = sW + (slot * RT + 16 * rw + gq) * L;
    // group grp's A fragments: W's, and X W's where the tile holds Y
    auto frags = [&](int grp, GroupA& A) {
      const int col = 16 * grp + 4 * tq;
      const float4 wa = *reinterpret_cast<const float4*>(wr + col);
      const float4 wb = *reinterpret_cast<const float4*>(wr + 8 * L + col);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        tf32_split(lane_of(wa, 2 * s2), A.big[1][s2][0], A.small[1][s2][0]);
        tf32_split(lane_of(wb, 2 * s2), A.big[1][s2][1], A.small[1][s2][1]);
        tf32_split(lane_of(wa, 2 * s2 + 1), A.big[1][s2][2],
                   A.small[1][s2][2]);
        tf32_split(lane_of(wb, 2 * s2 + 1), A.big[1][s2][3],
                   A.small[1][s2][3]);
      }
      if (has_y) {  // X W: Y = (X W) O - M Z, row by row
        const float4 xa = *reinterpret_cast<const float4*>(xr + col);
        const float4 xb = *reinterpret_cast<const float4*>(xr + 8 * L + col);
        float ta[4], tb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ta[e] = __fmul_rn(lane_of(xa, e), lane_of(wa, e));
          tb[e] = __fmul_rn(lane_of(xb, e), lane_of(wb, e));
        }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          tf32_split(ta[2 * s2], A.big[0][s2][0], A.small[0][s2][0]);
          tf32_split(tb[2 * s2], A.big[0][s2][1], A.small[0][s2][1]);
          tf32_split(ta[2 * s2 + 1], A.big[0][s2][2], A.small[0][s2][2]);
          tf32_split(tb[2 * s2 + 1], A.big[0][s2][3], A.small[0][s2][3]);
        }
      } else {
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            A.big[0][s2][e] = A.small[0][s2][e] = 0u;
      }
    };
    if (wg) {
      // the tensor-core form, two groups a stage: group 1's [O | Q] is
      // formed while group 0's W products run; X W's (the tile holding
      // Y) run before them, waited for
      float d[4 * NCT];
      form(0, 4);
#pragma unroll 1
      for (int grp = 0; grp < 2; ++grp) {
        GroupA A;
        frags(grp, A);
        const uint32_t* b = sB + 4 * grp * kCM;
        if (has_y) {
          tile_issue<NCT>(d, A, 0, b, half, sbo);
          tile_finish<NCT>(acc, d, 0, ny);
        }
        tile_issue<NCT>(d, A, 1, b, half, sbo);
        if (grp == 0) form(4, 8);
        tile_finish<NCT>(acc, d, 1, ny);
      }
    } else {
      form(0, L >> 2);
      for (int grp = kw; grp < L / 16; grp += KW) {  // this warp's groups
        GroupA A;
        frags(grp, A);
        const uint32_t* b = sB + 4 * grp * kCM;  // the group's core matrices
        const uint32_t* hb = b + (lane >> 3) * kCM + 4 * (lane & 7);
        group_mma_tile<NCT>(acc, A, hb, hb + half, sbo, ny);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: the block's partials go there

  float* sP = sm;
  {
    float* p0 = sP + (kw * RT + 16 * rw + gq) * PP + 2 * tq;
#pragma unroll
    for (int j = 0; j < NCT; ++j) {
      p0[8 * j] = acc[j][0];
      p0[8 * j + 1] = acc[j][1];
      p0[8 * PP + 8 * j] = acc[j][2];
      p0[8 * PP + 8 * j + 1] = acc[j][3];
    }
  }
  __syncthreads();
  const int nrows = min(RT, a.R - row0);  // the tile's rows in R
  const int ent = nrows * NC;
  for (int e = tid; KW > 1 && e < ent; e += kThreads) {  // warps in order
    const int r = e / NC, n = e - r * NC;
    float v = sP[r * PP + n];
    for (int q = 1; q < KW; ++q) v = v + sP[(q * RT + r) * PP + n];
    sP[r * PP + n] = v;
  }

  // the tile's Y columns [y0, y1): ncy of them; in row tile 0 their
  // col_nz flags, past tile 0's (k > 128) from O's rows of the split
  const int y0 = at * NC, ncy = has_y ? min(k - y0, NC) : 0, y1 = y0 + ncy;
  const bool flags_here = tile < ytiles;
  if (flags_here && !flag_block) {
    for (int e = tid; e < (hi - lo) * ncy; e += kThreads) {
      const int i = e / ncy, c = y0 + e - i * ncy;
      const float v = __ldg(O + (size_t)(lo + i) * k + c);
      if (v > 0.0f) sFlag[c] = 1;
      if (v != v) sFlag[k + c] = 1;
    }
    __syncthreads();
  }
  const int k2 = 2 * k;
  // flag e of the tile's 2 ncy: positive seen, then NaN seen, of [y0, y1)
  const auto flag_of = [&](int e) {
    return e < ncy ? y0 + e : k + y0 + e - ncy;
  };
  if (a.S > 1) {
    const int blk = chain * gridDim.x + tile;
    const size_t slab = (size_t)RT * NC;  // a split's partials
    float* base = a.part + (size_t)blk * a.S * slab;
    float* mine = base + (size_t)s * slab;
    for (int e = tid; e < ent; e += kThreads) {
      const int r = e / NC;
      mine[e] = sP[r * PP + e - r * NC];
    }
    if (flags_here)
      for (int e = tid; e < 2 * ncy; e += kThreads) {
        const int c = flag_of(e);
        a.flags[((size_t)chain * a.S + s) * k2 + c] = sFlag[c];
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) *sLast = atomicAdd(&a.counters[blk], 1) == a.S - 1;
    __syncthreads();
    if (!*sLast) return;
    __threadfence();
    // every split's partials, added in split order, as mma_kernel does
    const float4* b4 = reinterpret_cast<const float4*>(base);
    const size_t slab4 = slab / 4;
    const int ent4 = ent / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e4 = tid; e4 < ent4; e4 += 2 * kThreads) {
      const int f4 = e4 + kThreads;
      const bool two = f4 < ent4;
      float4 va = __ldcg(b4 + e4);
      float4 vb = two ? __ldcg(b4 + f4) : zero;
      int s2 = 1;
      for (; s2 + 8 <= a.S; s2 += 8) {
        float4 xa[8], xb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          xa[u] = __ldcg(b4 + (s2 + u) * slab4 + e4);
          xb[u] = two ? __ldcg(b4 + (s2 + u) * slab4 + f4) : zero;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          add_to(va, xa[u]);
          add_to(vb, xb[u]);
        }
      }
      for (; s2 < a.S; ++s2) {
        add_to(va, __ldcg(b4 + s2 * slab4 + e4));
        if (two) add_to(vb, __ldcg(b4 + s2 * slab4 + f4));
      }
      for (int h = 0; h < 2; ++h) {  // four entries of one row
        if (h == 1 && !two) break;
        const int e = 4 * (h == 0 ? e4 : f4);
        const int r = e / NC, n = e - r * NC;
        const float4 v = h == 0 ? va : vb;
        float* q = sP + r * PP + n;
        q[0] = v.x;
        q[1] = v.y;
        q[2] = v.z;
        q[3] = v.w;
      }
    }
    if (flags_here)
      for (int e = tid; e < 2 * ncy; e += kThreads) {
        const int c = flag_of(e);
        int any = 0;
        for (int s3 = 0; s3 < a.S; ++s3)
          any |= __ldcg(&a.flags[((size_t)chain * a.S + s3) * k2 + c]);
        sFlag[c] = any;
      }
    if (tid == 0) a.counters[blk] = 0;
  }
  __syncthreads();

  if (flags_here)
    for (int c = y0 + tid; c < y1; c += kThreads)
      a.col_nz[(size_t)chain * k + c] = sFlag[c] && !sFlag[k + c];
  // the tile's Z entries a warp a row, in the order of their addresses;
  // SQ on the diagonal; the tile's columns of (X W) O into Y, for the
  // last tile
  const int kk = k * k;
  const size_t rowg = (size_t)chain * a.R + row0;
  // this lane's entries of the tile's Z list: column, the diagonal's mark
  // (0x80) and address in a row's k x k (from bit 8), packed; -1 past its
  // end; on the diagonal SQ's column, address / (k + 1), else -1
  int zl[LIST], sq[LIST];
  const int* list = a.zlist + (size_t)at * 2 * NC;
#pragma unroll
  for (int j = 0; j < LIST; ++j) {
    zl[j] = __ldg(list + lane + 32 * j);
    sq[j] = zl[j] >= 0 && (zl[j] & 0x80) ? (zl[j] >> 8) / (k + 1) : -1;
  }
  for (int r = warp; r < nrows; r += kMmaWarps) {
    const float* pr = sP + r * PP;
    float* zr = a.Z + (rowg + r) * kk;
#pragma unroll
    for (int j = 0; j < LIST; ++j) {
      const int x = zl[j];
      if (x < 0) continue;
      const float v = pr[x & 0x7F];
      zr[x >> 8] = v;
      if (sq[j] >= 0) a.SQ[(rowg + r) * k + sq[j]] = v;
    }
  }
  float* Y = a.Y + rowg * k;
  for (int e = tid; e < nrows * ncy; e += kThreads) {
    const int r = e / ncy, j = e - r * ncy;
    Y[(size_t)r * k + y0 + j] = sP[r * PP + j];
  }
  if (a.acc_tiles > 1) {  // the last of the row tile's column tiles on
    int* rows_done = a.counters + (size_t)gridDim.z * gridDim.x;
    const size_t rc = (size_t)chain * (gridDim.x / a.acc_tiles) + rt;
    __threadfence();
    __syncthreads();
    if (tid == 0)
      *sLast = atomicAdd(&rows_done[rc], 1) == a.acc_tiles - 1;
    __syncthreads();
    if (!*sLast) return;
    __threadfence();
    if (tid == 0) rows_done[rc] = 0;
  } else {
    __syncthreads();
  }
  // Y = (X W) O - M Z, M Z by an fmaf chain over c' ascending, as
  // mma_kernel forms it: the row tile's Z and M rows staged in shared
  // memory (the ring and the partials are free), `per` rows at a time,
  // or where one row's k x k does not fit (k > ~170) a row's Z in chunks
  // of n2 rows c', the chains carried from chunk to chunk in sMZ
  const float* M = a.M + chain * a.cM + (size_t)row0 * k;
  const float* Z = a.Z + rowg * kk;
  const int per = max(1, ly.flag / (kk + 2 * k));
  const int n2 = kk + 2 * k <= ly.flag
                     ? k
                     : max(4, (ly.flag - 2 * k) / k / 4 * 4);
  for (int r0 = 0; r0 < nrows; r0 += per) {
    const int nr = min(per, nrows - r0);
    float* sZ = sm;
    float* sMr = sm + nr * n2 * k;
    float* sMZ = sMr + nr * k;
    for (int c0 = 0; c0 < k; c0 += n2) {
      const int nc2 = min(n2, k - c0);
      // rows [r0, r0 + nr) x c' in [c0, c0 + nc2): contiguous, as nr is 1
      // or nc2 is k
      const float* zs = Z + (size_t)r0 * kk + (size_t)c0 * k;
      const int nz = nr * nc2 * k;
      __syncthreads();  // the last rows' or chunk's reads are done
      // from L2, not L1 (the other tiles wrote them): in 16-byte pieces
      // by cp.async.cg, every piece of the pass in flight at once
      if ((kk & 3) == 0) {  // c0 and n2 are multiples of 4
        for (int e = tid; e < nz / 4; e += kThreads)
          cp_async16(sZ + 4 * e, zs + 4 * e, true);
      } else {
#pragma unroll 8
        for (int e = tid; e < nz; e += kThreads) sZ[e] = __ldcg(zs + e);
      }
      if (c0 == 0)
        for (int e = tid; e < nr * k; e += kThreads)
          cp_async4(sMr + e, M + (size_t)r0 * k + e, true);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int e = tid; e < nr * k; e += kThreads) {
        const int r = e / k, c = e - r * k;
        const float* zc = sZ + r * nc2 * k + c;
        const float* mr = sMr + r * k + c0;
        float mz = c0 == 0 ? 0.0f : sMZ[e];
        for (int c2 = 0; c2 < nc2; ++c2)
          mz = __fmaf_rn(mr[c2], zc[c2 * k], mz);
        if (c0 + nc2 < k) {
          sMZ[e] = mz;
        } else {
          const size_t y = (size_t)r0 * k + e;
          Y[y] = __fsub_rn(__ldcg(Y + y), mz);
        }
      }
    }
  }
}

template <typename Kernel, typename P>
int launch(Kernel kernel, int& smem_set, const P& params, const Args& a,
           int nch, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int row_tiles = (a.R + a.RT - 1) / a.RT;
  const dim3 grid(row_tiles * a.acc_tiles, a.S, nch);
  kernel<<<grid, kThreads, smem, stream>>>(params);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rows(const Args& a, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(rows_kernel<K>, smem_set, a, a, nch, smem, stream);
}

template <int PQ>
int launch_quads(const Args& a, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(quads_kernel<PQ>, smem_set, a, a, nch, smem, stream);
}

template <int K>
int launch_mma(const MmaArgs& p, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(mma_kernel<K>, smem_set, p, p.a, nch, smem, stream);
}

template <int NCT, int NS>
int launch_tiles(const MmaArgs& p, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(mma_tiles_kernel<NCT, NS>, smem_set, p, p.a, nch, smem,
                stream);
}


constexpr int kBad = (int)cudaErrorInvalidValue;

// The copy engine's map of a float32 (m, R, chains) tensor, chains
// stride floats apart, in boxes of box_m x box_r x 1: what lies past m
// or R reads as zeros. cuTensorMapEncodeTiled is libcuda's, found at
// first use through the runtime.
int tensor_map(CUtensorMap* map, const float* base, int m, int R, int nch,
               long long stride, int box_m, int box_r) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault) != cudaSuccess ||
        fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)m, (cuuint64_t)R, (cuuint64_t)nch};
  const cuuint64_t strides[2] = {
      4ull * m, 4ull * (stride ? stride : (long long)R * m)};
  const cuuint32_t box[3] = {(cuuint32_t)box_m, (cuuint32_t)box_r, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBad;
}

}  // namespace

// The plan's fields (ops/tables_cuda.tables_plan) and the tensors: form 0
// runs rows_kernel<k>, 1 quads_kernel<PQ> (PQ one of ops/tables_cuda.QUADS),
// 2 mma_kernel<k> with RW row warps (k <= 12), or above mma_tiles_kernel
// <NCT, stages> in acc_tiles column tiles, whose Z lists zlist holds.
extern "C" int cogaps_tables_launch(
    int nch, int R, int m, int k, int form, int G, int PQ, int TQ,
    int acc_tiles, int S, int CH, int L, int smq, int RW, int NCT,
    int stages, int smem,
    const float* D, long long cD, const float* W, long long cW,
    const float* M, long long cM, const float* O, long long cO, float* Y,
    float* SQ, float* Z, unsigned char* col_nz, float* part, int* flags,
    int* counters, const int* zlist, void* stream) {
  const bool tiles = form == 2 && k > kRowsMaxK;
  const int nt = (k + 7) / 8 + (k * (k + 1) / 2 + 7) / 8;  // n-blocks
  if (nch < 1 || nch > 65535 || R < 1 || m < 0 || k < 1 || k >= 0xFFFF ||
      G < 1 || kThreads % G || S < 1 || S > 65535 || L < 1 || CH < L ||
      form < 0 || form > 2 ||
      (form != 1 && G != 1) ||
      (form != 1 && !tiles && (k > kRowsMaxK || acc_tiles != 1)) ||
      (tiles && ((long long)k * k >= kListMaxKK ||
                 (NCT != 8 && NCT != 16) ||
                 (stages != 3 && (stages != 2 || NCT != 16)) ||
                 acc_tiles != (nt + NCT - 1) / NCT || zlist == nullptr ||
                 counters == nullptr)) ||
      (S > 1 && (part == nullptr || counters == nullptr || flags == nullptr)))
    return kBad;
  int RT = kThreads / G;
  if (form == 2) {
    const int lay_L =
        tiles ? tile_layout(k, RW, NCT, stages).L : mma_layout(k, RW).L;
    const int floats = tiles ? tile_layout(k, RW, NCT, stages).floats
                             : mma_layout(k, RW).floats;
    if ((RW != 1 && RW != 2 && RW != 4) || L != lay_L || CH % L ||
        smem < 4 * floats)
      return kBad;
    RT = 16 * RW;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // X and W rows in 16-byte pieces (1); mma_kernel's bulk copies, O's
  // rows too (2)
  int vec = m % 4 == 0 && L % 4 == 0 && CH % 4 == 0 && aligned(D) &&
            aligned(W) && cD % 4 == 0 && cW % 4 == 0;
  if (vec && form == 2 && aligned(O) && cO % 4 == 0) vec = 2;
  const Args a{D, W, M, O, cD, cW, cM, cO, Y, SQ, Z, col_nz,
               part, flags, counters, zlist, R, m, k, (k + 3) / 4,
               k * (k + 1) / 2, G, RT, TQ, acc_tiles, S, CH, L,
               smq, RW, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 2) {
    MmaArgs p{a, {}, {}};
    if (vec == 2) {
      const int err = tensor_map(&p.mapD, D, m, R, cD ? nch : 1, cD, L, RT);
      if (err) return err;
      const int err2 = tensor_map(&p.mapW, W, m, R, cW ? nch : 1, cW, L, RT);
      if (err2) return err2;
    }
    if (tiles)
      return NCT == 8       ? launch_tiles<8, 3>(p, nch, smem, s)
             : stages == 3 ? launch_tiles<16, 3>(p, nch, smem, s)
                           : launch_tiles<16, 2>(p, nch, smem, s);
    switch (k) {
      case 1: return launch_mma<1>(p, nch, smem, s);
      case 2: return launch_mma<2>(p, nch, smem, s);
      case 3: return launch_mma<3>(p, nch, smem, s);
      case 4: return launch_mma<4>(p, nch, smem, s);
      case 5: return launch_mma<5>(p, nch, smem, s);
      case 6: return launch_mma<6>(p, nch, smem, s);
      case 7: return launch_mma<7>(p, nch, smem, s);
      case 8: return launch_mma<8>(p, nch, smem, s);
      case 9: return launch_mma<9>(p, nch, smem, s);
      case 10: return launch_mma<10>(p, nch, smem, s);
      case 11: return launch_mma<11>(p, nch, smem, s);
      case 12: return launch_mma<12>(p, nch, smem, s);
      default: return kBad;
    }
  }
  if (form == 0) {
    switch (k) {
      case 1: return launch_rows<1>(a, nch, smem, s);
      case 2: return launch_rows<2>(a, nch, smem, s);
      case 3: return launch_rows<3>(a, nch, smem, s);
      case 4: return launch_rows<4>(a, nch, smem, s);
      case 5: return launch_rows<5>(a, nch, smem, s);
      case 6: return launch_rows<6>(a, nch, smem, s);
      case 7: return launch_rows<7>(a, nch, smem, s);
      case 8: return launch_rows<8>(a, nch, smem, s);
      case 9: return launch_rows<9>(a, nch, smem, s);
      case 10: return launch_rows<10>(a, nch, smem, s);
      case 11: return launch_rows<11>(a, nch, smem, s);
      case 12: return launch_rows<12>(a, nch, smem, s);
      default: return kBad;
    }
  }
  switch (PQ) {
    case 1: return launch_quads<1>(a, nch, smem, s);
    case 2: return launch_quads<2>(a, nch, smem, s);
    case 3: return launch_quads<3>(a, nch, smem, s);
    case 4: return launch_quads<4>(a, nch, smem, s);
    case 6: return launch_quads<6>(a, nch, smem, s);
    case 8: return launch_quads<8>(a, nch, smem, s);
    case 9: return launch_quads<9>(a, nch, smem, s);
    case 11: return launch_quads<11>(a, nch, smem, s);
    case 15: return launch_quads<15>(a, nch, smem, s);
    case 17: return launch_quads<17>(a, nch, smem, s);
    case 20: return launch_quads<20>(a, nch, smem, s);
    default: return kBad;
  }
}
