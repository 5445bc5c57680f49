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
//   Z[r,c,c'] = sum_i W[r,i] O[i,c] O[i,c']     (c <= c'; mirrored)
//   SQ[r,c]   = Z[r,c,c],   col_nz[c] = max_i O[i,c] > 0
// in float32, as models/dense.tables_plain forms them.
//
// Its summation order is the plan's alone (ops/tables_cuda.tables_plan:
// R, m, k and the SM count, never the chain count or a chain's index), so
// a chain's bits do not follow the chains that share its call; cuBLAS picks
// its kernel, and with it a float32 sum's order, by the batch count. The
// grid is (row tiles x accumulator tiles, contraction splits, chains): more
// chains add blocks and change no block's work. A block covers RT rows of
// one chain and the partners of one fixed chunk of the contraction, in
// sub-tiles of L partners staged in shared memory by cp.async, the next
// sub-tile in flight while the block works on this one: X and W
// (coalesced rows) and O's rows. Each thread keeps its row's accumulators
// in registers, the Y entries and Z's upper triangle, and forms the
// residual once a partner (fmaf over c ascending). Two kernels, as the plan
// says:
//   - rows_kernel<K> (k <= 12, more rows than half a block): a thread a
//     row, K + K(K+1)/2 float accumulators (65 at k=10), the partner's
//     row in registers; per partner t O_c for Y and (W O_c) O_c' for Z,
//     one fmaf each, with five shared-memory loads;
//   - quads_kernel<PQ> (any k, or few rows): after O's rows, a row of
//     "columns" a partner, [O_c | O_c O_c'], formed once a partner and
//     block, and each thread PQ quads of them (float4 accumulators), G
//     threads sharing a row where its quads exceed PQ or the rows are too
//     few to fill the block; one fmaf a column, a 16-byte broadcast load
//     for four. Above G = 32 (k > ~35) the accumulators are tiled over
//     blocks too, each forming the residual again.
// A contraction split into S chunks writes its partials, and the last
// block of its (chain, tile) to finish (an integer counter, left 0) adds
// them in split order, 0 to S - 1; no float atomics, so two runs give the
// same bits.
//
// What bounds it on the H100: bytes. D and W are read once, 8 bytes an
// element, against 2 + 4k + k(k+1) float32 operations (152 at k=10: 19
// operations a byte against the card's 67e12 / 3.35e12 = 20): at 4 x 5000
// x 2000 k=10 both samplers move 0.64 GB: ~0.19 ms at the 3.35 TB/s of
// the H100 SXM data sheet. The design keeps it one pass over D and W, the
// staging of the next sub-tile behind the work on this one; the
// instructions around each fmaf (shared-memory loads, the quads'
// selects) and the blocks a card holds at once are what is left.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // ops/tables_cuda.THREADS
constexpr int kY = 0xFFFF;     // a column code's partner for a Y column
constexpr int kRowsMaxK = 12;  // ops/tables_cuda.ROWS_MAX_K

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
  int* counters;  // (chains, tiles) blocks done, left 0 by the last
  int R, m, k, qy, npairs;
  int G, RT, TQ, acc_tiles, S, CH, L, smq;
  int vec;  // X and W rows in 16-byte pieces: m % 4 == 0, aligned
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

template <typename Kernel>
int launch(Kernel kernel, int& smem_set, const Args& a, int nch, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int row_tiles = (a.R + a.RT - 1) / a.RT;
  const dim3 grid(row_tiles * a.acc_tiles, a.S, nch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int launch_rows(const Args& a, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(rows_kernel<K>, smem_set, a, nch, smem, stream);
}

template <int PQ>
int launch_quads(const Args& a, int nch, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  return launch(quads_kernel<PQ>, smem_set, a, nch, smem, stream);
}

constexpr int kBad = (int)cudaErrorInvalidValue;

}  // namespace

// The plan's fields (ops/tables_cuda.tables_plan) and the tensors: PQ 0
// runs rows_kernel<k>, else quads_kernel<PQ> (PQ one of
// ops/tables_cuda.QUADS).
extern "C" int cogaps_tables_launch(
    int nch, int R, int m, int k, int G, int PQ, int TQ, int acc_tiles, int S,
    int CH, int L, int smq, int smem, const float* D, long long cD,
    const float* W, long long cW, const float* M, long long cM,
    const float* O, long long cO, float* Y, float* SQ, float* Z,
    unsigned char* col_nz, float* part, int* flags, int* counters,
    void* stream) {
  if (nch < 1 || nch > 65535 || R < 1 || m < 0 || k < 1 || k >= 0xFFFF ||
      G < 1 || kThreads % G || S < 1 || S > 65535 || L < 1 || CH < L ||
      (PQ == 0 && (G != 1 || k > kRowsMaxK || acc_tiles != 1)) ||
      (S > 1 && (part == nullptr || counters == nullptr || flags == nullptr)))
    return kBad;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = m % 4 == 0 && L % 4 == 0 && CH % 4 == 0 && aligned(D) &&
                  aligned(W) && cD % 4 == 0 && cW % 4 == 0;
  const Args a{D, W, M, O, cD, cW, cM, cO, Y, SQ, Z, col_nz,
               part, flags, counters, R, m, k, (k + 3) / 4,
               k * (k + 1) / 2, G, kThreads / G, TQ, acc_tiles, S, CH, L,
               smq, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (PQ == 0) {
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
