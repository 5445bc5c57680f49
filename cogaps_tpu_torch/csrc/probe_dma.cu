// The DMA probes' functions as kernels for Hopper (sm_90a).
//
// Replaces the pallas_call sites of tools/probe_dma.py (:56 p1's kern,
// :85 p2a, :112 p2b, :155 _mk_call's _gather_kernel), tools/probe_dma2.py
// (:68 _kern) and the exact gather and scatter kernels of
// tools/probe_mosaic5.py (:27 k_gather, k_gred, k_scatter). On the TPU a
// row of a table in HBM reaches the kernel by a DMA with a runtime offset,
// and a gather or scatter at lane indices by one-hot matmuls of 3-way bf16
// splits; on the H100 a thread loads what it needs. Plain versions and
// wrappers: cogaps_tpu_torch/probes/dma.py. Not carried over: the DMA
// semaphores and SMEM index copies, the bf16 splits, and probe_dma2's two
// pass counts R taken to cancel the TPU's dispatch cost (a launch is timed
// directly here).
//
//   F9 gather_rows     out[j, :] = tbl[idx[j], :] with float32 indices, or
//                      rows offset[0] + j with the offset read from device
//                      memory (p1). Bound by bytes: the rows written once
//                      (the table, 10 MB at K4's shape, stays in the 50 MB
//                      L2). A flat, streaming copy: the (B, K) output is
//                      walked in 16-byte pieces, each a float4 store with
//                      __stcs (evict-first, so the output does not push the
//                      table out of L2); a piece may straddle two rows when
//                      K % 4 != 0. Blocks take tiles of 1 or 2 pieces a
//                      thread in a grid-stride loop (probes/dma.gather_plan:
//                      up to 8 blocks an SM); a thread issues the table
//                      loads of its pieces (16-, 8- or 4-byte ones as K
//                      allows) before its stores, each piece's row index
//                      read through L1 beside them and its row found by a
//                      multiply and shifts (fast_div): a division
//                      instruction ahead of the index load cost the small
//                      gathers at the launch floor.
//   F9 gather_passes   R dependent passes: each gathers rows tbl[idx] into
//                      buf and sets idx = floor(idx * 0.5 + buf[:, 0]) % NB
//                      for the next; out = idx + buf[0, 0]. A warp a lane
//                      chain: it loads the chain's row as 16-byte pieces
//                      (one a thread at K = 128), writes it to buf and
//                      takes column 0 for its next index, so a pass costs
//                      one HBM round trip. Each warp also follows chain
//                      0's column 0, one 4-byte load beside its own row's,
//                      so buf[0, 0] needs no wait across blocks.
//   dependent_loads    the floor under gather_passes, not a TPU site: one
//                      lane's chain of n dependent 4-byte loads of column
//                      0, cur = floor(cur * 0.5 + tbl[cur, 0]) % NB from
//                      cur = idx[0] (gather_passes' index rule), out = cur.
//                      A pass can be no quicker than one such load.
//   F9 gather_batched  out[c, q, j] = tbl[c, idx[c, j], q]: probe_mosaic5's
//                      gather into the (K, B) layout (K = 1 is its flat
//                      table). A thread an output, j fastest.
//   F10 scatter_slots  out[c, slot[c, i]] = val[c, i] into zeros, slots
//                      unique in a chain. One block a chain: it zeroes its
//                      row, waits, then each lane stores its value.
//   F11 strided_sum    sum_{j<n} (x[stride j] * scale + shift), in order j
//                      (p2a: stride 7, x; p2b: stride 31, 2x + 1). One
//                      thread: a dependent chain of n loads and adds.
//
// All of these move a few hundred kilobytes at most, so launch and memory
// latency, not the bytes bound, set their times.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// probes/dma.py mirrors this (GATHER_THREADS)
constexpr int kGatherThreads = 256;

// Division of n < 2^32 by a d fixed for the launch, without a division
// instruction on the way to the index load (Granlund and Montgomery's
// round-up method, "Division by invariant integers using
// multiplication", 1994, fig. 4.1): m = floor(2^32 (2^l - d) / d) + 1,
// l = ceil(log2 d)
struct FastDiv {
  unsigned m;
  int sh1, sh2;
};

FastDiv make_div(unsigned d) {  // d >= 1
  int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long m = (((1ull << l) - d) << 32) / d + 1;
  return {(unsigned)m, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv d) {
  const unsigned t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}

// V floats of out from element f (counted from the start of row j0) on:
// tbl's row idx[j0 + f / K] (or offset + j0 + f / K), NaN where that names
// no row; the index is read through L1, where the other pieces of its row
// find it
template <int V>
__device__ __forceinline__ void load_at(int NB, int K, FastDiv by_k, int j0,
                                        int f, const float* __restrict__ tbl,
                                        const float* __restrict__ idx,
                                        long long base, float* v) {
  const int r = (int)fast_div((unsigned)f, by_k), col = f - r * K;
  const long long s = idx ? (long long)__ldg(idx + j0 + r) : base + j0 + r;
  if (s < 0 || s >= NB) {  // no such row: NaN, not a fault
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = nan_f();
    return;
  }
  const float* p = tbl + (size_t)s * K + col;
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

// V: the floats of one table load, 4 (K % 4 == 0), 2 (K % 2 == 0) or 1,
// with the table aligned to it; out is 16-byte aligned. A tile is
// kItems * kGatherThreads pieces of 16 bytes, piece it * kGatherThreads +
// x of it thread x's; a thread issues the loads of all its pieces before
// its stores.
template <int V, int kItems>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(int NB, int K, FastDiv by_k, int B,
                       const float* __restrict__ tbl,
                       const float* __restrict__ idx,
                       const int* __restrict__ offset,
                       float* __restrict__ out) {
  constexpr long long kTileFloats = 4LL * kItems * kGatherThreads;
  const long long n = (long long)B * K;  // floats of out
  const long long tiles = (n + kTileFloats - 1) / kTileFloats;
  const long long base = offset ? (long long)offset[0] : 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = tile * kTileFloats;
    int j0, rem;  // e0's row and column, in 32 bits where they fit
    if (n <= INT_MAX) {
      j0 = (int)fast_div((unsigned)e0, by_k);
      rem = (int)e0 - j0 * K;
    } else {
      j0 = (int)(e0 / K);
      rem = (int)(e0 - (long long)j0 * K);
    }
    const int len = (int)min(n - e0, kTileFloats);
    float v[kItems][4];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int l = 4 * (it * kGatherThreads + threadIdx.x);
#pragma unroll
      for (int k = 0; k < 4; k += V)
        if (l + k < len)
          load_at<V>(NB, K, by_k, j0, rem + l + k, tbl, idx, base,
                     &v[it][k]);
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int l = 4 * (it * kGatherThreads + threadIdx.x);
      float* o = out + e0 + l;
      if (l + 4 <= len) {
        __stcs(reinterpret_cast<float4*>(o),
               make_float4(v[it][0], v[it][1], v[it][2], v[it][3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (l + k < len) __stcs(o + k, v[it][k]);
      }
    }
  }
}

template <int kItems>
void gather_launch(int grid, cudaStream_t s, int NB, int K, int B,
                   const float* tbl, const float* idx, const int* offset,
                   float* out) {
  const FastDiv by_k = make_div((unsigned)K);
  if (K % 4 == 0 && aligned(tbl, 16))
    gather_rows_kernel<4, kItems><<<grid, kGatherThreads, 0, s>>>(
        NB, K, by_k, B, tbl, idx, offset, out);
  else if (K % 2 == 0 && aligned(tbl, 8))
    gather_rows_kernel<2, kItems><<<grid, kGatherThreads, 0, s>>>(
        NB, K, by_k, B, tbl, idx, offset, out);
  else
    gather_rows_kernel<1, kItems><<<grid, kGatherThreads, 0, s>>>(
        NB, K, by_k, B, tbl, idx, offset, out);
}

__global__ void gather_passes_kernel(int NB, int K, int B, int R,
                                     const float* __restrict__ tbl,
                                     const float* __restrict__ idx,
                                     float* __restrict__ buf,
                                     float* __restrict__ out) {
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= B) return;
  const int nq = K / 4;
  const float4* t4 = reinterpret_cast<const float4*>(tbl);
  float4* dst = reinterpret_cast<float4*>(buf + (size_t)j * K);
  float cur = idx[j], cur0 = idx[0], last00 = 0.0f;
  for (int p = 0; p < R; ++p) {
    const long long row = (long long)cur, row0 = (long long)cur0;
    const bool ok = row >= 0 && row < NB;
    // chain 0's column 0, loaded beside this chain's row: buf[0, 0]
    const float c00 = row0 >= 0 && row0 < NB ? tbl[(size_t)row0 * K] : nan_f();
    float col0 = nan_f();
    for (int q = lane; q < nq; q += 32) {
      const float4 v = ok ? t4[(size_t)row * nq + q]
                          : make_float4(nan_f(), nan_f(), nan_f(), nan_f());
      dst[q] = v;
      if (q == 0) col0 = v.x;
    }
    col0 = __shfl_sync(0xffffffffu, col0, 0);
    cur = fmodf(floorf(cur * 0.5f + col0), (float)NB);
    cur0 = fmodf(floorf(cur0 * 0.5f + c00), (float)NB);
    last00 = c00;
  }
  if (lane == 0) out[j] = cur + last00;
}

__global__ void dependent_loads_kernel(int NB, int K, int n,
                                       const float* __restrict__ tbl,
                                       const float* __restrict__ idx,
                                       float* __restrict__ out) {
  float cur = idx[0];
  for (int p = 0; p < n; ++p) {
    const long long row = (long long)cur;
    const float v = row >= 0 && row < NB ? tbl[(size_t)row * K] : nan_f();
    cur = fmodf(floorf(cur * 0.5f + v), (float)NB);
  }
  out[0] = cur;
}

__global__ void gather_batched_kernel(int nch, int T, int K, int B,
                                      const float* __restrict__ tbl,
                                      const float* __restrict__ idx,
                                      float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nch * K * B) return;
  const int j = (int)(i % B), q = (int)(i / B % K), c = (int)(i / B / K);
  const long long t = (long long)idx[(size_t)c * B + j];
  out[i] = (t < 0 || t >= T) ? nan_f() : tbl[((size_t)c * T + t) * K + q];
}

__global__ void scatter_slots_kernel(int B, int C,
                                     const float* __restrict__ val,
                                     const float* __restrict__ slot,
                                     float* __restrict__ out) {
  const int c = blockIdx.x;
  float* row = out + (size_t)c * C;
  for (int s = threadIdx.x; s < C; s += blockDim.x) row[s] = 0.0f;
  __syncthreads();  // zeroes before values
  for (int l = threadIdx.x; l < B; l += blockDim.x) {
    const long long s = (long long)slot[(size_t)c * B + l];
    if (s >= 0 && s < C) row[s] = val[(size_t)c * B + l];
  }
}

__global__ void strided_sum_kernel(int n, int stride, float scale, float shift,
                                   const float* __restrict__ x,
                                   float* __restrict__ out) {
  float acc = 0.0f;
  for (int j = 0; j < n; ++j)
    acc = acc + (x[(size_t)j * stride] * scale + shift);
  out[0] = acc;
}

constexpr int kBad = (int)cudaErrorInvalidValue;

}  // namespace

// items and grid: the pieces a thread takes per tile (1 or 2) and the
// blocks, as probes/dma.gather_plan gives them
extern "C" int probe_gather_rows(int NB, int K, int B, int items, int grid,
                                 const float* tbl, const float* idx,
                                 const int* offset, float* out,
                                 void* stream) {
  if (NB < 1 || K < 1 || B < 1 || grid < 1 || !aligned(out, 16) ||
      (idx == nullptr) == (offset == nullptr))
    return kBad;
  cudaStream_t s = (cudaStream_t)stream;
  if (items == 1)
    gather_launch<1>(grid, s, NB, K, B, tbl, idx, offset, out);
  else if (items == 2)
    gather_launch<2>(grid, s, NB, K, B, tbl, idx, offset, out);
  else
    return kBad;
  return (int)cudaGetLastError();
}

extern "C" int probe_gather_passes(int NB, int K, int B, int R,
                                   const float* tbl, const float* idx,
                                   float* buf, float* out, void* stream) {
  if (NB < 1 || K < 4 || K % 4 || B < 1 || R < 1 || !aligned(tbl, 16) ||
      !aligned(buf, 16))
    return kBad;
  gather_passes_kernel<<<(B + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      NB, K, B, R, tbl, idx, buf, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_dependent_loads(int NB, int K, int n, const float* tbl,
                                     const float* idx, float* out,
                                     void* stream) {
  if (NB < 1 || K < 1 || n < 1) return kBad;
  dependent_loads_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(NB, K, n, tbl,
                                                            idx, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_gather_batched(int nch, int T, int K, int B,
                                    const float* tbl, const float* idx,
                                    float* out, void* stream) {
  if (nch < 1 || T < 1 || K < 1 || B < 1) return kBad;
  const long long n = (long long)nch * K * B;
  gather_batched_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>(nch, T, K, B, tbl, idx, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_scatter_slots(int nch, int B, int C, const float* val,
                                   const float* slot, float* out,
                                   void* stream) {
  if (nch < 1 || B < 1 || C < 1) return kBad;
  scatter_slots_kernel<<<nch, 256, 0, (cudaStream_t)stream>>>(B, C, val, slot,
                                                              out);
  return (int)cudaGetLastError();
}

extern "C" int probe_strided_sum(int n, int stride, float scale, float shift,
                                 const float* x, float* out, void* stream) {
  if (n < 1 || stride < 0) return kBad;
  strided_sum_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, stride, scale,
                                                        shift, x, out);
  return (int)cudaGetLastError();
}
