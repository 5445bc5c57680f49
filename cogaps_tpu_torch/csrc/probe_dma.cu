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
//                      memory (p1). A warp a row, 16-byte loads where the
//                      rows allow them (8- or 4-byte ones otherwise).
//                      Bound by bytes; at the probes' B every row is a
//                      separate HBM access, so latency sets the time.
//   F9 gather_passes   R dependent passes: each gathers rows tbl[idx] into
//                      buf and sets idx = floor(idx * 0.5 + buf[:, 0]) % NB
//                      for the next; out = idx + buf[0, 0]. A warp a lane
//                      chain: it loads the chain's row as 16-byte pieces
//                      (one a thread at K = 128), writes it to buf and
//                      takes column 0 for its next index, so a pass costs
//                      one HBM round trip. Each warp also follows chain
//                      0's column 0, one 4-byte load beside its own row's,
//                      so buf[0, 0] needs no wait across blocks.
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
#include <stdint.h>

namespace {

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// one warp copies a row of K floats in pieces of V (K a multiple of the
// piece, both rows aligned to it)
template <typename V>
__device__ __forceinline__ void copy_row(const float* src, float* dst, int K,
                                         int lane) {
  constexpr int w = sizeof(V) / sizeof(float);
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (int q = lane; q < K / w; q += 32) d[q] = s[q];
}

template <typename V>
__global__ void gather_rows_kernel(int NB, int K, int B,
                                   const float* __restrict__ tbl,
                                   const float* __restrict__ idx,
                                   const int* __restrict__ offset,
                                   float* __restrict__ out) {
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= B) return;
  const long long src = idx ? (long long)idx[j] : (long long)offset[0] + j;
  float* dst = out + (size_t)j * K;
  if (src < 0 || src >= NB) {  // no such row: NaN, not a fault
    for (int q = lane; q < K; q += 32) dst[q] = nan_f();
    return;
  }
  copy_row<V>(tbl + (size_t)src * K, dst, K, lane);
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

inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

constexpr int kBad = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" int probe_gather_rows(int NB, int K, int B, const float* tbl,
                                 const float* idx, const int* offset,
                                 float* out, void* stream) {
  if (NB < 1 || K < 1 || B < 1 || (idx == nullptr) == (offset == nullptr))
    return kBad;
  const int blocks = (B + 7) / 8;  // 8 warps a block, a warp a row
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 4 == 0 && aligned(tbl, 16) && aligned(out, 16))
    gather_rows_kernel<float4><<<blocks, 256, 0, s>>>(NB, K, B, tbl, idx,
                                                      offset, out);
  else if (K % 2 == 0 && aligned(tbl, 8) && aligned(out, 8))
    gather_rows_kernel<float2><<<blocks, 256, 0, s>>>(NB, K, B, tbl, idx,
                                                      offset, out);
  else
    gather_rows_kernel<float><<<blocks, 256, 0, s>>>(NB, K, B, tbl, idx,
                                                     offset, out);
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
