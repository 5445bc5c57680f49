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
//   F1 bdot        out[c,i,b] = sum_t a[c,t,i] b[c,t,b] in float32. Block
//                  (32 columns b, 8 rows i, chain c); its warps split t
//                  into contiguous pieces of at least 16 (up to 32 warps:
//                  a warp's loads wait on memory, so long t needs many;
//                  short t pays more for the partial sums than it saves),
//                  a lane keeps 8 sums, and the warps' partial sums meet in
//                  shared memory in warp order (PERF.md gives the times of
//                  8 and 32 warps at every t beside these). The a row is
//                  one broadcast load per warp, b one 128-byte load. Bound
//                  by bytes at every probe and port shape but k = 128
//                  (4(T k + T B + k B) a chain against 2 T k B operations,
//                  so ~ k/2 operations a byte at B >> k).
//   F2 prefix      inclusive prefix sum along lanes: one block a chain,
//                  warp shuffles and one shared array of warp totals, as
//                  sweep_common.cuh::block_scan (in float32). Bytes.
//   F3 first_wins  the count of earlier lanes of the chain holding the same
//                  value: one block a chain, the lanes' values in shared
//                  memory, lane j compares with lanes 0..j-1 (a broadcast
//                  read). B(B-1)/2 compares a chain: operations bound it
//                  at B = 1024.
//   F4 claim_min   row form: claim[c,row] = the least lane holding row
//                  (else B), one block a chain, the table set to B and then
//                  atomicMin of the lane id, as K1 claims rows
//                  (sweep_common.cuh::sweep_chain); lane form: hit[c,lane]
//                  = lane if the lane's value is a row in [0, NR) (else B),
//                  the closed form of the TPU's min over an (NR, B) one-hot.
//                  Bytes.
//   F5 elem_chain  n times x = x * 1.0001 + 0.001, a thread an element.
//   F6 while_sum   a loop whose trip count is read from device memory: the
//                  "count" form adds sum(x) while i < x[0,0]; the "until"
//                  form adds x while sum(a) < 100, a += 1. One block; the
//                  sums are block reductions in a fixed order.
//   F7 reduce3d    sum over the middle axis of x*x (a thread an output,
//                  float64 products and sums rounded once, the plain
//                  version's rule) and min over the minor axis (a warp an
//                  output). Bytes.
//   F8 uniform     word 0 of Philox4x32-10 (sweep_common.cuh::philox) of
//                  the counter (lane, row, 0, 0) under the key (seed, 0),
//                  mapped to [0, 1) as ((w >> 9) | 0x3F800000) - 1, the
//                  probe's mapping. ~103 integer operations a value, so
//                  operations bound it.
//
// Every kernel is small: its launch, not its bound, sets its time at the
// probes' shapes. Compiled with -fmad=false like the other sources, so F5
// and F8 are bit-equal to their plain versions.

#include "sweep_common.cuh"

namespace {

constexpr int kBdotWarps = 32;  // at most, splitting t
constexpr int kBdotSpan = 16;   // t a warp takes at least
constexpr int kBdotRows = 8;   // rows i of a block

__global__ void __launch_bounds__(32 * kBdotWarps)
    bdot_kernel(int T, int K, int B, const float* __restrict__ a,
                const float* __restrict__ b, float* __restrict__ out) {
  const int c = blockIdx.z, i0 = blockIdx.y * kBdotRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const float* ac = a + (size_t)c * T * K + i0;
  const float* bc = b + (size_t)c * T * B;
  const int t0 = (int)((long long)T * w / nw);
  const int t1 = (int)((long long)T * (w + 1) / nw);
  float acc[kBdotRows];
#pragma unroll
  for (int r = 0; r < kBdotRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const float bv = col < B ? bc[(size_t)t * B + col] : 0.0f;
    const float* ar = ac + (size_t)t * K;
#pragma unroll
    for (int r = 0; r < kBdotRows; ++r)
      if (i0 + r < K) acc[r] = acc[r] + ar[r] * bv;
  }
  __shared__ float part[kBdotWarps][kBdotRows][32];
#pragma unroll
  for (int r = 0; r < kBdotRows; ++r) part[w][r][lane] = acc[r];
  __syncthreads();
  for (int q = threadIdx.x; q < kBdotRows * 32; q += blockDim.x) {
    const int r = q >> 5;  // q's lane is this thread's
    float s = 0.0f;
    for (int v = 0; v < nw; ++v) s = s + part[v][r][lane];
    if (i0 + r < K && col < B) out[((size_t)c * K + i0 + r) * B + col] = s;
  }
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

__global__ void first_wins_kernel(int B, const float* __restrict__ r,
                                  int* __restrict__ count) {
  __shared__ float vals[cogaps::kMaxB];
  const int c = blockIdx.x, j = threadIdx.x;
  if (j < B) vals[j] = r[(size_t)c * B + j];
  __syncthreads();
  if (j >= B) return;
  const float v = vals[j];
  int n = 0;
  for (int l = 0; l < j; ++l) n += vals[l] == v;
  count[(size_t)c * B + j] = n;
}

// v is a row of [0, NR): integer-valued and in range
__device__ __forceinline__ bool is_row(float v, int NR) {
  return v >= 0.0f && v < (float)NR && v == floorf(v);
}

__global__ void claim_min_kernel(int form, int B, int NR,
                                 const float* __restrict__ r,
                                 int* __restrict__ out) {
  const int c = blockIdx.x;
  const float* rc = r + (size_t)c * B;
  if (form == 0) {
    int* claim = out + (size_t)c * NR;
    for (int row = threadIdx.x; row < NR; row += blockDim.x) claim[row] = B;
    __syncthreads();  // the table is set before any claim
    for (int l = threadIdx.x; l < B; l += blockDim.x) {
      const float v = rc[l];
      if (is_row(v, NR)) atomicMin(&claim[(int)v], l);
    }
  } else {
    for (int l = threadIdx.x; l < B; l += blockDim.x)
      out[(size_t)c * B + l] = is_row(rc[l], NR) ? l : B;
  }
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

__global__ void reduce_sum_kernel(int M, int L, const float* __restrict__ x,
                                  float* __restrict__ out) {
  const int c = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  const float* xc = x + (size_t)c * M * L + j;
  double s = 0.0;
  for (int i = 0; i < M; ++i) {
    const double v = xc[(size_t)i * L];
    s += v * v;
  }
  out[(size_t)c * L + j] = (float)s;
}

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

}  // namespace

extern "C" int probe_bdot(int nch, int T, int K, int B, const float* a,
                          const float* b, float* out, void* stream) {
  if (nch < 1 || nch > 65535 || T < 1 || K < 1 || B < 1) return kBad;
  const dim3 grid((B + 31) / 32, (K + kBdotRows - 1) / kBdotRows, nch);
  const int warps = T / kBdotSpan < 1 ? 1
                    : T / kBdotSpan > kBdotWarps ? kBdotWarps
                                                 : T / kBdotSpan;
  bdot_kernel<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(T, K, B, a, b,
                                                             out);
  return launched();
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
  first_wins_kernel<<<nch, (B + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(
      B, r, count);
  return launched();
}

extern "C" int probe_claim_min(int form, int nch, int B, int NR,
                               const float* r, int* out, void* stream) {
  if (nch < 1 || B < 1 || NR < 1 || (form != 0 && form != 1)) return kBad;
  const int threads = B < cogaps::kMaxB ? (B + 31) / 32 * 32 : cogaps::kMaxB;
  claim_min_kernel<<<nch, threads, 0, (cudaStream_t)stream>>>(form, B, NR, r,
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
    reduce_sum_kernel<<<dim3((L + 127) / 128, nch), 128, 0,
                        (cudaStream_t)stream>>>(M, L, x, out);
  } else if (form == 1) {
    const int rows = nch * M;
    reduce_min_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        rows, L, x, out);
  } else {
    return kBad;
  }
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
