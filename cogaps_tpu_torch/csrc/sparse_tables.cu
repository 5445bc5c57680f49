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
// in float32, as models/sparse.sparse_tables_plain forms them. G is the
// dense model's Z over a gathered list of partners, so the shape is that
// of csrc/tables.cu's simt_tiles_kernel: register tiles on the CUDA cores.
//
// Layout. k is padded to KP = 4 ceil(k / 4); a thread's item is a tile of
// 4 x 4 entries (a, b) of U's upper triangle of tiles (a <= b; the
// diagonal tiles' lower entries are formed and dropped), or a strip of 4
// of T4: P = nt (nt + 1) / 2 + nt items a row, nt = KP / 4. A block takes
// one row at a time (blocks walk the (chain, row) items by a stride of the
// grid), as G groups of P threads (G = 128 / P, or one group of up to 1024
// threads above P = 128; above P = 1024, k > 172, S slabs of the items,
// the block taking a row's slabs in turn, each over all its nonzeros),
// all from k alone (ops/sparse_tables_cuda.sparse_plan). The row's
// nonzeros go in segments of SEG = G SUB: the
// block stages a segment's idx, w = 1 - 1/d^2 and 1/d (coalesced loads),
// then its partner rows (cp.async, every load in flight at once; zeros
// past k) in shared memory; group g sums nonzeros [g SUB, (g + 1) SUB) of
// it, each of its threads 16 (or 4) fmaf chains over them in order from
// zero: per nonzero two 16-byte loads of o's tiles, 4 products w o_c and
// 16 fmaf. The groups' partials are added in group order, the segments'
// in segment order, so each entry's sum is fixed by k and the row's
// nonzeros alone (ops/sparse_tables_cuda.segments). At the end the row's
// G goes to shared memory (each pair and its mirror from one sum) and
// out in address order with SQ; Y0 by an fmaf chain over c' ascending.
// With slabs (S > 1) the staging holds no k x k G: each slab writes its
// entries of G straight out, and Y0 reads them back after a barrier.
//
// Z2 comes first in the same launch: chunks of ZSEG partners of each
// chain (SEG, or with slabs a multiple of it), summed as a row's
// segments with w = 1, their partials added in chunk order after a grid
// barrier, then a second barrier before the rows. The grid is the blocks
// the card holds at once (a cooperative launch); the walk over the items
// moves no sum: the plan takes neither the chain count nor the SM count,
// so a chain's tables are the same bits alone and beside any others
// (batched cuBLAS products are not). No float atomics.
//
// What bounds it on the H100: the FP32 operations above k ~ 8 (per
// nonzero k(k+1)/2 fmaf against 8 bytes of idx and val: 1275 at k = 50;
// the partner rows come from L2, the partner factor fitting it), the
// bytes of G below. A segment's staging is not overlapped with its sums
// but by the other blocks on the SM; at small k a row's G groups keep a
// block's threads busy on one row, so that a few long rows still spread
// over the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBeta = 100.0f;  // models/sparse.BETA: 1/0.1^2

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
  float* zpart;  // (nch, nzc, k, k) Z2's chunk partials, upper triangle
  float* Z2;     // (nch, k, k)
  int nch, NR, m, k, KP, nt, npair, P, G, SUB, SEG, S, ZSEG, nzc;
};

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Stages n nonzeros from `start`: their partner rows' indices (a row
// segment's idx, or a Z2 chunk's partners start ..), w and 1/d (1 and
// unused for Z2), then the rows (zeros past k) by cp.async, a thread a
// row below k = 32 and a warp a row above; ends after a barrier with
// everything in shared memory.
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
  if (k >= 32) {  // a warp a row, its lanes over the row
    const int lane = threadIdx.x & 31;
    for (int l = threadIdx.x >> 5; l < n; l += blockDim.x >> 5) {
      const float* src = O + (size_t)sIdx[l] * k;
      float* dst = sO + (size_t)l * KP;
      for (int c = lane; c < KP; c += 32)
        cp_async4(dst + c, src + (c < k ? c : 0), c < k);
    }
  } else {  // a thread a row
    for (int l = threadIdx.x; l < n; l += blockDim.x) {
      const float* src = O + (size_t)sIdx[l] * k;
      float* dst = sO + (size_t)l * KP;
      for (int c = 0; c < k; ++c) cp_async4(dst + c, src + c, true);
      for (int c = k; c < KP; ++c) dst[c] = 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// A segment's sums of the block's threads, each entry an fmaf chain over
// its group's nonzeros of the segment, the groups' partials added in
// group order (the entries dealt over the block's threads), into the
// block's first group's tot: the segment's sums
// where `first`, else tot + them (the other threads' tot is left as it
// was). Ends after a barrier.
__device__ __forceinline__ void block_segment(const Args& p, const float* sO,
                                              const float* sW,
                                              const float* sR, float* sRed,
                                              int n, const Item& it,
                                              bool first, float tot[4][4]) {
  float acc[4][4];
  const int lo = min(n, it.group * p.SUB), hi = min(n, lo + p.SUB);
  segment_sums(sO + (size_t)lo * p.KP, sW + lo, sR + lo, p.KP,
               it.active ? hi - lo : 0, it, acc);
  if (p.G > 1) {  // every thread adds some entries' partials, in order
    const int width = p.P * 16;
    float* mine = sRed + ((size_t)it.group * p.P + it.i) * 16;
    if (it.active)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mine[4 * i + j] = acc[i][j];
    __syncthreads();
    for (int e = threadIdx.x; e < width; e += blockDim.x) {
      float v = sRed[e];
      for (int g = 1; g < p.G; ++g) v = __fadd_rn(v, sRed[g * width + e]);
      sRed[e] = v;
    }
    __syncthreads();
    if (it.group == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mine[4 * i + j];
  }
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
                                         float* sW, float* sR, float* sRed,
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
    block_segment(p, sO, sW, sR, sRed, len, it, sg == 0, tot);
  }
}

// The whole call: Z2's chunk partials, their ordered sums, the rows.
// Dynamic shared memory (floats): sO SEG x KP (then the row's G, k x k,
// where S = 1), sW, sR and sIdx SEG each, sT KP (beta T4), sRed G x P x
// 16 (the groups' partials, where G > 1). Slabs (S > 1) is a path of its
// own, so that the one-slab kernels keep a thread's item in registers
// and the row's G in shared memory as they did without it.
template <int MaxThreads, int MinBlocks, bool Slabs>
__global__ void __launch_bounds__(MaxThreads, MinBlocks)
    sparse_tables_kernel(const __grid_constant__ Args p) {
  extern __shared__ float4 smem4[];
  float* sO = reinterpret_cast<float*>(smem4);
  float* sW = sO + (size_t)p.SEG * p.KP;
  float* sR = sW + p.SEG;
  int* sIdx = reinterpret_cast<int*>(sR + p.SEG);
  float* sT = reinterpret_cast<float*>(sIdx + p.SEG);
  float* sRed = sT + p.KP;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, k = p.k, ZSEG = p.ZSEG;
  const int kk = k * k;
  const int S = Slabs ? p.S : 1;
  const Item it0 = item_of(p, tid, 0);
  float tot[4][4];

  // 1. Z2's chunk partials: items (chain, chunk of ZSEG partners)
  const long long zitems = (long long)p.nch * p.nzc;
  for (long long z = blockIdx.x; z < zitems; z += gridDim.x) {
    const int ch = (int)(z / p.nzc);
    const int q = (int)(z - (long long)ch * p.nzc);
    const int n = min(ZSEG, p.m - q * ZSEG);
    for (int s = 0; s < S; ++s) {
      const Item it = Slabs ? item_of(p, tid, s) : it0;
      if (Slabs) {
        run_sums(p, sO, sIdx, sW, sR, sRed, p.O + ch * p.cO,
                 (long long)q * ZSEG, n, true, it, tot);
      } else {  // a chunk is one segment (ZSEG = SEG)
        stage(p, sO, sIdx, sW, sR, p.O + ch * p.cO, (long long)q * ZSEG, n,
              true);
        block_segment(p, sO, sW, sR, sRed, n, it, true, tot);
      }
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

  // 3. the rows: items (chain, row)
  const long long ritems = (long long)p.nch * p.NR;
  for (long long g = blockIdx.x; g < ritems; g += gridDim.x) {
    const int ch = (int)(g / p.NR), r = (int)(g - (long long)ch * p.NR);
    const long long* ptr = p.indptr + (size_t)ch * (p.NR + 1) + r;
    const long long lo = ptr[0];
    const int n = (int)(ptr[1] - lo);
    const float* O = p.O + ch * p.cO;
    for (int s = 0; s < S; ++s) {
      const Item it = Slabs ? item_of(p, tid, s) : it0;
      run_sums(p, sO, sIdx, sW, sR, sRed, O, lo, n, false, it, tot);
      // G = beta (Z2 - U), a pair and its mirror from one sum, into the
      // staging (free: run_sums ended on a barrier), or with slabs
      // straight out; beta T4
      float* sG = Slabs ? p.Gtab + ((size_t)ch * p.NR + r) * kk : sO;
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
                sG[c * k + c2] = v;
                sG[c2 * k + c] = v;
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

    // out: G in address order (where it was staged), SQ, Y0
    const size_t rowg = (size_t)ch * p.NR + r;
    float* Gg = p.Gtab + rowg * kk;
    const float* sG = Slabs ? Gg : sO;
    if (!Slabs)
      for (int e = tid; e < kk; e += blockDim.x) Gg[e] = sG[e];
    const float* mr = p.M + ch * p.cM + (size_t)r * k;
    for (int c = tid; c < k; c += blockDim.x) {
      const float* gr = sG + c * k;
      float mg = 0.0f;
      for (int c2 = 0; c2 < k; ++c2) mg = __fmaf_rn(mr[c2], gr[c2], mg);
      p.Y0[rowg * k + c] = __fsub_rn(sT[c], mg);
      p.SQ[rowg * k + c] = gr[c];
    }
    __syncthreads();  // the next row's staging overwrites sG and sT
  }
}

template <int MaxThreads, int MinBlocks, bool Slabs>
int launch(const Args& a, int threads, int smem, cudaStream_t stream) {
  static int smem_set = -1, occ_dev = -1, occ_smem = -1, occ_threads = -1;
  static int grid = 0;
  const auto kernel = sparse_tables_kernel<MaxThreads, MinBlocks, Slabs>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (dev != occ_dev || smem != occ_smem || threads != occ_threads) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    occ_dev = dev;
    occ_smem = smem;
    occ_threads = threads;
  }
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(threads), args, (size_t)smem,
                                    stream);
  // read the launch status back so that a refused launch leaves no error
  // behind for the next kernel on the device
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// The plan's fields (ops/sparse_tables_cuda.sparse_plan: KP, nt, P, G,
// SUB, S, ZSEG, threads, smem from k alone) and the tensors.
extern "C" int cogaps_sparse_tables_launch(
    int nch, int NR, int m, int k, int KP, int nt, int P, int G, int SUB,
    int S, int ZSEG, int threads, int smem, const long long* indptr,
    const int* idx,
    const float* val, const float* O, long long cO, const float* M,
    long long cM, float* SQ, float* Y0, float* G_out, float* zpart,
    float* Z2, void* stream) {
  if (nch < 1 || NR < 1 || m < 0 || k < 1 || KP != 4 * ((k + 3) / 4) ||
      nt * 4 != KP || P != nt * (nt + 1) / 2 + nt || G < 1 || S < 1 ||
      G * P > (long long)S * threads || (S > 1 && (G != 1 ||
      (long long)(S - 1) * threads >= P)) || threads > 1024 ||
      threads % 32 != 0 || SUB < 1 || (S == 1 && G * SUB * KP < k * k) ||
      ZSEG < G * SUB || ZSEG % (G * SUB) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
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
  a.zpart = zpart;
  a.Z2 = Z2;
  a.nch = nch;
  a.NR = NR;
  a.m = m;
  a.k = k;
  a.KP = KP;
  a.nt = nt;
  a.npair = nt * (nt + 1) / 2;
  a.P = P;
  a.G = G;
  a.SUB = SUB;
  a.SEG = G * SUB;
  a.S = S;
  a.ZSEG = ZSEG;
  a.nzc = (m + ZSEG - 1) / ZSEG;
  const cudaStream_t s = (cudaStream_t)stream;
  if (S > 1) return launch<1024, 1, true>(a, threads, smem, s);
  if (threads <= 128) return launch<128, 6, false>(a, threads, smem, s);
  if (threads <= 512) return launch<512, 1, false>(a, threads, smem, s);
  return launch<1024, 1, false>(a, threads, smem, s);
}
