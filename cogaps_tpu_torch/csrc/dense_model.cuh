// The dense model of the CoGAPS Gibbs sweep, shared by csrc/sweep.cu (K1,
// K2) and csrc/span.cu (K3): s, s_mu and the pair term read from the SQ, Y
// and Z tables of one update call (noise floors 0), and
// Y[r,:] -= delta * Z[r*k+c,:] after each accepted change. Its plain
// version is ops/sweep.py with models/dense.make_model.
//
// The tables lie in global memory or in shared memory, where the plan
// (SweepArgs.smem) stages them: stage_chain and unstage_chain below are
// the staging of both kernels. A row
// update loads its Z and Y values before it stores any: Y and Z may
// alias as far as the compiler knows, so a loop of load-add-store would
// wait on each store's round trip before the next load.

#pragma once

#include "sweep_common.cuh"

namespace cogaps {

struct DenseModel {
  int K;
  float* Y;         // this chain's (NR, K) conditional-mean table
  const float* SQ;  // (NR, K)
  const float* Z;   // (NR * K, K)
  // Z lies in global memory and nothing writes it during the launch: it
  // is read through the read-only data path
  bool z_readonly;

  __device__ __forceinline__ float z(int i) const {
    return z_readonly ? __ldg(Z + i) : Z[i];
  }

  __device__ Alpha alpha(const Proposal& q) const {
    Alpha a = {F(0.0), F(0.0), F(0.0), F(0.0), F(0.0), F(0.0)};
    if (!q.keep) return a;
    const int e1 = q.r1 * K + q.c1;
    a.s1 = SQ[e1];
    a.smu1 = Y[e1];
    if (q.is_move || q.is_exch) {
      const int e2 = q.r2 * K + q.c2;
      const float s2 = SQ[e2], smu2 = Y[e2];
      const float x = z(e1 * K + q.c2);
      const float same_row = q.r1 == q.r2 ? F(1.0) : F(0.0);
      a.s_pair = a.s1 + s2 - F(2.0) * x * same_row;
      a.smu_pair = a.smu1 - smu2;
    }
    return a;
  }

  __device__ void apply(int r, int e, float delta) const {
    constexpr int kT = 8;  // values loaded ahead of their stores
    float* y = Y + r * K;
    const int ze = e * K;
    for (int j0 = 0; j0 < K; j0 += kT) {
      float yv[kT], zv[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (j0 + t < K) {
          zv[t] = z(ze + j0 + t);
          yv[t] = y[j0 + t];
        }
#pragma unroll
      for (int t = 0; t < kT; ++t)
        if (j0 + t < K) y[j0 + t] = yv[t] + (-delta) * zv[t];
    }
  }
};

// A chain's array as a block sweeps it: its staged copy in shared memory,
// if the plan put it there (p.smem: byte offsets from `smem`), else its
// slice of the global array.
template <class T>
__device__ __forceinline__ T* placed(const SweepArgs& p, unsigned char* smem,
                                     int a, T* global) {
  return p.smem[a] < 0 ? global : reinterpret_cast<T*>(smem + p.smem[a]);
}

// Starts copying n 4-byte values from global src to shared dst (16-byte
// aligned) by the whole block: asynchronous copies (cp.async) that keep
// every thread's loads in flight at once, 16 bytes each where src is
// aligned too. wait_staged() ends them.
template <class T>
__device__ __forceinline__ void stage_in(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "4-byte values");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       s + 16 * i),
                   "l"(src + 4 * i)
                   : "memory");
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s + 4 * i),
                 "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n values from the staged copy src back to global dst by the whole block
template <class T>
__device__ __forceinline__ void write_back(T* __restrict__ dst,
                                           const T* __restrict__ src, int n) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One chain's sweep state where the plan p.smem puts it: g its global
// slices, ch and model what the sweeps use.
struct StagedChain {
  Chain g, ch;
  DenseModel model;
  float* Yg;
};

// Points a chain's arrays at their places and starts staging those in
// shared memory (the claims are cleared where they lie by chain_begin);
// Y, SQ and Z are the chain's global tables. Z is read through the
// read-only path where it stays global and z_ldg says nothing writes it
// during the launch. Every thread of the block calls it; each thread's
// copies have landed when it returns, the block's after a barrier.
__device__ __forceinline__ StagedChain stage_chain(const SweepArgs& p,
                                                   unsigned char* smem,
                                                   int chain, float* Y,
                                                   const float* SQ,
                                                   const float* Z,
                                                   bool z_ldg) {
  StagedChain s;
  s.g = chain_of(p, chain);
  s.ch = s.g;
  s.ch.rmin = placed(p, smem, kRmin, s.g.rmin);
  s.ch.amin = placed(p, smem, kAmin, s.g.amin);
  s.ch.hole_flag = placed(p, smem, kHole, s.g.hole_flag);
  s.ch.mass = placed(p, smem, kMass, s.g.mass);
  s.ch.elem = placed(p, smem, kElem, s.g.elem);
  s.ch.M = placed(p, smem, kM, s.g.M);
  s.Yg = Y;
  s.model = DenseModel{p.K, placed(p, smem, kY, Y), placed(p, smem, kSQ, SQ),
                       placed(p, smem, kZ, Z), z_ldg && p.smem[kZ] < 0};
  if (s.ch.mass != s.g.mass) stage_in(s.ch.mass, s.g.mass, p.C);
  if (s.ch.elem != s.g.elem) stage_in(s.ch.elem, s.g.elem, p.C);
  if (s.ch.M != s.g.M) stage_in(s.ch.M, s.g.M, p.NB);
  if (s.model.Y != Y) stage_in(s.model.Y, Y, p.NB);
  if (s.model.SQ != SQ) stage_in(const_cast<float*>(s.model.SQ), SQ, p.NB);
  if (s.model.Z != Z)
    stage_in(const_cast<float*>(s.model.Z), Z, p.NB * p.K);
  wait_staged();
  return s;
}

// Writes back what the sweeps change, after a block barrier that follows
// the last sweep: mass, elem, M and (write_y) Y.
__device__ __forceinline__ void unstage_chain(const SweepArgs& p,
                                              const StagedChain& s,
                                              bool write_y) {
  if (s.ch.mass != s.g.mass) write_back(s.g.mass, s.ch.mass, p.C);
  if (s.ch.elem != s.g.elem) write_back(s.g.elem, s.ch.elem, p.C);
  if (s.ch.M != s.g.M) write_back(s.g.M, s.ch.M, p.NB);
  if (write_y && s.model.Y != s.Yg) write_back(s.Yg, s.model.Y, p.NB);
}

}  // namespace cogaps
