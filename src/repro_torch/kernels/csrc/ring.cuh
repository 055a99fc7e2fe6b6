// What the port's two FP32 GEMM kernels (matmul_fused.cu,
// newton_schulz.cu) share: the cp.async ring's 16-byte loaders and the
// register fragments of the 8x8 micro-tile.  A block of THREADS threads
// stages K-slices of BK = 16 of an operand tile of X rows (or columns) in
// shared memory, stored as the operand's unit-stride axis runs: [X][BK+PAD]
// floats when k is contiguous ("kc"), else [BK][X+PAD].  Each thread owns
// an 8x8 register micro-tile; its fragments are read as 128-bit ld.shared.
//
// The loaders count in bytes: an operand of E-byte elements (4: f32; 2:
// bf16, f16) is copied in 16-byte runs of 16/E elements, each landing at
// the f32 place of its first element.  A 2-byte run (8 elements) so fills
// the first half of its 32-byte f32 place, which matmul_fused.cu's
// widening pass then fills in place; newton_schulz.cu reads f32 scratch
// only.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int BK = 16;
constexpr int PAD = 4;                // keeps shared rows 16-byte aligned

// 16-byte copy through L2 only (.cg: never a stale L1 line); the bytes
// past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One operand's K-slices for this thread.  Element (x, kk) of the
// operand lies at base + (x * s_x + kk * s_k) * E bytes.  kc: the tile is
// stored [X][BK+PAD] (k contiguous, s_k == 1), else [BK][X+PAD] (s_x ==
// 1).  16-byte copies along the unit-stride axis, the ragged end
// zero-filled by the copy's source size; their addresses and bounds are
// planned once per tile, so a slice costs an add and a compare per copy.
struct Plan {
  const char* src;    // this thread's first 16-byte run at k = 0
  int64_t step;       // bytes: kc: between its runs; else the k stride
  int lim_a, lim_b;   // kc: rows, k left; else k, x left (from its run)
};

template <int X, int THREADS, int E = 4>
__device__ __forceinline__ Plan plan(const void* base, int64_t s_x,
                                     int64_t s_k, int ext_x, int k, int x0,
                                     bool kc, int tid) {
  constexpr int V = 16 / E;   // elements of a 16-byte run
  const char* b = static_cast<const char*>(base);
  Plan p;
  if (kc) {
    const int r0 = tid / (BK / V), c0 = (tid % (BK / V)) * V;
    p.src = b + ((x0 + r0) * s_x + c0) * E;
    p.step = (THREADS / (BK / V)) * s_x * E;
    p.lim_a = ext_x - x0 - r0;
    p.lim_b = k - c0;
  } else {
    const int kk0 = tid / (X / V), xo = (tid % (X / V)) * V;
    p.src = b + (kk0 * s_k + x0 + xo) * E;
    p.step = s_k * E;
    p.lim_a = k - kk0;
    p.lim_b = ext_x - x0 - xo;
  }
  return p;
}

// The K-slice at k0 of a planned operand into the f32 stage `s`; `safe`
// is any valid address, read for no bytes where a run lies outside the
// operand.
template <int X, int THREADS, int E = 4>
__device__ __forceinline__ void load_vec(const Plan& p, float* s, int k0,
                                         bool kc, const void* safe,
                                         int tid) {
  constexpr int V = 16 / E;
  constexpr int N = X * BK / V / THREADS;   // 16-byte runs per thread
  if (kc) {
    constexpr int RS = THREADS / (BK / V);  // rows between runs
    const int left = p.lim_b - k0;
    const int nb = left > 0 ? E * min(left, V) : 0;
    float* d = s + (tid / (BK / V)) * (BK + PAD) + (tid % (BK / V)) * V;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int bytes = i * RS < p.lim_a ? nb : 0;
      cp_async16(d + i * RS * (BK + PAD),
                 bytes ? p.src + i * p.step + k0 * E : safe, bytes);
    }
  } else {
    constexpr int KS = THREADS / (X / V);   // k-rows between runs
    const int nb = p.lim_b > 0 ? E * min(p.lim_b, V) : 0;
    const char* src = p.src + k0 * p.step;
    float* d = s + (tid / (X / V)) * (X + PAD) + (tid % (X / V)) * V;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int bytes = k0 + i * KS < p.lim_a ? nb : 0;
      cp_async16(d + i * KS * (X + PAD), bytes ? src + i * KS * p.step : safe,
                 bytes);
    }
  }
}

// Register fragments.  A [X][BK+PAD] tile gives 4 k-steps of a register
// row per 128-bit load (f[q][i] = row t + i*T at k = kc + q; T threads
// along that axis); a [BK][X+PAD] tile gives one k-step of 8 registers
// (x = 4t.. and X/2 + 4t..) in two 128-bit loads.
template <int T>
__device__ __forceinline__ void load_frag_kc(const float* s, int t, int kc,
                                             float (&f)[4][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(
        s + (t + i * T) * (BK + PAD) + kc);
    f[0][i] = v.x; f[1][i] = v.y; f[2][i] = v.z; f[3][i] = v.w;
  }
}

template <int X>
__device__ __forceinline__ void load_frag_k(const float* s, int t, int kk,
                                            float (&f)[8]) {
  const float4 lo =
      *reinterpret_cast<const float4*>(s + kk * (X + PAD) + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(
      s + kk * (X + PAD) + X / 2 + t * 4);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

}  // namespace ring
