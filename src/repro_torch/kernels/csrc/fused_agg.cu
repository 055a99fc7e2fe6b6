// dequant_accumulate: the qblock flush, sum_i w_i * scale_{i,b} * q_{i,b}.
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_agg/kernel.py::dequant_accumulate (a (rows, B)
// grid with the client axis innermost, the f32 output tile resident in
// VMEM while every client's int8 blocks stream through it once).  The
// server's qblock flush reduces a cohort's encoded leaf straight into the
// weighted sum with it; no decoded per-client tensor is formed.
//
// Inputs: q (B, n) int8, the wire's values (row stride n, no padding);
// scale (B, nb) f32 with nb = ceil(n / block); w (B,) f32.  Output: (n,)
// f32, the leaf's sum itself (no pad, no trim copy).
//
// Bound on an H100: memory — B*n int8 reads plus 4n bytes written (the
// B*nb scales are noise), a multiply-add per byte read.
//
// Design: the TPU grid's sequential client axis becomes a loop inside the
// thread.  Each thread owns 4 consecutive output elements (always in one
// quant block: block is a multiple of 4), keeps their sums in registers,
// and walks the B clients innermost: one char4 load per client when rows
// are 4-byte aligned (n % 4 == 0), else four byte loads, and one
// multiplier w_i * scale_{i,b} per client (an f32 product, rounded as the
// reference rounds it).  Each output is written once, so there is no
// carry across blocks and no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dequant_accumulate_kernel(const int8_t* __restrict__ q,
                          const float* __restrict__ scale,
                          const float* __restrict__ w,
                          float* __restrict__ out, int clients, int64_t n,
                          int64_t nb, int block) {
  const int64_t e0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e0 >= n) return;
  const int64_t b = e0 / block;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < clients; ++i) {
    const float ws = w[i] * scale[(int64_t)i * nb + b];
    const int8_t* row = q + (int64_t)i * n;
    float v[4];
    if (VEC) {
      const char4 c = *reinterpret_cast<const char4*>(row + e0);
      v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (e0 + j < n) ? row[e0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += ws * v[j];
  }
  if (VEC) {
    *reinterpret_cast<float4*>(out + e0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < n) out[e0 + j] = acc[j];
  }
}

}  // namespace

// C entry point bound with ctypes.  q is contiguous (clients, n) int8,
// scale contiguous (clients, nb) f32, w (clients,) f32, out a fresh (n,)
// f32 buffer; block must be a multiple of 4.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() so a refused launch
// raises in the caller.
extern "C" int repro_dequant_accumulate(const int8_t* q, const float* scale,
                                        const float* w, float* out,
                                        int clients, int64_t n, int block,
                                        void* stream) {
  if (block % 4) return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + block - 1) / block;
  const int64_t grid = ((n + 3) / 4 + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (n % 4 == 0) && ((uintptr_t)q % 4 == 0)
                   && ((uintptr_t)out % 16 == 0);
  if (vec)
    dequant_accumulate_kernel<true><<<(unsigned)grid, THREADS, 0, s>>>(
        q, scale, w, out, clients, n, nb, block);
  else
    dequant_accumulate_kernel<false><<<(unsigned)grid, THREADS, 0, s>>>(
        q, scale, w, out, clients, n, nb, block);
  return (int)cudaGetLastError();
}
