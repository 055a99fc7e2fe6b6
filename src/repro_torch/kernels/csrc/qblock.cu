// quantize: blockwise int8 quantization of a cohort-stacked leaf.
//
// Replaces the Pallas TPU kernel repro/kernels/qblock/kernel.py::quantize
// (rowwise abs-max, scale, divide, round, cast over (bm, block) tiles of
// a zero-padded flat array).  The qblock codec encodes every client's
// delta and Theta leaf with it.
//
// Input x is (rows, n) f32, one row per client; each row is cut into
// ceil(n / block) quant blocks, and a block never spans two rows:
//   scale = max(max|x_b| / 127, eps),  q = clamp(rint(x_b / scale), -127, 127)
// Outputs: q (rows, n) int8 — exactly the n values that ship, no padding —
// and scale (rows, ceil(n / block)) f32.
//
// Bound on an H100: memory — 4 B read and ~1.03 B written per element
// against a handful of flops, so 3.35 TB/s sets the floor.
//
// Design: one warp per quant block.  Lane j handles elements j, j+32, ...
// of its block (coalesced f32 loads and int8 stores); the abs-max is a
// warp-shuffle reduction, so no shared memory and no second pass.  The
// ragged tail of each row is masked (read as 0, never written), which is
// what the reference's zero padding computes.  Rounding is rintf (round
// half to even, as jnp.round and torch.round), and the divisions are IEEE
// (the build does not pass --use_fast_math), so q and scale are bitwise
// those of the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
qblock_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scale, int64_t rows, int64_t n,
                       int64_t nb, int block, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= rows * nb) return;
  const int64_t row = blk / nb;
  const int64_t start = (blk - row * nb) * block;   // offset in the row
  const int64_t len = (n - start < block) ? n - start : (int64_t)block;
  const float* xb = x + row * n + start;
  int8_t* qb = q + row * n + start;

  float amax = 0.f;
  for (int64_t j = lane; j < len; j += 32) amax = fmaxf(amax, fabsf(xb[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float s = fmaxf(amax / 127.0f, eps);
  for (int64_t j = lane; j < len; j += 32) {
    const float v = rintf(xb[j] / s);
    qb[j] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (lane == 0) scale[blk] = s;
}

}  // namespace

// C entry point bound with ctypes.  x is contiguous (rows, n) f32; q is a
// fresh (rows, n) int8 buffer and scale a fresh (rows, nb) f32 buffer.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch raises in the caller.
extern "C" int repro_qblock_quantize(const float* x, int8_t* q, float* scale,
                                     int64_t rows, int64_t n, int block,
                                     float eps, void* stream) {
  const int64_t nb = (n + block - 1) / block;
  const int64_t blocks = rows * nb;
  const int64_t grid = (blocks + WARPS - 1) / WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qblock_quantize_kernel<<<(unsigned)grid, THREADS, 0,
                           (cudaStream_t)stream>>>(x, q, scale, rows, n, nb,
                                                   block, eps);
  return (int)cudaGetLastError();
}
