// matmul_fused: out = alpha * (lhs @ rhs) + beta * aux, batched, strided, f32.
//
// Replaces the Pallas TPU kernel repro/kernels/ns_ortho/kernel.py::matmul_fused
// (blocked MXU matmul with the scale-and-add epilogue fused into the last
// K step).  SOAP calls it for the Kronecker-factor EMAs
// (L' = (1-b2) G G^T + b2 L, R' = (1-b2) G^T G + b2 R) and for the four
// eigenbasis rotations Q_L^T G, G Q_R, Q_L N, N Q_R^T, batched over the
// client axis.
//
// Bound on an H100: in full f32 these products run on the 67 TFLOP/s FP32
// (non-tensor-core) pipe; at SOAP's shapes (m, n <= 768, k <= 768, batch
// 5) a product is a few hundred MFLOP over a few MB, so the FP32 rate bounds
// it, and at the smallest shapes launch overhead dominates both.
//
// Design: the simplest kernel that is right in full f32 (no TF32, no
// wgmma yet).  Each 256-thread block owns a 64x64 output tile and walks K
// in 16-deep slices staged in shared memory; each thread accumulates a 4x4
// micro-tile in registers with FMAs.  Operands come with arbitrary
// (batch, row, col) strides, so transposed views (G^T, Q_L^T, Q_R^T) need
// no copies; tile loads pick the thread order that walks the operand's
// unit-stride axis.  Ragged edges are masked in the loads and the
// epilogue, so no operand is padded.  The TPU kernel carried its
// accumulator across sequential grid steps; here the K loop lives inside
// the block and the epilogue runs once, after it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
matmul_fused_f32_kernel(const float* __restrict__ lhs,
                        const float* __restrict__ rhs,
                        const float* __restrict__ aux,
                        float* __restrict__ out,
                        int m, int n, int k,
                        int64_t l_sb, int64_t l_sm, int64_t l_sk,
                        int64_t r_sb, int64_t r_sk, int64_t r_sn,
                        int64_t x_sb, int64_t x_sm, int64_t x_sn,
                        float alpha, float beta) {
  __shared__ float a_tile[BK][BM + 4];  // k-major: a_tile[kk][row]
  __shared__ float b_tile[BK][BN + 4];  // b_tile[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int64_t bz = blockIdx.z;
  lhs += bz * l_sb;
  rhs += bz * r_sb;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      int r, c;
      if (l_sk == 1) { r = e / BK; c = e % BK; } else { c = e / BM; r = e % BM; }
      const int gr = row0 + r, gc = k0 + c;
      a_tile[c][r] = (gr < m && gc < k) ? lhs[gr * l_sm + gc * l_sk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      int r, c;
      if (r_sn == 1) { r = e / BN; c = e % BN; } else { c = e / BK; r = e % BK; }
      const int gr = k0 + r, gc = col0 + c;
      b_tile[r][c] = (gr < k && gc < n) ? rhs[gr * r_sk + gc * r_sn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_tile[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_tile[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue: the scale-and-add costs no extra pass over memory
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= n) continue;
      float val = alpha * acc[i][j];
      if (aux != nullptr) val += beta * aux[bz * x_sb + r * x_sm + c * x_sn];
      out[(bz * m + r) * n + c] = val;
    }
  }
}

}  // namespace

// C entry point bound with ctypes.  out is a fresh contiguous
// (batch, m, n) buffer; aux may be null.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch raises
// in the caller.
extern "C" int repro_matmul_fused_f32(
    const float* lhs, const float* rhs, const float* aux, float* out,
    int batch, int m, int n, int k,
    int64_t l_sb, int64_t l_sm, int64_t l_sk,
    int64_t r_sb, int64_t r_sk, int64_t r_sn,
    int64_t x_sb, int64_t x_sm, int64_t x_sn,
    float alpha, float beta, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  matmul_fused_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      lhs, rhs, aux, out, m, n, k, l_sb, l_sm, l_sk, r_sb, r_sk, r_sn,
      x_sb, x_sm, x_sn, alpha, beta);
  return (int)cudaGetLastError();
}
