// householder_qr: the Q of the reduced QR of a list of f32 matrices, each
// overwritten in place, in one grouped, persistent launch.
//
// Replaces no TPU kernel: the reference's SOAP refresh (repro/optim/
// soap.py) leaves its QR to XLA (jnp.linalg.qr), and has no Pallas QR.
// Added because the port's refresh sent each side to torch.linalg.qr, where
// cuSOLVER ran its unblocked geqr2 on the 1,920 small matrices of a
// ViT-Tiny round (20 clients x 96 sides of 192, 576 and 768): 2.69 s on
// an H100 against a bound of 10.8 ms, 0.4%.
//
// Bound on an H100: operations.  Householder QR and forming Q cost
// 4 m n^2 - 4/3 n^3 FLOP (8/3 n^3 square) on the 67 TFLOP/s FP32 pipe (no
// TF32: the configuration's and the reference's arithmetic); one read and
// one write of each matrix take a tenth of that time at these sizes.
//
// What the design does about it:
//  1. One launch a refresh.  A table of records (one a side, its client
//     batch stride; __grid_constant__, as grouped.cuh's kernels) is
//     ordered largest problem first by the host; a CTA takes a matrix a
//     ticket and runs all of it.  So a launch is as long as its longest
//     CTA: the host sends it groups that fill the card or fit shared
//     memory, and leaves a few large matrices to the library, which
//     spreads one matrix over the card (householder_qr/kernel.py,
//     ``takes``).
//  2. Blocked Householder with compact WY (LAPACK's sgeqrf / sorgqr):
//     panels of NB = 32 columns are factored unblocked (sgeqr2, slarfg's
//     conventions), their T built as the columns go (slarft, forward,
//     columnwise), and the trailing columns updated a chunk of CW = 128 at
//     a time: W = V^T C, then C -= V (T^T W); Q is then accumulated
//     backward (C -= V (T W) on the later columns, sorg2r on the panel).
//     The products are register-tiled FP32 FMA inside the CTA (a 4 x 4
//     micro-tile a thread over row chunks staged in shared memory, the
//     next chunk prefetched into registers while this one is used).
//  3. In place, no scratch matrix: only Q is wanted, so each panel's tau
//     lies on its diagonal and its T in the strict upper triangle of its
//     diagonal block, where R would be.  A matrix that fits a block's
//     shared memory (ViT-Tiny's 192) is loaded once, factored and formed
//     there, and stored once; a larger one is
//     worked on through L2, its panel staged in shared memory while it is
//     factored or formed where the panel fits (up to ~1,250 rows), else
//     read eight rows a warp at a time.
//  4. Numerics: f32 FMA, no TF32; fixed reduction orders and no atomics in
//     sums, so one input gives the same bits every call (the grid size does
//     not change a matrix's arithmetic).  LAPACK's conventions: beta =
//     -sign(alpha) ||(alpha, x)||, tau = 0 (H = I) where x is exactly zero
//     (a zero matrix and the identity both give Q = I), slarfg's rescaling
//     where |beta| underflows, a column norm rescaled by its largest entry
//     where the plain sum of squares would over- or underflow.
//
// A matrix in device memory is read and written through L2 only
// (ld.global.cg / st.global.cg): its CTA streams it once a pass.  The
// entry point zeroes the ticket with cudaMemsetAsync on the stream before
// the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped.cuh"

namespace {

constexpr int NB = 32;                 // reflectors of a panel
constexpr int CW = 128;                // columns of a trailing-update chunk
constexpr int RC = 32;                 // rows of a staged row chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;    // 8
constexpr int VP = NB + 1;             // pitch of a staged panel or V chunk
constexpr int TP = NB + 1;             // pitch of T and of the Gram store
constexpr float SAFMIN = 0x1p-102f;    // LAPACK's slamch('S') / slamch('E')
constexpr float RSAFMIN = 0x1p102f;
constexpr float SSQ_LO = 0x1p-100f;    // a sum of squares outside [LO, HI]
constexpr float SSQ_HI = 0x1p100f;     // is taken again, scaled by max |x|

static_assert(THREADS == WARPS * 32 && NB == 32, "a lane a panel column");
static_assert(RC * NB == 4 * THREADS && RC * CW == 16 * THREADS,
              "a staged chunk splits evenly over the block");
static_assert(RC == 4 * WARPS && CW == 4 * 32 && NB == 4 * WARPS,
              "4 x 4 micro-tiles: rows ty + 8a, columns tx + 32b");

struct Head {
  int num_recs, num_inst;
  int* ticket;     // the next matrix (batch entry) of the launch
};
static_assert(sizeof(Head) == 16, "Head layout is mirrored on the host");

struct Rec {
  float* a;        // batch entry b: a + b sb, row-major m x n, m >= n
  int64_t sb;
  int batch, m, n;
  int inst;        // its first matrix (batch entry) in the launch
};
static_assert(sizeof(Rec) == 32, "Rec layout is mirrored on the host");

constexpr int MAX_RECS =
    (grouped::PARAM_LIMIT - sizeof(Head)) / sizeof(Rec);    // 1023

struct Table {
  Head h;
  Rec r[MAX_RECS];
};
static_assert(sizeof(Table) <= grouped::PARAM_LIMIT,
              "the table must fit the launch");

// dynamic shared memory, in floats: the big region (a resident matrix or a
// staged panel), then the fixed buffers
constexpr int V_FLOATS = 2 * RC * VP;       // V chunks, double-buffered
constexpr int C_FLOATS = 2 * RC * CW;       // C chunks, double-buffered
constexpr int W_FLOATS = NB * CW;           // W, W'; the Gram store
constexpr int T_FLOATS = NB * TP;
constexpr int RED_FLOATS = WARPS * NB;
constexpr int FIXED_FLOATS =
    V_FLOATS + C_FLOATS + W_FLOATS + T_FLOATS + RED_FLOATS + 2 * NB;
constexpr int BLOCK_SMEM = 232448;          // Hopper: 227 KB a block
constexpr int STATIC_BYTES = MAX_RECS * 4 + 256;   // starts[], margin
constexpr int BIG_FLOATS =
    ((BLOCK_SMEM - STATIC_BYTES) / 4 - FIXED_FLOATS) / 32 * 32;
constexpr int SMEM_BYTES = (BIG_FLOATS + FIXED_FLOATS) * 4;
static_assert(NB * TP <= W_FLOATS, "the Gram store fits W's buffer");

struct Smem {
  float* big;
  float* vs;       // [2][RC][VP]
  float* cs;       // [2][RC][CW]
  float* ws;       // [NB][CW]
  float* ts;       // [NB][TP]
  float* red;      // [WARPS][NB]
  float* taus;     // [NB]
  float* dots;     // [NB]
};

// ------------------------------------------------------------ memory ops

// SH: the data lies in shared memory; else in device memory, read and
// written through L2 only.
template <bool SH>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (SH) return *p;
  else return __ldcg(p);
}

template <bool SH>
__device__ __forceinline__ void st(float* p, float v) {
  if constexpr (SH) *p = v;
  else __stcg(p, v);
}

// Sum (max) of v over the block in a fixed order; every thread gets the
// same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s = fmaxf(s, red[i]);
  __syncthreads();
  return s;
}

// ------------------------------------------------------------ the panel

// ||P[r0:h, c]||: the plain sum of squares where it neither over- nor
// underflows, else the column scaled by its largest |entry| first.
template <bool SH>
__device__ float column_norm(const float* P, int ldp, int r0, int h, int c,
                             float* red) {
  float s = 0.f;
  for (int r = r0 + threadIdx.x; r < h; r += THREADS) {
    const float v = ld<SH>(P + static_cast<int64_t>(r) * ldp + c);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, red);
  if (s >= SSQ_LO && s <= SSQ_HI) return sqrtf(s);
  float a = 0.f;
  for (int r = r0 + threadIdx.x; r < h; r += THREADS)
    a = fmaxf(a, fabsf(ld<SH>(P + static_cast<int64_t>(r) * ldp + c)));
  a = block_max(a, red);
  if (!(a > 0.f)) return a;
  float q = 0.f;
  for (int r = r0 + threadIdx.x; r < h; r += THREADS) {
    const float v = ld<SH>(P + static_cast<int64_t>(r) * ldp + c) / a;
    q = fmaf(v, v, q);
  }
  return a * sqrtf(block_sum(q, red));
}

// Multiplies P[r0:h, c] by f.
template <bool SH>
__device__ __forceinline__ void scale_column(float* P, int ldp, int r0,
                                             int h, int c, float f) {
  for (int r = r0 + threadIdx.x; r < h; r += THREADS) {
    float* p = P + static_cast<int64_t>(r) * ldp + c;
    st<SH>(p, ld<SH>(p) * f);
  }
}

// d + sum of P[r][a] P[r][b] over the rows r = r0, r0 + WARPS, ... < h,
// in that order, eight rows' loads in flight at a time (a panel in device
// memory is latency-bound row by row).
template <bool SH>
__device__ __forceinline__ float dot_rows(const float* P, int ldp, int r0,
                                          int h, int a, int b, float d) {
  constexpr int U = 8;
  int r = r0;
  for (; r + (U - 1) * WARPS < h; r += U * WARPS) {
    float x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = P + static_cast<int64_t>(r + u * WARPS) * ldp;
      x[u] = ld<SH>(row + a);
      y[u] = ld<SH>(row + b);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) d = fmaf(x[u], y[u], d);
  }
  for (; r < h; r += WARPS) {
    const float* row = P + static_cast<int64_t>(r) * ldp;
    d = fmaf(ld<SH>(row + a), ld<SH>(row + b), d);
  }
  return d;
}

// P[r][b] += v_r t over the rows r = r0, r0 + WARPS, ... < h, where v_r
// = P[r][a], and 1 at row `one`; eight rows' loads in flight at a time.
template <bool SH>
__device__ __forceinline__ void axpy_rows(float* P, int ldp, int r0, int h,
                                          int a, int b, int one, float t) {
  constexpr int U = 8;
  int r = r0;
  for (; r + (U - 1) * WARPS < h; r += U * WARPS) {
    float x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = P + static_cast<int64_t>(r + u * WARPS) * ldp;
      x[u] = r + u * WARPS == one ? 1.f : ld<SH>(row + a);
      y[u] = ld<SH>(row + b);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      st<SH>(P + static_cast<int64_t>(r + u * WARPS) * ldp + b,
             fmaf(x[u], t, y[u]));
  }
  for (; r < h; r += WARPS) {
    float* row = P + static_cast<int64_t>(r) * ldp;
    const float v = r == one ? 1.f : ld<SH>(row + a);
    st<SH>(row + b, fmaf(v, t, ld<SH>(row + b)));
  }
}

__device__ __forceinline__ float neg_sign(float mag, float alpha) {
  return alpha >= 0.f ? -mag : mag;      // -sign(alpha) |mag|
}

// Householder QR of the h x jb panel at P (sgeqr2 column by column with
// slarfg's conventions), then its T (slarft, forward, columnwise).  On
// return the panel holds V below its diagonal, tau on it and T's strict
// upper triangle above it.
template <bool SH>
__device__ void panel_factor(float* P, int ldp, int h, int jb,
                             const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float* gs = s.ws;                      // gs[b][j] = v_b . v_j, b < j
  for (int j = 0; j < jb; ++j) {
    float xnorm = column_norm<SH>(P, ldp, j + 1, h, j, s.red);
    float alpha = ld<SH>(P + static_cast<int64_t>(j) * ldp + j);
    float tau = 0.f;
    if (xnorm != 0.f) {
      float beta = neg_sign(hypotf(alpha, xnorm), alpha);
      if (fabsf(beta) < SAFMIN) {        // slarfg: rescale, at most 20 times
        int knt = 0;
        do {
          ++knt;
          scale_column<SH>(P, ldp, j + 1, h, j, RSAFMIN);
          beta *= RSAFMIN;
          alpha *= RSAFMIN;
        } while (fabsf(beta) < SAFMIN && knt < 20);
        __syncthreads();
        xnorm = column_norm<SH>(P, ldp, j + 1, h, j, s.red);
        beta = neg_sign(hypotf(alpha, xnorm), alpha);
      }
      tau = (beta - alpha) / beta;
      scale_column<SH>(P, ldp, j + 1, h, j, 1.f / (alpha - beta));
    }
    if (tid == 0) s.taus[j] = tau;
    __syncthreads();
    // v_j's dots (v_j = 1 at row j): lane k > j gives w_k for the update,
    // lane k < j the Gram entry v_k . v_j for T
    if (lane < jb && lane != j)
      s.red[w * NB + lane] = dot_rows<SH>(
          P, ldp, j + 1 + w, h, j, lane,
          w == 0 ? ld<SH>(P + static_cast<int64_t>(j) * ldp + lane) : 0.f);
    __syncthreads();
    if (w == 0 && lane < jb && lane != j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) d += s.red[i * NB + lane];
      s.dots[lane] = d;
      if (lane < j) gs[lane * TP + j] = d;
    }
    __syncthreads();
    // H_j = I - tau v v^T on the panel's columns after j
    if (tau != 0.f && lane > j && lane < jb)
      axpy_rows<SH>(P, ldp, j + w, h, j, lane, j, -tau * s.dots[lane]);
    __syncthreads();
  }
  // T: T[j][j] = tau_j, T[0:j, j] = -tau_j T[0:j, 0:j] (V^T v_j)[0:j]
  if (w == 0) {
    for (int j = 0; j < jb; ++j) {
      float t = 0.f;
      if (lane < j)
        for (int b = lane; b < j; ++b)
          t = fmaf(s.ts[lane * TP + b], gs[b * TP + j], t);
      __syncwarp();
      if (lane < j) s.ts[lane * TP + j] = -s.taus[j] * t;
      if (lane == j) s.ts[j * TP + j] = s.taus[j];
      __syncwarp();
    }
  }
  __syncthreads();
  // tau and T into the diagonal block, where R would be
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int a = e / NB, b = e % NB;
    if (a <= b && b < jb)
      st<SH>(P + static_cast<int64_t>(a) * ldp + b, s.ts[a * TP + b]);
  }
  __syncthreads();
}

// The panel's columns of Q from its reflectors (sorg2r on the h x jb
// panel): V, tau and T are overwritten by the first jb columns of
// H_0 ... H_{jb-1} applied to I.
template <bool SH>
__device__ void panel_form_q(float* P, int ldp, int h, int jb,
                             const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid < jb)
    s.taus[tid] = ld<SH>(P + static_cast<int64_t>(tid) * ldp + tid);
  __syncthreads();
  for (int i = jb - 1; i >= 0; --i) {
    const float tau = s.taus[i];
    if (i < jb - 1 && tau != 0.f) {
      // w_k = v_i . P[i:h, k] (row i of the later columns is already 0)
      if (lane > i && lane < jb)
        s.red[w * NB + lane] = dot_rows<SH>(
            P, ldp, i + 1 + w, h, i, lane,
            w == 0 ? ld<SH>(P + static_cast<int64_t>(i) * ldp + lane) : 0.f);
      __syncthreads();
      if (w == 0 && lane > i && lane < jb) {
        float d = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) d += s.red[q * NB + lane];
        s.dots[lane] = d;
      }
      __syncthreads();
      if (lane > i && lane < jb)
        axpy_rows<SH>(P, ldp, i + w, h, i, lane, i, -tau * s.dots[lane]);
      __syncthreads();
    }
    scale_column<SH>(P, ldp, i + 1, h, i, -tau);
    if (tid == 0) st<SH>(P + static_cast<int64_t>(i) * ldp + i, 1.f - tau);
    for (int l = tid; l < i; l += THREADS)
      st<SH>(P + static_cast<int64_t>(l) * ldp + i, 0.f);
    __syncthreads();
  }
}

// ---------------------------------------------------- the trailing update

// Rows r0.. of the panel at j0 as V (1 on the diagonal, 0 above and past
// jb or m): this thread's 4 entries of the RC x NB chunk.
template <bool SH>
__device__ __forceinline__ void load_v(const float* A, int lda, int m,
                                       int j0, int jb, int r0,
                                       float (&vr)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + q * THREADS, k = e / NB, i = e % NB;
    const int r = r0 + k, d = r - (j0 + i);
    float v = 0.f;
    if (r < m && i < jb)
      v = d > 0 ? ld<SH>(A + static_cast<int64_t>(r) * lda + j0 + i)
                : (d == 0 ? 1.f : 0.f);
    vr[q] = v;
  }
}

__device__ __forceinline__ void store_v(float* vs, const float (&vr)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + q * THREADS;
    vs[(e / NB) * VP + e % NB] = vr[q];
  }
}

// Rows r0.. of columns [c0, c1): this thread's 16 entries of the RC x CW
// chunk (0 past m or c1).
template <bool SH>
__device__ __forceinline__ void load_c(const float* A, int lda, int m,
                                       int c0, int c1, int r0,
                                       float (&cr)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int e = threadIdx.x + q * THREADS, k = e / CW, c = c0 + e % CW;
    const int r = r0 + k;
    cr[q] = r < m && c < c1 ? ld<SH>(A + static_cast<int64_t>(r) * lda + c)
                            : 0.f;
  }
}

__device__ __forceinline__ void store_c(float* cs, const float (&cr)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) cs[threadIdx.x + q * THREADS] = cr[q];
}

// C = A[j0:m, c0:c1] <- (I - V op(T) V^T) C with the panel at j0: op(T) =
// T^T (TRANS: the factorisation's trailing update, H^T C) or T (the
// accumulation of Q, H C).  W = V^T C over row chunks (this thread's rows
// ty + 8a of W, columns tx + 32b), W' = op(T) W, then C -= V W' chunk by
// chunk.
template <bool SH, bool TRANS>
__device__ void block_update(float* A, int lda, int m, int j0, int jb,
                             int c0, int c1, const Smem& s) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int e = tid; e < NB * NB; e += THREADS) {
    const int a = e / NB, b = e % NB;
    s.ts[a * TP + b] =
        a <= b && b < jb
            ? ld<SH>(A + static_cast<int64_t>(j0 + a) * lda + j0 + b)
            : 0.f;
  }
  const int chunks = (m - j0 + RC - 1) / RC;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float vr[4], cr[16];
  load_v<SH>(A, lda, m, j0, jb, j0, vr);
  load_c<SH>(A, lda, m, c0, c1, j0, cr);
  store_v(s.vs, vr);
  store_c(s.cs, cr);
  __syncthreads();
  for (int q = 0; q < chunks; ++q) {
    const int buf = q & 1;
    const bool more = q + 1 < chunks;
    if (more) {
      load_v<SH>(A, lda, m, j0, jb, j0 + (q + 1) * RC, vr);
      load_c<SH>(A, lda, m, c0, c1, j0 + (q + 1) * RC, cr);
    }
    const float* vb = s.vs + buf * RC * VP;
    const float* cb = s.cs + buf * RC * CW;
#pragma unroll 8
    for (int k = 0; k < RC; ++k) {
      float v[4], c[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] = vb[k * VP + ty + 8 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) c[b] = cb[k * CW + tx + 32 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(v[a], c[b], acc[a][b]);
    }
    if (more) {
      store_v(s.vs + (buf ^ 1) * RC * VP, vr);
      store_c(s.cs + (buf ^ 1) * RC * CW, cr);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s.ws[(ty + 8 * a) * CW + tx + 32 * b] =
        acc[a][b];
  __syncthreads();
  // W' = op(T) W
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int l = 0; l < NB; ++l) {
    float t[4], wv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      t[a] = TRANS ? s.ts[l * TP + ty + 8 * a] : s.ts[(ty + 8 * a) * TP + l];
#pragma unroll
    for (int b = 0; b < 4; ++b) wv[b] = s.ws[l * CW + tx + 32 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(t[a], wv[b], acc[a][b]);
  }
  load_v<SH>(A, lda, m, j0, jb, j0, vr);
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s.ws[(ty + 8 * a) * CW + tx + 32 * b] =
        acc[a][b];
  store_v(s.vs, vr);
  __syncthreads();
  // C -= V W', this thread's rows r0 + ty + 8a and columns c0 + tx + 32b
  for (int q = 0; q < chunks; ++q) {
    const int buf = q & 1, r0 = j0 + q * RC;
    const bool more = q + 1 < chunks;
    if (more) load_v<SH>(A, lda, m, j0, jb, r0 + RC, vr);
    float cv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + ty + 8 * a, c = c0 + tx + 32 * b;
        cv[a][b] = r < m && c < c1
                       ? ld<SH>(A + static_cast<int64_t>(r) * lda + c)
                       : 0.f;
        acc[a][b] = 0.f;
      }
    const float* vb = s.vs + buf * RC * VP;
#pragma unroll 8
    for (int i = 0; i < NB; ++i) {
      float v[4], wv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] = vb[(ty + 8 * a) * VP + i];
#pragma unroll
      for (int b = 0; b < 4; ++b) wv[b] = s.ws[i * CW + tx + 32 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(v[a], wv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + ty + 8 * a, c = c0 + tx + 32 * b;
        if (r < m && c < c1)
          st<SH>(A + static_cast<int64_t>(r) * lda + c, cv[a][b] - acc[a][b]);
      }
    if (more) store_v(s.vs + (buf ^ 1) * RC * VP, vr);
    __syncthreads();
  }
}

// ------------------------------------------------------------- the phases

// The panel at j0 factored; a device-memory panel is staged in
// shared memory where it fits.
template <bool SH>
__device__ void factor(float* A, int lda, int m, int j0, int jb,
                       const Smem& s) {
  float* P = A + static_cast<int64_t>(j0) * lda + j0;
  const int h = m - j0;
  if constexpr (SH) {
    panel_factor<true>(P, lda, h, jb, s);
  } else if (h * VP <= BIG_FLOATS) {
    for (int e = threadIdx.x; e < h * NB; e += THREADS)
      if (e % NB < jb)
        s.big[(e / NB) * VP + e % NB] =
            __ldcg(P + static_cast<int64_t>(e / NB) * lda + e % NB);
    __syncthreads();
    panel_factor<true>(s.big, VP, h, jb, s);
    for (int e = threadIdx.x; e < h * NB; e += THREADS)
      if (e % NB < jb)
        __stcg(P + static_cast<int64_t>(e / NB) * lda + e % NB,
               s.big[(e / NB) * VP + e % NB]);
    __syncthreads();
  } else {
    panel_factor<false>(P, lda, h, jb, s);
  }
}

// The panel's columns of Q (sorg2r), rows above it zeroed.
template <bool SH>
__device__ void form(float* A, int lda, int m, int j0, int jb,
                     const Smem& s) {
  float* P = A + static_cast<int64_t>(j0) * lda + j0;
  const int h = m - j0;
  if constexpr (SH) {
    panel_form_q<true>(P, lda, h, jb, s);
  } else if (h * VP <= BIG_FLOATS) {
    for (int e = threadIdx.x; e < h * NB; e += THREADS)
      if (e % NB < jb)
        s.big[(e / NB) * VP + e % NB] =
            __ldcg(P + static_cast<int64_t>(e / NB) * lda + e % NB);
    __syncthreads();
    panel_form_q<true>(s.big, VP, h, jb, s);
    for (int e = threadIdx.x; e < h * NB; e += THREADS)
      if (e % NB < jb)
        __stcg(P + static_cast<int64_t>(e / NB) * lda + e % NB,
               s.big[(e / NB) * VP + e % NB]);
  } else {
    panel_form_q<false>(P, lda, h, jb, s);
  }
  for (int e = threadIdx.x; e < j0 * NB; e += THREADS)
    if (e % NB < jb)
      st<SH>(A + static_cast<int64_t>(e / NB) * lda + j0 + e % NB, 0.f);
  __syncthreads();
}

// A whole matrix by one CTA: the factorisation panel by panel (the panel,
// then the trailing update a chunk of CW columns at a time), then Q
// backward (the chunks after the panel, then the panel's own columns).
template <bool SH>
__device__ void qr_whole(float* A, int lda, int m, int n, const Smem& s) {
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int jb = min(NB, n - j0);
    factor<SH>(A, lda, m, j0, jb, s);
    for (int c0 = j0 + jb; c0 < n; c0 += CW)
      block_update<SH, true>(A, lda, m, j0, jb, c0, min(c0 + CW, n), s);
  }
  for (int j0 = (n - 1) / NB * NB; j0 >= 0; j0 -= NB) {
    const int jb = min(NB, n - j0);
    for (int c0 = j0 + jb; c0 < n; c0 += CW)
      block_update<SH, false>(A, lda, m, j0, jb, c0, min(c0 + CW, n), s);
    form<SH>(A, lda, m, j0, jb, s);
  }
}

// Whether an m x n matrix fits the big region, rows padded to n | 1 (odd:
// its columns read conflict-free).
__device__ __forceinline__ bool fits(int m, int n) {
  return m * (n | 1) <= BIG_FLOATS;
}

// A matrix that fits: loaded into shared memory, factored and formed
// there, stored back.
__device__ void qr_resident(float* A, int m, int n, const Smem& s) {
  const int ld = n | 1;
  for (int e = threadIdx.x; e < m * n; e += THREADS)
    s.big[(e / n) * ld + e % n] = __ldcg(A + e);
  __syncthreads();
  qr_whole<true>(s.big, ld, m, n, s);
  for (int e = threadIdx.x; e < m * n; e += THREADS)
    __stcg(A + e, s.big[(e / n) * ld + e % n]);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
householder_qr_kernel(const __grid_constant__ Table g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int starts[MAX_RECS];
  __shared__ int next;
  const int tid = threadIdx.x;
  Smem s;
  s.big = smem;
  s.vs = s.big + BIG_FLOATS;
  s.cs = s.vs + V_FLOATS;
  s.ws = s.cs + C_FLOATS;
  s.ts = s.ws + W_FLOATS;
  s.red = s.ts + T_FLOATS;
  s.taus = s.red + RED_FLOATS;
  s.dots = s.taus + NB;
  const Head& h = g.h;
  for (int i = tid; i < h.num_recs; i += THREADS) starts[i] = g.r[i].inst;
  __syncthreads();
  for (;;) {
    if (tid == 0) next = atomicAdd(h.ticket, 1);
    __syncthreads();
    const int t = next;
    __syncthreads();
    if (t >= h.num_inst) break;
    const Rec& R = g.r[grouped::find(starts, h.num_recs, t)];
    float* A = R.a + (t - R.inst) * R.sb;
    if (fits(R.m, R.n))
      qr_resident(A, R.m, R.n, s);
    else
      qr_whole<false>(A, R.n, R.m, R.n, s);
  }
}

int resident_blocks[grouped::MAX_DEVICES];   // 0 until the device is set up

cudaError_t setup(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= grouped::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident_blocks[dev] == 0) {
    err = cudaFuncSetAttribute(householder_qr_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, householder_qr_kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident_blocks[dev] = sms * per_sm;
  }
  *blocks = resident_blocks[dev];
  return cudaSuccess;
}

}  // namespace

// The compiled configuration, for the host's tables and checks: NB, CW,
// RC, THREADS, MAX_RECS, sizeof(Rec), sizeof(Head), sizeof(Table), dynamic
// shared memory bytes, BIG_FLOATS.
extern "C" void repro_householder_qr_config(int* cfg) {
  const int v[] = {NB, CW, RC, THREADS, MAX_RECS, (int)sizeof(Rec),
                   (int)sizeof(Head), (int)sizeof(Table), SMEM_BYTES,
                   BIG_FLOATS};
  for (int i = 0; i < 10; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_householder_qr_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = setup(&blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `table` points to a host Table (copied
// into the launch's parameters at the call).  Zeroes the launch's ticket,
// then launches at most a CTA a matrix on `stream`; does not synchronise, and returns
// the first CUDA error so that a refused launch raises in the caller.
extern "C" int repro_householder_qr(const void* table, void* stream) {
  int blocks = 0;
  cudaError_t err = setup(&blocks);
  if (err != cudaSuccess) return (int)err;
  const Table* g = static_cast<const Table*>(table);
  if (g->h.num_recs < 1 || g->h.num_recs > MAX_RECS || g->h.num_inst < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(g->h.ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int grid = g->h.num_inst < blocks ? g->h.num_inst : blocks;
  void* args[] = {const_cast<void*>(table)};
  err = cudaLaunchKernel((const void*)householder_qr_kernel, dim3(grid),
                         dim3(THREADS), args, SMEM_BYTES, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
