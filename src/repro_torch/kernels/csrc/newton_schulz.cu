// newton_schulz: Newton–Schulz orthogonalisation of a list of matrices,
// the pre-scale and every quintic step in one persistent launch.
//
// Replaces the Pallas TPU path repro/kernels/ns_ortho/ops.py::
// newton_schulz_pallas (and ns_iteration_pallas, one quintic step as three
// matmul_fused pallas_calls, repro/kernels/ns_ortho/kernel.py:95).  Each
// matrix (batch entry of a list entry) is taken in its wide form (m <= n,
// a tall input read as its transpose), divided by its Frobenius norm + eps,
// then `steps` times
//   A = X X^T,   B = c (A A) + b A,   X' = B X + a X.
//
// Bound on an H100: in full f32 the products run on the 67 TFLOP/s FP32
// (non-tensor-core) pipe.  One ViT-Tiny Muon step (240 matrices) is 119.3
// GFLOP of the reference's work over ~0.2 GB, so operations bound it.
//
// What the design does about what held the earlier composition (three
// grouped matmul_fused launches a step, 15 a call) back:
//  1. One launch a call.  The work is a list of tiles, numbered by a
//     global ticket in phase order: the norm's partial sums, the scaled
//     copy, then A, B and X' of step 0, of step 1, ...  Persistent blocks
//     take tickets from a counter; a tile waits (thread 0 spins on an
//     acquire load) until its matrix has finished every tile of the phases
//     before its own, counted by one completion counter a matrix, which a
//     block bumps (a release reduction after a barrier) after a tile's
//     stores.  Every
//     tile a tile waits for has an earlier ticket, and a ticket is only
//     handed to a running block, so every wait ends, whatever the grid.
//     Other matrices' tiles fill the card while one matrix waits, so the
//     14 phase boundaries of a step list cost no drain of the card and the
//     host builds one table instead of 15.
//  2. Square 64x64 tiles: every wide-form row count of the port's Muon
//     matrices (ViT-Tiny 192; LLaMA-60M 512; SmolLM-360M 320, 960) is a
//     multiple of 64, so no row tile idles (the 128x64 tiles of
//     matmul_fused left a quarter of the second row tile of 192 empty).
//     Each of 64 threads owns an 8x8 register micro-tile over a 4-stage
//     cp.async ring of K-slices of 16: the 16-byte loaders and register
//     fragments of matmul_fused.cu, shared through ring.cuh (only two of
//     matmul_fused's four operand layouts are needed here, both with the
//     lhs k-contiguous; its cross-tile loader is not used, since a tile
//     may only read its operands once it has waited for them).
//  3. Symmetric products once: A and B are symmetric, so only their tiles
//     on or above the diagonal are computed, each off-diagonal one stored
//     twice (once transposed).  An element and its mirror sum the same
//     products in the same K order (fmaf(x, y, s) == fmaf(y, x, s), and B
//     reads A[k][j] as A[j][k], bitwise equal), so the result is bitwise
//     the full product's.  This saves 47% of A's and B's work at 960.
//  4. The pre-scale inside the launch: a first phase reads each input
//     through its strides and dtype (f32, bf16, f16; tall inputs as
//     transposes, leading dims folded into the batch) and writes each
//     tile's sum of squares to a fixed slot; the second sums a matrix's
//     slots in a fixed order (no float atomics: two calls agree bitwise),
//     and writes x / (||x||_F + eps) into the scratch arena, the tile
//     staged in shared memory so that reads run along the input's
//     unit-stride axis and writes along scratch rows.
//
// Scratch (the wrapper's one torch.empty arena; the kernel allocates
// nothing): per matrix X ping-pong buffers, A and B, every row padded to a
// multiple of 16 bytes, so every operand read is a 16-byte cp.async.cg;
// ragged ends are zero-filled by the copies' source size and masked in
// the epilogues.  The last X' phase writes the contiguous wide output.
// Data written in the launch is read only through L2 (cp.async.cg,
// ld.global.cg), never through L1 (cp.async.ca, __ldg, .nc).  The entry
// point zeroes the ticket and completion counters with cudaMemsetAsync on
// the stream before the launch.
//
// Numerics: FP32 FFMA accumulated in K order, no TF32.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped.cuh"
#include "ring.cuh"

namespace {

// the ring's 16-byte loaders and register fragments (ring.cuh, shared
// with matmul_fused.cu)
using namespace ring;

constexpr int T = 64;                 // square output tile
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int TY = T / TM;            // threads along rows
constexpr int TX = T / TN;            // threads along columns
constexpr int THREADS = TX * TY;      // 64
constexpr int STAGES = 4;
// 4 blocks (8 warps) an SM at <= 255 registers, no spill: asked for 5,
// ptxas caps the kernel at 168 registers and spills, which measured
// slower at both ViT-Tiny's and SmolLM-360M's shapes; so did 3 stages
constexpr int MIN_BLOCKS = 4;
constexpr int MAX_STEPS = 16;
constexpr long long WAIT_LIMIT = 1LL << 36;   // SM cycles, ~40 s

constexpr int STAGE_FLOATS =
    T * (BK + PAD) > BK * (T + PAD) ? T * (BK + PAD) : BK * (T + PAD);
constexpr int SMEM_BYTES = STAGES * 2 * STAGE_FLOATS * 4;
constexpr int PRE_PITCH = T + 1;      // the pre-scale's staged tile

static_assert(T * PRE_PITCH <= 2 * STAGES * STAGE_FLOATS,
              "the pre-scale tile fits the ring's shared memory");
static_assert((T * BK / 4) % THREADS == 0 && THREADS % (T / 4) == 0 &&
              THREADS % (BK / 4) == 0, "16-byte runs split evenly");
static_assert((THREADS & (THREADS - 1)) == 0, "a power-of-two reduction");
static_assert(TX == TY && TM == 8 && TN == 8, "the register mappings");

enum : int { F32 = 0, BF16 = 1, F16 = 2 };
enum : int { RED = 0, SCALE = 1, PA = 2, PB = 3, PX = 4 };

struct Head {
  int num_mats, steps, total, num_inst;
  int full_total;     // tiles of one full phase (RED, SCALE, X') in all
  int sym_total;      // tiles of one symmetric phase (A, B)
  int pad0, pad1;
  float a, b, c, eps;
  int* counters;      // [0] the ticket, [1 + inst] tiles done by instance
  float* base;        // the arena (partials and scratch are offsets into it)
};
static_assert(sizeof(Head) == 64, "Head layout is mirrored on the host");

struct Mat {
  const void* in;     // element (b, r, c) of the wide view at
                      // in + b in_sb + r in_sr + c in_sc (elements)
  float* out;         // contiguous (batch, m, n)
  float* scratch;     // X0 | X1 (batch x m x ldx) | A | B (batch x m x lda)
  int64_t in_sb, in_sr, in_sc;
  int batch, m, n, ldx, lda, dtype;
  int tm, tn;         // tiles along m and n
  int full_start;     // first tile of this matrix in a full phase
  int sym_start;      // ... in a symmetric phase
  int inst;           // its first instance (batch entry) in the launch
  int part;           // its partial sums' offset in floats from base
};
static_assert(sizeof(Mat) == 96, "Mat layout is mirrored on the host");

constexpr int MAX_MATS =
    (grouped::PARAM_LIMIT - sizeof(Head)) / sizeof(Mat);   // 340

struct Table {
  Head h;
  Mat p[MAX_MATS];
};
static_assert(sizeof(Table) <= grouped::PARAM_LIMIT,
              "the table must fit the launch");

// ------------------------------------------------------------ memory ops

__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The input element at offset e (elements) as f32 (read-only data: the
// input is never written in the launch).
template <int DT>
__device__ __forceinline__ float load_in(const void* in, int64_t e) {
  if constexpr (DT == BF16) {
    const unsigned short u = __ldg(static_cast<const unsigned short*>(in) + e);
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  } else if constexpr (DT == F16) {
    return __half2float(__ldg(static_cast<const __half*>(in) + e));
  } else {
    return __ldg(static_cast<const float*>(in) + e);
  }
}

// ------------------------------------------------------------- the ring

// acc = lhs[row0.., :K] @ rhs[:K, col0..] over the ring.  lhs element
// (r, k) at lhs[r ldl + k] (r < rows).  BKC: rhs element (k, c) at
// rhs[c ldr + k] (c < cols), else at rhs[k ldr + c].  Register (i, j)
// holds row row0 + ty + 8i and column col0 + tx + 8j (BKC) or col0 +
// (j < 4 ? 4tx + j : 32 + 4tx + j - 4).
template <bool BKC>
__device__ __forceinline__ void mma_tile(const float* lhs, int ldl, int rows,
                                         const float* rhs, int ldr, int cols,
                                         int K, int row0, int col0,
                                         float* smem, float (&acc)[TM][TN],
                                         int tid, int tx, int ty) {
  float* As = smem;
  float* Bs = smem + STAGES * STAGE_FLOATS;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const Plan pa = plan<T, THREADS>(lhs, ldl, 1, rows, K, row0, true, tid);
  const Plan pb = BKC
      ? plan<T, THREADS>(rhs, ldr, 1, cols, K, col0, true, tid)
      : plan<T, THREADS>(rhs, 1, ldr, cols, K, col0, false, tid);
  const int kt_n = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) {
      load_vec<T, THREADS>(pa, As + s * STAGE_FLOATS, s * BK, true, lhs, tid);
      load_vec<T, THREADS>(pb, Bs + s * STAGE_FLOATS, s * BK, BKC, rhs, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();   // this slice has landed (this thread's)
    __syncthreads();               // ...everyone's; the previous one is done
    const int nk = kt + STAGES - 1;
    if (nk < kt_n) {               // into the previous slice's stage
      const int slot = nk % STAGES;
      load_vec<T, THREADS>(pa, As + slot * STAGE_FLOATS, nk * BK, true, lhs,
                           tid);
      load_vec<T, THREADS>(pb, Bs + slot * STAGE_FLOATS, nk * BK, BKC, rhs,
                           tid);
    }
    cp_async_commit();
    const float* as = As + (kt % STAGES) * STAGE_FLOATS;
    const float* bs = Bs + (kt % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float a4[4][8], b4[4][8];
      load_frag_kc<TY>(as, ty, kc, a4);
      if constexpr (BKC) load_frag_kc<TX>(bs, tx, kc, b4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[8];
        if constexpr (BKC) {
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = b4[q][j];
        } else {
          load_frag_k<T>(bs, tx, kc + q, b);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a4[q][i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free for the next tile
}

// ----------------------------------------------------------- the phases

// Sum of v over the block in a fixed order (deterministic).
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

constexpr int PRE_PER_THREAD = T * T / THREADS;   // 64
constexpr int PRE_UNROLL = 8;
static_assert(PRE_PER_THREAD % PRE_UNROLL == 0, "whole unrolled runs");

// f(u, i, j, v) for each element of this thread's share of the T x T
// pre-scale tile at (r0, c0): (i, j) inside the tile, v its value (0
// outside the matrix), u its place in a run of PRE_UNROLL loads in
// flight.  The input's unit-stride axis runs fastest across threads, and
// every thread visits its elements in a fixed order, so the sums below
// are deterministic.
template <int DT, typename F>
__device__ __forceinline__ void each_element(const Mat& P, int b, int r0,
                                             int c0, int tid, F f) {
  const int rr = min(T, P.m - r0), cc = min(T, P.n - c0);
  const bool by_rows = P.in_sr == 1 && P.in_sc != 1;
  const int64_t base = b * P.in_sb + r0 * P.in_sr + c0 * P.in_sc;
#pragma unroll 1
  for (int k0 = 0; k0 < PRE_PER_THREAD; k0 += PRE_UNROLL) {
    float v[PRE_UNROLL];
    int ii[PRE_UNROLL], jj[PRE_UNROLL];
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) {
      const int e = tid + (k0 + u) * THREADS;
      ii[u] = by_rows ? e % T : e / T;
      jj[u] = by_rows ? e / T : e % T;
      const bool in = ii[u] < rr && jj[u] < cc;
      v[u] = in ? load_in<DT>(P.in,
                              base + ii[u] * P.in_sr + jj[u] * P.in_sc)
                : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) f(u, ii[u], jj[u], v[u]);
  }
}

// RED: the tile's sum of squares into its fixed slot.
template <int DT>
__device__ void reduce_tile(const Head& h, const Mat& P, int b, int ti,
                            int tj, float* red, int tid) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  each_element<DT>(P, b, ti * T, tj * T, tid,
                   [&](int u, int, int, float v) {
                     s[u & 3] = fmaf(v, v, s[u & 3]);
                   });
  const float sum = block_sum((s[0] + s[1]) + (s[2] + s[3]), red, tid);
  if (tid == 0)
    h.base[P.part + static_cast<int64_t>(b) * P.tm * P.tn + ti * P.tn + tj] =
        sum;
}

// SCALE: the matrix's norm from its slots in a fixed order, then the
// tile divided by norm + eps into X0 (or, with no step, the output),
// staged in shared memory so that writes run along rows.
template <int DT>
__device__ void scale_tile(const Head& h, const Mat& P, int b, int ti,
                           int tj, float* smem, float* red, int tid) {
  const int slots = P.tm * P.tn;
  const float* part = h.base + P.part + static_cast<int64_t>(b) * slots;
  float s = 0.f;
  for (int k = tid; k < slots; k += THREADS) s += ld_cg(part + k);
  const float denom = sqrtf(block_sum(s, red, tid)) + h.eps;
  const int r0 = ti * T, c0 = tj * T;
  each_element<DT>(P, b, r0, c0, tid, [&](int, int i, int j, float v) {
    smem[i * PRE_PITCH + j] = v;
  });
  __syncthreads();
  float* dst;
  int64_t pitch;
  if (h.steps == 0) {
    dst = P.out + static_cast<int64_t>(b) * P.m * P.n;
    pitch = P.n;
  } else {
    dst = P.scratch + static_cast<int64_t>(b) * P.m * P.ldx;
    pitch = P.ldx;
  }
  const int rr = min(T, P.m - r0), cc = min(T, P.n - c0);
  for (int e = tid; e < T * T; e += THREADS) {
    const int i = e / T, j = e % T;
    if (i < rr && j < cc)
      dst[(r0 + i) * pitch + c0 + j] = smem[i * PRE_PITCH + j] / denom;
  }
  __syncthreads();
}

// A or B: the (ti, tj) tile of a symmetric m x m product, tj >= ti, stored
// at (ti, tj) and, off the diagonal, transposed at (tj, ti).
__device__ void sym_tile(const float* lhs, int ldl, int K, int m, int ti,
                         int tj, float alpha, const float* aux, float beta,
                         float* dst, int ld, float* smem, int tid, int tx,
                         int ty) {
  float acc[TM][TN];
  const int row0 = ti * T, col0 = tj * T;
  // the rhs (k, c) = lhs[c][k]: X^T for A, and A[k][c] = A[c][k] for B
  mma_tile<true>(lhs, ldl, m, lhs, ldl, m, K, row0, col0, smem, acc, tid, tx,
                 ty);
  const bool mirror = ti != tj;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= m) continue;
      float v = alpha * acc[i][j];
      if (aux != nullptr)
        v += beta * ld_cg(aux + static_cast<int64_t>(r) * ld + c);
      dst[static_cast<int64_t>(r) * ld + c] = v;
      if (mirror) dst[static_cast<int64_t>(c) * ld + r] = v;
    }
  }
}

// X': the (ti, tj) tile of B X + a X, into the next X or the output.
__device__ void x_tile(const float* bm, int lda, const float* x, int ldx,
                       int m, int n, int ti, int tj, float a, float* dst,
                       int64_t ldd, bool vec, float* smem, int tid, int tx,
                       int ty) {
  float acc[TM][TN];
  const int row0 = ti * T, col0 = tj * T;
  mma_tile<false>(bm, lda, m, x, ldx, n, m, row0, col0, smem, acc, tid, tx,
                  ty);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= m) continue;
    const float* xr = x + static_cast<int64_t>(r) * ldx;
    float* dr = dst + r * ldd;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = col0 + hh * (T / 2) + tx * 4;
      if (c >= n) continue;
      if (c + 4 <= n) {
        const float4 xv = ld_cg4(xr + c);
        const float4 v = make_float4(
            fmaf(a, xv.x, acc[i][4 * hh]), fmaf(a, xv.y, acc[i][4 * hh + 1]),
            fmaf(a, xv.z, acc[i][4 * hh + 2]),
            fmaf(a, xv.w, acc[i][4 * hh + 3]));
        if (vec) {
          *reinterpret_cast<float4*>(dr + c) = v;
        } else {
          dr[c] = v.x; dr[c + 1] = v.y; dr[c + 2] = v.z; dr[c + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < n)
            dr[c + q] = fmaf(a, ld_cg(xr + c + q), acc[i][4 * hh + q]);
      }
    }
  }
}

// ------------------------------------------------------------- schedule

// A ticket's work: phase kind, step, matrix, batch entry, tile (ti, tj).
struct Work {
  int kind, step, mat, b, ti, tj;
};

// Tickets run phase by phase: RED, SCALE (full_total each), then each
// step's A, B (sym_total each) and X' (full_total).  Within a phase,
// matrix by matrix, batch entry by entry, tile by tile (row-major; the
// symmetric phases' upper triangle row by row).  The CPU tests decode
// the host's tables with a numpy mirror of this and of ``need``.
__device__ Work decode(const Table& g, const int* full_starts,
                       const int* sym_starts, int t) {
  const int F = g.h.full_total, S = g.h.sym_total;
  Work w{RED, 0, 0, 0, 0, 0};
  int local;
  if (t < F) {
    local = t;
  } else if (t < 2 * F) {
    w.kind = SCALE;
    local = t - F;
  } else {
    const int u = t - 2 * F, per = 2 * S + F;
    w.step = u / per;
    local = u - w.step * per;
    if (local < S) {
      w.kind = PA;
    } else if (local < 2 * S) {
      w.kind = PB;
      local -= S;
    } else {
      w.kind = PX;
      local -= 2 * S;
    }
  }
  const bool sym = w.kind == PA || w.kind == PB;
  w.mat = grouped::find(sym ? sym_starts : full_starts, g.h.num_mats, local);
  const Mat& P = g.p[w.mat];
  local -= sym ? sym_starts[w.mat] : full_starts[w.mat];
  const int per = sym ? P.tm * (P.tm + 1) / 2 : P.tm * P.tn;
  w.b = local / per;
  int idx = local - w.b * per;
  if (sym) {
    while (idx >= P.tm - w.ti) { idx -= P.tm - w.ti; ++w.ti; }
    w.tj = w.ti + idx;
  } else {
    w.ti = idx / P.tn;
    w.tj = idx - w.ti * P.tn;
  }
  return w;
}

// Tiles of its own matrix instance that a tile waits for: every tile of
// the phases before its own.
__device__ __forceinline__ int need(const Work& w, const Mat& P) {
  const int f = P.tm * P.tn, s = P.tm * (P.tm + 1) / 2;
  switch (w.kind) {
    case RED: return 0;
    case SCALE: return f;
    case PA: return 2 * f + w.step * (2 * s + f);
    case PB: return 2 * f + w.step * (2 * s + f) + s;
    default: return 2 * f + w.step * (2 * s + f) + 2 * s;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
newton_schulz_kernel(const __grid_constant__ Table g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int full_starts[MAX_MATS];
  __shared__ int sym_starts[MAX_MATS];
  __shared__ float red[THREADS];
  __shared__ int next;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Head& h = g.h;
  for (int i = tid; i < h.num_mats; i += THREADS) {
    full_starts[i] = g.p[i].full_start;
    sym_starts[i] = g.p[i].sym_start;
  }
  if (tid == 0) next = atomicAdd(h.counters, 1);
  __syncthreads();
  int t = next;
  while (t < h.total) {
    __syncthreads();                         // everyone has read `next`
    if (tid == 0) next = atomicAdd(h.counters, 1);   // fetched early
    const Work w = decode(g, full_starts, sym_starts, t);
    const Mat& P = g.p[w.mat];
    int* done = h.counters + 1 + P.inst + w.b;
    const int want = need(w, P);
    if (want > 0) {
      if (tid == 0) {
        // a wait that outlasts any phase by far is a fault: trap (the
        // launch fails) rather than hang the card
        const long long t0 = clock64();
        while (ld_acquire(done) < want) {
          __nanosleep(64);
          if (clock64() - t0 > WAIT_LIMIT) __trap();
        }
      }
      __syncthreads();
    }
    const int64_t xs = static_cast<int64_t>(P.m) * P.ldx;
    const int64_t as = static_cast<int64_t>(P.m) * P.lda;
    float* x0 = P.scratch + w.b * xs;
    float* x1 = P.scratch + (P.batch + w.b) * xs;
    float* am = P.scratch + 2 * P.batch * xs + w.b * as;
    float* bm = P.scratch + 2 * P.batch * xs + (P.batch + w.b) * as;
    float* xcur = (w.step & 1) ? x1 : x0;
    switch (w.kind) {
      case RED:
        if (P.dtype == BF16)
          reduce_tile<BF16>(h, P, w.b, w.ti, w.tj, red, tid);
        else if (P.dtype == F16)
          reduce_tile<F16>(h, P, w.b, w.ti, w.tj, red, tid);
        else
          reduce_tile<F32>(h, P, w.b, w.ti, w.tj, red, tid);
        break;
      case SCALE:
        if (P.dtype == BF16)
          scale_tile<BF16>(h, P, w.b, w.ti, w.tj, smem, red, tid);
        else if (P.dtype == F16)
          scale_tile<F16>(h, P, w.b, w.ti, w.tj, smem, red, tid);
        else
          scale_tile<F32>(h, P, w.b, w.ti, w.tj, smem, red, tid);
        break;
      case PA:
        sym_tile(xcur, P.ldx, P.n, P.m, w.ti, w.tj, 1.f, nullptr, 0.f, am,
                 P.lda, smem, tid, tx, ty);
        break;
      case PB:
        sym_tile(am, P.lda, P.m, P.m, w.ti, w.tj, h.c, am, h.b, bm, P.lda,
                 smem, tid, tx, ty);
        break;
      default: {
        const bool last = w.step == h.steps - 1;
        float* dst = last ? P.out + static_cast<int64_t>(w.b) * P.m * P.n
                          : ((w.step & 1) ? x0 : x1);
        const int64_t ldd = last ? P.n : P.ldx;
        const bool vec = !last || (P.n % 4 == 0);
        x_tile(bm, P.lda, xcur, P.ldx, P.m, P.n, w.ti, w.tj, h.a, dst, ldd,
               vec, smem, tid, tx, ty);
        break;
      }
    }
    __syncthreads();                         // every store of the tile issued
    if (tid == 0) red_release(done, 1);      // cumulative: the block's stores
    t = next;
  }
}

int resident_blocks[grouped::MAX_DEVICES];   // 0 until the device is set up

cudaError_t setup(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= grouped::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident_blocks[dev] == 0) {
    err = cudaFuncSetAttribute(newton_schulz_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, newton_schulz_kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident_blocks[dev] = sms * per_sm;
  }
  *blocks = resident_blocks[dev];
  return cudaSuccess;
}

}  // namespace

// The compiled configuration, for the host's tables and checks:
// T, BK, STAGES, THREADS, MAX_MATS, sizeof(Mat), sizeof(Head),
// sizeof(Table), dynamic shared memory bytes, MAX_STEPS.
extern "C" void repro_newton_schulz_config(int* cfg) {
  const int v[] = {T, BK, STAGES, THREADS, MAX_MATS, (int)sizeof(Mat),
                   (int)sizeof(Head), (int)sizeof(Table), SMEM_BYTES,
                   MAX_STEPS};
  for (int i = 0; i < 10; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_newton_schulz_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = setup(&blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `table` points to a host Table (copied
// into the launch's parameters at the call).  Zeroes the launch's ticket
// and completion counters, then launches on `stream`; does not
// synchronise, and returns the first CUDA error so that a refused launch
// raises in the caller.
extern "C" int repro_newton_schulz(const void* table, void* stream) {
  int blocks = 0;
  cudaError_t err = setup(&blocks);
  if (err != cudaSuccess) return (int)err;
  const Table* g = static_cast<const Table*>(table);
  if (g->h.num_mats < 1 || g->h.num_mats > MAX_MATS || g->h.steps < 0 ||
      g->h.steps > MAX_STEPS || g->h.total < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(g->h.counters, 0,
                        sizeof(int) * (1 + (size_t)g->h.num_inst), s);
  if (err != cudaSuccess) return (int)err;
  const int grid = g->h.total < blocks ? g->h.total : blocks;
  void* args[] = {const_cast<void*>(table)};
  err = cudaLaunchKernel((const void*)newton_schulz_kernel, dim3(grid),
                         dim3(THREADS), args, SMEM_BYTES, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
