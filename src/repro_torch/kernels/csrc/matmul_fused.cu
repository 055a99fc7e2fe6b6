// matmul_fused: a group of products out_p = alpha_p * (lhs_p @ rhs_p) +
// beta_p * aux_p, each batched and strided, in f32, in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/ns_ortho/kernel.py::
// matmul_fused (blocked MXU matmul with the scale-and-add epilogue fused
// into the last K step).  SOAP calls it once per phase of its step: the
// Kronecker-factor EMAs (L' = (1-b2) G G^T + b2 L, R' = (1-b2) G^T G + b2
// R) of every matrix leaf in one launch, then each of the four eigenbasis
// rotations Q_L^T G, G Q_R, Q_L N, N Q_R^T of every leaf in one launch.
//
// Bound on an H100: in full f32 these products run on the 67 TFLOP/s FP32
// (non-tensor-core) pipe; one ViT-Tiny SOAP step is 138 GFLOP over tens
// of MB, so the FP32 rate bounds it (2.06 ms).
//
// What the design does about the three things that held the first (one
// 64x64-tile launch per product) kernel back:
//  1. Grids that did not fill the card: a launch takes a whole group of
//     problems (m, n, k and batch vary per problem) and runs persistent
//     blocks, as many as are resident on the card, each walking a global
//     tile index over the group.  A tile finds its problem by binary search
//     over the prefix tile counts, staged in shared memory.  The host
//     orders the problems by operand layout (so an SM's blocks run the
//     same one of the four mainloops and share the instruction cache),
//     then by K, longest first, so long-K tiles do not trail at the end.
//  2. A mainloop starved by shared memory: each thread owns an 8x8
//     register micro-tile (0.25 shared-memory floats per FMA, read as
//     128-bit ld.shared), over a ring of 4 K-slices of BK=16 in dynamic
//     shared memory filled by cp.async, so the loads of slice k+3 overlap
//     the FMAs of slice k.  The loader runs ahead across tile boundaries:
//     the next tile's first slices are in flight during this tile's last
//     ones and its epilogue.  A tile is stored as the operand's unit-stride
//     axis runs (k-contiguous rows, or k-major), so 16-byte cp.async.cg
//     copies need no transposition; their addresses and bounds are planned
//     once per tile.  The inner loop picks the matching register mapping
//     (one of four instantiations, chosen per problem).  Where the
//     unit-stride axis is not 16-byte aligned (the CNN's 27-wide rows,
//     108 B) a per-problem flag, set on the host, selects 4-byte copies;
//     ragged edges are zero-filled by the copies' source size and masked
//     in the epilogue, which reads aux and writes out 16 bytes at a time
//     where the layout allows.  No operand is padded or copied.
//  3. Host time: one launch per phase instead of one per product; the
//     problem table is passed by value as a __grid_constant__ parameter
//     (up to 227 problems of 144 B within Hopper's 32,764 bytes of
//     kernel parameters; the host splits a larger group), so there is no
//     host-to-device copy and no pinned buffer to race on.
//
// Tile shape: 128x64 outputs per 128-thread block, 3 blocks (12 warps) an
// SM at <= 168 registers.  tools/tune_matmul_tiles.py measures it against
// 128x128 and 64x128 (-DMF_BM/-DMF_BN) on the grouped ViT-Tiny step:
// 128x128 wastes a quarter of a tile on every 192 edge in both dimensions
// and fits one 256-thread block an SM; 64x128 is close (ahead on G Q_R
// and N Q_R^T, behind on the rest).  PERF.md keeps the numbers.
//
// Numerics: FP32 FFMA, accumulated in K order, no TF32.  Plain TF32 wgmma
// rounds every operand to 10 mantissa bits and breaks the 2(k+2)u bound
// the port holds this kernel to; 3xTF32 split precision is a later
// question.  TMA is not used: it needs a tensor map per operand of every
// problem, re-encoded on the host each step because the pointers change,
// and the CNN's 108-byte rows break its 16-byte stride rule.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

#ifndef MF_BM
#define MF_BM 128
#endif
#ifndef MF_BN
#define MF_BN 64
#endif

namespace {

// the ring's 16-byte loaders and register fragments (ring.cuh, shared
// with newton_schulz.cu)
using namespace ring;

constexpr int BM = MF_BM;
constexpr int BN = MF_BN;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int TY = BM / TM;           // threads along m
constexpr int TX = BN / TN;           // threads along n
constexpr int THREADS = TX * TY;
constexpr int STAGES = 4;
// Ask for 12 resident warps per SM (at most 168 registers a thread) where
// the block is small enough; a 256-thread block gets the whole file.
constexpr int MIN_BLOCKS = 384 / THREADS > 0 ? 384 / THREADS : 1;
constexpr int PARAM_LIMIT = 32764;    // bytes of kernel parameters (CUDA >= 12.1)

constexpr int stage_floats(int x) {
  return x * (BK + PAD) > BK * (x + PAD) ? x * (BK + PAD) : BK * (x + PAD);
}
constexpr int A_STAGE = stage_floats(BM);
constexpr int B_STAGE = stage_floats(BN);
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;

static_assert(TM == 8 && TN == 8, "the register mappings assume 8x8");
static_assert(BK % 4 == 0 && THREADS % 32 == 0, "whole float4s and warps");
static_assert((BM * BK / 4) % THREADS == 0 && (BN * BK / 4) % THREADS == 0 &&
              THREADS % (BM / 4) == 0 && THREADS % (BN / 4) == 0,
              "16-byte runs split evenly over the block");

// flags, set per problem on the host (kernels/ns_ortho/kernel.py)
enum : int {
  A_KC = 1,    // lhs's k axis has unit stride: A tile is [BM][BK+PAD]
  B_KC = 2,    // rhs's k axis has unit stride: B tile is [BN][BK+PAD]
  A_VEC = 4,   // lhs's unit-stride axis takes 16-byte copies
  B_VEC = 8,
  O_VEC = 16,  // n % 4 == 0 and aux (if any) takes 16-byte loads by rows
};

struct Problem {
  const float* lhs;
  const float* rhs;
  const float* aux;     // may be null
  float* out;           // contiguous (batch, m, n)
  int64_t l_sb, l_sm, l_sk;
  int64_t r_sb, r_sk, r_sn;
  int64_t x_sb, x_sm, x_sn;
  int batch, m, n, k;
  int tiles_m, tiles_n, tile_start, flags;
  float alpha, beta;
};
static_assert(sizeof(Problem) == 144, "Problem layout is mirrored on the host");

constexpr int MAX_PROBLEMS = (PARAM_LIMIT - 16) / sizeof(Problem);   // 227

struct Group {
  int num_problems, total_tiles, pad0, pad1;
  Problem p[MAX_PROBLEMS];
};
static_assert(sizeof(Group) <= PARAM_LIMIT, "the table must fit the launch");

// Where an operand's unit-stride axis takes no 16-byte copies (the CNN's
// 108-byte rows): 4-byte copies through any strides.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

template <int X>
__device__ __forceinline__ void load_scalar(float* s, const float* base,
                                            int64_t s_x, int64_t s_k,
                                            int ext_x, int k, int x0, int k0,
                                            bool kc, int tid) {
#pragma unroll 1   // the rare path: kept small for the instruction cache
  for (int e = tid; e < X * BK; e += THREADS) {
    int x, kk;
    if (kc) { x = e / BK; kk = e % BK; } else { kk = e / X; x = e % X; }
    const int gx = x0 + x, gk = k0 + kk;
    const bool in = gx < ext_x && gk < k;
    cp_async4(kc ? s + x * (BK + PAD) + kk : s + kk * (X + PAD) + x,
              in ? base + gx * s_x + gk * s_k : base, in ? 4 : 0);
  }
}

// Output row of register row i (col of register col j): a [X][BK+PAD]
// tile is read one row per register, strided over the threads (conflict
// free with the 5-float4 row pitch); a [BK][X+PAD] tile as two float4
// runs, at x = t*4 and X/2 + t*4.
template <bool KC, int X, int T>
__device__ __forceinline__ int reg_index(int t, int i) {
  return KC ? t + i * T : (i < 4 ? t * 4 + i : X / 2 + t * 4 + i - 4);
}

// A tile of the group: its problem (-1 past the group's end), batch entry,
// first output row and column, and number of K-slices.
struct TileRef {
  int p, b, row0, col0, ktiles;
};

__device__ __forceinline__ TileRef locate(const Group& g, const int* starts,
                                          int tile) {
  TileRef r{-1, 0, 0, 0, 0};
  if (tile >= g.total_tiles) return r;
  int lo = 0, hi = g.num_problems - 1;   // the last problem starting <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const Problem& P = g.p[lo];
  const int per_batch = P.tiles_m * P.tiles_n;
  int t = tile - starts[lo];
  r.p = lo;
  r.b = t / per_batch;
  t -= r.b * per_batch;
  r.row0 = (t / P.tiles_n) * BM;
  r.col0 = (t % P.tiles_n) * BN;
  r.ktiles = (P.k + BK - 1) / BK;
  return r;
}

// The producer side of the ring: the next K-slice to load, walking the
// block's tiles ahead of the consumer, across tile boundaries, so the
// next tile's first slices are in flight during this tile's last ones and
// its epilogue.
struct Loader {
  TileRef t;
  int tile, kt, slot;
  Plan a, b;
};

__device__ __forceinline__ void load_next(const Group& g, const int* starts,
                                          Loader& ld, float* As, float* Bs,
                                          int tid) {
  while (ld.t.p >= 0 && ld.kt == ld.t.ktiles) {   // also skips k == 0 tiles
    ld.tile += gridDim.x;
    ld.t = locate(g, starts, ld.tile);
    ld.kt = 0;
  }
  if (ld.t.p < 0) return;
  const Problem& P = g.p[ld.t.p];
  const int k0 = ld.kt * BK;
  const int flags = P.flags;
  const bool akc = flags & A_KC, bkc = flags & B_KC;
  if (ld.kt == 0) {
    ld.a = plan<BM, THREADS>(P.lhs + ld.t.b * P.l_sb, P.l_sm, P.l_sk, P.m, P.k,
                    ld.t.row0, akc, tid);
    ld.b = plan<BN, THREADS>(P.rhs + ld.t.b * P.r_sb, P.r_sn, P.r_sk, P.n, P.k,
                    ld.t.col0, bkc, tid);
  }
  float* as = As + ld.slot * A_STAGE;
  float* bs = Bs + ld.slot * B_STAGE;
  if (flags & A_VEC)
    load_vec<BM, THREADS>(ld.a, as, k0, akc, P.lhs, tid);
  else
    load_scalar<BM>(as, P.lhs + ld.t.b * P.l_sb, P.l_sm, P.l_sk, P.m, P.k,
                    ld.t.row0, k0, akc, tid);
  if (flags & B_VEC)
    load_vec<BN, THREADS>(ld.b, bs, k0, bkc, P.rhs, tid);
  else
    load_scalar<BN>(bs, P.rhs + ld.t.b * P.r_sb, P.r_sn, P.r_sk, P.n, P.k,
                    ld.t.col0, k0, bkc, tid);
  ++ld.kt;
  ld.slot = ld.slot + 1 == STAGES ? 0 : ld.slot + 1;
}

// The consumer side: one tile's K loop over the ring, then the epilogue.
template <bool AKC, bool BKC>
__device__ __forceinline__ void gemm_tile(const Group& g, const int* starts,
                                          const TileRef& cur, Loader& ld,
                                          int& slot, float* As, float* Bs,
                                          int tid, int tx, int ty) {
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < cur.ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // this slice has landed (this thread's)
    __syncthreads();               // ...everyone's; the previous one is done
    load_next(g, starts, ld, As, Bs, tid);   // into the previous one's stage
    cp_async_commit();
    const float* as = As + slot * A_STAGE;
    const float* bs = Bs + slot * B_STAGE;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float a4[4][8], b4[4][8];
      if constexpr (AKC) load_frag_kc<TY>(as, ty, kc, a4);
      if constexpr (BKC) load_frag_kc<TX>(bs, tx, kc, b4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if constexpr (AKC) a[i] = a4[q][i];
          if constexpr (BKC) b[i] = b4[q][i];
        }
        if constexpr (!AKC) load_frag_k<BM>(as, ty, kc + q, a);
        if constexpr (!BKC) load_frag_k<BN>(bs, tx, kc + q, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // fused epilogue: the scale-and-add costs no extra pass over memory
  const Problem& P = g.p[cur.p];
  const float* aux = P.aux != nullptr ? P.aux + cur.b * P.x_sb : nullptr;
  float* out = P.out + static_cast<int64_t>(cur.b) * P.m * P.n;
  if (!BKC && (P.flags & O_VEC)) {   // runs of 4 columns: 16-byte accesses
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = cur.row0 + reg_index<AKC, BM, TY>(ty, i);
      if (r >= P.m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = cur.col0 + h * (BN / 2) + tx * 4;
        if (c >= P.n) continue;
        float4 v = make_float4(
            P.alpha * acc[i][4 * h], P.alpha * acc[i][4 * h + 1],
            P.alpha * acc[i][4 * h + 2], P.alpha * acc[i][4 * h + 3]);
        if (aux != nullptr) {
          const float4 x =
              *reinterpret_cast<const float4*>(aux + r * P.x_sm + c);
          v.x += P.beta * x.x; v.y += P.beta * x.y;
          v.z += P.beta * x.z; v.w += P.beta * x.w;
        }
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * P.n + c) =
            v;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = cur.row0 + reg_index<AKC, BM, TY>(ty, i);
    if (r >= P.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = cur.col0 + reg_index<BKC, BN, TX>(tx, j);
      if (c >= P.n) continue;
      float val = P.alpha * acc[i][j];
      if (aux != nullptr) val += P.beta * aux[r * P.x_sm + c * P.x_sn];
      out[static_cast<int64_t>(r) * P.n + c] = val;
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
matmul_fused_group_kernel(const __grid_constant__ Group g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int starts[MAX_PROBLEMS];
  for (int i = threadIdx.x; i < g.num_problems; i += THREADS)
    starts[i] = g.p[i].tile_start;
  __syncthreads();
  float* As = smem;
  float* Bs = smem + STAGES * A_STAGE;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  Loader ld{locate(g, starts, blockIdx.x), static_cast<int>(blockIdx.x), 0,
            0, {}, {}};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_next(g, starts, ld, As, Bs, tid);
    cp_async_commit();
  }
  int slot = 0;
  for (int tile = blockIdx.x; tile < g.total_tiles; tile += gridDim.x) {
    const TileRef cur = locate(g, starts, tile);
    switch (g.p[cur.p].flags & (A_KC | B_KC)) {
      case 0:
        gemm_tile<false, false>(g, starts, cur, ld, slot, As, Bs, tid, tx, ty);
        break;
      case A_KC:
        gemm_tile<true, false>(g, starts, cur, ld, slot, As, Bs, tid, tx, ty);
        break;
      case B_KC:
        gemm_tile<false, true>(g, starts, cur, ld, slot, As, Bs, tid, tx, ty);
        break;
      default:
        gemm_tile<true, true>(g, starts, cur, ld, slot, As, Bs, tid, tx, ty);
        break;
    }
  }
  cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;
int resident_blocks[MAX_DEVICES];   // 0 until the device is set up

// Blocks of the kernel resident on the current device at once (SMs x
// blocks per SM); sets the kernel's dynamic shared-memory limit first.
cudaError_t setup(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident_blocks[dev] == 0) {
    err = cudaFuncSetAttribute(matmul_fused_group_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, matmul_fused_group_kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident_blocks[dev] = sms * per_sm;
  }
  *blocks = resident_blocks[dev];
  return cudaSuccess;
}

}  // namespace

// The compiled configuration, for the host's table builder and checks:
// BM, BN, BK, STAGES, THREADS, MAX_PROBLEMS, sizeof(Problem),
// sizeof(Group), dynamic shared memory bytes.
extern "C" void repro_matmul_fused_config(int* cfg) {
  const int v[] = {BM, BN, BK, STAGES, THREADS, MAX_PROBLEMS,
                   (int)sizeof(Problem), (int)sizeof(Group), SMEM_BYTES};
  for (int i = 0; i < 9; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_matmul_fused_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = setup(&blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `group` points to a host Group (the
// table, copied into the launch's parameters at the call); every out is a
// fresh contiguous buffer and every aux may be null.  Launches on
// `stream`, does not synchronise, and returns the launch's CUDA error so
// a refused launch raises in the caller.
extern "C" int repro_matmul_fused_group(const void* group, void* stream) {
  int blocks = 0;
  cudaError_t err = setup(&blocks);
  if (err != cudaSuccess) return (int)err;
  const Group* g = static_cast<const Group*>(group);
  if (g->num_problems < 1 || g->num_problems > MAX_PROBLEMS)
    return (int)cudaErrorInvalidValue;
  const int grid = g->total_tiles < blocks ? g->total_tiles : blocks;
  if (grid <= 0) return 0;
  void* args[] = {const_cast<void*>(group)};
  err = cudaLaunchKernel((const void*)matmul_fused_group_kernel, dim3(grid),
                         dim3(THREADS), args, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
