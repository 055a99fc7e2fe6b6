// matmul_fused: a group of products out_p = alpha_p * (lhs_p @ rhs_p) +
// beta_p * aux_p, each batched and strided, accumulated in f32, in one
// launch.  Each of lhs, rhs and aux is f32, bf16 or f16 (they may differ),
// and each problem names its output's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/ns_ortho/kernel.py::
// matmul_fused (blocked MXU matmul with the scale-and-add epilogue fused
// into the last K step, operands cast to f32 inside the body, the result
// written in lhs's dtype).  SOAP calls it once per phase of its step: the
// Kronecker-factor EMAs (L' = (1-b2) G G^T + b2 L, R' = (1-b2) G^T G + b2
// R) of every matrix leaf in one launch, then each of the four eigenbasis
// rotations Q_L^T G, G Q_R, Q_L N, N Q_R^T of every leaf in one launch.
// At SOAP's state_dtype bf16 the stored factors are read as they are: the
// EMAs write bf16 factors from an f32 G and a bf16 aux, the rotations f32
// results from a bf16 Q and an f32 G.
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
//     orders the problems by mainloop (so an SM's blocks run the same
//     one and share the instruction cache),
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
//     (one of four operand layouts, chosen per problem).  Where the
//     unit-stride axis is not 16-byte aligned (the CNN's 27-wide rows,
//     108 B) a per-problem flag, set on the host, selects element copies;
//     ragged edges are zero-filled by the copies' source size and masked
//     in the epilogue, which reads aux and writes out 4 elements at a time
//     where the layout allows.  No operand is padded or copied.
//  3. Host time: one launch per phase instead of one per product; the
//     problem table is passed by value as a __grid_constant__ parameter
//     (up to 227 problems of 144 B within Hopper's 32,764 bytes of
//     kernel parameters; the host splits a larger group), so there is no
//     host-to-device copy and no pinned buffer to race on.
//
// 2-byte operands.  Each is widened to f32 exactly, and the same FFMA
// mainloop runs in the same K order, so a product of bf16 or f16 operands
// is bitwise the product of their f32 casts.  The dtypes are per-problem
// fields (two bits each in the flags) that the loader and the epilogue
// read at run time, so no dtype pair multiplies the instantiations.  The
// source builds the kernel twice: a group of f32 problems runs the f32
// build, whose loader and epilogue have no dtype branch, any other group
// the mixed build, in which whether a tile widens is a template flag
// (the four layouts with and without the pass).  Code for 2-byte operands
// in the f32 mainloop, even untaken, cost the f32 loop registers, spills
// and time.  A 2-byte operand's slice is copied raw by the same 16-byte
// cp.async ring (runs of 8 elements, 8-element aligned; the host checks
// that by bytes), each run into the first half of the 32 bytes its 8
// elements take as f32 in the stage.  Once the slice has landed, each
// thread widens its own runs in place (a 16-byte read, two 16-byte
// writes over the same place: no other thread's run is there), then one
// barrier.  That keeps the copies asynchronous, and the fragment loads
// and the shared-memory footprint (3 blocks an SM) as they were; a
// second, raw ring would not fit beside three blocks' f32 rings.  A
// 2-byte operand whose runs are not aligned is loaded element by element
// and widened on the way (a synchronous load; the rare narrow path).  The
// epilogue widens a 2-byte aux and rounds a bf16 or f16 output once,
// round-to-nearest-even, from the f32 value.
//
// Tile shape: 128x64 outputs per 128-thread block, 3 blocks (12 warps) an
// SM at <= 168 registers.
//
// Numerics: FP32 FFMA, accumulated in K order, no TF32.  Plain TF32 wgmma
// rounds every operand to 10 mantissa bits and breaks the 2(k+2)u bound
// the port holds this kernel to; 3xTF32 split precision is a later
// question.  TMA is not used: it needs a tensor map per operand of every
// problem, re-encoded on the host each step because the pointers change,
// and the CNN's 108-byte rows break its 16-byte stride rule.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

// the ring's 16-byte loaders and register fragments (ring.cuh, shared
// with newton_schulz.cu)
using namespace ring;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int TY = BM / TM;           // threads along m
constexpr int TX = BN / TN;           // threads along n
constexpr int THREADS = TX * TY;
constexpr int STAGES = 4;
// 12 resident warps per SM: at most 168 registers a thread
constexpr int MIN_BLOCKS = 384 / THREADS;
constexpr int PARAM_LIMIT = 32764;    // bytes of kernel parameters (CUDA >= 12.1)

constexpr int stage_floats(int x) {
  return x * (BK + PAD) > BK * (x + PAD) ? x * (BK + PAD) : BK * (x + PAD);
}
constexpr int A_STAGE = stage_floats(BM);
constexpr int B_STAGE = stage_floats(BN);
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;

static_assert(TM == 8 && TN == 8, "the register mappings assume 8x8");
static_assert(BK % 8 == 0 && THREADS % 32 == 0, "whole 16-byte runs, warps");
static_assert((BM * BK / 8) % THREADS == 0 && (BN * BK / 8) % THREADS == 0 &&
              THREADS % (BM / 8) == 0 && THREADS % (BN / 8) == 0,
              "16-byte runs of 4-byte and of 2-byte elements split evenly "
              "over the block");

// flags, set per problem on the host (kernels/ns_ortho/kernel.py)
enum : int {
  A_KC = 1,    // lhs's k axis has unit stride: A tile is [BM][BK+PAD]
  B_KC = 2,    // rhs's k axis has unit stride: B tile is [BN][BK+PAD]
  A_VEC = 4,   // lhs's unit-stride axis takes 16-byte copies
  B_VEC = 8,
  O_VEC = 16,  // n % 4 == 0, and aux (if any) takes 4-element runs by rows
};
// Element types, two bits each in the flags from these shifts: lhs, rhs,
// aux and out.
enum : int { F32 = 0, BF16 = 1, F16 = 2, NUM_DTYPES = 3 };
enum : int { DT_LHS = 8, DT_RHS = 10, DT_AUX = 12, DT_OUT = 14 };

__device__ __forceinline__ int dtype_at(int flags, int shift) {
  return (flags >> shift) & 3;
}

// The element type the MIXED or the f32 build of the kernel reads: the
// f32 build folds every dtype branch away.
template <bool MIXED>
__device__ __forceinline__ int dtype_of(int flags, int shift) {
  return MIXED ? dtype_at(flags, shift) : F32;
}

__host__ __device__ constexpr int elem_bytes(int dt) {
  return dt == F32 ? 4 : 2;
}

struct Problem {
  const void* lhs;
  const void* rhs;
  const void* aux;      // may be null
  void* out;            // contiguous (batch, m, n)
  int64_t l_sb, l_sm, l_sk;   // strides in elements
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

// A 2-byte element widened to f32 (exact), and an f32 value rounded to
// one (round-to-nearest-even, as torch's .to(dtype)).
__device__ __forceinline__ float widen(uint32_t h, int dt) {
  return dt == BF16 ? __uint_as_float(h << 16)
                    : __half2float(__ushort_as_half(
                          static_cast<unsigned short>(h)));
}

__device__ __forceinline__ uint16_t narrow(float v, int dt) {
  return dt == BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(v))
                    : __half_as_ushort(__float2half_rn(v));
}

// Element i of a tensor of dtype dt, as f32; four from i (4-element
// aligned); and the stores of the rounded results.
__device__ __forceinline__ float load1(const void* p, int64_t i, int dt) {
  return dt == F32 ? static_cast<const float*>(p)[i]
                   : widen(static_cast<const uint16_t*>(p)[i], dt);
}

__device__ __forceinline__ float4 load4(const void* p, int64_t i, int dt) {
  if (dt == F32)
    return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
  const uint2 r =
      *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
  return make_float4(widen(r.x & 0xffffu, dt), widen(r.x >> 16, dt),
                     widen(r.y & 0xffffu, dt), widen(r.y >> 16, dt));
}

__device__ __forceinline__ void store1(void* p, int64_t i, int dt, float v) {
  if (dt == F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<uint16_t*>(p)[i] = narrow(v, dt);
}

__device__ __forceinline__ void store4(void* p, int64_t i, int dt, float4 v) {
  if (dt == F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
    return;
  }
  uint2 r;
  r.x = narrow(v.x, dt) | (static_cast<uint32_t>(narrow(v.y, dt)) << 16);
  r.y = narrow(v.z, dt) | (static_cast<uint32_t>(narrow(v.w, dt)) << 16);
  *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) = r;
}

// Where an operand's unit-stride axis takes no 16-byte copies (the CNN's
// 108-byte rows): 4-byte copies of f32 elements through any strides, or
// 2-byte elements loaded and widened on the way (cp.async copies no less
// than 4 bytes).
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

template <int X>
__device__ __forceinline__ void load_scalar(float* s, const void* base,
                                            int64_t s_x, int64_t s_k,
                                            int ext_x, int k, int x0, int k0,
                                            bool kc, int dt, int tid) {
#pragma unroll 1   // the rare path: kept small for the instruction cache
  for (int e = tid; e < X * BK; e += THREADS) {
    int x, kk;
    if (kc) { x = e / BK; kk = e % BK; } else { kk = e / X; x = e % X; }
    const int gx = x0 + x, gk = k0 + kk;
    const bool in = gx < ext_x && gk < k;
    float* d = kc ? s + x * (BK + PAD) + kk : s + kk * (X + PAD) + x;
    const int64_t off = gx * s_x + gk * s_k;
    if (dt == F32)
      cp_async4(d, in ? static_cast<const float*>(base) + off : base,
                in ? 4 : 0);
    else
      *d = in ? widen(static_cast<const uint16_t*>(base)[off], dt) : 0.f;
  }
}

// The widening pass over one stage: each thread's 16-byte runs of a
// 2-byte operand, as load_vec<X, THREADS, 2> left them at the f32 places
// of their first elements, rewritten in place as 8 floats each.
template <int X>
__device__ __forceinline__ void widen_runs(float* s, bool kc, int dt,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < X * BK / 8 / THREADS; ++i) {
    float* d = s + (kc ? (tid / (BK / 8) + i * (THREADS / (BK / 8)))
                             * (BK + PAD) + (tid % (BK / 8)) * 8
                       : (tid / (X / 8) + i * (THREADS / (X / 8)))
                             * (X + PAD) + (tid % (X / 8)) * 8);
    const uint4 r = *reinterpret_cast<const uint4*>(d);
    *reinterpret_cast<float4*>(d) = make_float4(
        widen(r.x & 0xffffu, dt), widen(r.x >> 16, dt),
        widen(r.y & 0xffffu, dt), widen(r.y >> 16, dt));
    *reinterpret_cast<float4*>(d + 4) = make_float4(
        widen(r.z & 0xffffu, dt), widen(r.z >> 16, dt),
        widen(r.w & 0xffffu, dt), widen(r.w >> 16, dt));
  }
}

// Which operands of a problem are staged raw (2-byte, 16-byte copies):
// bit 0 lhs, bit 1 rhs; any makes the tile run the RAW mainloop.
constexpr int RAW_LOOP = 4;
__device__ __forceinline__ int raw_operands(int flags) {
  return ((flags & A_VEC) && dtype_at(flags, DT_LHS) != F32 ? 1 : 0)
       | ((flags & B_VEC) && dtype_at(flags, DT_RHS) != F32 ? 2 : 0);
}

// Called by every thread once its copies of the stage have landed
// (block-uniform `raw`); the barrier after it lets the fragment loads
// read other threads' runs.
__device__ __forceinline__ void widen_stage(float* as, float* bs, int raw,
                                            int flags, int tid) {
  if (raw & 1) widen_runs<BM>(as, flags & A_KC, dtype_at(flags, DT_LHS), tid);
  if (raw & 2) widen_runs<BN>(bs, flags & B_KC, dtype_at(flags, DT_RHS), tid);
  __syncthreads();
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

// An operand's base at batch entry b.
__device__ __forceinline__ const void* batch_base(const void* p, int b,
                                                  int64_t sb, int dt) {
  return static_cast<const char*>(p) + b * sb * elem_bytes(dt);
}

// An operand's K-slice into its stage: 16-byte copies of its own element
// size where its flag allows, else element by element.
template <int X>
__device__ __forceinline__ Plan plan_operand(const void* p, int b, int64_t sb,
                                             int64_t s_x, int64_t s_k,
                                             int ext_x, int k, int x0,
                                             bool kc, int dt, int tid) {
  const void* base = batch_base(p, b, sb, dt);
  return dt == F32
      ? plan<X, THREADS>(base, s_x, s_k, ext_x, k, x0, kc, tid)
      : plan<X, THREADS, 2>(base, s_x, s_k, ext_x, k, x0, kc, tid);
}

template <int X>
__device__ __forceinline__ void load_operand(const Plan& pl, float* s,
                                             const void* p, int b,
                                             int64_t sb, int64_t s_x,
                                             int64_t s_k, int ext_x, int k,
                                             int x0, int k0, bool kc,
                                             bool vec, int dt, int tid) {
  if (!vec)
    load_scalar<X>(s, batch_base(p, b, sb, dt), s_x, s_k, ext_x, k, x0, k0,
                   kc, dt, tid);
  else if (dt == F32)
    load_vec<X, THREADS>(pl, s, k0, kc, p, tid);
  else
    load_vec<X, THREADS, 2>(pl, s, k0, kc, p, tid);
}

template <bool MIXED>
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
  const int da = dtype_of<MIXED>(flags, DT_LHS);
  const int db = dtype_of<MIXED>(flags, DT_RHS);
  if (ld.kt == 0) {
    ld.a = plan_operand<BM>(P.lhs, ld.t.b, P.l_sb, P.l_sm, P.l_sk, P.m, P.k,
                            ld.t.row0, akc, da, tid);
    ld.b = plan_operand<BN>(P.rhs, ld.t.b, P.r_sb, P.r_sn, P.r_sk, P.n, P.k,
                            ld.t.col0, bkc, db, tid);
  }
  load_operand<BM>(ld.a, As + ld.slot * A_STAGE, P.lhs, ld.t.b, P.l_sb,
                   P.l_sm, P.l_sk, P.m, P.k, ld.t.row0, k0, akc,
                   flags & A_VEC, da, tid);
  load_operand<BN>(ld.b, Bs + ld.slot * B_STAGE, P.rhs, ld.t.b, P.r_sb,
                   P.r_sn, P.r_sk, P.n, P.k, ld.t.col0, k0, bkc,
                   flags & B_VEC, db, tid);
  ++ld.kt;
  ld.slot = ld.slot + 1 == STAGES ? 0 : ld.slot + 1;
}

// The fused epilogue: the scale-and-add costs no extra pass over memory.
// WIDE: a 2-byte aux is widened or a 2-byte output rounded once; else
// both are f32 and the dtype branches fold away.
template <bool AKC, bool BKC, bool WIDE>
__device__ __forceinline__ void epilogue(const Problem& P, const TileRef& cur,
                                         const float (&acc)[TM][TN], int tx,
                                         int ty) {
  const int dx = WIDE ? dtype_at(P.flags, DT_AUX) : F32;
  const int dout = WIDE ? dtype_at(P.flags, DT_OUT) : F32;
  const void* aux = P.aux != nullptr
      ? static_cast<const char*>(P.aux) + cur.b * P.x_sb * elem_bytes(dx)
      : nullptr;
  const int64_t out0 = static_cast<int64_t>(cur.b) * P.m * P.n;
  if (!BKC && (P.flags & O_VEC)) {   // runs of 4 columns: 16- or 8-byte
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
          const float4 x = load4(aux, r * P.x_sm + c, dx);
          v.x += P.beta * x.x; v.y += P.beta * x.y;
          v.z += P.beta * x.z; v.w += P.beta * x.w;
        }
        store4(P.out, out0 + static_cast<int64_t>(r) * P.n + c, dout, v);
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
      if (aux != nullptr) val += P.beta * load1(aux, r * P.x_sm + c * P.x_sn,
                                                dx);
      store1(P.out, out0 + static_cast<int64_t>(r) * P.n + c, dout, val);
    }
  }
}


// The consumer side: one tile's K loop over the ring, then the epilogue.
// RAW: a 2-byte operand's slices are widened once they land; a tile of
// f32 operands runs the loop without the pass or its barrier (as a
// runtime branch, the pass cost the f32 loop registers and spills).
template <bool AKC, bool BKC, bool RAW, bool MIXED>
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
    load_next<MIXED>(g, starts, ld, As, Bs, tid);   // the previous stage
    cp_async_commit();
    float* as = As + slot * A_STAGE;
    float* bs = Bs + slot * B_STAGE;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if constexpr (RAW) {
      const int flags = g.p[cur.p].flags;
      widen_stage(as, bs, raw_operands(flags), flags, tid);
    }
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

  const Problem& P = g.p[cur.p];
  if (MIXED && (P.flags & ((3 << DT_AUX) | (3 << DT_OUT))))
    epilogue<AKC, BKC, true>(P, cur, acc, tx, ty);
  else
    epilogue<AKC, BKC, false>(P, cur, acc, tx, ty);
}

// One tile by the mainloop of its operand layout.
template <bool RAW, bool MIXED>
__device__ __forceinline__ void run_tile(int layout, const Group& g,
                                         const int* starts,
                                         const TileRef& cur, Loader& ld,
                                         int& slot, float* As, float* Bs,
                                         int tid, int tx, int ty) {
  switch (layout) {
    case 0:
      gemm_tile<false, false, RAW, MIXED>(g, starts, cur, ld, slot, As, Bs,
                                          tid, tx, ty);
      break;
    case A_KC:
      gemm_tile<true, false, RAW, MIXED>(g, starts, cur, ld, slot, As, Bs,
                                         tid, tx, ty);
      break;
    case B_KC:
      gemm_tile<false, true, RAW, MIXED>(g, starts, cur, ld, slot, As, Bs,
                                         tid, tx, ty);
      break;
    default:
      gemm_tile<true, true, RAW, MIXED>(g, starts, cur, ld, slot, As, Bs,
                                        tid, tx, ty);
      break;
  }
}

// MIXED: the build for a group with any 2-byte operand or output (its
// loader and epilogue read the dtype codes; tiles that widen run the RAW
// mainloops); else the f32 build, whose loader and epilogue are f32 only.
template <bool MIXED>
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
    load_next<MIXED>(g, starts, ld, As, Bs, tid);
    cp_async_commit();
  }
  int slot = 0;
  for (int tile = blockIdx.x; tile < g.total_tiles; tile += gridDim.x) {
    const TileRef cur = locate(g, starts, tile);
    const int flags = g.p[cur.p].flags;
    if constexpr (MIXED) {
      if (raw_operands(flags)) {
        run_tile<true, true>(flags & (A_KC | B_KC), g, starts, cur, ld, slot,
                             As, Bs, tid, tx, ty);
        continue;
      }
    }
    run_tile<false, MIXED>(flags & (A_KC | B_KC), g, starts, cur, ld, slot,
                           As, Bs, tid, tx, ty);
  }
  cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;
int resident_blocks[2][MAX_DEVICES];   // 0 until the device is set up

// Blocks of a build of the kernel resident on the current device at once
// (SMs x blocks per SM); sets its dynamic shared-memory limit first.
template <bool MIXED>
cudaError_t setup(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int& cached = resident_blocks[MIXED][dev];
  if (cached == 0) {
    err = cudaFuncSetAttribute(matmul_fused_group_kernel<MIXED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, matmul_fused_group_kernel<MIXED>, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = sms * per_sm;
  }
  *blocks = cached;
  return cudaSuccess;
}

template <bool MIXED>
cudaError_t launch(const void* group, int total_tiles, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = setup<MIXED>(&blocks);
  if (err != cudaSuccess) return err;
  const int grid = total_tiles < blocks ? total_tiles : blocks;
  if (grid <= 0) return cudaSuccess;
  void* args[] = {const_cast<void*>(group)};
  err = cudaLaunchKernel((const void*)matmul_fused_group_kernel<MIXED>,
                         dim3(grid), dim3(THREADS), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The compiled configuration, for the host's table builder and checks:
// BM, BN, BK, STAGES, THREADS, MAX_PROBLEMS, sizeof(Problem),
// sizeof(Group), dynamic shared memory bytes, then the dtype fields: the
// flags' shifts of lhs, rhs, aux and out, and the codes of f32, bf16 and
// f16.
extern "C" void repro_matmul_fused_config(int* cfg) {
  const int v[] = {BM, BN, BK, STAGES, THREADS, MAX_PROBLEMS,
                   (int)sizeof(Problem), (int)sizeof(Group), SMEM_BYTES,
                   DT_LHS, DT_RHS, DT_AUX, DT_OUT, F32, BF16, F16};
  for (int i = 0; i < 16; ++i) cfg[i] = v[i];
}

// Blocks of the f32 build resident on the current device (the persistent
// grid; the mixed build's is checked at its first launch), or a negative
// CUDA error code.
extern "C" int repro_matmul_fused_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = setup<false>(&blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `group` points to a host Group (the
// table, copied into the launch's parameters at the call); every out is a
// fresh contiguous buffer and every aux may be null.  A group whose
// problems are all f32 runs the f32 build, any other the mixed build.
// Launches on `stream`, does not synchronise, and returns the launch's
// CUDA error so a refused launch raises in the caller.
extern "C" int repro_matmul_fused_group(const void* group, void* stream) {
  const Group* g = static_cast<const Group*>(group);
  if (g->num_problems < 1 || g->num_problems > MAX_PROBLEMS)
    return (int)cudaErrorInvalidValue;
  bool mixed = false;
  for (int i = 0; i < g->num_problems; ++i)   // dtype codes the kernel reads
    for (int shift = DT_LHS; shift <= DT_OUT; shift += 2) {
      const int code = (g->p[i].flags >> shift) & 3;
      if (code >= NUM_DTYPES) return (int)cudaErrorInvalidValue;
      mixed = mixed || code != F32;
    }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mixed ? launch<true>(group, g->total_tiles, s)
                     : launch<false>(group, g->total_tiles, s));
}
