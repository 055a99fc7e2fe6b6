// quantize: blockwise int8 quantization of a group of cohort-stacked
// leaves in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/qblock/kernel.py::quantize
// (rowwise abs-max, scale, divide, round, cast over (bm, block) tiles of
// a zero-padded flat array).  The qblock codec encodes every leaf of a
// client upload (the delta, or Theta) with one launch.
//
// Input per leaf: x (rows, n) f32, one row per client; each row is cut
// into nb = ceil(n / block) quant blocks, and a block never spans two
// rows:
//   scale = max(max|x_b| / 127, eps),  q = clamp(rint(x_b / scale), -127, 127)
// Outputs per leaf: q (rows, n) int8 -- exactly the n values that ship, no
// padding -- and scale (rows, nb) f32.
//
// Bound on an H100: memory -- 4 B read and ~1.03 B written per element
// against a handful of flops, so 3.35 TB/s sets the floor.
//
// Design: an upload's leaves (127 for ViT-Tiny, most of them 192-element
// LayerNorm and bias rows) launched one by one would mostly be grids of a
// few blocks, each paying its ramp-up, tail and host time.  One launch
// covers them all:
//  * a table of per-leaf records (x, q, scale, n, nb, first work item, a
//    flag) is passed by value as the kernel's __grid_constant__ parameter
//    (grouped.cuh), up to MAX_LEAVES a launch; the host splits above that;
//  * a work item is one quant block of one row, owned by a group of
//    GROUP = 8 lanes; persistent blocks, as many as are resident on the
//    card, walk the global item index, finding an item's leaf by binary
//    search over the items' starts, staged in shared memory per block;
//  * a group reads its block in slices of SLICE = 128 elements, 16 a lane
//    (four 16-byte loads in flight), and keeps the first slice in
//    registers, so x is read from device memory once; the later slices of
//    a block above SLICE elements are read a second time, from cache.  The
//    abs-max is a shuffle reduction over the group's lanes: no shared
//    memory, no second pass over HBM.  A warp per block, four elements a
//    lane, left the kernel bound by instruction issue (~220 warp
//    instructions a block for its leaf search, indexing, shuffles and
//    divisions, at 40% of HBM rate); a group of 8 lanes shares that cost
//    among four blocks a warp;
//  * a leaf whose x is 16-byte aligned, whose q is 4-byte aligned and
//    whose n is a multiple of 4 takes float4 loads and 4-byte stores of
//    four codes (flag VEC, set on the host); any other takes coalesced
//    scalar accesses with its ragged tail masked (read as 0, never
//    written), which is what the reference's zero padding computes.
//
// Numerics: rounding is rintf (round half to even, as jnp.round and
// torch.round), the divisions are IEEE (__fdiv_rn; the build does not pass
// --use_fast_math) and the scale is fmaxf of the IEEE quotient and eps, so
// q and scale are bitwise the plain version's and ref.py's.  A block
// holding a NaN gets a NaN scale, as jnp.max and torch.amax propagate it
// (fmaxf alone drops NaN), and one holding +-inf an inf scale; the codes
// of such a block are not defined by the reference (a NaN cast to int8).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped.cuh"

namespace {

constexpr int THREADS = 256;
// blocks an SM the build must fit: caps registers at 64 a thread without
// spills; uncapped, the build holds 3 blocks an SM and ran slower on an
// H100
constexpr int MIN_BLOCKS = 4;
constexpr int GROUP = 8;                 // lanes a quant block
constexpr int GROUPS = THREADS / GROUP;  // quant blocks a block has at once
constexpr int SLICE = 128;               // elements a group reads at once
constexpr int VECS = SLICE / GROUP / 4;  // float4s a lane holds a slice

enum : int { VEC = 1 };   // flags, set per leaf on the host

struct Leaf {
  const float* x;
  int8_t* q;
  float* scale;
  int64_t n, nb;
  int item_start;
  int flags;
};
static_assert(sizeof(Leaf) == 48, "Leaf layout is mirrored on the host");

constexpr int HEADER_BYTES = 16;
constexpr int MAX_LEAVES =
    (grouped::PARAM_LIMIT - HEADER_BYTES) / (int)sizeof(Leaf);   // 682

struct Group {
  int num_leaves, total_items;
  int block;
  float eps;
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Group) <= grouped::PARAM_LIMIT,
              "the table must fit the launch");

// One quant block of one row: where its values and codes lie, its scale's
// slot, its length (0 for no block) and whether it takes wide accesses.
struct QBlk {
  const float* x;
  int8_t* q;
  float* scale;
  int len;
  bool vec;
};

__device__ __forceinline__ QBlk locate(const Group& p, const int* starts,
                                       int it) {
  const int li = grouped::find(starts, p.num_leaves, it);
  const Leaf& L = p.leaf[li];
  const int local = it - starts[li];
  const int nb = (int)L.nb;
  const int row = local / nb;
  const int b = local - row * nb;
  const int64_t start = (int64_t)b * p.block;     // offset in the row
  const int64_t off = row * L.n + start;
  return {L.x + off, L.q + off, L.scale + row * L.nb + b,
          (int)(L.n - start < p.block ? L.n - start : p.block),
          (L.flags & VEC) != 0};
}

// Element c of the lane's j-th float4 of slice s (gl: the lane's place in
// its group): 16 consecutive bytes a lane and 128 a group per float4 on
// the wide path, else one element a lane and 8 consecutive a group.
__device__ __forceinline__ int elem(bool vec, int s, int gl, int j, int c) {
  return vec ? s * SLICE + j * 4 * GROUP + gl * 4 + c
             : s * SLICE + (j * 4 + c) * GROUP + gl;
}

__device__ __forceinline__ void load_slice(const QBlk& k, int s, int gl,
                                           float4 (&v)[VECS]) {
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    if (k.vec) {
      const int e = elem(true, s, gl, j, 0);   // len % 4 == 0 on this path
      v[j] = e < k.len ? __ldg(reinterpret_cast<const float4*>(k.x + e))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = elem(false, s, gl, j, c);
        t[c] = e < k.len ? __ldg(k.x + e) : 0.f;
      }
      v[j] = make_float4(t[0], t[1], t[2], t[3]);
    }
  }
}

// max that carries NaN, as jnp.max and torch.amax do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float slice_amax(const float4 (&v)[VECS],
                                            float amax) {
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    amax = max_nan(fabsf(v[j].x), amax);
    amax = max_nan(fabsf(v[j].y), amax);
    amax = max_nan(fabsf(v[j].z), amax);
    amax = max_nan(fabsf(v[j].w), amax);
  }
  return amax;
}

__device__ __forceinline__ signed char code(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return (signed char)fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ void store_slice(const QBlk& k, int s, int gl,
                                            const float4 (&v)[VECS],
                                            float sc) {
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const signed char c[4] = {code(v[j].x, sc), code(v[j].y, sc),
                              code(v[j].z, sc), code(v[j].w, sc)};
    if (k.vec) {
      const int e = elem(true, s, gl, j, 0);
      if (e < k.len)
        *reinterpret_cast<char4*>(k.q + e) =
            make_char4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = elem(false, s, gl, j, i);
        if (e < k.len) k.q[e] = c[i];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
qblock_quantize_group_kernel(const __grid_constant__ Group p) {
  __shared__ int starts[MAX_LEAVES];
  for (int i = threadIdx.x; i < p.num_leaves; i += THREADS)
    starts[i] = p.leaf[i].item_start;
  __syncthreads();
  const int gl = threadIdx.x % GROUP;
  const int64_t stride = (int64_t)gridDim.x * GROUPS;
  // the loop index is the warp's first item, so a warp's lanes run the
  // same trip count and meet at every shuffle
  for (int64_t it0 = (int64_t)blockIdx.x * GROUPS + (threadIdx.x & ~31) /
                     GROUP;
       it0 < p.total_items; it0 += stride) {
    const int64_t it = it0 + (threadIdx.x & 31) / GROUP;
    const QBlk k = it < p.total_items
                       ? locate(p, starts, (int)it)
                       : QBlk{nullptr, nullptr, nullptr, 0, false};
    const int slices = (k.len + SLICE - 1) / SLICE;
    float4 v[VECS];
    load_slice(k, 0, gl, v);
    float amax = slice_amax(v, 0.f);
    for (int s = 1; s < slices; ++s) {   // block > SLICE: read again below
      float4 w[VECS];
      load_slice(k, s, gl, w);
      amax = slice_amax(w, amax);
    }
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1)
      amax = max_nan(__shfl_xor_sync(0xffffffffu, amax, off), amax);
    const float sc = isnan(amax) ? amax
                                 : fmaxf(__fdiv_rn(amax, 127.f), p.eps);
    store_slice(k, 0, gl, v, sc);
    for (int s = 1; s < slices; ++s) {
      float4 w[VECS];
      load_slice(k, s, gl, w);
      store_slice(k, s, gl, w, sc);
    }
    if (gl == 0 && k.len > 0) *k.scale = sc;
  }
}

int resident[grouped::MAX_DEVICES];   // persistent grid per device

}  // namespace

// The compiled configuration, for the host's table builder and checks:
// THREADS, SLICE, MAX_LEAVES, sizeof(Leaf), sizeof(Group).
extern "C" void repro_quantize_config(int* cfg) {
  const int v[] = {THREADS, SLICE, MAX_LEAVES, (int)sizeof(Leaf),
                   (int)sizeof(Group)};
  for (int i = 0; i < 5; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_quantize_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = grouped::resident_blocks(
      qblock_quantize_group_kernel, THREADS, resident, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `group` points to a host Group (the
// table, copied into the launch's parameters at the call); every q and
// scale is a fresh buffer and block a multiple of SLICE.  Launches on
// `stream`, does not synchronise, and returns the launch's CUDA error so
// a refused launch raises in the caller.
extern "C" int repro_quantize_group(const void* group, void* stream) {
  int blocks = 0;
  cudaError_t err = grouped::resident_blocks(qblock_quantize_group_kernel,
                                             THREADS, resident, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Group* p = static_cast<const Group*>(group);
  if (p->num_leaves < 1 || p->num_leaves > MAX_LEAVES ||
      p->total_items < 0 || p->block < SLICE || p->block % SLICE)
    return (int)cudaErrorInvalidValue;
  const int64_t want = ((int64_t)p->total_items + GROUPS - 1) / GROUPS;
  const int grid = want < blocks ? (int)want : blocks;
  if (grid <= 0) return 0;
  void* args[] = {const_cast<void*>(group)};
  err = cudaLaunchKernel((const void*)qblock_quantize_group_kernel,
                         dim3(grid), dim3(THREADS), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
