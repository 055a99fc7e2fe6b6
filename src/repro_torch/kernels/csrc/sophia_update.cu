// sophia_update: Sophia's fused momentum and clipped diagonal step over a
// group of leaves in one launch,
//
//   m' = b1 m + (1-b1) g,   d = clip(m' / max(h, eps), -rho, rho),
//
// each leaf's d and m' written in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/sophia_update/kernel.py::
// sophia_update (one fused pass over (8, 128)-tiled VMEM blocks of one
// zero-padded leaf).  Sophia's step calls it once for all its leaves.
//
// Bound on an H100: memory -- three f32 reads and two f32 writes per
// element (20 B) against ~6 flops, so 3.35 TB/s sets the floor.
//
// Design: a step's leaves (a ViT-Tiny step has 127, from a few KB to ~2 MB
// across the cohort) launched one by one would mostly be grids of a
// handful of blocks that never fill 132 SMs, each paying its own ramp-up,
// tail and host time.  One launch covers them all:
//  * A table of per-leaf records (five pointers, numel, first chunk, a
//    flag) is passed by value as the kernel's __grid_constant__ parameter
//    (grouped.cuh), up to MAX_LEAVES a launch; the host splits above that.
//  * Each leaf is cut into chunks of CHUNK elements.  Persistent blocks,
//    as many as are resident on the card, walk the global chunk index; a
//    block finds a chunk's leaf by binary search over the chunk starts,
//    staged in shared memory once per block.
//  * In a chunk each thread loads UNROLL float4s of each operand before it
//    computes, so 12 16-byte loads a thread are in flight.  A leaf whose
//    five pointers are 16-byte aligned and whose numel is a multiple of 4
//    takes that path (flag VEC, set on the host); any other takes scalar,
//    coalesced accesses.  Nothing is padded or copied.
//
// Numerics: every product, sum and quotient is rounded as the plain
// PyTorch version rounds it (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction, IEEE division), and 1-b1 comes from the host as the plain
// version's constant, so d and m' are bitwise the plain version's.  NaN
// propagates through the max and the clip as torch.clamp and jnp.clip
// propagate it (fmaxf alone would map a NaN h to eps).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                     // float4s per thread per chunk
constexpr int CHUNK = THREADS * 4 * UNROLL;   // 4096 elements

enum : int { VEC = 1 };   // flags, set per leaf on the host

struct Leaf {
  const float* g;
  const float* m;
  const float* h;
  float* d;
  float* m_out;
  int64_t numel;
  int chunk_start;
  int flags;
};
static_assert(sizeof(Leaf) == 56, "Leaf layout is mirrored on the host");

constexpr int HEADER_BYTES = 32;
constexpr int MAX_LEAVES =
    (grouped::PARAM_LIMIT - HEADER_BYTES) / (int)sizeof(Leaf);   // 584

struct Group {
  int num_leaves, total_chunks;
  float b1, omb1, rho, eps;
  int pad0, pad1;
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Group) <= grouped::PARAM_LIMIT,
              "the table must fit the launch");

__device__ __forceinline__ void sophia(const Group& p, float g, float m,
                                       float h, float& d, float& m_out) {
  m_out = __fadd_rn(__fmul_rn(p.b1, m), __fmul_rn(p.omb1, g));
  const float hc = isnan(h) ? h : fmaxf(h, p.eps);
  const float q = __fdiv_rn(m_out, hc);
  d = isnan(q) ? q : fminf(fmaxf(q, -p.rho), p.rho);
}

__device__ __forceinline__ void vec_chunk(const Group& p, const Leaf& L,
                                          int64_t base, int tid) {
  float4 g[UNROLL], m[UNROLL], h[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t e = base + (int64_t)(u * THREADS + tid) * 4;
    if (e < L.numel) {
      g[u] = __ldg(reinterpret_cast<const float4*>(L.g + e));
      m[u] = __ldg(reinterpret_cast<const float4*>(L.m + e));
      h[u] = __ldg(reinterpret_cast<const float4*>(L.h + e));
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t e = base + (int64_t)(u * THREADS + tid) * 4;
    if (e < L.numel) {
      float4 d, mo;
      sophia(p, g[u].x, m[u].x, h[u].x, d.x, mo.x);
      sophia(p, g[u].y, m[u].y, h[u].y, d.y, mo.y);
      sophia(p, g[u].z, m[u].z, h[u].z, d.z, mo.z);
      sophia(p, g[u].w, m[u].w, h[u].w, d.w, mo.w);
      *reinterpret_cast<float4*>(L.d + e) = d;
      *reinterpret_cast<float4*>(L.m_out + e) = mo;
    }
  }
}

__device__ __forceinline__ void scalar_chunk(const Group& p, const Leaf& L,
                                             int64_t base, int tid) {
  constexpr int K = 4 * UNROLL;
  float g[K], m[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t e = base + (int64_t)k * THREADS + tid;
    if (e < L.numel) {
      g[k] = __ldg(L.g + e);
      m[k] = __ldg(L.m + e);
      h[k] = __ldg(L.h + e);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t e = base + (int64_t)k * THREADS + tid;
    if (e < L.numel) {
      float d, mo;
      sophia(p, g[k], m[k], h[k], d, mo);
      L.d[e] = d;
      L.m_out[e] = mo;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sophia_update_group_kernel(const __grid_constant__ Group p) {
  __shared__ int starts[MAX_LEAVES];
  for (int i = threadIdx.x; i < p.num_leaves; i += THREADS)
    starts[i] = p.leaf[i].chunk_start;
  __syncthreads();
  for (int c = blockIdx.x; c < p.total_chunks; c += gridDim.x) {
    const int li = grouped::find(starts, p.num_leaves, c);
    const Leaf& L = p.leaf[li];
    const int64_t base = (int64_t)(c - starts[li]) * CHUNK;
    if (L.flags & VEC)
      vec_chunk(p, L, base, threadIdx.x);
    else
      scalar_chunk(p, L, base, threadIdx.x);
  }
}

int resident[grouped::MAX_DEVICES];   // persistent grid per device

}  // namespace

// The compiled configuration, for the host's table builder and checks:
// THREADS, CHUNK, MAX_LEAVES, sizeof(Leaf), sizeof(Group).
extern "C" void repro_sophia_update_config(int* cfg) {
  const int v[] = {THREADS, CHUNK, MAX_LEAVES, (int)sizeof(Leaf),
                   (int)sizeof(Group)};
  for (int i = 0; i < 5; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_sophia_update_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = grouped::resident_blocks(
      sophia_update_group_kernel, THREADS, resident, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `group` points to a host Group (the
// table, copied into the launch's parameters at the call); every d and
// m_out is a fresh buffer that overlaps no input.  Launches on `stream`,
// does not synchronise, and returns the launch's CUDA error so a refused
// launch raises in the caller.
extern "C" int repro_sophia_update_group(const void* group, void* stream) {
  int blocks = 0;
  cudaError_t err = grouped::resident_blocks(sophia_update_group_kernel,
                                             THREADS, resident, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Group* p = static_cast<const Group*>(group);
  if (p->num_leaves < 1 || p->num_leaves > MAX_LEAVES || p->total_chunks < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = p->total_chunks < blocks ? p->total_chunks : blocks;
  if (grid <= 0) return 0;
  void* args[] = {const_cast<void*>(group)};
  err = cudaLaunchKernel((const void*)sophia_update_group_kernel, dim3(grid),
                         dim3(THREADS), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
