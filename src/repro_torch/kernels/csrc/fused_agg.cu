// dequant_accumulate: the qblock flush, sum_i w_i * scale_{i,b} * q_{i,b},
// over a group of leaves in one launch, optionally folded into a running
// carry (carry + sum).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_agg/kernel.py::dequant_accumulate (a (rows, B)
// grid with the client axis innermost, the f32 output tile resident in
// VMEM while every client's int8 blocks stream through it once).  The
// server's qblock flush reduces a cohort's encoded tree straight into the
// weighted sums with one launch; no decoded per-client tensor is formed.
//
// Inputs per leaf: q (B, n) int8, the wire's values (row stride n, no
// padding); scale (B, nb) f32 with nb = ceil(n / block); optionally a
// carry (n,) f32, the chunk pipeline's running sum of earlier chunks.
// Shared by the group: w (B,) f32, B and block.  Output per leaf: (n,)
// f32, the leaf's sum itself (no pad, no trim copy), or carry + sum.
//
// Bound on an H100: memory -- B*n int8 reads plus 4n bytes written (and
// 4n read with a carry; the B*nb scales are noise), a multiply and an add
// per byte read.
//
// Design: the TPU grid's sequential client axis is a loop inside the
// thread.  A work item is ELEMS = 4 consecutive outputs of one leaf (always
// in one quant block: block is a multiple of 4); its thread keeps their
// sums in registers and walks the B clients innermost, one 4-byte load
// and one multiplier w_i * scale_{i,b} (an f32 product, rounded as the
// reference rounds it) per client, and writes each output once: no
// atomics.  The products and sums are rounded one by one (__fmul_rn,
// __fadd_rn: no fused multiply-add), clients in order, so the plain
// version (kernels/fused_agg/kernel.py) repeats them bit for bit.  A leaf
// with a carry (flag CARRY) adds it once to the finished register sums,
// carry + sum as the reference folds a chunk, and writes that: one read
// and one write of the running sum instead of a second elementwise pass.
// One launch covers every leaf of the tree:
//  * a table of per-leaf records (q, scale, out, carry, n, nb, first work
//    item, flags) is passed by value as the kernel's __grid_constant__
//    parameter (grouped.cuh), up to MAX_LEAVES a launch;
//  * persistent blocks, as many as are resident on the card, walk the
//    global work-item index; a thread finds its item's leaf by binary
//    search over the items' starts, staged in shared memory per block;
//  * a leaf whose rows are 4-byte aligned (q aligned, n % 4 == 0) and
//    whose output (and carry) is 16-byte aligned takes 4-byte loads and
//    float4 loads and stores (flag VEC, set on the host); any other takes
//    byte loads and scalar ones with its ragged tail masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ELEMS = 4;   // outputs per work item (one thread)

enum : int { VEC = 1, CARRY = 2 };   // flags, set per leaf on the host

struct Leaf {
  const int8_t* q;
  const float* scale;
  float* out;
  const float* carry;   // null without the CARRY flag
  int64_t n, nb;
  int item_start;
  int flags;
};
static_assert(sizeof(Leaf) == 56, "Leaf layout is mirrored on the host");

constexpr int HEADER_BYTES = 32;
constexpr int MAX_LEAVES =
    (grouped::PARAM_LIMIT - HEADER_BYTES) / (int)sizeof(Leaf);   // 584

struct Group {
  int num_leaves, total_items;
  const float* w;
  int clients, block;
  int pad0, pad1;
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Group) <= grouped::PARAM_LIMIT,
              "the table must fit the launch");

template <bool VEC_>
__device__ __forceinline__ void accumulate(const Group& p, const Leaf& L,
                                           int64_t e0) {
  const int64_t b = e0 / p.block;
  float acc[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < p.clients; ++i) {
    const float ws = __fmul_rn(__ldg(p.w + i), __ldg(L.scale + i * L.nb + b));
    const int8_t* row = L.q + i * L.n;
    int8_t v[ELEMS];
    if (VEC_) {
      const int raw = __ldg(reinterpret_cast<const int*>(row + e0));
#pragma unroll
      for (int j = 0; j < ELEMS; ++j)
        v[j] = reinterpret_cast<const int8_t*>(&raw)[j];
    } else {
#pragma unroll
      for (int j = 0; j < ELEMS; ++j)
        v[j] = (e0 + j < L.n) ? row[e0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < ELEMS; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(ws, (float)v[j]));
  }
  const bool carry = L.flags & CARRY;
  if (VEC_) {
    if (carry) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(L.carry + e0));
      acc[0] = __fadd_rn(c.x, acc[0]);
      acc[1] = __fadd_rn(c.y, acc[1]);
      acc[2] = __fadd_rn(c.z, acc[2]);
      acc[3] = __fadd_rn(c.w, acc[3]);
    }
    *reinterpret_cast<float4*>(L.out + e0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < ELEMS; ++j)
      if (e0 + j < L.n)
        L.out[e0 + j] = carry ? __fadd_rn(L.carry[e0 + j], acc[j]) : acc[j];
  }
}

__global__ void __launch_bounds__(THREADS)
dequant_accumulate_group_kernel(const __grid_constant__ Group p) {
  __shared__ int starts[MAX_LEAVES];
  for (int i = threadIdx.x; i < p.num_leaves; i += THREADS)
    starts[i] = p.leaf[i].item_start;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t it = (int64_t)blockIdx.x * THREADS + threadIdx.x;
       it < p.total_items; it += stride) {
    const int li = grouped::find(starts, p.num_leaves, (int)it);
    const Leaf& L = p.leaf[li];
    const int64_t e0 = (it - starts[li]) * ELEMS;
    if (L.flags & VEC)
      accumulate<true>(p, L, e0);
    else
      accumulate<false>(p, L, e0);
  }
}

int resident[grouped::MAX_DEVICES];   // persistent grid per device

}  // namespace

// The compiled configuration, for the host's table builder and checks:
// THREADS, ELEMS, MAX_LEAVES, sizeof(Leaf), sizeof(Group).
extern "C" void repro_dequant_accumulate_config(int* cfg) {
  const int v[] = {THREADS, ELEMS, MAX_LEAVES, (int)sizeof(Leaf),
                   (int)sizeof(Group)};
  for (int i = 0; i < 5; ++i) cfg[i] = v[i];
}

// Blocks resident on the current device (the persistent grid), or a
// negative CUDA error code.
extern "C" int repro_dequant_accumulate_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = grouped::resident_blocks(
      dequant_accumulate_group_kernel, THREADS, resident, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C entry point bound with ctypes.  `group` points to a host Group (the
// table, copied into the launch's parameters at the call); every out is a
// fresh buffer and block a multiple of ELEMS.  Launches on `stream`, does
// not synchronise, and returns the launch's CUDA error so a refused launch
// raises in the caller.
extern "C" int repro_dequant_accumulate_group(const void* group,
                                              void* stream) {
  int blocks = 0;
  cudaError_t err = grouped::resident_blocks(dequant_accumulate_group_kernel,
                                             THREADS, resident, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Group* p = static_cast<const Group*>(group);
  if (p->num_leaves < 1 || p->num_leaves > MAX_LEAVES ||
      p->total_items < 0 || p->clients < 0 || p->block < ELEMS ||
      p->block % ELEMS)
    return (int)cudaErrorInvalidValue;
  const int64_t want = ((int64_t)p->total_items + THREADS - 1) / THREADS;
  const int grid = want < blocks ? (int)want : blocks;
  if (grid <= 0) return 0;
  void* args[] = {const_cast<void*>(group)};
  err = cudaLaunchKernel((const void*)dequant_accumulate_group_kernel,
                         dim3(grid), dim3(THREADS), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
