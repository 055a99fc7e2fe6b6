"""``matmul_fused``: alpha * (lhs @ rhs) + beta * aux, batched, for one
product or for a group of products in one launch.

Replaces the Pallas TPU kernel ``repro/kernels/ns_ortho/kernel.py::
matmul_fused`` with the hand-written CUDA C++ kernel in
``kernels/csrc/matmul_fused.cu``: a grouped, persistent FP32 GEMM (8x8
register micro-tiles over a 4-stage ``cp.async`` ring, the scale-and-add
epilogue fused; operands read through their strides, so transposed views
and the batch-stride-0 ``expand``ed identity cost no copy; ragged edges
masked, nothing padded).  Bound on an H100: the 67 TFLOP/s FP32 pipe.

``matmul_fused_group(problems)`` takes ``(lhs, rhs, aux, alpha, beta)``
problems whose shapes, batches and scalars all differ, and launches the
kernel once per ``MAX_PROBLEMS`` of them; ``matmul_fused`` is the group of
one.  The problem table (pointers, strides, shapes, tile counts and
prefix offsets, layout flags) is built here in numpy (``group_tables``)
and handed to the kernel by value as its launch parameter.

Dispatch follows the tensors: CPU tensors take the plain versions
(``matmul_fused_plain``, ``matmul_fused_group_plain``: the same math in
PyTorch), CUDA tensors launch the kernel or raise — no fallback.
``matmul_fused.launches`` counts kernel launches, from either entry.

Unlike the 2-D-only reference, operands may carry leading batch dims
(``(..., m, k) @ (..., k, n)``, identical batch shapes), the client axis
and expert stacks folded into each problem's batch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped import PARAM_LIMIT, arena_layout, arena_views

SOURCE = "matmul_fused.cu"

# The kernel's problem record, field for field as ``struct Problem`` in
# the source (checked against the compiled library at load).
PROBLEM = np.dtype([
    ("lhs", "<u8"), ("rhs", "<u8"), ("aux", "<u8"), ("out", "<u8"),
    ("l_sb", "<i8"), ("l_sm", "<i8"), ("l_sk", "<i8"),
    ("r_sb", "<i8"), ("r_sk", "<i8"), ("r_sn", "<i8"),
    ("x_sb", "<i8"), ("x_sm", "<i8"), ("x_sn", "<i8"),
    ("batch", "<i4"), ("m", "<i4"), ("n", "<i4"), ("k", "<i4"),
    ("tiles_m", "<i4"), ("tiles_n", "<i4"), ("tile_start", "<i4"),
    ("flags", "<i4"), ("alpha", "<f4"), ("beta", "<f4")])
HEADER_BYTES = 16            # num_problems, total_tiles, two pad ints
MAX_PROBLEMS = (PARAM_LIMIT - HEADER_BYTES) // PROBLEM.itemsize   # 227
TABLE_BYTES = HEADER_BYTES + MAX_PROBLEMS * PROBLEM.itemsize
TILE = (128, 64)             # the default build's (BM, BN)
A_KC, B_KC, A_VEC, B_VEC, O_VEC = 1, 2, 4, 8, 16


def matmul_fused_plain(lhs, rhs, aux=None, *, alpha: float = 1.0,
                       beta: float = 0.0):
    """The kernel's math in plain PyTorch: f32 accumulate, lhs dtype out."""
    out = alpha * torch.matmul(lhs.to(torch.float32), rhs.to(torch.float32))
    if aux is not None:
        out = out + beta * aux.to(torch.float32)
    return out.to(lhs.dtype)


def matmul_fused_group_plain(problems):
    """``matmul_fused_plain`` over ``(lhs, rhs, aux, alpha, beta)``
    problems."""
    return [matmul_fused_plain(lhs, rhs, aux, alpha=alpha, beta=beta)
            for lhs, rhs, aux, alpha, beta in problems]


def _check(lhs, rhs, aux):
    if lhs.ndim < 2 or rhs.ndim < 2:
        raise ValueError(f"matmul_fused wants (..., m, k) @ (..., k, n), got "
                         f"{tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    if lhs.shape[:-2] != rhs.shape[:-2] or lhs.shape[-1] != rhs.shape[-2]:
        raise ValueError(f"matmul_fused shape mismatch: {tuple(lhs.shape)} @ "
                         f"{tuple(rhs.shape)}")
    want = (*lhs.shape[:-1], rhs.shape[-1])
    if aux is not None and tuple(aux.shape) != want:
        raise ValueError(f"aux shape {tuple(aux.shape)} != output {want}")


def _mergeable(x):
    """``x``, or a copy of it whose batch dims merge into one under their
    strides (the kernel reads a (batch, rows, cols) view)."""
    if x.dim() <= 3:
        return x
    shape, st = x.shape, x.stride()
    if any(st[i] != st[i + 1] * shape[i + 1] for i in range(len(shape) - 3)
           if shape[i] > 1):
        return x.reshape(-1, shape[-2], shape[-1])
    return x


def operand_flags(ptr: int, strides, ext_x: int, k: int, batch: int):
    """(kc, vec) for an operand whose element (b, x, kk) lies at byte
    ``ptr + 4 (b sb + x sx + kk sk)``, ``strides = (sb, sx, sk)`` (x is m
    for lhs, n for rhs).  kc: k has unit stride, so the kernel stores the
    tile k-contiguous.  vec: the unit-stride axis takes 16-byte copies —
    every run it copies starts 16-byte aligned (base aligned, the other
    strides multiples of 4 floats, or their extent 1)."""
    sb, sx, sk = strides
    kc = sk == 1 and sx != 1
    unit, across, across_ext = (sk, sx, ext_x) if kc else (sx, sk, k)
    vec = (unit == 1 and ptr % 16 == 0
           and (across % 4 == 0 or across_ext == 1)
           and (sb % 4 == 0 or batch == 1))
    return kc, vec


def _operand(x):
    """(data pointer, batch, rows, cols, batch stride, row stride, col
    stride) of a (..., rows, cols) operand whose batch dims merge
    (``_mergeable``)."""
    shape, st = x.shape, x.stride()
    nd = len(shape)
    if nd == 3:
        return (x.data_ptr(), shape[0], shape[1], shape[2], st[0], st[1],
                st[2])
    if nd == 2:
        return x.data_ptr(), 1, shape[0], shape[1], 0, st[0], st[1]
    return (x.data_ptr(), math.prod(shape[:-2]), shape[-2], shape[-1],
            st[-3], st[-2], st[-1])


def problem_row(lhs, rhs, aux, alpha, beta, out_ptr: int):
    """One problem's record (a tuple in ``PROBLEM`` order, tile fields 0)
    from its (..., m, k) / (..., k, n) / (..., m, n) operands, their batch
    dims mergeable."""
    l_ptr, batch, m, k, l_sb, l_sm, l_sk = _operand(lhs)
    r_ptr, _, _, n, r_sb, r_sk, r_sn = _operand(rhs)
    a_kc, a_vec = operand_flags(l_ptr, (l_sb, l_sm, l_sk), m, k, batch)
    b_kc, b_vec = operand_flags(r_ptr, (r_sb, r_sn, r_sk), n, k, batch)
    if aux is None:
        x_ptr = x_sb = x_sm = x_sn = 0
    else:
        x_ptr, _, _, _, x_sb, x_sm, x_sn = _operand(aux)
    # the output (a fresh 128-byte aligned (batch, m, n) buffer) and aux
    # take 16-byte accesses along rows
    o_vec = n % 4 == 0 and (aux is None or (
        x_sn == 1 and x_ptr % 16 == 0 and x_sm % 4 == 0
        and (x_sb % 4 == 0 or batch == 1)))
    flags = ((A_KC * a_kc) | (B_KC * b_kc) | (A_VEC * a_vec)
             | (B_VEC * b_vec) | (O_VEC * o_vec))
    return (l_ptr, r_ptr, x_ptr, out_ptr, l_sb, l_sm, l_sk, r_sb, r_sk, r_sn,
            x_sb, x_sm, x_sn, batch, m, n, k, 0, 0, 0, flags, float(alpha),
            float(beta))


def group_tables(rows, tile=TILE, max_problems: int = MAX_PROBLEMS):
    """The launch tables of a group of problem records (``problem_row``).

    Problems with no output tile are dropped; the rest are ordered by
    operand layout (``A_KC | B_KC``: tiles that run the same one of the
    kernel's four mainloops stay together, so an SM's resident blocks
    share their instructions), then by k, longest first (so long-K tiles
    do not trail at the end), stably, and cut into launches of at most
    ``max_problems``.  Each table is a ``TABLE_BYTES`` numpy buffer — the
    header (problem count, total tiles) and the records with their tile
    counts and prefix tile offsets — as the kernel takes it by value.
    Returns [(table, problem indices in table order)]."""
    bm, bn = tile
    p = np.array(rows, dtype=PROBLEM)
    p["tiles_m"] = -(-p["m"] // bm)
    p["tiles_n"] = -(-p["n"] // bn)
    tiles = p["batch"].astype(np.int64) * p["tiles_m"] * p["tiles_n"]
    keep = np.flatnonzero(tiles > 0)
    layout = p["flags"][keep] & (A_KC | B_KC)
    order = keep[np.lexsort((-p["k"][keep], -layout))]
    out = []
    for lo in range(0, len(order), max_problems):
        idx = order[lo:lo + max_problems]
        t = tiles[idx]
        if t.sum() >= 2 ** 31:
            raise ValueError(f"matmul_fused group of {int(t.sum())} tiles "
                             "exceeds the kernel's 32-bit tile index")
        table = np.zeros(TABLE_BYTES, np.uint8)
        recs = table[HEADER_BYTES:].view(PROBLEM)
        recs[:len(idx)] = p[idx]
        recs["tile_start"][:len(idx)] = np.cumsum(t) - t
        table[:8].view(np.int32)[:] = (len(idx), int(t.sum()))
        out.append((table, idx.tolist()))
    return out


class KernelLibrary:
    """A loaded build of ``matmul_fused.cu``, checked against the host's
    record layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 9)()
        cdll.repro_matmul_fused_config(cfg)
        bm, bn, _, _, _, max_p, rec, table, _ = cfg
        if (max_p, rec, table) != (MAX_PROBLEMS, PROBLEM.itemsize,
                                   TABLE_BYTES):
            raise RuntimeError(f"matmul_fused.cu's problem table ({max_p} x "
                               f"{rec} B, {table} B) does not match the "
                               "wrapper's")
        self.config = tuple(cfg)     # BM BN BK STAGES THREADS MAX_P ...
        self.tile = (bm, bn)
        self.launch = cdll.repro_matmul_fused_group
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_matmul_fused_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library(defines=()) -> KernelLibrary:
    """The default build, or a variant built with ``-D`` ``defines``
    (``("MF_BM=128", "MF_BN=64")``: a tile shape to measure)."""
    if not defines:
        return KernelLibrary(build.load(SOURCE))
    path, _ = build.build(SOURCE, defines)
    return KernelLibrary(ctypes.CDLL(str(path)))


def matmul_fused_group(problems, library: KernelLibrary | None = None):
    """[alpha * (lhs @ rhs) + beta * aux for each (lhs, rhs, aux, alpha,
    beta)]; aux may be None.  On CUDA the outputs are views into one
    arena, and the group takes one launch per ``MAX_PROBLEMS`` problems
    (of ``library``, default the standard build)."""
    problems = [tuple(p) for p in problems]
    if not problems:
        return []
    for lhs, rhs, aux, _, _ in problems:
        _check(lhs, rhs, aux)
    devices = {t.device for p in problems for t in p[:3] if t is not None}
    if len(devices) != 1:
        raise ValueError(f"matmul_fused operands on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return matmul_fused_group_plain(problems)
    if dev.type != "cuda":
        raise ValueError(f"matmul_fused: unsupported device {dev}")
    if any(t.dtype != torch.float32 for p in problems for t in p[:3]
           if t is not None):
        raise TypeError("the CUDA matmul_fused kernel takes float32 only")
    lib = library or kernel_library()
    shapes = tuple((*p[0].shape[:-1], p[1].shape[-1]) for p in problems)
    _, _, total, runs = arena_layout(shapes)
    arena = torch.empty(total, device=dev, dtype=torch.float32)
    outs, = arena_views(arena, runs, len(problems))
    # held until the launches are enqueued: a copy made by _mergeable must
    # not return to the allocator before the kernel that reads it
    operands = [tuple(None if x is None else _mergeable(x) for x in p[:3])
                for p in problems]
    rows = [problem_row(*x, *p[3:], out.data_ptr())
            for x, p, out in zip(operands, problems, outs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table, idx in group_tables(rows, lib.tile):
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"matmul_fused kernel launch failed: CUDA error {err} "
                    f"({len(idx)} problems, first (batch, m, n, k) = "
                    f"{tuple(rows[idx[0]][13:17])})")
            matmul_fused.launches += 1
    return outs


def matmul_fused(lhs, rhs, aux=None, *, alpha: float = 1.0,
                 beta: float = 0.0):
    """alpha * (lhs @ rhs) + beta * aux; aux may be None.  A group of one."""
    return matmul_fused_group([(lhs, rhs, aux, alpha, beta)])[0]


matmul_fused.launches = 0
