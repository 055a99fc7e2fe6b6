"""``matmul_fused``: alpha * (lhs @ rhs) + beta * aux, batched, for one
product or for a group of products in one launch.

Replaces the Pallas TPU kernel ``repro/kernels/ns_ortho/kernel.py::
matmul_fused`` with the hand-written CUDA C++ kernel in
``kernels/csrc/matmul_fused.cu``: a grouped, persistent FP32 GEMM (8x8
register micro-tiles over a 4-stage ``cp.async`` ring, the scale-and-add
epilogue fused; operands read through their strides, so transposed views
and the batch-stride-0 ``expand``ed identity cost no copy; ragged edges
masked, nothing padded).  Bound on an H100: the 67 TFLOP/s FP32 pipe.

Operands are f32, bf16 or f16, each on its own, as the reference's
kernel casts them inside its body: the kernel widens 2-byte operands to
f32 exactly and accumulates in f32, so a product is bitwise the product of
the operands' f32 casts.  A launch of f32 problems only runs the kernel's
f32 build, any other its mixed build (one source, chosen in the C entry
from the table's dtype codes).  The output is ``lhs.dtype``, as the reference
writes it, or the dtype a group problem names (SOAP at a bf16
``state_dtype`` wants bf16 factors from an f32 G and f32 rotations from
a bf16 Q), rounded once from the f32 result.

``matmul_fused_group(problems)`` takes ``(lhs, rhs, aux, alpha, beta)``
problems, or ``(lhs, rhs, aux, alpha, beta, out_dtype)``, whose shapes,
batches, dtypes and scalars all differ, and launches the kernel once per
``MAX_PROBLEMS`` of them; ``matmul_fused`` is the group of one.  The
problem table (pointers, strides, shapes, tile counts and prefix
offsets, layout flags and dtype codes) is built here in numpy
(``group_tables``) and handed to the kernel by value as its launch
parameter.

Dispatch follows the tensors: CPU tensors take the plain versions
(``matmul_fused_plain``, ``matmul_fused_group_plain``: the same math in
PyTorch), CUDA tensors launch the kernel or raise — no fallback, no cast.
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
TILE = (128, 64)             # the kernel's (BM, BN)
A_KC, B_KC, A_VEC, B_VEC, O_VEC = 1, 2, 4, 8, 16
RAW_LOOP = 4                 # a mainloop's bit: it widens 2-byte slices
# The element types the kernel reads and writes, by their codes, and the
# flags' bit shifts of the lhs, rhs, aux and out codes (two bits each).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DT_LHS, DT_RHS, DT_AUX, DT_OUT = 8, 10, 12, 14


def matmul_fused_plain(lhs, rhs, aux=None, *, alpha: float = 1.0,
                       beta: float = 0.0, out_dtype=None):
    """The kernel's math in plain PyTorch: operands cast to f32, f32
    accumulate, the result in ``out_dtype`` (default ``lhs.dtype``)."""
    out = alpha * torch.matmul(lhs.to(torch.float32), rhs.to(torch.float32))
    if aux is not None:
        out = out + beta * aux.to(torch.float32)
    return out.to(out_dtype or lhs.dtype)


def _problem(p):
    """``(lhs, rhs, aux, alpha, beta, out_dtype)`` of a 5- or 6-tuple."""
    p = tuple(p)
    if len(p) == 5:
        return (*p, None)
    if len(p) != 6:
        raise ValueError(f"a matmul_fused problem is (lhs, rhs, aux, alpha, "
                         f"beta[, out_dtype]), got {len(p)} entries")
    return p


def matmul_fused_group_plain(problems):
    """``matmul_fused_plain`` over ``(lhs, rhs, aux, alpha, beta[,
    out_dtype])`` problems."""
    return [matmul_fused_plain(lhs, rhs, aux, alpha=alpha, beta=beta,
                               out_dtype=out_dtype)
            for lhs, rhs, aux, alpha, beta, out_dtype in map(_problem,
                                                              problems)]


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


def operand_flags(ptr: int, strides, ext_x: int, k: int, batch: int,
                  itemsize: int = 4):
    """(kc, vec) for an operand of ``itemsize``-byte elements whose element
    (b, x, kk) lies at byte ``ptr + itemsize (b sb + x sx + kk sk)``,
    ``strides = (sb, sx, sk)`` (x is m for lhs, n for rhs).  kc: k has
    unit stride, so the kernel stores the tile k-contiguous.  vec: the
    unit-stride axis takes 16-byte copies of 16 / itemsize elements —
    every run it copies starts 16-byte aligned (base aligned, the other
    strides whole runs, or their extent 1)."""
    sb, sx, sk = strides
    run = 16 // itemsize
    kc = sk == 1 and sx != 1
    unit, across, across_ext = (sk, sx, ext_x) if kc else (sx, sk, k)
    vec = (unit == 1 and ptr % 16 == 0
           and (across % run == 0 or across_ext == 1)
           and (sb % run == 0 or batch == 1))
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


def dtype_code(dtype) -> int:
    """The kernel's code of an element type; TypeError for any other."""
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA matmul_fused kernel takes float32, "
                        f"bfloat16 and float16, not {dtype}") from None


def problem_row(lhs, rhs, aux, alpha, beta, out_ptr: int, out_dtype=None):
    """One problem's record (a tuple in ``PROBLEM`` order, tile fields 0)
    from its (..., m, k) / (..., k, n) / (..., m, n) operands, their batch
    dims mergeable, and its output's dtype (default ``lhs.dtype``)."""
    l_ptr, batch, m, k, l_sb, l_sm, l_sk = _operand(lhs)
    r_ptr, _, _, n, r_sb, r_sk, r_sn = _operand(rhs)
    a_kc, a_vec = operand_flags(l_ptr, (l_sb, l_sm, l_sk), m, k, batch,
                                lhs.element_size())
    b_kc, b_vec = operand_flags(r_ptr, (r_sb, r_sn, r_sk), n, k, batch,
                                rhs.element_size())
    if aux is None:
        x_ptr = x_sb = x_sm = x_sn = 0
        x_code = 0
    else:
        x_ptr, _, _, _, x_sb, x_sm, x_sn = _operand(aux)
        x_code = dtype_code(aux.dtype)
    # the output (a fresh 128-byte aligned (batch, m, n) buffer) and aux
    # take runs of 4 elements along rows: 16 bytes of f32, 8 of bf16/f16
    o_vec = n % 4 == 0 and (aux is None or (
        x_sn == 1 and x_ptr % (4 * aux.element_size()) == 0
        and x_sm % 4 == 0 and (x_sb % 4 == 0 or batch == 1)))
    flags = ((A_KC * a_kc) | (B_KC * b_kc) | (A_VEC * a_vec)
             | (B_VEC * b_vec) | (O_VEC * o_vec)
             | (dtype_code(lhs.dtype) << DT_LHS)
             | (dtype_code(rhs.dtype) << DT_RHS) | (x_code << DT_AUX)
             | (dtype_code(out_dtype or lhs.dtype) << DT_OUT))
    return (l_ptr, r_ptr, x_ptr, out_ptr, l_sb, l_sm, l_sk, r_sb, r_sk, r_sn,
            x_sb, x_sm, x_sn, batch, m, n, k, 0, 0, 0, flags, float(alpha),
            float(beta))


def mainloop(flags):
    """The kernel's mainloop of each problem, from its flags (a numpy
    array): the operand layout (``A_KC | B_KC``), plus ``RAW_LOOP`` where
    a 2-byte operand takes 16-byte copies and so the widening pass."""
    raw = (((flags & A_VEC) != 0) & (((flags >> DT_LHS) & 3) != 0)) | (
        ((flags & B_VEC) != 0) & (((flags >> DT_RHS) & 3) != 0))
    return (flags & (A_KC | B_KC)) | RAW_LOOP * raw


def group_tables(rows, tile=TILE, max_problems: int = MAX_PROBLEMS):
    """The launch tables of a group of problem records (``problem_row``).

    Problems with no output tile are dropped; the rest are ordered by
    ``mainloop`` (tiles that run the same one of the kernel's mainloops
    stay together, so an SM's resident blocks share their instructions), then by k, longest first (so long-K tiles do not trail
    at the end), stably, and cut into launches of at most
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
    order = keep[np.lexsort((-p["k"][keep], -mainloop(p["flags"][keep])))]
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
    """The loaded build of ``matmul_fused.cu``, checked against the host's
    record layout and dtype fields."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 16)()
        cdll.repro_matmul_fused_config(cfg)
        bm, bn, _, _, _, max_p, rec, table, _ = cfg[:9]
        if ((max_p, rec, table) != (MAX_PROBLEMS, PROBLEM.itemsize,
                                    TABLE_BYTES)
                or tuple(cfg[9:13]) != (DT_LHS, DT_RHS, DT_AUX, DT_OUT)
                or tuple(cfg[13:]) != tuple(DTYPE_CODES.values())):
            raise RuntimeError(f"matmul_fused.cu's problem table ({max_p} x "
                               f"{rec} B, {table} B, dtype fields "
                               f"{tuple(cfg[9:])}) does not match the "
                               "wrapper's")
        self.config = tuple(cfg)     # BM BN BK STAGES THREADS MAX_P ...
        self.tile = (bm, bn)
        self.launch = cdll.repro_matmul_fused_group
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_matmul_fused_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def matmul_fused_group(problems):
    """[alpha * (lhs @ rhs) + beta * aux for each (lhs, rhs, aux, alpha,
    beta[, out_dtype])]; aux may be None, out_dtype defaults to
    ``lhs.dtype``.  On CUDA the outputs are views into one arena per
    output dtype, and the group takes one launch per ``MAX_PROBLEMS``
    problems."""
    problems = [_problem(p) for p in problems]
    if not problems:
        return []
    for lhs, rhs, aux, *_ in problems:
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
    lib = kernel_library()
    outs = [None] * len(problems)
    by_dtype: dict = {}
    for i, p in enumerate(problems):
        by_dtype.setdefault(p[5] or p[0].dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        shapes = tuple((*problems[i][0].shape[:-1], problems[i][1].shape[-1])
                       for i in idx)
        _, _, total, runs = arena_layout(shapes)
        arena = torch.empty(total, device=dev, dtype=dtype)
        for i, v in zip(idx, arena_views(arena, runs, len(idx))[0]):
            outs[i] = v
    # held until the launches are enqueued: a copy made by _mergeable must
    # not return to the allocator before the kernel that reads it
    operands = [tuple(None if x is None else _mergeable(x) for x in p[:3])
                for p in problems]
    rows = [problem_row(*x, *p[3:5], out.data_ptr(), p[5])
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
    """alpha * (lhs @ rhs) + beta * aux in ``lhs.dtype``; aux may be None.
    A group of one."""
    return matmul_fused_group([(lhs, rhs, aux, alpha, beta)])[0]


matmul_fused.launches = 0
