"""``dequant_accumulate``: the fused dequantize-accumulate of the qblock
flush, sum_i w_i * (q_i * scale_i) over the client axis, in f32, for one
leaf or for a group of leaves in one launch.

Replaces the Pallas TPU kernel ``repro/kernels/fused_agg/kernel.py::
dequant_accumulate`` (with ``ref.py``/``ops.py``) by the hand-written
CUDA C++ kernel in ``kernels/csrc/fused_agg.cu``: each thread owns four
output elements of one quant block and loops over the clients innermost
(one 4-byte int8 load and one ``w_i * scale_{i,b}`` multiplier per client),
so the decoded per-client leaves never exist; persistent blocks walk a
global work-item index over every leaf of the group.  Bound on an H100:
memory — B*n int8 bytes read and 4n f32 bytes written.

Operands take the wire's layout (``kernels.qblock``): ``q`` (B, n) int8
and ``scale`` (B, ceil(n / block)) f32, unpadded; the result is the
leaf's (n,) sum.  ``dequant_accumulate_group(qs, scales, w)`` launches the
kernel once per ``MAX_LEAVES`` leaves, all with the same clients, weights
and block; ``dequant_accumulate`` is the group of one.  The leaf table is
built here in numpy (``leaf_tables``) and handed to the kernel by value;
the sums of a call are views into one arena.
``lowrank_accumulate``/``sketch_accumulate`` are not Pallas kernels in
the reference (merged GEMMs left to XLA); they are in ``ops.py``.

Dispatch follows the tensors: CPU tensors take the plain versions
(``dequant_accumulate_plain``, ``dequant_accumulate_group_plain``), CUDA
tensors launch the kernel or raise — no fallback.
``dequant_accumulate.launches`` counts kernel launches, from either
entry.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.grouped import (
    aligned, arena_layout, arena_views, max_records, split_tables,
)
from repro_torch.kernels.qblock.kernel import LANES, n_blocks

SOURCE = "fused_agg.cu"

# The kernel's table, field for field as ``struct Group`` and ``struct
# Leaf`` in the source (checked against the compiled library at load).
HEADER = np.dtype([("num_leaves", "<i4"), ("total_items", "<i4"),
                   ("w", "<u8"), ("clients", "<i4"), ("block", "<i4"),
                   ("pad", "<i4", 2)])
LEAF = np.dtype([("q", "<u8"), ("scale", "<u8"), ("out", "<u8"),
                 ("n", "<i8"), ("nb", "<i8"), ("item_start", "<i4"),
                 ("flags", "<i4")])
MAX_LEAVES = max_records(HEADER, LEAF)                       # 681
TABLE_BYTES = HEADER.itemsize + MAX_LEAVES * LEAF.itemsize
ELEMS = 4                    # outputs a work item (one thread)
VEC = 1


def dequant_accumulate_plain(q, scale, weights, *, block: int = 128):
    """The kernel's math in plain PyTorch (the reference's ``ref.py``):
    the block scale and the client weight fold into one multiplier."""
    b, n = q.shape
    nb = scale.shape[1]
    ws = weights.to(torch.float32)[:, None] * scale.to(torch.float32)
    qb = F.pad(q, (0, nb * block - n)).reshape(b, nb, block)
    out = torch.einsum("bn,bnk->nk", ws, qb.to(torch.float32))
    return out.reshape(-1)[:n]


def dequant_accumulate_group_plain(qs, scales, weights, *, block: int = 128):
    """``dequant_accumulate_plain`` over the leaves."""
    return [dequant_accumulate_plain(q, s, weights, block=block)
            for q, s in zip(qs, scales)]


def leaf_tables(ptrs, ns, w_ptr: int, clients: int, block: int,
                capacity: int = MAX_LEAVES):
    """The launch tables of a group: ``ptrs`` (leaves, 3) holds each
    leaf's q, scale and out addresses, ``ns`` its per-client sizes; a work
    item is ``ELEMS`` outputs.  A leaf whose q is ``ELEMS``-byte aligned
    with ``n % ELEMS == 0`` and whose out is 16-byte aligned gets the
    ``VEC`` flag; empty leaves are dropped; item starts are prefix sums per
    launch.  Returns [(table, leaf indices)]."""
    ptrs = np.asarray(ptrs, dtype=np.uint64).reshape(-1, 3)
    ns = np.asarray(ns, dtype=np.int64)
    recs = np.zeros(len(ns), LEAF)
    for j, name in enumerate(("q", "scale", "out")):
        recs[name] = ptrs[:, j]
    recs["n"] = ns
    recs["nb"] = -(-ns // block)
    recs["flags"] = VEC * (aligned(ptrs[:, :1], ns, ELEMS, ELEMS)
                           & aligned(ptrs[:, 2:], ns, 16, 4))
    header = np.zeros(1, HEADER)
    header[["w", "clients", "block"]] = (w_ptr, clients, block)
    return split_tables(header, recs, -(-ns // ELEMS), "item_start",
                        capacity)


class KernelLibrary:
    """The loaded build of ``fused_agg.cu``, checked against the host's
    table layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 5)()
        cdll.repro_dequant_accumulate_config(cfg)
        self.config = tuple(cfg)     # THREADS ELEMS MAX_LEAVES sizes
        want = (ELEMS, MAX_LEAVES, LEAF.itemsize, TABLE_BYTES)
        if self.config[1:] != want:
            raise RuntimeError(f"fused_agg.cu's table (outputs a thread, "
                               f"leaves, record, table bytes) "
                               f"{self.config[1:]} does not match the "
                               f"wrapper's {want}")
        self.launch = cdll.repro_dequant_accumulate_group
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_dequant_accumulate_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def _check(qs, scales, weights, block):
    if len(qs) != len(scales):
        raise ValueError(f"dequant_accumulate wants a scale per q, got "
                         f"{len(qs)} q and {len(scales)} scales")
    if weights.ndim != 1:
        raise ValueError(f"dequant_accumulate wants weights (B,), got "
                         f"{tuple(weights.shape)}")
    b = weights.shape[0]
    qshapes = [q.shape for q in qs]
    sshapes = [s.shape for s in scales]
    if not all(len(x) == 2 for x in qshapes + sshapes):
        q, s = next((q, s) for q, s in zip(qs, scales)
                    if q.ndim != 2 or s.ndim != 2)
        raise ValueError(
            f"dequant_accumulate wants q (B, n), scale (B, nb), weights "
            f"(B,), got {tuple(q.shape)}, {tuple(s.shape)}, {(b,)}")
    ns = [x[1] for x in qshapes]
    want = [(b, -(-n // block)) for n in ns]
    if [(x[0], y[0], y[1]) for x, y in zip(qshapes, sshapes)] != [
            (b, *w) for w in want]:
        q, s = next((q, s) for q, s, w in zip(qs, scales, want)
                    if (q.shape[0], *s.shape) != (b, *w))
        raise ValueError(
            f"dequant_accumulate shape mismatch at block {block}: q "
            f"{tuple(q.shape)}, scale {tuple(s.shape)}, weights {(b,)}")
    if {q.dtype for q in qs} != {torch.int8}:
        bad = next(q.dtype for q in qs if q.dtype != torch.int8)
        raise TypeError(f"dequant_accumulate wants int8 q, got {bad}")
    devices = {weights.device, *(t.device for t in qs),
               *(t.device for t in scales)}
    if len(devices) != 1:
        raise ValueError(f"dequant_accumulate operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop(), tuple(qshapes)


def dequant_accumulate_group(qs, scales, weights, *, block: int = 128):
    """[sum_i w_i * (q_i * scale_i) for each leaf]: (B, n) int8 + (B, nb)
    f32 per leaf, (B,) weights -> (n,) f32 per leaf.  On CUDA the sums are
    views into one arena, and the group takes one launch per
    ``MAX_LEAVES`` leaves."""
    qs, scales = list(qs), list(scales)
    if not qs:
        return []
    dev, qshapes = _check(qs, scales, weights, block)
    if dev.type == "cpu":
        return dequant_accumulate_group_plain(qs, scales, weights,
                                              block=block)
    if dev.type != "cuda":
        raise ValueError(f"dequant_accumulate: unsupported device {dev}")
    lib = kernel_library()
    if block % LANES:
        raise ValueError(f"the CUDA dequant_accumulate kernel takes block in "
                         f"multiples of {LANES}, got {block}")
    f32 = torch.float32
    # held until the launches are enqueued
    qs = [q.contiguous() for q in qs]
    scales = [(s if s.dtype == f32 else s.to(f32)).contiguous()
              for s in scales]
    weights = weights.to(f32).contiguous()
    offsets, ns, total, runs = _layout(qshapes)
    arena = torch.empty(total, device=dev, dtype=f32)
    outs, = arena_views(arena, runs, len(qs))
    ptrs = np.empty((len(qs), 3), np.uint64)
    ptrs[:, :2] = np.array([t.data_ptr() for pair in zip(qs, scales)
                            for t in pair], np.uint64).reshape(-1, 2)
    ptrs[:, 2] = np.uint64(arena.data_ptr()) + 4 * offsets[0].astype(
        np.uint64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table, idx in leaf_tables(ptrs, ns, weights.data_ptr(),
                                      weights.shape[0], block):
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"dequant_accumulate kernel launch failed: CUDA error "
                    f"{err} ({len(idx)} leaves, B={weights.shape[0]}, "
                    f"block={block})")
            dequant_accumulate.launches += 1
    return outs


@functools.lru_cache(maxsize=64)
def _layout(qshapes):
    """The arena of the (n,) sums of leaves with q shapes ``qshapes``."""
    return arena_layout(tuple((x[1],) for x in qshapes))


def dequant_accumulate(q, scale, weights, *, block: int = 128):
    """sum_i w_i * (q_i * scale_i): (B, n) int8 + (B, nb) f32 + (B,) ->
    (n,) f32.  A group of one."""
    return dequant_accumulate_group([q], [scale], weights, block=block)[0]


dequant_accumulate.launches = 0
