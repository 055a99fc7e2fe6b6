"""``quantize``: blockwise int8 quantization of cohort-stacked leaves, for
one leaf or for a group of leaves in one launch.

  scale_b = max(max|x_b| / 127, eps),  q_b = clip(round(x_b / scale_b), ±127)

Replaces the Pallas TPU kernel ``repro/kernels/qblock/kernel.py::
quantize`` (with ``ref.py``/``ops.py``) by the hand-written CUDA C++
kernel in ``kernels/csrc/qblock.cu``: eight lanes per quant block, its
values held in registers and its abs-max a shuffle reduction, ``rintf``
and IEEE division, so the output is bitwise the reference's; persistent
blocks walk a global work-item index (one quant block of one row) over
every leaf of the group.  Bound on an H100: memory — ~5.03 B per
element.

Layout: each input is seen as ``(rows, n)``, one row per client of the
stacked leaf, and each row is cut into ``ceil(n / block)`` blocks of its
own — a block never spans two clients, as under the reference's ``vmap``.
``q`` comes back as ``(rows, n)`` int8 (the n values that ship; the
reference's zero padding is implicit) and ``scale`` as
``(rows, ceil(n / block))`` f32 (both contiguous from the kernel, which
the flush kernel reads at row stride n).  ``dequantize`` is the inverse.

``quantize_group(xs)`` launches the kernel once per ``MAX_LEAVES``
leaves; ``quantize`` is the group of one.  The leaf table is built here in
numpy (``leaf_tables``) and handed to the kernel by value; the codes of a
call are views into one int8 arena, the scales into one f32 arena.

Dispatch follows the tensors: CPU tensors take the plain versions
(``quantize_plain``, ``quantize_group_plain``), CUDA tensors launch the
kernel or raise — no fallback.  The CUDA kernel takes float32 and
``block`` in multiples of 128, as the Pallas kernel did.
``quantize.launches`` counts kernel launches, from either entry.
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

SOURCE = "qblock.cu"
LANES = 128

# The kernel's table, field for field as ``struct Group`` and ``struct
# Leaf`` in the source (checked against the compiled library at load).
HEADER = np.dtype([("num_leaves", "<i4"), ("total_items", "<i4"),
                   ("block", "<i4"), ("eps", "<f4")])
LEAF = np.dtype([("x", "<u8"), ("q", "<u8"), ("scale", "<u8"),
                 ("n", "<i8"), ("nb", "<i8"), ("item_start", "<i4"),
                 ("flags", "<i4")])
MAX_LEAVES = max_records(HEADER, LEAF)                       # 682
TABLE_BYTES = HEADER.itemsize + MAX_LEAVES * LEAF.itemsize
VEC = 1


def n_blocks(n: int, block: int) -> int:
    return -(-n // block)


def quantize_plain(x, *, block: int = 128, eps: float = 1e-12):
    """The kernel's math in plain PyTorch (the reference's ``ref.py`` per
    row): x (rows, n) -> (q (rows, n) int8, scale (rows, nb) f32)."""
    rows, n = x.shape
    nb = n_blocks(n, block)
    xb = F.pad(x.to(torch.float32), (0, nb * block - n)).reshape(
        rows, nb, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    # a 0-d tensor divisor, not a Python scalar: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal (one ulp off in a few
    # percent of blocks); this is IEEE division on every device
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=eps)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(rows, nb * block)[:, :n], scale[..., 0]


def dequantize(q, scale, block: int):
    """Inverse of ``quantize``: (rows, n) int8 + (rows, nb) scales ->
    (rows, n) f32, ``q * scale`` per block."""
    n = q.shape[-1]
    per_elem = scale.to(torch.float32).repeat_interleave(block, dim=-1)
    return q.to(torch.float32) * per_elem[..., :n]


def quantize_group_plain(xs, *, block: int = 128, eps: float = 1e-12):
    """``quantize_plain`` over the leaves: [(q, scale)]."""
    return [quantize_plain(x, block=block, eps=eps) for x in xs]


def leaf_tables(ptrs, rows, ns, block: int, eps: float,
                capacity: int = MAX_LEAVES):
    """The launch tables of a group: ``ptrs`` (leaves, 3) holds each
    leaf's x, q and scale addresses, ``rows`` and ``ns`` its clients and
    per-client sizes; a work item is one quant block of one row.  A leaf
    whose x is 16-byte aligned, whose q is 4-byte aligned and whose n is a
    multiple of 4 gets the ``VEC`` flag; empty leaves are dropped; item
    starts are prefix sums per launch.  Returns [(table, leaf indices)]."""
    ptrs = np.asarray(ptrs, dtype=np.uint64).reshape(-1, 3)
    ns = np.asarray(ns, dtype=np.int64)
    recs = np.zeros(len(ns), LEAF)
    for j, name in enumerate(("x", "q", "scale")):
        recs[name] = ptrs[:, j]
    recs["n"] = ns
    recs["nb"] = -(-ns // block)
    recs["flags"] = VEC * (aligned(ptrs[:, :1], ns, 16, 4)
                           & aligned(ptrs[:, 1:2], ns, 4, 4))
    header = np.zeros(1, HEADER)
    header[["block", "eps"]] = (block, eps)
    return split_tables(header, recs, np.asarray(rows, np.int64) * recs["nb"],
                        "item_start", capacity)


class KernelLibrary:
    """The loaded build of ``qblock.cu``, checked against the host's table
    layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 5)()
        cdll.repro_quantize_config(cfg)
        self.config = tuple(cfg)     # THREADS SLICE MAX_LEAVES sizes
        want = (LANES, MAX_LEAVES, LEAF.itemsize, TABLE_BYTES)
        if self.config[1:] != want:
            raise RuntimeError(f"qblock.cu's table (slice, leaves, record, "
                               f"table bytes) {self.config[1:]} does not "
                               f"match the wrapper's {want}")
        self.launch = cdll.repro_quantize_group
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_quantize_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def _check(xs, block):
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    bad = next((x for x in xs if x.ndim != 2), None)
    if bad is not None:
        raise ValueError(f"quantize wants (rows, n), got {tuple(bad.shape)}")
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"quantize operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop(), tuple(tuple(x.shape) for x in xs)


def quantize_group(xs, *, block: int = 128, eps: float = 1e-12):
    """Blockwise int8 quantization of each row of every leaf (rows, n):
    [(q (rows, n) int8, scale (rows, nb) f32)].  On CUDA the codes are
    views into one int8 arena and the scales into one f32 arena, and the
    group takes one launch per ``MAX_LEAVES`` leaves."""
    xs = list(xs)
    if not xs:
        return []
    dev, shapes = _check(xs, block)
    if dev.type == "cpu":
        return quantize_group_plain(xs, block=block, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"quantize: unsupported device {dev}")
    bad = next((x.dtype for x in xs if x.dtype != torch.float32), None)
    if bad is not None:
        raise TypeError(f"the CUDA quantize kernel takes float32, got {bad}")
    if block % LANES:
        raise ValueError(f"the CUDA quantize kernel takes block in "
                         f"multiples of {LANES}, got {block}")
    lib = kernel_library()
    xs = [x.contiguous() for x in xs]    # held until the launches are enqueued
    (q_off, q_runs, q_total), (s_off, s_runs, s_total) = _layout(shapes,
                                                                 block)
    q_arena = torch.empty(q_total, device=dev, dtype=torch.int8)
    s_arena = torch.empty(s_total, device=dev, dtype=torch.float32)
    qs, = arena_views(q_arena, q_runs, len(xs))
    scales, = arena_views(s_arena, s_runs, len(xs))
    ptrs = np.empty((len(xs), 3), np.uint64)
    ptrs[:, 0] = [x.data_ptr() for x in xs]
    ptrs[:, 1] = np.uint64(q_arena.data_ptr()) + q_off
    ptrs[:, 2] = np.uint64(s_arena.data_ptr()) + 4 * s_off
    rows, ns = np.array(shapes, np.int64).reshape(-1, 2).T
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table, idx in leaf_tables(ptrs, rows, ns, block, eps):
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"quantize kernel launch failed: CUDA error {err} "
                    f"({len(idx)} leaves, block={block})")
            quantize.launches += 1
    return list(zip(qs, scales))


@functools.lru_cache(maxsize=64)
def _layout(shapes, block):
    """The int8 arena of the codes and the f32 arena of the scales of
    leaves of ``shapes``: (offsets, runs, size) each."""
    out = []
    for s in (shapes, tuple((r, n_blocks(n, block)) for r, n in shapes)):
        offsets, _, total, runs = arena_layout(s)
        out.append((offsets[0].astype(np.uint64), runs, total))
    return tuple(out)


def quantize(x, *, block: int = 128, eps: float = 1e-12):
    """Blockwise int8 quantization of each row of ``x`` (rows, n).  A
    group of one."""
    return quantize_group([x], block=block, eps=eps)[0]


quantize.launches = 0
