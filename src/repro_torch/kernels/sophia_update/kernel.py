"""``sophia_update``: Sophia's fused momentum + clipped diagonal step, for
one leaf or for a group of leaves in one launch.

  m' = b1 m + (1-b1) g,   d = clip(m' / max(h, eps), -rho, rho)
                                                   -> (d, m') in f32

Replaces the Pallas TPU kernel ``repro/kernels/sophia_update/kernel.py::
sophia_update`` (with ``ref.py``/``ops.py``) by the hand-written CUDA C++
kernel in ``kernels/csrc/sophia_update.cu``: persistent blocks walk a
global chunk index over every leaf of the group, reading and writing each
element once with 16-byte accesses where a leaf's pointers allow.  Bound
on an H100: memory — three f32 reads and two writes per element (20 B)
against ~6 flops, so 3.35 TB/s sets the floor.

``sophia_update_group(gs, ms, hs)`` launches the kernel once per
``MAX_LEAVES`` leaves; ``sophia_update`` is the group of one.  The leaf
table (pointers, numel, first chunk, a 16-byte-access flag) is built here
in numpy (``leaf_tables``) and handed to the kernel by value; the d and m'
of a call are views into one arena.  ``b1``, ``1-b1`` (computed here, as
the plain version's constant), ``rho`` and ``eps`` ride in the table's
header; the kernel rounds as the plain version does and propagates NaN as
``torch.clamp`` does, so its outputs are bitwise the plain version's.

Dispatch follows the tensors: CPU tensors take the plain versions
(``sophia_update_plain``, ``sophia_update_group_plain``), CUDA tensors
launch the kernel or raise — no fallback.  ``sophia_update.launches``
counts kernel launches, from either entry.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped import (
    aligned, arena_layout, arena_views, max_records, split_tables,
)

SOURCE = "sophia_update.cu"

# The kernel's table, field for field as ``struct Group`` and ``struct
# Leaf`` in the source (checked against the compiled library at load).
HEADER = np.dtype([("num_leaves", "<i4"), ("total_chunks", "<i4"),
                   ("b1", "<f4"), ("omb1", "<f4"), ("rho", "<f4"),
                   ("eps", "<f4"), ("pad", "<i4", 2)])
LEAF = np.dtype([("g", "<u8"), ("m", "<u8"), ("h", "<u8"), ("d", "<u8"),
                 ("m_out", "<u8"), ("numel", "<i8"), ("chunk_start", "<i4"),
                 ("flags", "<i4")])
MAX_LEAVES = max_records(HEADER, LEAF)                       # 584
TABLE_BYTES = HEADER.itemsize + MAX_LEAVES * LEAF.itemsize
CHUNK = 4096                 # elements per chunk (THREADS x 4 x UNROLL)
VEC = 1


def sophia_update_plain(g, m, h, *, b1: float = 0.9, rho: float = 0.05,
                        eps: float = 1e-12):
    """The kernel's math in plain PyTorch (the reference's ``ref.py``)."""
    m_new = b1 * m.to(torch.float32) + (1 - b1) * g.to(torch.float32)
    d = torch.clamp(m_new / torch.clamp(h.to(torch.float32), min=eps),
                    -rho, rho)
    return d, m_new


def sophia_update_group_plain(gs, ms, hs, **kw):
    """``sophia_update_plain`` over the leaves: ([d], [m'])."""
    outs = [sophia_update_plain(g, m, h, **kw) for g, m, h in zip(gs, ms, hs)]
    return [d for d, _ in outs], [m for _, m in outs]


def leaf_tables(ptrs, numels, *, b1: float, rho: float, eps: float,
                chunk: int = CHUNK, capacity: int = MAX_LEAVES):
    """The launch tables of a group: ``ptrs`` (leaves, 5) holds each
    leaf's g, m, h, d, m' addresses, ``numels`` its sizes.  A leaf whose
    five pointers are 16-byte aligned and whose numel is a multiple of 4
    gets the ``VEC`` flag; empty leaves are dropped; chunk starts are
    prefix sums per launch.  Returns [(table, leaf indices)]."""
    ptrs = np.asarray(ptrs, dtype=np.uint64).reshape(-1, 5)
    numels = np.asarray(numels, dtype=np.int64)
    recs = np.zeros(len(numels), LEAF)
    for j, name in enumerate(("g", "m", "h", "d", "m_out")):
        recs[name] = ptrs[:, j]
    recs["numel"] = numels
    recs["flags"] = VEC * aligned(ptrs, numels, 16, 4)
    header = np.zeros(1, HEADER)
    header[["b1", "omb1", "rho", "eps"]] = (b1, 1 - b1, rho, eps)
    return split_tables(header, recs, -(-numels // chunk), "chunk_start",
                        capacity)


class KernelLibrary:
    """The loaded build of ``sophia_update.cu``, checked against the
    host's table layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 5)()
        cdll.repro_sophia_update_config(cfg)
        self.config = tuple(cfg)     # THREADS CHUNK MAX_LEAVES sizes
        want = (CHUNK, MAX_LEAVES, LEAF.itemsize, TABLE_BYTES)
        if self.config[1:] != want:
            raise RuntimeError(f"sophia_update.cu's table (chunk, leaves, "
                               f"record, table bytes) {self.config[1:]} does "
                               f"not match the wrapper's {want}")
        self.launch = cdll.repro_sophia_update_group
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_sophia_update_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def _check(gs, ms, hs):
    if not len(gs) == len(ms) == len(hs):
        raise ValueError(f"sophia_update wants as many g, m and h leaves, "
                         f"got {len(gs)}, {len(ms)}, {len(hs)}")
    shapes = [g.shape for g in gs]
    if not shapes == [m.shape for m in ms] == [h.shape for h in hs]:
        g, m, h = next(x for x in zip(gs, ms, hs)
                       if not x[0].shape == x[1].shape == x[2].shape)
        raise ValueError(f"sophia_update shape mismatch: {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(h.shape)}")
    devices = {t.device for leaves in (gs, ms, hs) for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"sophia_update operands on several devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop(), tuple(shapes)


def sophia_update_group(gs, ms, hs, *, b1: float = 0.9, rho: float = 0.05,
                        eps: float = 1e-12):
    """The fused Sophia direction of every leaf: ([d], [m']) as f32 in
    each g's shape.  On CUDA they are views into one arena, and the group
    takes one launch per ``MAX_LEAVES`` leaves."""
    gs, ms, hs = list(gs), list(ms), list(hs)
    if not gs:
        return [], []
    dev, shapes = _check(gs, ms, hs)
    kw = dict(b1=b1, rho=rho, eps=eps)
    if dev.type == "cpu":
        return sophia_update_group_plain(gs, ms, hs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"sophia_update: unsupported device {dev}")
    f32 = torch.float32
    if {t.dtype for leaves in (ms, hs) for t in leaves} != {f32}:
        raise TypeError("sophia_update keeps its m and h in float32")
    if not all(g.dtype.is_floating_point for g in gs):
        raise TypeError("sophia_update wants floating g")
    lib = kernel_library()
    # held until the launches are enqueued: a copy made here must not
    # return to the allocator before the kernel that reads it
    gs = [(g if g.dtype == f32 else g.to(f32)).contiguous() for g in gs]
    ms = [m.contiguous() for m in ms]
    hs = [h.contiguous() for h in hs]
    offsets, numels, total, runs = arena_layout(shapes, 2)
    arena = torch.empty(total, device=dev, dtype=f32)
    ds, mos = arena_views(arena, runs, len(gs), 2)
    ptrs = np.empty((len(gs), 5), np.uint64)
    ptrs[:, :3] = np.array([t.data_ptr() for leaf in zip(gs, ms, hs)
                            for t in leaf], np.uint64).reshape(-1, 3)
    ptrs[:, 3:] = (np.uint64(arena.data_ptr())
                   + 4 * offsets.T.astype(np.uint64))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table, idx in leaf_tables(ptrs, numels, **kw):
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"sophia_update kernel launch failed: CUDA error {err} "
                    f"({len(idx)} leaves, {int(numels.sum())} elements)")
            sophia_update.launches += 1
    return ds, mos


def sophia_update(g, m, h, *, b1: float = 0.9, rho: float = 0.05,
                  eps: float = 1e-12):
    """Fused Sophia direction; returns (d, m') as f32 in ``g``'s shape.
    A group of one."""
    (d,), (m_new,) = sophia_update_group([g], [m], [h], b1=b1, rho=rho,
                                         eps=eps)
    return d, m_new


sophia_update.launches = 0
