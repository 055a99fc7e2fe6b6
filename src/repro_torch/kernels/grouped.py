"""Host side of the port's grouped kernels: one launch over a list of
leaves or problems, described by a table that the kernel takes by value.

A table is a fixed-size byte buffer — a header, then one record per leaf —
laid out field for field as the kernel's parameter struct (each wrapper
checks its numpy record against the compiled library's ``sizeof``) and
copied into the launch's parameters at the call, so no device buffer or
pinned copy has to outlive it (``csrc/grouped.cuh``).  Hopper takes up to
``PARAM_LIMIT`` bytes of kernel parameters; a longer group splits into
several launches.  Outputs are views into one arena per call and dtype.
"""
from __future__ import annotations

import functools
import math

import numpy as np

PARAM_LIMIT = 32764          # bytes of kernel parameters on Hopper (CUDA >= 12.1)
OUT_ALIGN = 32               # elements: every f32 output starts 128-byte
                             # aligned, every int8 one 32-byte aligned


def max_records(header: np.dtype, record: np.dtype) -> int:
    """Records that fit one launch's parameters beside ``header``."""
    return (PARAM_LIMIT - header.itemsize) // record.itemsize


def split_tables(header, records, units, start: str, capacity: int):
    """The launch tables of a group.

    ``header`` is a one-element structured array whose first two fields
    count the records and their units of work (chunks, work items) and are
    filled here; ``records`` holds one record per leaf, ``units`` its units
    of work, and the field ``start`` of each record gets its first unit in
    its launch's global index (the prefix sum).  Leaves with no work are
    dropped, the rest cut into launches of at most ``capacity`` records.
    Each table is a ``header.itemsize + capacity * record size`` numpy
    buffer.  Returns [(table, record indices)]."""
    units = np.asarray(units, dtype=np.int64)
    keep = np.flatnonzero(units > 0)
    count, total = header.dtype.names[:2]
    out = []
    for lo in range(0, len(keep), capacity):
        idx = keep[lo:lo + capacity]
        u = units[idx]
        if u.sum() >= 2 ** 31:
            raise ValueError(f"a group of {int(u.sum())} units of work "
                             "exceeds the kernels' 32-bit index")
        table = np.zeros(header.itemsize + capacity * records.itemsize,
                         np.uint8)
        head = table[:header.itemsize].view(header.dtype)
        head[0] = header[0]
        head[count], head[total] = len(idx), u.sum()
        recs = table[header.itemsize:].view(records.dtype)
        recs[:len(idx)] = records[idx]
        recs[start][:len(idx)] = np.cumsum(u) - u
        out.append((table, idx))
    return out


def aligned(ptrs, numels, align_bytes: int, multiple: int):
    """Per leaf: every pointer of its row of ``ptrs`` is ``align_bytes``
    aligned and its numel a multiple of ``multiple`` (the kernels' wide
    loads are legal)."""
    ptrs = np.asarray(ptrs, dtype=np.uint64).reshape(len(numels), -1)
    return ((ptrs % np.uint64(align_bytes) == 0).all(axis=1)
            & (np.asarray(numels, dtype=np.int64) % multiple == 0))


@functools.lru_cache(maxsize=64)
def arena_layout(shapes: tuple, copies: int = 1, align: int = OUT_ALIGN):
    """Where ``copies`` outputs of each of ``shapes`` lie in one arena:
    (offsets, numels, arena size, runs).

    Outputs of one shape lie side by side, each ``align``-aligned, so a
    run of them is cut into views with a few tensor ops (``arena_views``)
    rather than a few per output.  Everything is counted in elements, so
    one layout serves an arena of any dtype (f32 outputs, int8 codes).
    ``offsets`` (copies, len(shapes)), ``numels`` (len(shapes),); runs are
    (shape, numel, padded numel, first offset, output indices)."""
    by_shape: dict = {}
    for i, s in enumerate(shapes):
        by_shape.setdefault(tuple(s), []).append(i)
    offsets = np.zeros((copies, len(shapes)), np.int64)
    numels = np.zeros(len(shapes), np.int64)
    total, runs = 0, []
    for s, idx in by_shape.items():
        n = math.prod(s)
        padded = -(-n // align) * align
        runs.append((s, n, padded, total, idx))
        offsets[:, idx] = total + padded * np.arange(
            copies * len(idx)).reshape(copies, len(idx))
        numels[idx] = n
        total += copies * len(idx) * padded
    return offsets, numels, total, runs


def arena_views(arena, runs, count: int, copies: int = 1):
    """The outputs of ``arena_layout``'s ``runs`` as views into ``arena``:
    ``copies`` lists of ``count`` tensors, in the order of its shapes."""
    out = [[None] * count for _ in range(copies)]
    for s, n, padded, start, idx in runs:
        k = len(idx)
        rows = arena[start:start + copies * k * padded].view(copies * k,
                                                             padded)
        if padded != n:
            rows = rows[:, :n]
        views = rows.view(copies * k, *s).unbind(0)
        for c in range(copies):
            for i, v in zip(idx, views[c * k:(c + 1) * k]):
                out[c][i] = v
    return out
