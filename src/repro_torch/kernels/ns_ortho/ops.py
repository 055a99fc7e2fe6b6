"""Newton–Schulz orthogonalisation — counterpart of
``repro/kernels/ns_ortho/ops.py`` (``ns_iteration_pallas``,
``newton_schulz_pallas``, ``newton_schulz``) and of its oracle
``ref.py``.

Each matrix is orthogonalised as the reference does it: a tall one
(m > n) as its transpose, pre-scaled by its own Frobenius norm + eps,
then ``steps`` quintic steps with ``NS_COEFFS`` (a, b, c):

  A = X X^T,   B = c (A A) + b A,   X' = B X + a X.

``newton_schulz_group(mats)`` orthogonalises a whole list in one launch
of the hand-written CUDA C++ kernel ``kernels/csrc/newton_schulz.cu``
(the pre-scale and all five steps; more launches only where the list
exceeds ``MAX_MATS`` matrices, the records one launch's parameters
hold).  Leading dims of a matrix (the cohort's client axis, expert
stacks) fold into its batch; each batch entry is pre-scaled by its own
norm, as the reference vmaps one client at a time.  Inputs are read
through their strides in f32, bf16 or f16, so the transposes cost no
copy.  The host builds the launch's table here in numpy: the matrices'
tile counts and ticket offsets (``arena_plan``, ``launch_tables``), and
one scratch
arena per call, which the wrapper allocates and the kernel fills: per
matrix two X buffers, A and B, every row padded to 16 bytes.  Outputs
are f32, views into one arena; a tall input's output is a transposed
view.

``newton_schulz_group_plain`` repeats ``ref.ns_iteration``'s math per
matrix in plain PyTorch.  Dispatch follows the tensors: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise — no
fallback.  ``newton_schulz_group.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped import PARAM_LIMIT, arena_layout, arena_views

NS_COEFFS = (3.4445, -4.7750, 2.0315)

SOURCE = "newton_schulz.cu"
TILE = 64                   # the kernel's square output tile
MAX_STEPS = 16
ALIGN = 128                 # bytes: every region of the scratch arena
# the launch's header and matrix record, field for field as ``struct
# Head`` and ``struct Mat`` in the source (checked against the compiled
# library at load)
HEAD = np.dtype([
    ("num_mats", "<i4"), ("steps", "<i4"), ("total", "<i4"),
    ("num_inst", "<i4"), ("full_total", "<i4"), ("sym_total", "<i4"),
    ("pad0", "<i4"), ("pad1", "<i4"), ("a", "<f4"), ("b", "<f4"),
    ("c", "<f4"), ("eps", "<f4"), ("counters", "<u8"), ("base", "<u8")])
MAT = np.dtype([
    ("in", "<u8"), ("out", "<u8"), ("scratch", "<u8"),
    ("in_sb", "<i8"), ("in_sr", "<i8"), ("in_sc", "<i8"),
    ("batch", "<i4"), ("m", "<i4"), ("n", "<i4"), ("ldx", "<i4"),
    ("lda", "<i4"), ("dtype", "<i4"), ("tm", "<i4"), ("tn", "<i4"),
    ("full_start", "<i4"), ("sym_start", "<i4"), ("inst", "<i4"),
    ("part", "<i4")])
MAX_MATS = (PARAM_LIMIT - HEAD.itemsize) // MAT.itemsize      # 340
TABLE_BYTES = HEAD.itemsize + MAX_MATS * MAT.itemsize
# what the wrapper knows of each input: its pointers, the wide view's
# strides in elements, its dtype's code
ROW = np.dtype([("in", "<u8"), ("out", "<u8"), ("in_sb", "<i8"),
                ("in_sr", "<i8"), ("in_sc", "<i8"), ("dtype", "<i4")])
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _prescaled(g, eps):
    """(X, transposed): g as a wide matrix (a view), divided by its own
    Frobenius norm + eps over the last two dims, in f32."""
    transpose = g.shape[-2] > g.shape[-1]
    x = g.transpose(-1, -2) if transpose else g
    x = x.to(torch.float32)
    norm = torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    return x / (norm + eps), transpose


def newton_schulz_group_plain(mats, steps: int = 5, eps: float = 1e-7):
    """``ref.newton_schulz`` per matrix in plain PyTorch, batched over the
    leading dims."""
    a, b, c = NS_COEFFS
    out = []
    for g in mats:
        x, transpose = _prescaled(g, eps)
        for _ in range(steps):
            aa = x @ x.transpose(-1, -2)
            bb = b * aa + c * (aa @ aa)
            x = a * x + bb @ x
        out.append(x.transpose(-1, -2) if transpose else x)
    return out


# ------------------------------------------------------------ host tables

def _aligned(nbytes):
    return -(-nbytes // ALIGN) * ALIGN


def _offsets(start: int, sizes):
    """Exclusive prefix of ``sizes`` (bytes, each rounded up to ``ALIGN``)
    from ``start``; returns (offsets, end)."""
    sizes = _aligned(np.asarray(sizes, np.int64))
    ends = start + np.cumsum(sizes)
    return ends - sizes, int(ends[-1]) if len(sizes) else start


@functools.lru_cache(maxsize=64)
def arena_plan(dims: tuple, max_mats: int = MAX_MATS) -> dict:
    """Where one call's work lies.  ``dims``: a tuple of (batch, m, n),
    each matrix in wide form (m <= n); the plan is cached by it, since an
    optimizer orthogonalises the same shapes every step (its arrays are
    read-only).

    Matrices with no element are dropped; the rest go to launches of at
    most ``max_mats``, longest tiles first (by m, the K of B's and X''s
    tiles, then by n, the K of A's, descending; stably): a phase's
    longest tiles take the earliest tickets, so they are done before the
    next phase's tiles that wait for them.  The scratch arena holds, each
    region ``ALIGN``-aligned: every launch's counters (its ticket, then
    one int32 a batch entry), every matrix's partial sums of squares (one
    a tile of a batch entry), then every matrix's X0 | X1 | A | B, rows
    padded to ``ldx`` = n and ``lda`` = m rounded up to 4 floats.
    Returns groups (matrix indices a launch), counters (byte offset a
    launch), part (float offset a matrix), scratch (byte offset a
    matrix), tm, tn, ldx, lda and nbytes."""
    dims = np.asarray(dims, dtype=np.int64).reshape(-1, 3)
    batch, m, n = dims.T
    if (m > n).any():
        raise ValueError("arena_plan takes matrices in wide form (m <= n)")
    keep = np.flatnonzero(batch * m * n > 0)
    keep = keep[np.lexsort((-n[keep], -m[keep]))]
    groups = [keep[lo:lo + max_mats] for lo in range(0, len(keep), max_mats)]
    tm, tn = -(-m // TILE), -(-n // TILE)
    ldx, lda = -(-n // 4) * 4, -(-m // 4) * 4
    counters, end = _offsets(0, [4 * (1 + batch[idx].sum())
                                 for idx in groups])
    part = np.zeros(len(dims), np.int64)
    off, end = _offsets(end, 4 * batch[keep] * tm[keep] * tn[keep])
    part[keep] = off // 4
    scratch = np.zeros(len(dims), np.int64)
    scratch[keep], end = _offsets(
        end, 4 * batch[keep] * m[keep] * 2 * (ldx[keep] + lda[keep]))
    if len(keep) and part[keep].max() >= 2 ** 31:
        raise ValueError("the partial sums lie beyond a 32-bit offset")
    arrays = dict(dims=dims, part=part, scratch=scratch, tm=tm, tn=tn,
                  ldx=ldx, lda=lda)
    for x in [*arrays.values(), *groups]:
        x.setflags(write=False)
    return dict(arrays, groups=tuple(groups),
                counters=tuple(counters.tolist()), nbytes=end)


def launch_tables(dims, steps: int, eps: float, rows=None, base: int = 0,
                  max_mats: int = MAX_MATS):
    """The launch tables of ``dims`` (``arena_plan``): per launch a
    ``TABLE_BYTES`` numpy buffer, the header and its matrices' records,
    as the kernel takes it by value.  ``rows`` (a ``ROW`` array, one a
    matrix of ``dims``) gives the inputs' and outputs' pointers and
    strides, ``base`` the arena's address; without them those fields are
    0 (the tests read the schedule alone).  Everything else is cached by
    shape.  Returns [(table, matrix indices)]."""
    out = []
    for template, idx in _templates(tuple(map(tuple, dims)), steps,
                                    float(eps), max_mats):
        table = template.copy()
        head = table[:HEAD.itemsize].view(HEAD)
        recs = table[HEAD.itemsize:].view(MAT)[:len(idx)]
        head["counters"] += base
        head["base"] = base
        recs["scratch"] += base
        if rows is not None:
            for name in ROW.names:
                recs[name] = rows[name][idx]
        out.append((table, idx))
    return out


@functools.lru_cache(maxsize=64)
def _templates(dims: tuple, steps: int, eps: float, max_mats: int):
    """``launch_tables`` at base 0 with no pointers: [(table, indices)]."""
    plan = arena_plan(dims, max_mats)
    a, b, c = NS_COEFFS
    batch, m, n = plan["dims"].T
    tm, tn = plan["tm"], plan["tn"]
    out = []
    for counters, idx in zip(plan["counters"], plan["groups"]):
        bt = batch[idx]
        full = bt * tm[idx] * tn[idx]
        sym = bt * tm[idx] * (tm[idx] + 1) // 2
        f_total, s_total = int(full.sum()), int(sym.sum())
        total = 2 * f_total + steps * (2 * s_total + f_total)
        if total >= 2 ** 31:
            raise ValueError(f"newton_schulz launch of {total} tiles exceeds "
                             "the kernel's 32-bit ticket")
        table = np.zeros(TABLE_BYTES, np.uint8)
        table[:HEAD.itemsize].view(HEAD)[0] = (
            len(idx), steps, total, int(bt.sum()), f_total, s_total, 0, 0,
            a, b, c, eps, counters, 0)
        recs = table[HEAD.itemsize:].view(MAT)[:len(idx)]
        for name, value in (("batch", bt), ("m", m[idx]), ("n", n[idx]),
                            ("ldx", plan["ldx"][idx]),
                            ("lda", plan["lda"][idx]), ("tm", tm[idx]),
                            ("tn", tn[idx]), ("full_start", np.cumsum(full)
                                              - full),
                            ("sym_start", np.cumsum(sym) - sym),
                            ("inst", np.cumsum(bt) - bt),
                            ("part", plan["part"][idx]),
                            ("scratch", plan["scratch"][idx])):
            recs[name] = value
        table.setflags(write=False)
        out.append((table, idx))
    return out


# -------------------------------------------------------------- the kernel

class KernelLibrary:
    """A loaded build of ``newton_schulz.cu``, checked against the host's
    record layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 10)()
        cdll.repro_newton_schulz_config(cfg)
        tile, _, _, _, max_m, rec, head, table, _, max_steps = cfg
        want = (TILE, MAX_MATS, MAT.itemsize, HEAD.itemsize, TABLE_BYTES,
                MAX_STEPS)
        if (tile, max_m, rec, head, table, max_steps) != want:
            raise RuntimeError(f"newton_schulz.cu's table ({tuple(cfg)}) "
                               "does not match the wrapper's")
        self.config = tuple(cfg)     # T BK STAGES THREADS MAX_MATS ...
        self.launch = cdll.repro_newton_schulz
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_newton_schulz_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def _wide(g):
    """(wide (batch, m, n) view of g — a copy only where its leading dims
    do not merge under their strides —, tall)."""
    tall = g.shape[-2] > g.shape[-1]
    w = g.transpose(-1, -2) if tall else g
    if w.dim() == 2:
        w = w.unsqueeze(0)
    elif w.dim() > 3:
        w = w.reshape(-1, w.shape[-2], w.shape[-1])
    return w, tall


def newton_schulz_group(mats, steps: int = 5, eps: float = 1e-7):
    """Orthogonalise every (..., m, n) matrix of ``mats``: on CUDA one
    kernel launch a call (one per ``MAX_MATS`` matrices).  Returns f32
    outputs in the inputs' shapes (a tall input's output is a transposed
    view)."""
    mats = list(mats)
    if not mats:
        return []
    if any(g.dim() < 2 for g in mats):
        raise ValueError("newton_schulz wants (..., m, n) matrices, got "
                         f"{[tuple(g.shape) for g in mats if g.dim() < 2]}")
    devices = {g.device for g in mats}
    if len(devices) != 1:
        raise ValueError(f"newton_schulz operands on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return newton_schulz_group_plain(mats, steps=steps, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"newton_schulz: unsupported device {dev}")
    bad = {g.dtype for g in mats} - set(DTYPES)
    if bad:
        raise TypeError(f"the CUDA newton_schulz kernel takes float32, "
                        f"bfloat16 or float16, got {sorted(map(str, bad))}")
    if not 0 <= steps <= MAX_STEPS:
        raise ValueError(f"newton_schulz: steps {steps} outside "
                         f"[0, {MAX_STEPS}]")
    lib = kernel_library()
    # held until the launches are enqueued: a copy made by _wide must not
    # return to the allocator before the kernel that reads it
    wide = [_wide(g) for g in mats]
    shapes = tuple((*(g.shape[:-2]), *w.shape[-2:]) for g, (w, _) in
                   zip(mats, wide))
    _, _, total, runs = arena_layout(shapes)
    arena = torch.empty(total, device=dev, dtype=torch.float32)
    outs, = arena_views(arena, runs, len(mats))
    dims = tuple(tuple(w.shape) for w, _ in wide)
    plan = arena_plan(dims)
    rows = np.array([(w.data_ptr(), o.data_ptr(), *w.stride(),
                      DTYPES[w.dtype]) for (w, _), o in zip(wide, outs)],
                    dtype=ROW)
    scratch = torch.empty(plan["nbytes"], device=dev, dtype=torch.uint8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table, idx in launch_tables(dims, steps, eps, rows,
                                        scratch.data_ptr()):
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"newton_schulz kernel launch failed: CUDA error {err} "
                    f"({len(idx)} matrices, first (batch, m, n) = "
                    f"{tuple(plan['dims'][idx[0]])})")
            newton_schulz_group.launches += 1
    return [o.transpose(-1, -2) if tall else o
            for o, (_, tall) in zip(outs, wide)]


newton_schulz_group.launches = 0


def newton_schulz(g, steps: int = 5, eps: float = 1e-7):
    """One (m, n) matrix, or (E, m, n) orthogonalised matrix by matrix (the
    reference vmaps 3-D inputs over dim 0): the group of one."""
    if g.ndim not in (2, 3):
        raise ValueError(f"newton_schulz wants (m, n) or (E, m, n), got "
                         f"{tuple(g.shape)}")
    return newton_schulz_group([g], steps=steps, eps=eps)[0]
