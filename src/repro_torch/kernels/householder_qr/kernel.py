"""Householder QR: the Q of the reduced QR of a list of f32 matrices,
each overwritten in place.

Replaces no TPU kernel: the reference's SOAP refresh takes its QR from
XLA (``jnp.linalg.qr``).  On CUDA ``householder_qr_group(mats)`` launches
the hand-written kernel ``kernels/csrc/householder_qr.cu`` once over the
whole list (once per ``MAX_RECS`` records, ``launch_plan``): blocked
Householder with compact WY, in place, one CTA a matrix.  Bound on an
H100: the 67 TFLOP/s FP32 pipe (``qr_flops``).

A CTA runs a whole matrix, so a launch lasts as long as its longest CTA.
``takes`` says which groups the kernel is for: those whose matrices all
fit a CTA's shared memory, or that hold a matrix for every CTA the card
holds at once.  A group of fewer large matrices leaves most of the card
idle behind them, where ``torch.linalg.qr`` spreads each matrix over the
card: on an H100 one 2,560^2 matrix took the kernel 442 ms and the
library 15.8, 132 of them the kernel 487 ms and the library 2,082.
SOAP's refresh asks ``takes_group`` before it builds a group's products.

``householder_qr_plain`` repeats the kernel's arithmetic column by column
(LAPACK's ``sgeqr2`` then ``sorg2r``, ``slarfg``'s conventions: beta =
-sign(alpha) ||(alpha, x)||, tau = 0 where x is exactly zero, the
rescaling where |beta| underflows), batched over leading dims.  Q matches
``torch.linalg.qr``'s up to rounding on well-conditioned columns; in the
null space of a rank-deficient input the directions are its own.

Dispatch follows the tensors: CPU tensors take the plain version (its
result copied into the inputs), CUDA tensors launch the kernel or raise —
no fallback, no cast.  ``householder_qr_group.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped import PARAM_LIMIT

SOURCE = "householder_qr.cu"
NB = 32                     # the kernel's panel width
CW = 128                    # columns of a trailing-update chunk
SAFMIN = 2.0 ** -102        # LAPACK's slamch('S') / slamch('E')
SSQ_RANGE = (2.0 ** -100, 2.0 ** 100)   # a plain sum of squares is kept
# the launch's header and record, field for field as ``struct Head`` and
# ``struct Rec`` in the source (checked against the compiled library)
HEAD = np.dtype([("num_recs", "<i4"), ("num_inst", "<i4"),
                 ("ticket", "<u8")])
REC = np.dtype([("a", "<u8"), ("sb", "<i8"), ("batch", "<i4"),
                ("m", "<i4"), ("n", "<i4"), ("inst", "<i4")])
MAX_RECS = (PARAM_LIMIT - HEAD.itemsize) // REC.itemsize       # 1023
TABLE_BYTES = HEAD.itemsize + MAX_RECS * REC.itemsize


def qr_flops(m: int, n: int) -> int:
    """FLOPs of Householder QR and forming Q of one m x n matrix (m >= n):
    2 m n^2 - 2/3 n^3 each (LAPACK's counts; 8/3 n^3 in all, square)."""
    return 4 * m * n * n - 4 * n ** 3 // 3


# ---------------------------------------------------------- plain version

def _norm(x):
    """||x|| over the last dim: the plain sum of squares inside
    ``SSQ_RANGE``, else x scaled by its largest |entry| first."""
    ssq = (x * x).sum(-1)
    ok = (ssq >= SSQ_RANGE[0]) & (ssq <= SSQ_RANGE[1])
    if bool(ok.all()):
        return ssq.sqrt()
    amax = x.abs().amax(-1) if x.shape[-1] else torch.zeros_like(ssq)
    div = torch.where(amax > 0, amax, torch.ones_like(amax))
    scaled = amax * ((x / div[..., None]) ** 2).sum(-1).sqrt()
    return torch.where(ok, ssq.sqrt(), scaled)


def _reflector(a, j):
    """``slarfg`` on column j of ``a`` (..., m, n) below row j, in place
    (x scaled to v's tail); returns tau (...)."""
    alpha = a[..., j, j].clone()
    x = a[..., j + 1:, j]
    xnorm = _norm(x)
    hyp = torch.hypot(alpha, xnorm)
    beta = torch.where(alpha >= 0, -hyp, hyp)
    live = xnorm != 0
    small = live & (beta.abs() < SAFMIN)
    if bool(small.any()):
        for _ in range(20):
            grow = small & (beta.abs() < SAFMIN)
            if not bool(grow.any()):
                break
            f = torch.where(grow, torch.full_like(beta, 1 / SAFMIN),
                            torch.ones_like(beta))
            x.mul_(f[..., None])
            alpha, beta = alpha * f, beta * f
        fresh = torch.hypot(alpha, _norm(x))
        fresh = torch.where(alpha >= 0, -fresh, fresh)
        beta = torch.where(small, fresh, beta)
    one = torch.ones_like(beta)
    tau = torch.where(live, (beta - alpha) / torch.where(live, beta, one),
                      torch.zeros_like(beta))
    scal = torch.where(live, 1 / torch.where(live, alpha - beta, one), one)
    x.mul_(scal[..., None])
    return tau


def _apply(a, i, tau, cols):
    """H_i = I - tau v v^T (v = 1 at row i, column i's tail below) on
    ``a``'s columns ``cols`` from row i down, in place."""
    v = torch.cat([torch.ones_like(a[..., i:i + 1, i]), a[..., i + 1:, i]],
                  dim=-1)
    c = a[..., i:, cols]
    w = (v[..., :, None] * c).sum(-2)
    c.add_(v[..., :, None] * (-tau[..., None] * w)[..., None, :])


def householder_qr_plain(mats):
    """The Q of the reduced QR of each (..., m, n) of ``mats`` (m >= n),
    batched over leading dims: new f32 tensors."""
    out = []
    for g in mats:
        a = g.to(torch.float32, copy=True)
        n = a.shape[-1]
        taus = []
        for j in range(n):
            taus.append(_reflector(a, j))
            if j + 1 < n:
                _apply(a, j, taus[j], slice(j + 1, n))
        for i in reversed(range(n)):
            if i + 1 < n:
                _apply(a, i, taus[i], slice(i + 1, n))
            a[..., i + 1:, i] *= -taus[i][..., None]
            a[..., i, i] = 1 - taus[i]
            a[..., :i, i] = 0
        out.append(a)
    return out


# ------------------------------------------------------------ host tables

def takes(dims, resident: int, big_floats: int) -> bool:
    """Whether the kernel is for a group of (batch, m, n) records on a card
    that holds ``resident`` of its CTAs at once, each with ``big_floats``
    floats of shared memory for a matrix (the source's ``fits``): every
    matrix fits there, or the group holds at least ``resident`` matrices.
    Else ``torch.linalg.qr`` is."""
    dims = np.asarray(dims, dtype=np.int64).reshape(-1, 3)
    batch, m, n = dims[dims.prod(axis=1) > 0].T
    return bool((m * (n | 1) <= big_floats).all() or batch.sum() >= resident)


def launch_plan(dims, max_recs: int = MAX_RECS):
    """Launches of a group.  ``dims``: (batch, m, n) per matrix record.
    Records with no work are dropped, the rest ordered by work (m n^2,
    largest first; stably) and cut into launches of at most ``max_recs``.
    Returns [(record indices, matrices)]."""
    dims = np.asarray(dims, dtype=np.int64).reshape(-1, 3)
    batch, m, n = dims.T
    keep = np.flatnonzero(batch * m * n > 0)
    keep = keep[np.argsort(-(m[keep] * n[keep] * n[keep]), kind="stable")]
    return [(idx, int(batch[idx].sum()))
            for idx in (keep[lo:lo + max_recs]
                        for lo in range(0, len(keep), max_recs))]


def launch_table(rows, idx, ticket: int = 0):
    """A ``TABLE_BYTES`` numpy buffer, the header and the records ``idx``
    of ``rows`` (a ``REC`` array; their ``inst`` filled here, the prefix
    of the batches), as the kernel takes it by value."""
    table = np.zeros(TABLE_BYTES, np.uint8)
    recs = table[HEAD.itemsize:].view(REC)[:len(idx)]
    recs[:] = rows[idx]
    recs["inst"] = np.cumsum(recs["batch"]) - recs["batch"]
    table[:HEAD.itemsize].view(HEAD)[0] = (
        len(idx), int(recs["batch"].sum()), ticket)
    return table


# -------------------------------------------------------------- the kernel

class KernelLibrary:
    """A loaded build of ``householder_qr.cu``, checked against the host's
    record layout."""

    def __init__(self, cdll):
        cfg = (ctypes.c_int * 10)()
        cdll.repro_householder_qr_config(cfg)
        nb, cw, _, _, max_r, rec, head, table, _, _ = cfg
        want = (NB, CW, MAX_RECS, REC.itemsize, HEAD.itemsize, TABLE_BYTES)
        if (nb, cw, max_r, rec, head, table) != want:
            raise RuntimeError(f"householder_qr.cu's table ({tuple(cfg)}) "
                               "does not match the wrapper's")
        self.config = tuple(cfg)     # NB CW RC THREADS MAX_RECS ... BIG
        self.launch = cdll.repro_householder_qr
        self.launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        self.launch.restype = ctypes.c_int
        self.resident_blocks = cdll.repro_householder_qr_resident_blocks
        self.resident_blocks.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def kernel_library() -> KernelLibrary:
    return KernelLibrary(build.load(SOURCE))


def _resident(lib, dev) -> int:
    with torch.cuda.device(dev):
        resident = lib.resident_blocks()
    if resident < 1:
        raise RuntimeError(f"householder_qr: the kernel cannot be set up on "
                           f"{dev} (CUDA error {-resident})")
    return resident


def _dims(mats):
    return [(g.numel() // (g.shape[-2] * g.shape[-1]) if g.numel() else 0,
             *g.shape[-2:]) for g in mats]


def takes_group(mats) -> bool:
    """``takes`` for the shapes of ``mats``, CUDA tensors of one device, on
    that device (their data is not read)."""
    lib = kernel_library()
    return takes(_dims(mats), _resident(lib, mats[0].device), lib.config[9])


def _check(mats):
    for g in mats:
        if g.dim() < 2 or g.shape[-2] < g.shape[-1]:
            raise ValueError(f"householder_qr wants (..., m, n) matrices "
                             f"with m >= n, got {tuple(g.shape)}")
        if g.dtype != torch.float32:
            raise TypeError(f"householder_qr takes float32, got {g.dtype}")
        if not g.is_contiguous():
            raise ValueError(f"householder_qr overwrites its inputs in "
                             f"place: a contiguous tensor, got strides "
                             f"{g.stride()} for {tuple(g.shape)}")


def householder_qr_group(mats):
    """Overwrite each f32, contiguous (..., m, n) tensor of ``mats`` (m >=
    n) with the Q of its reduced QR and return them: on CUDA one kernel
    launch a call (one per ``MAX_RECS`` records), whatever ``takes``
    says."""
    mats = list(mats)
    if not mats:
        return []
    _check(mats)
    devices = {g.device for g in mats}
    if len(devices) != 1:
        raise ValueError(f"householder_qr operands on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        for g, q in zip(mats, householder_qr_plain(mats)):
            g.copy_(q)
        return mats
    if dev.type != "cuda":
        raise ValueError(f"householder_qr: unsupported device {dev}")
    lib = kernel_library()
    _resident(lib, dev)                  # the card set up for the kernel
    dims = _dims(mats)
    rows = np.zeros(len(mats), REC)
    for i, (g, (b, m, n)) in enumerate(zip(mats, dims)):
        rows[i] = (g.data_ptr(), m * n, b, m, n, 0)
    plan = launch_plan(dims)
    if not plan:
        return mats
    with torch.cuda.device(dev):
        ticket = torch.empty(1, device=dev, dtype=torch.int32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for idx, count in plan:
            table = launch_table(rows, idx, ticket.data_ptr())
            err = lib.launch(table.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(
                    f"householder_qr kernel launch failed: CUDA error {err} "
                    f"({len(idx)} records, {count} matrices, first (m, n) = "
                    f"{tuple(mats[idx[0]].shape[-2:])})")
            householder_qr_group.launches += 1
    return mats


householder_qr_group.launches = 0
