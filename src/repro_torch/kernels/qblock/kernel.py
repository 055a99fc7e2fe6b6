"""``quantize``: blockwise int8 quantization of a cohort-stacked leaf.

  scale_b = max(max|x_b| / 127, eps),  q_b = clip(round(x_b / scale_b), ±127)

Replaces the Pallas TPU kernel ``repro/kernels/qblock/kernel.py::
quantize`` (with ``ref.py``/``ops.py``) by the hand-written CUDA C++
kernel in ``kernels/csrc/qblock.cu`` (one warp per quant block, abs-max
by warp shuffles, ``rintf`` and IEEE division, so the output is bitwise
the reference's).  Bound on an H100: memory — ~5.03 B per element.

Layout: the input is seen as ``(rows, n)``, one row per client of the
stacked leaf, and each row is cut into ``ceil(n / block)`` blocks of its
own — a block never spans two clients, as under the reference's ``vmap``.
``q`` comes back as ``(rows, n)`` int8 (the n values that ship; the
reference's zero padding is implicit) and ``scale`` as
``(rows, ceil(n / block))`` f32.  ``dequantize`` is the inverse.

Dispatch follows the tensors: CPU tensors take ``quantize_plain``, CUDA
tensors launch the kernel or raise — no fallback.  The CUDA kernel takes
``block`` in multiples of 128, as the Pallas kernel did.
``quantize.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SOURCE = "qblock.cu"
LANES = 128


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


def _lib():
    fn = build.load(SOURCE).repro_qblock_quantize
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def quantize(x, *, block: int = 128, eps: float = 1e-12):
    """Blockwise int8 quantization of each row of ``x`` (rows, n)."""
    if x.ndim != 2:
        raise ValueError(f"quantize wants (rows, n), got {tuple(x.shape)}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    dev = x.device
    if dev.type == "cpu":
        return quantize_plain(x, block=block, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"quantize: unsupported device {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA quantize kernel takes float32, got "
                        f"{x.dtype}")
    if block % LANES:
        raise ValueError(f"the CUDA quantize kernel takes block in "
                         f"multiples of {LANES}, got {block}")
    x = x.contiguous()
    rows, n = x.shape
    q = torch.empty((rows, n), device=dev, dtype=torch.int8)
    scale = torch.empty((rows, n_blocks(n, block)), device=dev,
                        dtype=torch.float32)
    if q.numel() == 0:
        return q, scale
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
                     block, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err} "
                           f"(rows={rows}, n={n}, block={block})")
    quantize.launches += 1
    return q, scale


quantize.launches = 0
