"""``dequant_accumulate``: the fused dequantize-accumulate of the qblock
flush, sum_i w_i * (q_i * scale_i) over the client axis, in f32.

Replaces the Pallas TPU kernel ``repro/kernels/fused_agg/kernel.py::
dequant_accumulate`` (with ``ref.py``/``ops.py``) by the hand-written
CUDA C++ kernel in ``kernels/csrc/fused_agg.cu``: each thread owns four
output elements and loops over the clients innermost (``char4`` loads,
one ``w_i * scale_{i,b}`` multiplier per client and block), so the
decoded per-client leaves never exist.  Bound on an H100: memory —
B*n int8 bytes read and 4n f32 bytes written.

Operands take the wire's layout (``kernels.qblock``): ``q`` (B, n) int8
and ``scale`` (B, ceil(n / block)) f32, unpadded; the result is the
leaf's (n,) sum.  ``lowrank_accumulate``/``sketch_accumulate`` are not
Pallas kernels in the reference (merged GEMMs left to XLA) and come with
the low-rank codecs.

Dispatch follows the tensors: CPU tensors take
``dequant_accumulate_plain``, CUDA tensors launch the kernel or raise —
no fallback.  ``dequant_accumulate.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.qblock.kernel import LANES, n_blocks

SOURCE = "fused_agg.cu"


def dequant_accumulate_plain(q, scale, weights, *, block: int = 128):
    """The kernel's math in plain PyTorch (the reference's ``ref.py``):
    the block scale and the client weight fold into one multiplier."""
    b, n = q.shape
    nb = scale.shape[1]
    ws = weights.to(torch.float32)[:, None] * scale.to(torch.float32)
    qb = F.pad(q, (0, nb * block - n)).reshape(b, nb, block)
    out = torch.einsum("bn,bnk->nk", ws, qb.to(torch.float32))
    return out.reshape(-1)[:n]


def _check(q, scale, weights, block):
    if q.ndim != 2 or scale.ndim != 2 or weights.ndim != 1:
        raise ValueError(
            f"dequant_accumulate wants q (B, n), scale (B, nb), weights "
            f"(B,), got {tuple(q.shape)}, {tuple(scale.shape)}, "
            f"{tuple(weights.shape)}")
    b, n = q.shape
    if scale.shape != (b, n_blocks(n, block)) or weights.shape[0] != b:
        raise ValueError(
            f"dequant_accumulate shape mismatch at block {block}: q "
            f"{tuple(q.shape)}, scale {tuple(scale.shape)}, weights "
            f"{tuple(weights.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"dequant_accumulate wants int8 q, got {q.dtype}")
    devices = {q.device, scale.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"dequant_accumulate operands on several devices: "
                         f"{sorted(map(str, devices))}")


def _lib():
    fn = build.load(SOURCE).repro_dequant_accumulate
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def dequant_accumulate(q, scale, weights, *, block: int = 128):
    """sum_i w_i * (q_i * scale_i): (B, n) int8 + (B, nb) f32 + (B,) ->
    (n,) f32."""
    _check(q, scale, weights, block)
    dev = q.device
    if dev.type == "cpu":
        return dequant_accumulate_plain(q, scale, weights, block=block)
    if dev.type != "cuda":
        raise ValueError(f"dequant_accumulate: unsupported device {dev}")
    if block % LANES:
        raise ValueError(f"the CUDA dequant_accumulate kernel takes block in "
                         f"multiples of {LANES}, got {block}")
    b, n = q.shape
    q = q.contiguous()
    scale = scale.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    out = torch.empty((n,), device=dev, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(q.data_ptr(), scale.data_ptr(), weights.data_ptr(),
                     out.data_ptr(), b, n, block, stream)
    if err != 0:
        raise RuntimeError(f"dequant_accumulate kernel launch failed: CUDA "
                           f"error {err} (B={b}, n={n}, block={block})")
    dequant_accumulate.launches += 1
    return out


dequant_accumulate.launches = 0
