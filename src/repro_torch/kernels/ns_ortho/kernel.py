"""``matmul_fused``: alpha * (lhs @ rhs) + beta * aux, batched.

Replaces the Pallas TPU kernel ``repro/kernels/ns_ortho/kernel.py::
matmul_fused`` with the hand-written CUDA C++ kernel in
``kernels/csrc/matmul_fused.cu`` (FP32 FMA mainloop over shared-memory
tiles, the scale-and-add epilogue fused, operands read through their
strides so transposed views cost no copy, ragged edges masked).  Bound on
an H100: the 67 TFLOP/s FP32 pipe at SOAP's shapes, launch overhead at the
smallest ones.

Dispatch follows the tensors: CPU tensors take ``matmul_fused_plain`` (the
same math in PyTorch), CUDA tensors launch the kernel or raise — no
fallback.  ``matmul_fused.launches`` counts kernel launches.

Unlike the 2-D-only reference, operands may carry leading batch dims
(``(..., m, k) @ (..., k, n)``, identical batch shapes), the client axis
and expert stacks folded into the kernel's batch grid axis.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

SOURCE = "matmul_fused.cu"
MAX_BATCH = 65535       # CUDA grid z extent


def matmul_fused_plain(lhs, rhs, aux=None, *, alpha: float = 1.0,
                       beta: float = 0.0):
    """The kernel's math in plain PyTorch: f32 accumulate, lhs dtype out."""
    out = alpha * torch.matmul(lhs.to(torch.float32), rhs.to(torch.float32))
    if aux is not None:
        out = out + beta * aux.to(torch.float32)
    return out.to(lhs.dtype)


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
    devices = {t.device for t in (lhs, rhs, aux) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"matmul_fused operands on several devices: "
                         f"{sorted(map(str, devices))}")


def _batched(x):
    """(..., r, c) -> (batch, r, c), a view unless the batch dims cannot
    merge under their strides."""
    return x.reshape(-1, x.shape[-2], x.shape[-1])


def _lib():
    lib = build.load(SOURCE)
    fn = lib.repro_matmul_fused_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def matmul_fused(lhs, rhs, aux=None, *, alpha: float = 1.0,
                 beta: float = 0.0):
    """alpha * (lhs @ rhs) + beta * aux; aux may be None."""
    _check(lhs, rhs, aux)
    dev = lhs.device
    if dev.type == "cpu":
        return matmul_fused_plain(lhs, rhs, aux, alpha=alpha, beta=beta)
    if dev.type != "cuda":
        raise ValueError(f"matmul_fused: unsupported device {dev}")
    if any(t.dtype != torch.float32 for t in (lhs, rhs, aux)
           if t is not None):
        raise TypeError("the CUDA matmul_fused kernel takes float32 only")
    m, k, n = lhs.shape[-2], lhs.shape[-1], rhs.shape[-1]
    batch_shape = lhs.shape[:-2]
    batch = math.prod(batch_shape)
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the grid limit {MAX_BATCH}")
    out = torch.empty((*batch_shape, m, n), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    a, b = _batched(lhs), _batched(rhs)
    x = _batched(aux) if aux is not None else None
    xs = x.stride() if x is not None else (0, 0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(a.data_ptr(), b.data_ptr(),
                     x.data_ptr() if x is not None else None, out.data_ptr(),
                     batch, m, n, k, *a.stride(), *b.stride(), *xs,
                     float(alpha), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"matmul_fused kernel launch failed: CUDA error "
                           f"{err} (batch={batch}, m={m}, n={n}, k={k})")
    matmul_fused.launches += 1
    return out


matmul_fused.launches = 0
