"""Kernel profiling hooks (counterpart of ``repro/obs/profiling.py``): one
timing harness over the five kernel triads (``soap_rotate``, ``qblock``,
``ns_ortho``, ``sophia_update``, ``fused_agg``).

Each kernel package pairs a plain PyTorch version with a hand-written
Hopper kernel; this harness times both on the same inputs and emits
records with the reference's analytic FLOP/byte envelopes:

  {"kind": "kernel", "kernel": "soap_rotate", "impl": "ref"|"kernel",
   "shape": [m, n], "us_per_call": ..., "flops": ..., "bytes": ...,
   "gflops_s": ..., "gbps": ...}

``impl: "ref"`` is the plain version, ``impl: "kernel"`` the Hopper
kernel (CUDA tensors only: on the CPU the wrappers run the plain version,
so a "kernel" row there would time the plain path under the kernel's
name, and asking for one raises).  On the card a row is timed with CUDA
events after a warm-up; on the CPU with the host clock.  The envelopes
are coarse by design (matmul 2mnk FLOPs, one read+write per array).
"""
from __future__ import annotations

import time

import torch

from repro_torch.utils.hw import resolve_device

KERNELS = ("soap_rotate", "qblock", "ns_ortho", "sophia_update",
           "fused_agg")
IMPLS = ("ref", "kernel")
NS_STEPS = 5
FUSED_AGG_COHORT = 8   # stacked client axis for the fused_agg case


def time_fn(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Microseconds per call after ``warmup`` calls: CUDA events on the
    card (the device's time for the queue of calls), the host clock on
    the CPU."""
    for _ in range(warmup):
        fn(*args)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def kernel_cases(shape, *, block: int = 128, device="cuda", seed: int = 0):
    """[(kernel, {"ref": fn, "kernel": fn}, args, flops, bytes)] for the
    five triads at ``shape`` on ``device``; both fns of a case take the
    same ``args``."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_plain,
    )
    from repro_torch.kernels.ns_ortho.ops import (
        newton_schulz_group, newton_schulz_group_plain,
    )
    from repro_torch.kernels.qblock.kernel import quantize, quantize_plain
    from repro_torch.kernels.soap_rotate.ops import (
        soap_rotated_update, soap_rotated_update_plain,
    )
    from repro_torch.kernels.sophia_update.kernel import (
        sophia_update, sophia_update_plain,
    )
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen).to(dev)

    m, n = shape
    size = m * n
    f32 = 4
    g = randn(1, m, n)
    out = []

    # soap_rotate: 4 (n x n)-ish matmuls + fused rotated-Adam moments, on
    # orthogonal eigenbases as SOAP's are (the reference times normals;
    # the envelope is the same)
    ql = torch.linalg.qr(torch.randn((1, m, m), generator=gen))[0].to(dev)
    qr = torch.linalg.qr(torch.randn((1, n, n), generator=gen))[0].to(dev)
    mom, v = randn(1, m, n), randn(1, m, n).abs()
    flops = 2 * (m * m * n) * 2 + 2 * (m * n * n) * 2 + 12 * size
    byts = f32 * size * 8   # g, 2 rotations, m, v in/out, d
    out.append(("soap_rotate",
                {"ref": soap_rotated_update_plain,
                 "kernel": soap_rotated_update},
                (g, ql, qr, mom, v), flops, byts))

    # qblock: one memory-bound pass (read f32, write int8 + scales)
    qflops = 4 * size
    qbytes = f32 * size + size + f32 * (size // block + 1)
    out.append(("qblock",
                {"ref": lambda x: quantize_plain(x, block=block),
                 "kernel": lambda x: quantize(x, block=block)},
                (g.reshape(1, size),), qflops, qbytes))

    # ns_ortho: NS_STEPS quintic iterations, 3 matmuls each
    nflops = NS_STEPS * (2 * m * m * n * 2 + 2 * m * m * m)
    nbytes = f32 * size * 2 * NS_STEPS * 3
    out.append(("ns_ortho",
                {"ref": lambda x: newton_schulz_group_plain(
                    [x], steps=NS_STEPS)[0],
                 "kernel": lambda x: newton_schulz_group(
                     [x], steps=NS_STEPS)[0]},
                (g,), nflops, nbytes))

    # sophia_update: fused momentum/clip/precondition elementwise pass
    h = randn(1, m, n)
    sflops = 8 * size
    sbytes = f32 * size * 5   # g, m, h in; update, m out
    out.append(("sophia_update",
                {"ref": sophia_update_plain, "kernel": sophia_update},
                (g, mom, h), sflops, sbytes))

    # fused_agg: dequantize-and-accumulate B stacked int8 uploads into one
    # f32 weighted sum (2 flops/element: scale-multiply + accumulate)
    bsz = FUSED_AGG_COHORT
    nb = max(1, size // block)
    q = torch.randint(-127, 128, (bsz, nb * block), generator=gen,
                      dtype=torch.int8).to(dev)
    scale = randn(bsz, nb).abs() + 1e-3
    wts = randn(bsz).abs() + 0.1
    aflops = 2 * bsz * nb * block
    abytes = bsz * nb * block + f32 * bsz * nb + f32 * nb * block
    out.append(("fused_agg",
                {"ref": lambda *a: dequant_accumulate_plain(*a, block=block),
                 "kernel": lambda *a: dequant_accumulate(*a, block=block)},
                (q, scale, wts), aflops, abytes))
    return out


def profile_kernels(shapes=((256, 256),), *, block: int = 128,
                    iters: int = 5, kernels=None, impls=None,
                    device="cuda") -> list:
    """Time every triad at every shape; returns a list of records.

    ``kernels`` restricts to a subset of ``KERNELS``; ``impls`` to a
    subset of ``IMPLS`` (default: both on the card, ``("ref",)`` on the
    CPU, where asking for ``"kernel"`` raises).
    """
    dev = resolve_device(device)
    want = set(kernels) if kernels is not None else set(KERNELS)
    unknown = want - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)} "
                         f"(want a subset of {KERNELS})")
    if impls is None:
        impls = IMPLS if dev.type == "cuda" else ("ref",)
    if set(impls) - set(IMPLS):
        raise ValueError(f"unknown impls {sorted(set(impls) - set(IMPLS))} "
                         f"(want a subset of {IMPLS})")
    if "kernel" in impls and dev.type != "cuda":
        raise ValueError("impl 'kernel' times the Hopper kernels, which run "
                         f"on CUDA tensors only (device {str(dev)!r})")
    records = []
    for shape in shapes:
        for kernel, fns, args, flops, byts in kernel_cases(
                tuple(shape), block=block, device=dev):
            if kernel not in want:
                continue
            for impl in impls:
                us = time_fn(fns[impl], *args, iters=iters)
                sec = us / 1e6
                records.append({
                    "kind": "kernel", "kernel": kernel, "impl": impl,
                    "shape": list(shape), "block": block,
                    "interpret": False, "backend": dev.type,
                    "us_per_call": us, "flops": flops, "bytes": byts,
                    "gflops_s": flops / sec / 1e9,
                    "gbps": byts / sec / 1e9,
                })
    return records
