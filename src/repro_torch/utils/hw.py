"""Device resolution for the port's entry points.

The entry points default to ``"cuda"`` and never fall back: asking for the
GPU on a host without one raises.  Kernel dispatch does not consult this
module — each kernel wrapper follows the device of the tensors it is given
(``repro_torch.kernels``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no CUDA
    device is present (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (want cuda or "
                         "cpu)")
    return dev


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): a span that
    times device work ends here, and only when someone is tracing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
