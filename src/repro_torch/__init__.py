"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
relative paths and public names (``repro_torch/optim/soap.py`` is held
against ``repro/optim/soap.py``).  It imports torch and numpy only — never
JAX, never a ``repro`` module — and keeps its own copies of what it needs.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
Kernels dispatch on the tensor's device: CPU tensors take each kernel's
plain PyTorch version, CUDA tensors launch the hand-written Hopper kernel
(or raise) — there is no silent fallback.
"""
