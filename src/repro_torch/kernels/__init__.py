"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ns_ortho/kernel.py      matmul_fused  CUDA C++ (csrc/matmul_fused.cu)
  soap_rotate/kernel.py   adam_moments  Triton
  soap_rotate/ops.py      soap_rotated_update, composed from the two

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
