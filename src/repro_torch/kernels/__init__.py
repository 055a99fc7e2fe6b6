"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ns_ortho/kernel.py      matmul_fused, matmul_fused_group  CUDA C++
                          (csrc/matmul_fused.cu: one grouped launch)
  soap_rotate/kernel.py   adam_moments  Triton
  soap_rotate/ops.py      soap_rotated_update, composed from the two
  sophia_update/kernel.py sophia_update  Triton
  qblock/kernel.py        quantize      CUDA C++ (csrc/qblock.cu)
  fused_agg/kernel.py     dequant_accumulate  CUDA C++ (csrc/fused_agg.cu)

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
