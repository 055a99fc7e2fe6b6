"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

  ns_ortho/kernel.py      matmul_fused, matmul_fused_group  CUDA C++
                          (csrc/matmul_fused.cu: one grouped launch)
  ns_ortho/ops.py         newton_schulz_group, newton_schulz  CUDA C++
                          (csrc/newton_schulz.cu: the pre-scale and
                          every quintic step of a list in one launch)
  soap_rotate/kernel.py   adam_moments  Triton
  soap_rotate/ops.py      soap_rotated_update, composed from the two
  sophia_update/kernel.py sophia_update, sophia_update_group  CUDA C++
                          (csrc/sophia_update.cu: one grouped launch)
  qblock/kernel.py        quantize, quantize_group  CUDA C++
                          (csrc/qblock.cu: one grouped launch)
  fused_agg/kernel.py     dequant_accumulate, dequant_accumulate_group
                          CUDA C++ (csrc/fused_agg.cu: one grouped launch)
  householder_qr/kernel.py  householder_qr_group  CUDA C++
                          (csrc/householder_qr.cu: SOAP's QR refresh in
                          place, one grouped launch; replaces no TPU
                          kernel: the reference's QR is XLA's)

The grouped kernels take a table of leaves or matrices by value
(``grouped.py``, ``csrc/grouped.cuh``).  Each wrapper counts its launches in
``<wrapper>.launches``.
"""
