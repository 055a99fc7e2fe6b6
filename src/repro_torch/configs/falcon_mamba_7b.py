"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1 SSM, attention-free.

64 layers, d_model=4096 (d_inner=8192), ssm_state=16, conv=4, d_ff=0 (the
Mamba block subsumes the MLP). O(1) state -> long_500k decode runs.

Counterpart of ``repro/configs/falcon_mamba_7b.py``.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    num_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    block_pattern=("mamba",),
    mlp_type="none",
    norm_type="rms",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, scan_chunk=128),
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2410.05355",
)
