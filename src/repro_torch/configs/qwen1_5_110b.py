"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family] — dense GQA(kv=8), QKV bias.

Counterpart of ``repro/configs/qwen1_5_110b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=False,
    dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-0.5B",
)
