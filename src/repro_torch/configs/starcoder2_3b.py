"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA(kv=2), RoPE, GELU MLP, LayerNorm, biases.

Counterpart of ``repro/configs/starcoder2_3b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    num_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layer",
    rope_theta=1e5,
    qkv_bias=True,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2402.19173",
)
