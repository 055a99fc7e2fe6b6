"""ChatGLM3-6B [arXiv:2406.12793] — GQA(kv=2), 2d/partial RoPE (fraction 0.5), QKV bias.

Counterpart of ``repro/configs/chatglm3_6b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    num_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e4,
    rope_fraction=0.5,
    qkv_bias=True,
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2406.12793",
)
