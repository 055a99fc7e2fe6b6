"""Qwen2-VL-7B backbone [arXiv:2409.12191] — M-RoPE, GQA(kv=4), QKV bias.

The vision frontend (ViT + projector) is stubbed: the batch's ``embeds``
entry carries precomputed patch embeddings (B, S, D).
M-RoPE sections (t, h, w) = (16, 24, 24) over head_dim/2 = 64.

Counterpart of ``repro/configs/qwen2_vl_7b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    num_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    accepts_embeds=True,
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2409.12191",
)
