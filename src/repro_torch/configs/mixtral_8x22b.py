"""Mixtral-8x22B [arXiv:2401.04088] — MoE 8 experts top-2, GQA(kv=8), SWA.

Sliding-window attention (window 4096) bounds the decode cache, so the
long_500k decode shape runs with a ring-buffer KV cache.

Counterpart of ``repro/configs/mixtral_8x22b.py``.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("swa",),
    window=4096,
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2401.04088",
)
