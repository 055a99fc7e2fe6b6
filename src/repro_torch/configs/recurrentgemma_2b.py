"""RecurrentGemma-2B [arXiv:2402.19427] — RG-LRU + local attention, 1:2 ratio.

Block pattern (rglru, rglru, local_attn); local window 2048; MQA (kv=1);
GeGLU MLP; head_dim 256. O(1) recurrent state + window-bounded attention
cache -> long_500k decode runs.

Counterpart of ``repro/configs/recurrentgemma_2b.py``.
"""
from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    mlp_type="geglu",
    norm_type="rms",
    rope_theta=1e4,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4),
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2402.19427",
)
