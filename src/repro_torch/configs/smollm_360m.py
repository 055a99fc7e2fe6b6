"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — llama-arch small, GQA(kv=5).

Counterpart of ``repro/configs/smollm_360m.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    num_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e4,
    tie_embeddings=True,
    dtype="bfloat16",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
