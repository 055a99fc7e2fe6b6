"""LLaMA-130M — the paper's C4 federated pre-training model (Table 3);
counterpart of ``repro/configs/llama_130m.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-130m",
    num_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32000,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=True,
    dtype="float32",
    source="arXiv:2302.13971 (scaled)",
)
