"""LLaMA-60M — the paper's C4 federated pre-training model (Table 3);
counterpart of ``repro/configs/llama_60m.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-60m",
    num_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1376,
    vocab_size=32000,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=True,
    dtype="float32",
    source="arXiv:2302.13971 (scaled)",
)
