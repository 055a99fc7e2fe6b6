"""LLaMA-350M — the paper's C4 federated pre-training model (Table 3);
counterpart of ``repro/configs/llama_350m.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-350m",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2736,
    vocab_size=32000,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=True,
    dtype="float32",
    source="arXiv:2302.13971 (scaled)",
)
