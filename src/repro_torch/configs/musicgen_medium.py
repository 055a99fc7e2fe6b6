"""MusicGen-medium decoder [arXiv:2306.05284] — decoder-only over EnCodec tokens.

4 parallel codebooks (vocab 2048 each); the EnCodec conv codec + delay-pattern
interleaver is a data-pipeline stub — the backbone consumes summed codebook
embeddings and emits per-codebook logits (B, S, 4, 2048). MHA (kv=24 == heads).

Counterpart of ``repro/configs/musicgen_medium.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layer",
    rope_theta=1e4,
    num_codebooks=4,
    accepts_embeds=True,
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2306.05284",
)
