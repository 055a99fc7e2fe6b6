"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora=512) + MoE 160e top-6, 2 shared.

Per the assignment: d_ff=1536 is the routed-expert intermediate size; layer 0
is a dense FFN (DeepSeek-V2 convention). MLA decode cache stores only the
compressed (c_kv, k_rope) latents.

Counterpart of ``repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    num_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # qk_nope(128) + qk_rope(64); v_head_dim=128
    d_ff=1536,
    vocab_size=102400,
    block_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rms",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    tie_embeddings=False,
    dtype="bfloat16",
    source="arXiv:2405.04434",
)
