"""Model configuration dataclasses covering all assigned architecture
families (counterpart of ``repro/models/config.py``; ``torch_dtype`` in
place of ``jnp_dtype``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_dense_layers: int = 0  # DeepSeek-V2: layer 0 is a dense FFN
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25  # used by benchmarks; ragged path is dropless


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 (falcon-mamba)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    scan_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""

    lru_width: int = 0  # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0  # power for the a parameterization


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Block layout: pattern cycled across layers.
    # entries: "attn" | "swa" | "local_attn" | "mamba" | "rglru"
    block_pattern: Sequence[str] = ("attn",)
    mlp_type: str = "swiglu"  # "swiglu" | "gelu" | "none"
    norm_type: str = "rms"  # "rms" | "layer"
    # RoPE
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # ChatGLM3 "2d" rope: 0.5
    mrope_sections: Optional[Sequence[int]] = None  # Qwen2-VL: (16, 24, 24)
    qkv_bias: bool = False
    window: int = 0  # sliding-window size for swa/local_attn blocks
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    num_codebooks: int = 1  # musicgen: 4 parallel EnCodec codebooks
    accepts_embeds: bool = False  # VLM/audio: frontend supplies embeddings
    tie_embeddings: bool = True
    dtype: str = "float32"
    # attention chunking for long sequences (flash-style online softmax)
    attn_chunk: int = 1024
    attn_chunk_threshold: int = 8192
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[self.dtype]

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def is_attention_free(self) -> bool:
        return all(b == "mamba" for b in self.block_pattern)

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: every block is SSM/recurrent/windowed."""
        return all(b in ("mamba", "rglru", "swa", "local_attn")
                   for b in self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512, max_experts: int = 4) -> ModelConfig:
    """CPU-scale variant of the same family for smoke tests."""
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=vocab,
        window=min(cfg.window, 64) if cfg.window else 0,
        attn_chunk_threshold=1 << 30,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=d_model,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, scan_chunk=16)
    if cfg.rglru:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=d_model)
    if cfg.mrope_sections:
        hd = d_model // n_heads
        third = hd // 2 // 4
        kw["mrope_sections"] = (hd // 2 - 2 * third, third, third)
    return dataclasses.replace(cfg, **kw)
