"""Architecture registry: 10 assigned architectures + the paper's own
models (counterpart of ``repro/configs``).

The paper's LLaMA tables (Table 3) and the six dense-attention tables are
ported; ``get_config`` of the other four assigned architectures raises
until the layers they need land with their ROADMAP queue 1 item.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

# arch id -> module name (dashes are not importable)
_ARCHS = {
    "starcoder2-3b": "starcoder2_3b",
    "smollm-360m": "smollm_360m",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "chatglm3-6b": "chatglm3_6b",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    # paper's own experimental models
    "llama-60m": "llama_60m",
    "llama-130m": "llama_130m",
    "llama-350m": "llama_350m",
}

ASSIGNED = list(_ARCHS)[:10]
ALL = list(_ARCHS)

# the assigned tables whose layers are not ported yet -> the ROADMAP queue 1
# item that brings them
NOT_PORTED = {
    "mixtral-8x22b": "item 3: the MoE layer",
    "deepseek-v2-236b": "item 4: multi-head latent attention and MoE",
    "falcon-mamba-7b": "item 5: the Mamba block",
    "recurrentgemma-2b": "item 5: the RG-LRU block",
}


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"the {name!r} table is not ported yet (ROADMAP queue 1 "
            f"{NOT_PORTED[name]})")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


def get_reduced(name: str, **kw) -> ModelConfig:
    return reduced(get_config(name), **kw)
