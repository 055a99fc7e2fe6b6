"""Architecture registry: 10 assigned architectures + the paper's own
models (counterpart of ``repro/configs``)."""
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


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


def get_reduced(name: str, **kw) -> ModelConfig:
    return reduced(get_config(name), **kw)
