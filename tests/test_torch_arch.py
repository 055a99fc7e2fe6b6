"""The six dense-attention tables of the port (``repro_torch.configs``:
StarCoder2-3B, SmolLM-360M, ChatGLM3-6B, Qwen1.5-110B, Qwen2-VL-7B,
MusicGen-medium) against the JAX package's: every field of the full and
the reduced tables, ``num_params``, the assignment's shape table, and on
each ``reduced()`` table the logits,
loss and gradients of the transformer LM on the carried-across JAX
weights (Qwen2-VL also from ``embeds``, MusicGen on its 4 codebooks).

The reference runs eagerly (no ``jax.jit``): its op-by-op compiles are
cached across the six tables, where a jitted step would compile once a
table.

Tolerances:
  * tables, counts and shapes: exact.
  * logits and loss 2e-5 absolute, gradients 1e-5 + 1e-4 relative per
    element: tests/test_torch_lm.py's, in f32 (the tables' bf16 is set
    to f32, as the reference's decode test and serving driver set it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import model
from repro_torch.utils.tree import tree_flatten_with_path

LOGIT_TOL = 2e-5
DENSE = ["starcoder2-3b", "smollm-360m", "chatglm3-6b", "qwen1.5-110b",
         "qwen2-vl-7b", "musicgen-medium"]
# tests/test_arch_smoke.py's table: layers, d_model, heads, kv heads,
# d_ff, vocab
SHAPES = {
    "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
    "smollm-360m": (32, 960, 15, 5, 2560, 49152),
    "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
    "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
    "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
    "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
}


def _cfgs(arch):
    """(reference, port) reduced table in f32."""
    return (jax_configs.get_reduced(arch).replace(dtype="float32"),
            configs.get_reduced(arch).replace(dtype="float32"))


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-5):
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = tree_flatten_with_path(got)
    assert len(w_leaves) == len(g_leaves)
    for (wp, w), (gp, g) in zip(w_leaves, g_leaves):
        g = g.detach().numpy()
        assert np.asarray(w).shape == g.shape, (wp, gp)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=str(gp))


# --------------------------------------------------------------- tables

def test_full_tables_match_reference():
    for arch in DENSE:
        want, got = jax_configs.get_config(arch), configs.get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.torch_dtype == {"bfloat16": torch.bfloat16,
                                   "float32": torch.float32}[want.dtype]
        assert dataclasses.asdict(configs.get_reduced(arch)) == \
            dataclasses.asdict(jax_configs.get_reduced(arch)), arch
        assert model.num_params(got) == jax_model.num_params(want), arch
        assert (got.num_layers, got.d_model, got.n_heads, got.n_kv_heads,
                got.d_ff, got.vocab_size) == SHAPES[arch], arch
    # 49,152 x 960 tied embedding + 32 layers of 9,832,320 + the final norm
    assert model.num_params(configs.get_config("smollm-360m")) == \
        49_152 * 960 + 32 * 9_832_320 + 960 == 361_821_120


# ---------------------------------------------------------------- parity

def _batch(cfg, seed, b=2, s=16, embeds=False):
    """numpy tokens (or embeds) and labels: (B, S), or (B, S, C) for a
    multi-codebook table."""
    r = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    batch = {"labels": r.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if embeds:
        batch["embeds"] = r.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = r.integers(0, cfg.vocab_size,
                                     shape).astype(np.int32)
    return batch


@pytest.mark.parametrize("case", DENSE + ["qwen2-vl-7b/embeds"])
def test_reduced_forward_loss_and_grad_match_reference(case):
    arch, _, path = case.partition("/")
    jcfg, tcfg = _cfgs(arch)
    jparams = jax_model.init_params(jcfg, jax.random.key(DENSE.index(arch)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = _batch(tcfg, 1, embeds=path == "embeds")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if path == "embeds":
        jb["tokens"] = tb["tokens"] = None

    wl = jax_model.forward(jparams, jb, jcfg)[0]
    gl = model.forward(tparams, tb, tcfg)[0]
    assert gl.shape == wl.shape == batch["labels"].shape + (
        tcfg.vocab_size,)
    np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl),
                               atol=LOGIT_TOL, rtol=0)
    wloss, wgrad = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, jb, jcfg))(jparams)
    ggrad, gloss = torch.func.grad_and_value(
        lambda p: model.loss_fn(p, tb, tcfg))(tparams)
    assert abs(float(gloss) - float(wloss)) <= LOGIT_TOL
    _assert_tree_close(wgrad, ggrad)
