"""The port's decode path (``models.attention`` caches, ``models.model``
``prefill``/``decode_step``/``init_caches``, ``models.rope
.default_positions`` and ``launch.serve``) against the JAX package's, on
the six dense tables' ``reduced()`` forms in f32 and the carried-across
JAX weights: prefill then decode steps against the reference's logits and
against the port's own full forward (decode-matches-forward), Qwen2-VL's
prefill from ``embeds``, the ring buffer of a windowed layer decoded past
its window, and the write of a chunk that does not fit before the end of
a ring buffer (clamped, as ``jax.lax.dynamic_update_slice`` clamps).

The reference runs eagerly (no ``jax.jit``).

Tolerances:
  * decode against the port's own forward: 2e-4 absolute, the
    reference's own bound (tests/test_arch_smoke.py).
  * prefill and decode logits against the reference's: 2e-5 absolute
    (tests/test_torch_lm.py's logits), and so the caches' K/V; their
    positions exactly.
  * positions: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import rope as jax_rope
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention, model, rope

LOGIT_TOL = 2e-5
DECODE_TOL = 2e-4
DENSE = ["starcoder2-3b", "smollm-360m", "chatglm3-6b", "qwen1.5-110b",
         "qwen2-vl-7b", "musicgen-medium"]
# the windowed SmolLM of the ring tests: every layer a sliding window of 8
RING = dict(block_pattern=("swa",), window=8)


def _setup(arch, seed, **kw):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced table in f32."""
    jcfg = jax_configs.get_reduced(arch).replace(dtype="float32", **kw)
    tcfg = configs.get_reduced(arch).replace(dtype="float32", **kw)
    jparams = jax_model.init_params(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, seed, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------- decode

@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_forward_and_reference(arch):
    """Prefill 8 tokens into caches of 16 slots, then decode the next 4
    (teacher-forced): each step's logits against the full forward at its
    position and against the reference's step."""
    jcfg, tcfg, jparams, tparams = _setup(arch, DENSE.index(arch))
    b, s, pre = 2, 12, 8
    toks = _tokens(tcfg, 7, b, s)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        full = model.forward(tparams, {"tokens": tt}, tcfg)[0]
        got, caches = model.prefill(tparams, {"tokens": tt[:, :pre]}, tcfg,
                                    max_len=s + 4)
        want, jcaches = jax_model.prefill(
            jparams, {"tokens": jnp.asarray(toks[:, :pre])}, jcfg,
            max_len=s + 4)
        _close(got, full[:, pre - 1], DECODE_TOL)
        _close(got, want, LOGIT_TOL)
        for i in range(pre, s):
            got, caches = model.decode_step(tparams, tt[:, i:i + 1], caches,
                                            i, tcfg)
            want, jcaches = jax_model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                jnp.int32(i), jcfg)
            assert got.shape == full[:, i].shape
            _close(got, full[:, i], DECODE_TOL)
            _close(got, want, LOGIT_TOL)
    for g, w in zip(caches, jcaches):
        assert g["k"].shape == w["k"].shape == (
            tcfg.num_layers, b, s + 4, tcfg.n_kv_heads,
            tcfg.resolved_head_dim)
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        _close(g["k"], w["k"], LOGIT_TOL)


def test_cache_axes_match_reference_and_caches():
    """``cache_axes`` gives the reference's logical axes, one a dimension
    of each group's stacked cache, on all ten tables (MLA's latents,
    Mamba's and RG-LRU's states included)."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    for arch in configs.ASSIGNED:
        tcfg = configs.get_reduced(arch)
        axes = transformer.cache_axes(tcfg)
        assert axes == jax_transformer.cache_axes(
            jax_configs.get_reduced(arch))
        caches = model.init_caches(tcfg, 2, max_len=4)
        assert [{k: len(t) for k, t in a.items()} for a in axes] == [
            {k: v.ndim for k, v in c.items()} for c in caches]


def test_qwen2_vl_prefill_from_embeds_matches_reference():
    """Qwen2-VL prefills from frontend embeddings (``tokens=None``, M-RoPE
    positions (B, S, 3)) and decodes tokens after them."""
    jcfg, tcfg, jparams, tparams = _setup("qwen2-vl-7b", 4)
    r = np.random.default_rng(3)
    emb = r.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    toks = _tokens(tcfg, 5, 2, 3)
    with torch.inference_mode():
        got, caches = model.prefill(
            tparams, {"embeds": torch.from_numpy(emb), "tokens": None},
            tcfg, max_len=10)
        want, jcaches = jax_model.prefill(
            jparams, {"embeds": jnp.asarray(emb), "tokens": None}, jcfg,
            max_len=10)
        _close(got, want, LOGIT_TOL)
        for i in range(3):
            got, caches = model.decode_step(
                tparams, torch.from_numpy(toks[:, i:i + 1]), caches, 6 + i,
                tcfg)
            want, jcaches = jax_model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                jnp.int32(6 + i), jcfg)
            _close(got, want, LOGIT_TOL)


def test_ring_decode_past_window_matches_reference():
    """A windowed SmolLM (window 8) decodes 20 tokens from index 0 into
    ring caches of 8 slots: step by step against the reference, and
    against the full windowed forward over the tokens so far."""
    jcfg, tcfg, jparams, tparams = _setup("smollm-360m", 11, **RING)
    b, steps = 2, 20
    toks = _tokens(tcfg, 13, b, steps)
    tt = torch.from_numpy(toks)
    caches = model.init_caches(tcfg, b, max_len=64, ring=True)
    jcaches = jax_model.init_caches(jcfg, b, max_len=64, ring=True)
    assert caches[0]["k"].shape == (tcfg.num_layers, b, 8, tcfg.n_kv_heads,
                                    tcfg.resolved_head_dim)
    with torch.inference_mode():
        full = model.forward(tparams, {"tokens": tt}, tcfg)[0]
        for i in range(steps):
            got, caches = model.decode_step(tparams, tt[:, i:i + 1], caches,
                                            i, tcfg)
            want, jcaches = jax_model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jcaches,
                jnp.int32(i), jcfg)
            _close(got, want, LOGIT_TOL)
            _close(got, full[:, i], DECODE_TOL)
            np.testing.assert_array_equal(caches[0]["pos"].numpy(),
                                          np.asarray(jcaches[0]["pos"]))
    # the buffer holds the last 8 positions, wrapped: slot j has the
    # newest position that is j modulo 8
    assert caches[0]["pos"][0, 0].tolist() == [16, 17, 18, 19, 12, 13, 14,
                                               15]


def test_clamped_chunk_write_matches_reference():
    """A 3-token chunk at cache_index 14 of an 8-slot ring buffer: slot
    14 % 8 = 6 would run past the end, so the write lands at 8 - 3 = 5 and
    overwrites position 13, in both packages."""
    jcfg, tcfg, jparams, tparams = _setup("smollm-360m", 12, **RING)
    r = np.random.default_rng(21)
    b, buf, s = 2, 8, 3
    hkv, hd = tcfg.n_kv_heads, tcfg.resolved_head_dim
    k = r.standard_normal((b, buf, hkv, hd)).astype(np.float32)
    v = r.standard_normal((b, buf, hkv, hd)).astype(np.float32)
    # positions 8..15 already decoded: slot j holds 8 + j
    pos = np.broadcast_to(np.arange(8, 16, dtype=np.int32), (b, buf)).copy()
    x = r.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(14, 17, dtype=np.int32),
                                (b, s)).copy()
    p = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mixer"])
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    want, wcache = jax_attn.attention_forward(
        p, jnp.asarray(x), jnp.asarray(positions), jcfg, window=8,
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "pos": jnp.asarray(pos)}, cache_index=14)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "pos": torch.from_numpy(pos.copy())}
    got, gcache = attention.attention_forward(
        tp, torch.from_numpy(x), torch.from_numpy(positions), tcfg, window=8,
        cache=cache, cache_index=14)
    assert gcache is cache       # written in place
    assert attention._cache_start(14, s, buf) == 5
    assert cache["pos"][0].tolist() == [8, 9, 10, 11, 12, 14, 15, 16]
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(wcache["pos"]))
    np.testing.assert_array_equal(cache["k"][:, :5].numpy(), k[:, :5])
    for key in ("k", "v"):
        _close(cache[key], wcache[key], LOGIT_TOL)
    _close(got, want, LOGIT_TOL)


# ------------------------------------------------------------- positions

@pytest.mark.parametrize("mrope", [False, True])
@pytest.mark.parametrize("offset", [0, 5])
def test_default_positions_match_reference(mrope, offset):
    want = jax_rope.default_positions(3, 7, mrope=mrope,
                                      offset=jnp.int32(offset))
    for off in (offset, torch.tensor(offset, dtype=torch.int32)):
        got = rope.default_positions(3, 7, mrope=mrope, offset=off)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- serve

def test_serve_main_on_cpu():
    argv = ["--arch", "smollm-360m", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--device", "cpu"]
    out = serve.main(argv)
    cfg = out["cfg"]
    assert cfg.dtype == "float32" and cfg.d_model == 256
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0
    # greedy: each token is the argmax of the logits it came from, and the
    # logits match a full forward over prompt + generated tokens
    seq = torch.cat([out["prompt"], out["tokens"][:, :-1]], dim=1)
    with torch.inference_mode():
        full = model.forward(out["params"], {"tokens": seq}, cfg)[0]
    for i, lg in enumerate(out["logits"]):
        assert torch.equal(out["tokens"][:, i], torch.argmax(lg, dim=-1))
        _close(lg, full[:, 7 + i], DECODE_TOL)
    # sampling at a temperature is reproducible from the seed
    hot = [serve.main(argv + ["--temperature", "0.8", "--arch",
                              "musicgen-medium"]) for _ in range(2)]
    assert hot[0]["tokens"].shape == (2, 4, 4)
    assert torch.equal(hot[0]["tokens"], hot[1]["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(argv[:-2])
