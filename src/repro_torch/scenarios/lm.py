"""``lm_zipf`` source family: federated LM pre-training on topic-skewed
token streams (the paper's Dirichlet-partitioned-C4 stand-in, Table 3) —
counterpart of ``repro/scenarios/lm.py``.

The corpus is topic-labelled documents (``data.synth.make_lm_topic_corpus``)
so the *same* partitioners as the vision tasks drive heterogeneity: a
Dirichlet/shard/quantity/IID split over topic labels assigns documents to
clients, whose training streams are the concatenated assigned documents.
Corpus, partition and batch draws are the reference's, bit for bit, from
the same seed (numpy on both sides).  The model is the port's transformer
LM (``repro_torch.models.model``) at a reduced architecture declared in
``model_kwargs``; its weights come from a ``torch.Generator`` seeded with
the scenario seed, so they differ from the reference's ``jax.random``
init (parity runs carry the reference's weights across).  Eval tensors
and weights live on the scenario's device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import lm_batches, make_lm_topic_corpus, partition_stats
from repro_torch.fed.staging import mark_thread_safe
from repro_torch.models import model as M
from repro_torch.scenarios.registry import register_source
from repro_torch.scenarios.spec import (
    Scenario, ScenarioSpec, check_source_kwargs,
)

# doc/topic counts sized so Dirichlet(0.05..0.1) over topic labels with
# min_size=1 partitions cleanly (the reference's defaults)
SOURCE_DEFAULTS = dict(vocab=256, n_docs=256, tokens_per_doc=500,
                       n_topics=32, seq_len=32, n_eval_docs=16,
                       eval_batch=16)


def _make_transformer_lm(seed: int, *, vocab: int, device,
                         arch: str = "llama-60m", layers: int = 2,
                         d_model: int = 64):
    cfg = configs.get_reduced(arch, layers=layers, d_model=d_model,
                              vocab=vocab).replace(dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    return M.init_params(cfg, gen, device=device), cfg


LM_MODELS = {"transformer_lm": _make_transformer_lm}


def register_lm_model(name: str, factory: Callable) -> Callable:
    """Add an LM backbone: ``factory(seed, vocab=, device=,
    **model_kwargs) -> (params, model_cfg)`` where ``model_cfg`` feeds
    ``models.model.loss_fn``."""
    LM_MODELS[name] = factory
    return factory


def materialize_lm(spec: ScenarioSpec, seed: int, n_clients: int,
                   device) -> Scenario:
    kw = check_source_kwargs(spec, SOURCE_DEFAULTS)
    n_docs, n_eval_docs = kw["n_docs"], kw["n_eval_docs"]
    seq_len, vocab = kw["seq_len"], kw["vocab"]
    if spec.model not in LM_MODELS:
        raise ValueError(
            f"scenario {spec.name!r}: unknown LM model {spec.model!r} "
            f"(want one of {sorted(LM_MODELS)}); add backbones via "
            "scenarios.lm.register_lm_model")

    docs, topics = make_lm_topic_corpus(
        n_docs + n_eval_docs, kw["tokens_per_doc"], vocab=vocab,
        n_topics=kw["n_topics"], seed=seed)
    train_docs, train_topics = docs[:n_docs], topics[:n_docs]
    eval_stream = docs[n_docs:].reshape(-1)
    if spec.partition.lazy:
        raise ValueError(
            f"scenario {spec.name!r}: the lm_zipf source builds eager "
            f"per-client token streams and does not support lazy partition "
            f"kinds ({spec.partition.kind!r}) — use an eager kind, or the "
            "synth_image source for population-scale runs")
    parts = spec.partition.build(train_topics, n_docs, n_clients, seed)
    streams = [train_docs[p].reshape(-1) for p in parts]
    for cid, stream in enumerate(streams):
        if len(stream) <= seq_len + 1:
            raise ValueError(
                f"scenario {spec.name!r}: client {cid} received "
                f"{len(parts[cid])} documents ({len(stream)} tokens), too "
                f"few to sample a seq_len={seq_len} window — raise "
                "tokens_per_doc/n_docs or lower n_clients")

    params, cfg = LM_MODELS[spec.model](seed, vocab=vocab, device=device,
                                        **dict(spec.model_kwargs))

    def loss_fn(p, batch):
        return M.loss_fn(p, batch, cfg)

    et, el = lm_batches(eval_stream, seq_len=seq_len, batch=kw["eval_batch"],
                        steps=1, seed=seed)
    eval_tokens = torch.from_numpy(et[0]).to(device)
    eval_labels = torch.from_numpy(el[0]).to(device)

    @torch.no_grad()
    def eval_fn(p):
        logits, _, aux = M.forward(p, {"tokens": eval_tokens}, cfg)
        acc = torch.mean((torch.argmax(logits, -1)
                          == eval_labels).to(torch.float32))
        return {"eval_loss": M.cross_entropy(logits, eval_labels) + aux,
                "token_acc": acc}

    batch = spec.batch_size

    # pure in (cid, rng) over immutable token streams: safe for
    # concurrent stager workers
    @mark_thread_safe
    def batch_fn(cid, rng):
        s = streams[cid]
        starts = rng.integers(0, len(s) - seq_len - 1, batch)
        idx = starts[:, None] + np.arange(seq_len + 1)
        w = s[idx]
        return {"tokens": w[:, :-1], "labels": w[:, 1:]}

    stats = partition_stats(parts, train_topics)
    stats["tokens_per_client"] = [int(len(s)) for s in streams]
    return Scenario(
        spec=spec, seed=seed, n_clients=n_clients, params=params,
        loss_fn=loss_fn, client_batch_fn=batch_fn, eval_fn=eval_fn,
        device=device, partitions=parts, partition_stats=stats,
        meta={"model_cfg": cfg, "seq_len": seq_len, "vocab": vocab,
              "n_docs": n_docs, "n_eval_docs": n_eval_docs})


register_source("lm_zipf", materialize_lm)
