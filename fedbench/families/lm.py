"""The Llama-architecture LM family on the program's ``lm_zipf`` source:
topic-labelled synthetic documents, a Dirichlet split of the documents
over the clients by topic, next-token windows of ``seq_len``."""
from __future__ import annotations

from fedbench.reference import lm as ref
from fedbench.reference.common import flatten, make_weights


def model_config(cfg):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=cfg["name"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        block_pattern=("attn",), mlp_type="swiglu", norm_type="rms",
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], dtype="float32")


def scenario(cfg, traffic, seeds, device):
    from repro_torch.api import PartitionSpec, ScenarioSpec, materialize
    from repro_torch.models import model as M
    from repro_torch.scenarios.lm import register_lm_model

    data = cfg["data"]
    mcfg = model_config(cfg)
    name = f"fedbench_{cfg['name']}"

    def backbone(seed, *, vocab, device):
        params = make_weights(ref.weight_layout(cfg), seeds["weights"],
                              device)
        want = [(k, tuple(v.shape)) for k, v in flatten(M.param_shapes(mcfg))]
        got = [(k, tuple(v.shape)) for k, v in flatten(params)]
        if sorted(want) != sorted(got):
            raise ValueError(f"{name}: the benchmark's weights are not the "
                             f"program's tree: {sorted(set(want) ^ set(got))}")
        return params, mcfg

    register_lm_model(name, backbone)
    spec = ScenarioSpec(
        name=name, source="lm_zipf",
        partition=PartitionSpec("dirichlet", alpha=data["dirichlet_alpha"],
                                min_size=1),
        model=name, n_clients=traffic["n_clients"],
        batch_size=traffic["batch_size"],
        source_kwargs=dict(vocab=cfg["vocab_size"], n_docs=data["n_docs"],
                           tokens_per_doc=data["tokens_per_doc"],
                           n_topics=data["n_topics"], seq_len=data["seq_len"],
                           n_eval_docs=data["n_eval_docs"],
                           eval_batch=data["eval_batch"]))
    return materialize(spec, seed=seeds["data"], n_clients=traffic[
        "n_clients"], device=device)
