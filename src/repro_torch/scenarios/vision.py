"""``synth_image`` source family: Dirichlet/IID-partitioned synthetic image
classification (CIFAR-like gaussian mixtures) with CNN or ViT backbones —
counterpart of ``repro/scenarios/vision.py``.

Data, partition and batch draws are the reference's, bit for bit, from
the same seed (numpy on both sides).  Parameters come from a
``torch.Generator`` seeded with the scenario seed, so they differ from the
reference's ``jax.random`` init; parity runs carry the reference's weights
across (``repro_torch.convert``).
"""
from __future__ import annotations

import torch

from repro_torch.data import make_image_classification, partition_stats
from repro_torch.fed.staging import mark_thread_safe
from repro_torch.models.vision import (
    accuracy, classification_loss, cnn_apply, init_cnn, init_vit, vit_apply,
)
from repro_torch.scenarios.registry import register_source
from repro_torch.scenarios.spec import (
    Scenario, ScenarioSpec, check_source_kwargs,
)

SOURCE_DEFAULTS = dict(n=3000, image_size=12, n_classes=8, noise=2.5,
                       n_eval=768)


def _make_cnn(seed: int, *, image_size: int, n_classes: int, device,
              width: int = 8, blocks: int = 2):
    del image_size  # fully convolutional
    gen = torch.Generator().manual_seed(seed)
    params = init_cnn(gen, n_classes=n_classes, width=width, blocks=blocks,
                      device=device)
    return params, cnn_apply


def _make_vit(seed: int, *, image_size: int, n_classes: int, device,
              patch: int = 4, d_model: int = 48, layers: int = 2,
              heads: int = 2):
    gen = torch.Generator().manual_seed(seed)
    params, meta = init_vit(gen, image_size=image_size, patch=patch,
                            d_model=d_model, layers=layers, heads=heads,
                            n_classes=n_classes, device=device)
    return params, lambda p, x: vit_apply(p, meta, x)


VISION_MODELS = {"cnn": _make_cnn, "vit": _make_vit}


def materialize_vision(spec: ScenarioSpec, seed: int, n_clients: int,
                       device) -> Scenario:
    kw = check_source_kwargs(spec, SOURCE_DEFAULTS)
    n, n_eval = kw["n"], kw["n_eval"]
    image_size, n_classes = kw["image_size"], kw["n_classes"]
    if spec.model not in VISION_MODELS:
        raise ValueError(
            f"scenario {spec.name!r}: unknown vision model {spec.model!r} "
            f"(want one of {sorted(VISION_MODELS)})")

    X_all, y_all = make_image_classification(
        n + n_eval, image_size=image_size, n_classes=n_classes, seed=seed,
        noise=kw["noise"])
    X, y = X_all[:n], y_all[:n]
    Xe = torch.from_numpy(X_all[n:]).to(device)
    ye = torch.from_numpy(y_all[n:]).to(device)
    parts = spec.partition.build(y, n, n_clients, seed)
    params, apply = VISION_MODELS[spec.model](
        seed, image_size=image_size, n_classes=n_classes, device=device,
        **dict(spec.model_kwargs))

    def loss_fn(p, b):
        return classification_loss(apply(p, b["x"]), b["y"])

    @torch.no_grad()
    def eval_fn(p):
        logits = apply(p, Xe)
        return {"test_acc": accuracy(logits, ye),
                "test_loss": classification_loss(logits, ye)}

    batch = spec.batch_size

    # pure in (cid, rng): reads immutable arrays and the lock-guarded lazy
    # partition map, so the pipeline's stager threads may call it at once
    @mark_thread_safe
    def batch_fn(cid, rng):
        # fixed size (with replacement) so cohort batches stack
        idx = rng.choice(parts[cid], size=batch, replace=True)
        return {"x": X[idx], "y": y[idx]}

    return Scenario(
        spec=spec, seed=seed, n_clients=n_clients, params=params,
        loss_fn=loss_fn, client_batch_fn=batch_fn, eval_fn=eval_fn,
        device=device, partitions=parts,
        partition_stats=partition_stats(parts, y),
        meta={"n_train": n, "n_eval": n_eval, "n_classes": n_classes,
              "image_size": image_size})


register_source("synth_image", materialize_vision)
