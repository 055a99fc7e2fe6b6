"""The ViT family on the program's ``synth_image`` source: CIFAR-like
synthetic images (class prototypes plus Gaussian noise), Dirichlet label
skew over the clients."""
from __future__ import annotations

from fedbench.reference import vit as ref
from fedbench.reference.common import make_weights


def scenario(cfg, traffic, seeds, device):
    from repro_torch.api import PartitionSpec, ScenarioSpec, materialize
    from repro_torch.models.vision import vit_apply
    from repro_torch.scenarios.vision import register_vision_model

    data = cfg["data"]
    meta = {"patch": cfg["patch_size"], "heads": cfg["num_attention_heads"]}
    name = f"fedbench_{cfg['name']}"

    def backbone(seed, *, image_size, n_classes, device):
        if (image_size, n_classes) != (cfg["image_size"], cfg["num_labels"]):
            raise ValueError(f"{name}: image {image_size}, {n_classes} "
                             f"classes; the configuration says "
                             f"{cfg['image_size']}, {cfg['num_labels']}")
        params = make_weights(ref.weight_layout(cfg), seeds["weights"],
                              device)
        return params, lambda p, x: vit_apply(p, meta, x)

    register_vision_model(name, backbone)
    spec = ScenarioSpec(
        name=name, source="synth_image",
        partition=PartitionSpec("dirichlet", alpha=data["dirichlet_alpha"]),
        model=name, n_clients=traffic["n_clients"],
        batch_size=traffic["batch_size"],
        source_kwargs=dict(n=data["n_train"], image_size=cfg["image_size"],
                           n_classes=cfg["num_labels"], noise=data["noise"],
                           n_eval=data["n_eval"]))
    return materialize(spec, seed=seeds["data"], n_clients=traffic[
        "n_clients"], device=device)
