"""The registered scenario catalog (counterpart of
``repro/scenarios/catalog.py``).  Three task families, each under four
heterogeneity variants:

  cifar_like_cnn[_dir0.05|_shard|_iid]   CNN on CIFAR-like images
  cifar_like_vit[_dir0.05|_shard|_iid]   ViT on the same images
  lm_zipf[_dir0.05|_shard|_iid]          transformer LM on topic-skewed text

The base names carry the paper's default severity, Dirichlet(0.1);
``_shard`` deals two label-sorted shards to each client.  The LM split is
over documents, so a single-document client is a valid client
(``min_size=1``).
"""
from __future__ import annotations

from typing import Optional

# the source families self-register on import
import repro_torch.scenarios.lm  # noqa: F401
import repro_torch.scenarios.vision  # noqa: F401
from repro_torch.scenarios.registry import register
from repro_torch.scenarios.spec import PartitionSpec, ScenarioSpec

DIR01 = PartitionSpec("dirichlet", alpha=0.1)


def cifar_like(*, model: str = "cnn", n: int = 3000, image_size: int = 12,
               n_classes: int = 8, alpha: Optional[float] = 0.1,
               batch: int = 16, noise: float = 2.5, n_eval: int = 768,
               n_clients: int = 10, partition: Optional[PartitionSpec] = None,
               name: Optional[str] = None) -> ScenarioSpec:
    """Synthetic-image ScenarioSpec with the reference's defaults
    (``alpha=None`` selects the IID split; ``partition`` wins)."""
    if partition is None:
        partition = (PartitionSpec("iid") if alpha is None
                     else PartitionSpec("dirichlet", alpha=alpha))
    model_kwargs = ({"width": 8, "blocks": 2} if model == "cnn"
                    else {"patch": 4, "d_model": 48, "layers": 2, "heads": 2}
                    if model == "vit" else {})
    return ScenarioSpec(
        name=name or f"cifar_like_{model}@{partition.tag()}",
        source="synth_image", partition=partition, model=model,
        n_clients=n_clients, batch_size=batch,
        source_kwargs=dict(n=n, image_size=image_size, n_classes=n_classes,
                           noise=noise, n_eval=n_eval),
        model_kwargs=model_kwargs,
        description=f"synthetic CIFAR-like images, {model} backbone, "
                    f"{partition.tag()} split")


def lm_zipf(*, vocab: int = 256, n_docs: int = 256, tokens_per_doc: int = 500,
            n_topics: int = 32, seq_len: int = 32, batch: int = 8,
            n_eval_docs: int = 16, n_clients: int = 8, layers: int = 2,
            d_model: int = 64, arch: str = "llama-60m",
            partition: Optional[PartitionSpec] = None,
            name: Optional[str] = None) -> ScenarioSpec:
    """Topic-skewed LM pre-training ScenarioSpec (Table 3 stand-in) with
    the reference's defaults; the default split allows single-document
    clients instead of softening small alphas."""
    partition = partition or PartitionSpec("dirichlet", alpha=0.1,
                                           min_size=1)
    return ScenarioSpec(
        name=name or f"lm_zipf@{partition.tag()}",
        source="lm_zipf", partition=partition, model="transformer_lm",
        n_clients=n_clients, batch_size=batch,
        source_kwargs=dict(vocab=vocab, n_docs=n_docs,
                           tokens_per_doc=tokens_per_doc, n_topics=n_topics,
                           seq_len=seq_len, n_eval_docs=n_eval_docs),
        model_kwargs=dict(arch=arch, layers=layers, d_model=d_model),
        description=f"topic-Zipf LM corpus, reduced {arch}, "
                    f"{partition.tag()} split")


VARIANTS = (
    ("dir0.05", PartitionSpec("dirichlet", alpha=0.05)),
    ("shard", PartitionSpec("shard", shards_per_client=2)),
    ("iid", PartitionSpec("iid")),
)

# document-level variants (LM): a single-document client is a valid client
LM_VARIANTS = (
    ("dir0.05", PartitionSpec("dirichlet", alpha=0.05, min_size=1)),
    ("shard", PartitionSpec("shard", shards_per_client=2)),
    ("iid", PartitionSpec("iid")),
)


def _register_family(base: ScenarioSpec, variants=VARIANTS):
    register(base)
    for suffix, part in variants:
        register(base.variant(suffix, partition=part))


_register_family(cifar_like(model="cnn", name="cifar_like_cnn"))
_register_family(cifar_like(model="vit", name="cifar_like_vit"))
_register_family(lm_zipf(name="lm_zipf"), variants=LM_VARIANTS)
