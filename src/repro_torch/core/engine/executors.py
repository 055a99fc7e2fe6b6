"""Cohort executors: how one round's S clients map onto the device —
counterpart of ``repro/core/engine/executors.py``.

``make_cohort_executor`` returns ``run(fn, *stacked_args)``, which applies
a per-client function over the leading (S,) client axis of every argument
and returns stacked outputs.  Only the ``vmap`` backend is ported: one
batched program (``torch.func.vmap``) for the whole cohort.  The
chunked/sharded backends come with the population port.
"""
from __future__ import annotations

import dataclasses

import torch

BACKENDS = ("vmap",)


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    backend: str = "vmap"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown or unported executor backend {self.backend!r} "
                f"(want one of {BACKENDS})")


def make_cohort_executor(cfg: ExecutorConfig | None = None):
    cfg = cfg or ExecutorConfig()

    def run(fn, *args):
        return torch.func.vmap(fn)(*args)
    return run
