"""FedSOA (Alg. 1): the naive second-order FL baseline (counterpart of
``repro/core/fedsoa.py``).

Clients run the second-order optimizer locally from a fresh state each
round (line 3: Theta_i^{r,0} <- 0) and the server averages parameters
only.  This is `Local Sophia/SOAP/Muon` in the paper's tables — the
configuration whose preconditioner drift FedPAC is built to fix.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.fedpac import make_round_fn
from repro_torch.optim.api import LocalOptimizer


def make_fedsoa_round_fn(loss_fn: Callable, opt: LocalOptimizer, *,
                         lr: float, local_steps: int, hessian_freq: int = 10,
                         server_lr: float = 1.0):
    return make_round_fn(
        loss_fn, opt, lr=lr, local_steps=local_steps,
        beta=0.0, align=False, correct=False,
        hessian_freq=hessian_freq, server_lr=server_lr)


VARIANTS = {
    # name -> (align, correct)  — Table 5 component ablation
    "fedsoa": (False, False),
    "align_only": (True, False),
    "correct_only": (False, True),
    "fedpac": (True, True),
}


def make_variant_round_fn(variant: str, loss_fn, opt, **kw):
    align, correct = VARIANTS[variant]
    return make_round_fn(loss_fn, opt, align=align, correct=correct, **kw)
