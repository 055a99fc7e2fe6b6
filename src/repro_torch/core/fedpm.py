"""FedPM-style preconditioned-mixing aggregation (counterpart of
``repro/core/fedpm.py``).

Curvature-weighted mixing of local updates (after Ishii et al., 2025):
clients train with a second-order optimizer under FedPAC Alignment, and
the server replaces the uniform delta mean with weights inversely
proportional to each client's local curvature mass
(``engine.precond_mixing_weights``) — sharp-region clients move the model
less.  A mixing hook reads the decoded cohort, so these specs take the
round's decode-then-``aggregate`` path.
"""
from __future__ import annotations

from repro_torch.core.algorithms import AlgorithmSpec, register
from repro_torch.core.engine.aggregation import precond_mixing_weights

# second-order local optimizers only: mixing needs a non-empty Theta upload
_FEDPM_OPTS = ("adamw", "sophia", "muon", "soap")

FEDPM_SPECS = {
    opt_name: register(AlgorithmSpec(
        name=f"fedpm_{opt_name}", optimizer=opt_name, align=True,
        mixing=precond_mixing_weights,
        description=f"preconditioned mixing with {opt_name}: curvature-"
                    "weighted delta mean under aligned geometry"))
    for opt_name in _FEDPM_OPTS
}
