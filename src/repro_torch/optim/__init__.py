"""Local optimizers implementing the paper's (Theta, P_Theta) abstraction
(counterpart of ``repro/optim/__init__.py``): SGD, AdamW, Muon, SOAP and
Sophia, all ported."""
from repro_torch.optim.api import (  # noqa: F401
    LocalOptimizer, as_matrix, is_hidden_matrix, matrix_mask,
)
from repro_torch.optim import adamw, muon, sgd, soap, sophia

_FACTORIES = {
    "sgd": sgd.make,
    "adamw": adamw.make,
    "muon": muon.make,
    "soap": soap.make,
    "sophia": sophia.make,
}


def make(name: str, **kw) -> LocalOptimizer:
    if name not in _FACTORIES:
        raise ValueError(f"unknown optimizer {name!r} (want one of "
                         f"{available()})")
    return _FACTORIES[name](**kw)


def available() -> tuple:
    """Sorted optimizer names ``make`` accepts (AlgorithmSpec validation)."""
    return tuple(sorted(_FACTORIES))


DEFAULT_LR = {  # paper's Appendix Table 8 defaults
    "sgd": 0.1,
    "adamw": 3e-4,
    "sophia": 3e-4,
    "muon": 3e-2,
    "soap": 3e-3,
}
