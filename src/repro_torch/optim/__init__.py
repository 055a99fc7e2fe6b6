"""Local optimizers implementing the paper's (Theta, P_Theta) abstraction.

SOAP and Sophia are ported so far; sgd, adamw and muon follow."""
from repro_torch.optim.api import (  # noqa: F401
    LocalOptimizer, as_matrix, is_hidden_matrix, matrix_mask,
)
from repro_torch.optim import soap, sophia

_FACTORIES = {
    "soap": soap.make,
    "sophia": sophia.make,
}


def make(name: str, **kw) -> LocalOptimizer:
    if name not in _FACTORIES:
        raise ValueError(f"optimizer {name!r} is not ported (want one of "
                         f"{available()})")
    return _FACTORIES[name](**kw)


def available() -> tuple:
    """Sorted optimizer names ``make`` accepts (AlgorithmSpec validation)."""
    return tuple(sorted(_FACTORIES))


DEFAULT_LR = {  # paper's Appendix Table 8 defaults
    "sophia": 3e-4,
    "soap": 3e-3,
}
