"""Compat shim (counterpart of ``repro/fed/scaffold.py``): SCAFFOLD lives
in ``repro_torch.core.scaffold`` as a registered ``AlgorithmSpec``; this
keeps ``ScaffoldState`` importable from its historical location."""
from repro_torch.core.scaffold import (  # noqa: F401
    SCAFFOLD_SPEC, ScaffoldState, make_scaffold_local_update,
)
