"""Host and tree helpers (counterpart of ``repro/utils``)."""
from repro_torch.utils import hw  # noqa: F401
from repro_torch.utils.tree import (  # noqa: F401
    client_weighted_sum, tree_add, tree_bytes, tree_cast, tree_dot,
    tree_mean, tree_norm_sq, tree_scale, tree_size, tree_sub,
    tree_zeros_like,
)
