"""Checkpoints (counterpart of ``repro/checkpoint``), in the reference's
on-disk format."""
from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, latest_step, load_meta, load_pytree,
    load_server_state, save_pytree, save_server_state,
)
