"""Logical-axis sharding on ``torch.distributed`` meshes (counterpart of
``repro/sharding``)."""
from repro_torch.sharding.partitioning import (  # noqa: F401
    LogicalAxisRules,
    SERVE_FSDP_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    client_axis_spec,
    greedy_spec,
    logical_to_sharding,
    mesh_sizes,
    resolve_spec,
    shard_params_spec,
    spec_to_placements,
)
