"""Production mesh construction (counterpart of ``repro/launch/mesh.py``)
on ``torch.distributed``, and the card's roofline constants.

Functions, not module-level meshes: importing this module touches no
process group.  ``make_production_mesh`` lays the reference's shapes and
axis names over whatever default process group is initialised: a real
one of 256 or 512 ranks, or the dry-run's fake one
(``launch.dryrun.fake_process_group``).
"""
from __future__ import annotations

import torch.distributed as dist


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the initialised world (which must
    hold exactly that many ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type=None):
    """("data", "model") mesh over the initialised world (CPU tests with
    gloo, a host's cards with NCCL)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {n} ranks")
    return init_device_mesh(_device_type(device_type),
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


# Hardware constants for the dry-run's roofline: one NVIDIA H100 SXM5 at
# its 700 W power limit, from NVIDIA's H100 datasheet (dense rates, no
# sparsity).  Datasheet figures, not measurements.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per card, BF16 tensor cores
HBM_BW = 3.35e12              # bytes/s per card, HBM3
NVLINK_BW = 25e9              # bytes/s per NVLink 4 link, each direction
#                               (18 links: 900 GB/s a card both ways)
