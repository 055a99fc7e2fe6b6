from repro_torch.data.partition import (  # noqa: F401
    ClientIndexMap, dirichlet_partition, heterogeneity_stat, iid_partition,
    partition_stats, stream_dirichlet_map,
)
from repro_torch.data.synth import make_image_classification  # noqa: F401
