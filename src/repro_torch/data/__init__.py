from repro_torch.data.partition import (  # noqa: F401
    ClientIndexMap, dirichlet_partition, heterogeneity_stat, iid_partition,
    partition_stats, quantity_partition, shard_partition,
    stream_dirichlet_indices, stream_dirichlet_map,
)
from repro_torch.data.synth import (  # noqa: F401
    lm_batches, make_image_classification, make_lm_corpus,
    make_lm_topic_corpus,
)
