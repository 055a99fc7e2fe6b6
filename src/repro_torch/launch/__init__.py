"""Launch entry points and step builders (counterpart of
``repro/launch``): ``steps`` (train, fed-round, prefill and decode
steps), ``train`` and ``serve`` (the entry points), ``mesh`` and
``specs`` (production meshes and the dry-run's sharded stand-ins) and
``dryrun``."""
from repro_torch.launch.specs import INPUT_SHAPES, InputShape  # noqa: F401
from repro_torch.launch.steps import (  # noqa: F401
    make_decode_step, make_fed_round_step, make_loss_fn, make_prefill_step,
    make_train_step,
)
