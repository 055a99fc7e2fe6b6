"""Models (counterpart of ``repro/models``): the transformer LM zoo and
the vision backbones."""
from repro_torch.models.config import (  # noqa: F401
    MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig, reduced,
)
from repro_torch.models.model import (  # noqa: F401
    decode_step, forward, init_boxed, init_caches, init_params, loss_fn,
    num_params, param_axes, param_shapes, prefill,
)
from repro_torch.models.vision import (  # noqa: F401
    accuracy, classification_loss, cnn_apply, init_cnn, init_vit, vit_apply,
)
