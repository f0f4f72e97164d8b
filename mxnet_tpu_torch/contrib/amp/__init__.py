"""``mx.contrib.amp``: automatic mixed precision, the port of
``mxnet_tpu/contrib/amp``."""
from .amp import (  # noqa: F401
    init, init_trainer, scale_loss, unscale, convert_model, convert_symbol,
    convert_hybrid_block, list_bf16_ops, list_fp16_ops, list_fp32_ops,
    is_initialized, disable,
)
from .loss_scaler import LossScaler  # noqa: F401
