"""``mx.amp`` — automatic mixed precision, port of ``mxnet_tpu/amp``
(reference ``python/mxnet/contrib/amp/``)."""
from .amp import (init, init_trainer, scale_loss, convert_model,
                  convert_hybrid_block, _uninit)
from .loss_scaler import LossScaler
from . import lists
