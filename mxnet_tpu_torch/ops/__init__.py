"""Ops of the port: plain PyTorch, plus the hand-written kernels K1
(flash-attention forward), K2/K3 (its backward), K4 (int8 matvec), K5
(the fused decode step), K6 (the fused 1x1-convolution backward) and
the port's own greedy NMS (``box_nms``, no Pallas counterpart).
Importing the package registers the op modules' ops, ``rnn``
(``fused_rnn``), ``linalg``, ``legacy``, ``optimizer_ops``,
``extended`` and ``samplers`` among them, as the reference's does."""
from . import legacy, linalg, rnn  # noqa: F401 (registers their ops)
from . import extended, optimizer_ops, samplers  # noqa: F401
from .attention import (flash_attention, flash_bwd_dkv, flash_bwd_dkv_plain,
                        flash_bwd_dq, flash_bwd_dq_plain, flash_fwd,
                        flash_fwd_plain, rope)
from .conv_fused import (conv1x1_bwd_pair, conv1x1_bwd_pair_plain,
                         conv1x1_nhwc, fused_bwd_supported)
from .decode_fused import (decode_step, decode_step_plain,
                           fused_decode_supported, pack_gpt_weights,
                           pack_llama_weights)
from .nn import (activation, batch_norm, convolution, dropout, embedding,
                 flatten, fully_connected, layer_norm, log_softmax, pick,
                 pooling, rms_norm, sparse_softmax_ce)
from .q8_matvec import q8_matvec, q8_matvec_plain
from .rnn import fused_rnn

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "rope", "activation", "dropout",
           "embedding", "fully_connected", "layer_norm", "log_softmax",
           "pick", "rms_norm", "sparse_softmax_ce", "q8_matvec",
           "q8_matvec_plain", "decode_step", "decode_step_plain",
           "fused_decode_supported", "pack_gpt_weights",
           "pack_llama_weights", "convolution", "pooling", "batch_norm",
           "flatten", "conv1x1_nhwc", "conv1x1_bwd_pair",
           "conv1x1_bwd_pair_plain", "fused_bwd_supported", "fused_rnn",
           "legacy", "linalg", "rnn", "extended", "optimizer_ops",
           "samplers"]
