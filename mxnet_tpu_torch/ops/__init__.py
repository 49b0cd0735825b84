"""Ops of the port: plain PyTorch, plus the hand-written kernels K1
(flash-attention forward), K2/K3 (its backward), K4 (int8 matvec), K5
(the fused decode step) and K6 (the fused 1x1-convolution backward)."""
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

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "rope", "activation", "dropout",
           "embedding", "fully_connected", "layer_norm", "log_softmax",
           "pick", "rms_norm", "sparse_softmax_ce", "q8_matvec",
           "q8_matvec_plain", "decode_step", "decode_step_plain",
           "fused_decode_supported", "pack_gpt_weights",
           "pack_llama_weights", "convolution", "pooling", "batch_norm",
           "flatten", "conv1x1_nhwc", "conv1x1_bwd_pair",
           "conv1x1_bwd_pair_plain", "fused_bwd_supported"]
