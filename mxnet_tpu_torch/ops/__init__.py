"""Ops of the port: plain PyTorch, plus the hand-written kernels K1
(flash-attention forward), K2/K3 (its backward), K4 (int8 matvec) and K5
(the fused decode step)."""
from .attention import (flash_attention, flash_bwd_dkv, flash_bwd_dkv_plain,
                        flash_bwd_dq, flash_bwd_dq_plain, flash_fwd,
                        flash_fwd_plain, rope)
from .decode_fused import (decode_step, decode_step_plain,
                           fused_decode_supported, pack_gpt_weights,
                           pack_llama_weights)
from .nn import (activation, dropout, embedding, fully_connected,
                 layer_norm, log_softmax, pick, rms_norm, sparse_softmax_ce)
from .q8_matvec import q8_matvec, q8_matvec_plain

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "rope", "activation", "dropout",
           "embedding", "fully_connected", "layer_norm", "log_softmax",
           "pick", "rms_norm", "sparse_softmax_ce", "q8_matvec",
           "q8_matvec_plain", "decode_step", "decode_step_plain",
           "fused_decode_supported", "pack_gpt_weights",
           "pack_llama_weights"]
