"""Ops of the port: plain PyTorch, plus the hand-written kernels K1
(flash-attention forward), K2/K3 (its backward) and K4 (int8 matvec)."""
from .attention import (flash_attention, flash_bwd_dkv, flash_bwd_dkv_plain,
                        flash_bwd_dq, flash_bwd_dq_plain, flash_fwd,
                        flash_fwd_plain, rope)
from .nn import (activation, dropout, embedding, fully_connected,
                 layer_norm, log_softmax, pick, sparse_softmax_ce)
from .q8_matvec import q8_matvec, q8_matvec_plain

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain",
           "flash_bwd_dq", "flash_bwd_dq_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "rope", "activation", "dropout",
           "embedding", "fully_connected", "layer_norm", "log_softmax",
           "pick", "sparse_softmax_ce", "q8_matvec", "q8_matvec_plain"]
