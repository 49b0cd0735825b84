"""Ops of the port: plain PyTorch, plus the hand-written kernels K1
(flash-attention forward) and K4 (int8 matvec)."""
from .attention import flash_attention, flash_fwd, flash_fwd_plain, rope
from .nn import activation, embedding, fully_connected, layer_norm
from .q8_matvec import q8_matvec, q8_matvec_plain

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_plain", "rope",
           "activation", "embedding", "fully_connected", "layer_norm",
           "q8_matvec", "q8_matvec_plain"]
