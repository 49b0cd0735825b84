"""GPT-family decoder-only language models.

Port of ``mxnet_tpu/models/gpt.py``: pre-norm blocks over the
``flash_attention`` op, fused QKV, and an LM head tied to the token
embedding (one parameter, so its gradient sums both uses).  Parameters
are created on the card unless ``device="cpu"``.  ``config.dropout``
(embedding, attention and residual dropout) applies in training mode.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..base import torch_dtype
from ..device import resolve_device
from .transformer import (Dropout, Embedding, LayerNorm,
                          TransformerDecoderCell, initialize)

__all__ = ["GPTConfig", "GPT", "gpt2_small", "gpt2_medium", "gpt2_large",
           "gpt2_774m"]


@dataclass
class GPTConfig:
    vocab_size: int = 50257
    max_length: int = 1024
    num_layers: int = 12
    units: int = 768
    num_heads: int = 12
    hidden_size: int = 3072
    dropout: float = 0.0
    dtype: str = "float32"


class GPT(nn.Module):
    """Decoder-only transformer LM: tokens (B, L) -> logits (B, L, vocab).
    The LM head reuses the token embedding (weight tying)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self._cfg = c = config
        dev = resolve_device(device)
        dt = torch_dtype(dtype if dtype is not None else c.dtype)
        self.wte = Embedding(c.vocab_size, c.units, dev, dt)
        self.wpe = Embedding(c.max_length, c.units, dev, dt)
        self.drop = Dropout(c.dropout) if c.dropout else None
        self.blocks = nn.ModuleList(
            TransformerDecoderCell(c.units, c.hidden_size, c.num_heads,
                                   c.dropout, dev, dt)
            for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.units, device=dev, dtype=dt)

    @property
    def device(self):
        return self.wte.weight.device

    @property
    def dtype(self):
        return self.wte.weight.dtype

    def initialize(self, std=0.02, seed=0):
        """Seeded ``Normal(std)`` init (``transformer.initialize``)."""
        return initialize(self, std, seed)

    def forward(self, tokens):
        B, L = tokens.shape
        pos = torch.arange(L, device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)[None]
        if self.drop is not None:
            x = self.drop(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        return torch.matmul(x, self.wte.weight.t())


def _preset(**kw):
    def make(device=None, **overrides):
        dtype = overrides.pop("dtype", None)
        cfg = GPTConfig(**{**kw, **overrides})
        if dtype is not None:
            cfg.dtype = str(dtype).replace("torch.", "")
        return GPT(cfg, device=device), cfg
    return make


gpt2_small = _preset(num_layers=12, units=768, num_heads=12,
                     hidden_size=3072)
gpt2_medium = _preset(num_layers=24, units=1024, num_heads=16,
                      hidden_size=4096)
gpt2_large = _preset(num_layers=36, units=1280, num_heads=20,
                     hidden_size=5120)
gpt2_774m = gpt2_large      # GPT-2 774M, the name BASELINE.json uses
