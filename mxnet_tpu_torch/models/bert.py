"""BERT encoder models (``bench.py``'s BERT-base pretraining step).

Port of ``mxnet_tpu/models/bert.py``: word, token-type and position
embeddings, an embedding LayerNorm, encoder cells over
``flash_attention`` with the ``valid_length`` key mask, a tanh pooler
and an MLM head tied to the word embedding.  Parameters are created on
the card unless ``device="cpu"``.  At BERT's lengths (up to 512) every
attention takes the plain path, as in the reference: no kernel runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..base import torch_dtype
from ..device import resolve_device
from .transformer import (Dense, Dropout, Embedding, LayerNorm,
                          TransformerEncoderCell, initialize)

__all__ = ["BERTConfig", "BERTModel", "bert_base", "bert_large"]


@dataclass
class BERTConfig:
    vocab_size: int = 30522
    max_length: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    units: int = 768
    num_heads: int = 12
    hidden_size: int = 3072
    dropout: float = 0.0
    dtype: str = "float32"


class BERTModel(nn.Module):
    """tokens (B, L) [+ token_types (B, L), + valid_length (B,)] ->
    [sequence_output (B, L, U), pooled_output (B, U), mlm_logits
    (B, L, V)] (only the enabled outputs; a single one unwrapped)."""

    def __init__(self, config: BERTConfig, use_pooler=True, use_mlm=True,
                 device=None, dtype=None):
        super().__init__()
        self._cfg = c = config
        dev = resolve_device(device)
        dt = torch_dtype(dtype if dtype is not None else c.dtype)
        self.word_embed = Embedding(c.vocab_size, c.units, dev, dt)
        self.token_type_embed = Embedding(c.type_vocab_size, c.units, dev,
                                          dt)
        self.position_embed = Embedding(c.max_length, c.units, dev, dt)
        self.embed_ln = LayerNorm(c.units, device=dev, dtype=dt)
        self.embed_drop = Dropout(c.dropout) if c.dropout else None
        self.cells = nn.ModuleList(
            TransformerEncoderCell(c.units, c.hidden_size, c.num_heads,
                                   c.dropout, dev, dt)
            for _ in range(c.num_layers))
        self.pooler = Dense(c.units, c.units, activation="tanh",
                            device=dev, dtype=dt) if use_pooler else None
        self.mlm_dense = self.mlm_ln = None
        if use_mlm:
            self.mlm_dense = Dense(c.units, c.units, activation="gelu",
                                   device=dev, dtype=dt)
            self.mlm_ln = LayerNorm(c.units, device=dev, dtype=dt)

    @property
    def device(self):
        return self.word_embed.weight.device

    def initialize(self, std=0.02, seed=0):
        """Seeded ``Normal(std)`` init (``transformer.initialize``)."""
        return initialize(self, std, seed)

    def forward(self, tokens, token_types=None, valid_length=None):
        B, L = tokens.shape
        x = self.word_embed(tokens)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = x + self.position_embed(torch.arange(L, device=tokens.device))
        x = self.embed_ln(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        mask = None
        if valid_length is not None:
            # additive key-side padding mask: (B, 1, 1, L), -1e30 at pads
            kpos = torch.arange(L, device=tokens.device,
                                dtype=torch.float32).reshape(1, 1, 1, L)
            vl = valid_length.float().reshape(B, 1, 1, 1)
            mask = (kpos >= vl).float() * -1e30
        for cell in self.cells:
            x = cell(x, mask)
        outs = [x]
        if self.pooler is not None:
            outs.append(self.pooler(x[:, 0]))
        if self.mlm_dense is not None:
            h = self.mlm_ln(self.mlm_dense(x))
            outs.append(torch.matmul(h, self.word_embed.weight.t()))
        return outs if len(outs) > 1 else outs[0]


def _preset(**kw):
    def make(use_pooler=True, use_mlm=True, device=None, **overrides):
        dtype = overrides.pop("dtype", None)
        cfg = BERTConfig(**{**kw, **overrides})
        if dtype is not None:
            cfg.dtype = str(dtype).replace("torch.", "")
        return BERTModel(cfg, use_pooler=use_pooler, use_mlm=use_mlm,
                         device=device), cfg
    return make


bert_base = _preset(num_layers=12, units=768, num_heads=12,
                    hidden_size=3072)
bert_large = _preset(num_layers=24, units=1024, num_heads=16,
                     hidden_size=4096)
