"""Transformer building blocks as ``nn.Module``s.

Port of ``mxnet_tpu/models/transformer.py``.  Each layer keeps the
reference's parameter layout — ``Dense`` weights are (out, in), LayerNorm
carries ``gamma``/``beta`` — so weights carry over name for name
(``models/convert.py``).  Dropout (attention probabilities inside the
flash kernels, the attention and FFN outputs) applies in training mode
(``nn.Module.train()``), as the reference's applies under
``autograd.record()``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..ops.attention import flash_attention
from ..ops.nn import (activation, dropout, embedding, fully_connected,
                      layer_norm)

__all__ = ["Dense", "LayerNorm", "Embedding", "Dropout",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerDecoderCell", "initialize"]


def _empty(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


@torch.no_grad()
def initialize(model, std=0.02, seed=0):
    """Seeded ``Normal(std)`` init of every parameter of ``model``, by the
    reference initializer's name rules: weights normal, biases and betas
    zero, gammas one.  Returns ``model``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("gamma"):
            p.fill_(1.0)
        elif name.endswith(("bias", "beta")):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32) * std)
    return model


class Dense(nn.Module):
    """y = act(x W^T + b), weight (units, in_units)."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 device=None, dtype=None):
        super().__init__()
        self.weight = _empty((units, in_units), device, dtype)
        self.bias = _empty((units,), device, dtype) if use_bias else None
        self.act_type = activation

    def forward(self, x):
        y = fully_connected(x, self.weight, self.bias)
        return activation(y, self.act_type) if self.act_type else y


class LayerNorm(nn.Module):
    def __init__(self, units, eps=1e-5, device=None, dtype=None):
        super().__init__()
        self.gamma = _empty((units,), device, dtype)
        self.beta = _empty((units,), device, dtype)
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self.eps)


class Embedding(nn.Module):
    def __init__(self, input_dim, output_dim, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((input_dim, output_dim), device, dtype)

    def forward(self, idx):
        return embedding(idx, self.weight)


class Dropout(nn.Module):
    """Reference ``gluon.nn.Dropout``: active in training mode only."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return dropout(x, self.rate, self.training)


class MultiHeadAttention(nn.Module):
    """Fused-QKV multi-head self-attention over (batch, seq, units)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 device=None, dtype=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self.units, self.heads, self.causal = units, num_heads, causal
        self.attn_dropout = dropout
        self.qkv = Dense(3 * units, units, device=device, dtype=dtype)
        self.proj = Dense(units, units, device=device, dtype=dtype)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        B, L, U = x.shape
        H, D = self.heads, self.units // self.heads
        qkv = self.qkv(x).reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
        out = flash_attention(qkv[0], qkv[1], qkv[2], mask,
                              causal=self.causal, dropout=self.attn_dropout,
                              training=self.training)
        out = self.proj(out.permute(0, 2, 1, 3).reshape(B, L, U))
        return self.drop(out) if self.drop is not None else out


class PositionwiseFFN(nn.Module):
    """units -> hidden (GELU, tanh form) -> units."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 device=None, dtype=None):
        super().__init__()
        self.fc1 = Dense(hidden_size, units, activation=activation,
                         device=device, dtype=dtype)
        self.fc2 = Dense(units, hidden_size, device=device, dtype=dtype)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.fc2(self.fc1(x))
        return self.drop(out) if self.drop is not None else out


class _TransformerCell(nn.Module):
    """Pre-norm layer: x + attn(ln1(x)); x + ffn(ln2(x))."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, device=None, dtype=None):
        super().__init__()
        self.ln1 = LayerNorm(units, device=device, dtype=dtype)
        self.attn = MultiHeadAttention(units, num_heads, dropout,
                                       causal=causal, device=device,
                                       dtype=dtype)
        self.ln2 = LayerNorm(units, device=device, dtype=dtype)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   device=device, dtype=dtype)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.ffn(self.ln2(x))


class TransformerEncoderCell(_TransformerCell):
    """Bidirectional layer (BERT); ``mask`` is a (B, 1, 1, L) key mask."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, dtype=None):
        super().__init__(units, hidden_size, num_heads, dropout,
                         causal=False, device=device, dtype=dtype)


class TransformerDecoderCell(_TransformerCell):
    """Causal layer (GPT)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, dtype=None):
        super().__init__(units, hidden_size, num_heads, dropout,
                         causal=True, device=device, dtype=dtype)
