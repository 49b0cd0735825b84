"""Llama-family decoder-only language models.

Port of ``mxnet_tpu/models/llama.py``: pre-RMSNorm blocks, rotary
position embeddings (no position table), grouped-query attention
(``num_kv_heads`` ≤ ``num_heads``; each KV head serves a group of
consecutive query heads), a SwiGLU FFN ``down(g·sigmoid(g)·up)`` in the
compute dtype, and an untied LM head.  Projections carry no bias.
Parameters are created on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..base import MXNetError
from ..device import resolve_device
from ..ops.attention import flash_attention, rope
from .gpt import _torch_dtype
from .transformer import Dense, Embedding, RMSNorm, initialize

__all__ = ["LlamaConfig", "Llama", "llama_tiny", "llama_7b"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    max_length: int = 2048
    num_layers: int = 8
    units: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8          # < num_heads => grouped-query attention
    hidden_size: int = 1376        # SwiGLU inner dim
    rope_base: float = 10000.0
    dtype: str = "float32"


class LlamaAttention(nn.Module):
    """RoPE + grouped-query causal self-attention over (B, L, U)."""

    def __init__(self, units, num_heads, num_kv_heads, rope_base=10000.0,
                 device=None, dtype=None):
        super().__init__()
        if units % num_heads or num_heads % num_kv_heads:
            raise MXNetError(f"units {units} / heads {num_heads} / "
                             f"kv_heads {num_kv_heads} incompatible")
        self.heads, self.kv_heads = num_heads, num_kv_heads
        self.rope_base = float(rope_base)
        kvd = num_kv_heads * (units // num_heads)
        self.q_proj = Dense(units, units, use_bias=False, device=device,
                            dtype=dtype)
        self.k_proj = Dense(kvd, units, use_bias=False, device=device,
                            dtype=dtype)
        self.v_proj = Dense(kvd, units, use_bias=False, device=device,
                            dtype=dtype)
        self.o_proj = Dense(units, units, use_bias=False, device=device,
                            dtype=dtype)

    def forward(self, x):
        B, L, U = x.shape
        H, KV = self.heads, self.kv_heads
        D = U // H
        q = self.q_proj(x).reshape(B, L, H, D).permute(0, 2, 1, 3)
        k = self.k_proj(x).reshape(B, L, KV, D).permute(0, 2, 1, 3)
        v = self.v_proj(x).reshape(B, L, KV, D).permute(0, 2, 1, 3)
        q = rope(q, base=self.rope_base)
        k = rope(k, base=self.rope_base)
        if KV != H:     # each KV head serves H // KV consecutive q heads
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.permute(0, 2, 1, 3).reshape(B, L, U))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) · up(x)), in the compute dtype."""

    def __init__(self, units, hidden_size, device=None, dtype=None):
        super().__init__()
        self.gate = Dense(hidden_size, units, use_bias=False, device=device,
                          dtype=dtype)
        self.up = Dense(hidden_size, units, use_bias=False, device=device,
                        dtype=dtype)
        self.down = Dense(units, hidden_size, use_bias=False, device=device,
                          dtype=dtype)

    def forward(self, x):
        g = self.gate(x)
        return self.down(g * torch.sigmoid(g) * self.up(x))


class LlamaCell(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.rms1 = RMSNorm(cfg.units, device=device, dtype=dtype)
        self.attn = LlamaAttention(cfg.units, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.rope_base,
                                   device=device, dtype=dtype)
        self.rms2 = RMSNorm(cfg.units, device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg.units, cfg.hidden_size, device=device,
                            dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.rms1(x))
        return x + self.mlp(self.rms2(x))


class Llama(nn.Module):
    """tokens (B, L) -> logits (B, L, vocab)."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self._cfg = c = config
        dev = resolve_device(device)
        dt = _torch_dtype(dtype if dtype is not None else c.dtype)
        self.wte = Embedding(c.vocab_size, c.units, dev, dt)
        self.blocks = nn.ModuleList(LlamaCell(c, dev, dt)
                                    for _ in range(c.num_layers))
        self.ln_f = RMSNorm(c.units, device=dev, dtype=dt)
        self.head = Dense(c.vocab_size, c.units, use_bias=False, device=dev,
                          dtype=dt)

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
        x = self.wte(tokens)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x))


def _preset(**kw):
    def make(device=None, **overrides):
        dtype = overrides.pop("dtype", None)
        cfg = LlamaConfig(**{**kw, **overrides})
        if dtype is not None:
            cfg.dtype = str(dtype).replace("torch.", "")
        return Llama(cfg, device=device), cfg
    return make


llama_tiny = _preset(vocab_size=512, max_length=128, num_layers=2,
                     units=64, num_heads=4, num_kv_heads=2,
                     hidden_size=128)
llama_7b = _preset(vocab_size=32000, max_length=4096, num_layers=32,
                   units=4096, num_heads=32, num_kv_heads=32,
                   hidden_size=11008)
