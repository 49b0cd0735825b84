"""The neural-network ops the GPT serving path reaches, as thin functions
on tensors.  Port of the matching ops of ``mxnet_tpu/ops/nn.py``, with
the same numerics: ``gelu`` is the tanh approximation (``jax.nn.gelu``),
``erf_gelu`` the exact form; LayerNorm statistics accumulate in f32 for
half-precision inputs; FullyConnected is ``x W^T`` then the bias add.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["activation", "layer_norm", "fully_connected", "embedding"]

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "erf_gelu": F.gelu,
    "swish": F.silu,
}


def activation(x, act_type="relu"):
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type}")
    return fn(x)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis: ``(x - mean) * rsqrt(var + eps) *
    gamma + beta``, computed in f32 for bf16/f16 inputs and cast back."""
    x32 = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = (x32 - mean) * inv * gamma.to(x32.dtype) + beta.to(x32.dtype)
    return out.to(x.dtype)


def fully_connected(x, weight, bias=None):
    """``x W^T + b`` with ``weight`` (out, in), over the last axis."""
    y = torch.matmul(x, weight.t())
    return y + bias if bias is not None else y


def embedding(idx, weight):
    return weight[idx.long()]
