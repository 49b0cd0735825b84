"""The neural-network ops the GPT and BERT paths reach, as thin
functions on tensors.  Port of the matching ops of
``mxnet_tpu/ops/nn.py``, with the same numerics: ``gelu`` is the tanh
approximation (``jax.nn.gelu``), ``erf_gelu`` the exact form; LayerNorm
statistics accumulate in f32 for half-precision inputs; FullyConnected
is ``x W^T`` then the bias add; ``log_softmax`` and the fused sparse
cross-entropy do their math in f32 and return the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError

__all__ = ["activation", "layer_norm", "fully_connected", "embedding",
           "dropout", "log_softmax", "pick", "sparse_softmax_ce"]

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


def dropout(x, p=0.5, training=True, generator=None):
    """Reference ``Dropout``: in training, keep each element with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``; otherwise the
    identity.  The mask is drawn from ``generator`` (default: the port's
    generator of ``x``'s device, ``random.generator``).  The reference
    draws threefry bits, which no torch generator reproduces."""
    if not training or p <= 0.0:
        return x
    gen = generator if generator is not None else \
        _random.generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(
        x.dtype)


def log_softmax(x, axis=-1):
    """f32 math for half-precision inputs, the input's dtype out."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.log_softmax(x.float(), dim=axis).to(x.dtype)
    return torch.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False):
    """``x`` at ``index`` along ``axis``; indices clipped to the axis
    (the reference's ``mode='clip'``)."""
    ax = axis % x.dim()
    idx = index.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)


_CE_ROWS = 1024     # rows per chunk: bounds the f32 (rows, V) temporaries


class _SparseSoftmaxCE(torch.autograd.Function):
    """``lse(pred) - pred[label]`` over the last axis of a (N, V) input,
    f32 inside the reductions.  Rows go through in chunks of ``_CE_ROWS``,
    so no (N, V) f32 array exists in the forward or the backward; the
    backward recomputes ``softmax - onehot`` from the input and the saved
    per-row lse, in f32, rounded once to the input's dtype."""

    @staticmethod
    def forward(ctx, pred, label):
        lse = torch.empty((pred.shape[0], 1), dtype=torch.float32,
                          device=pred.device)
        for r in range(0, pred.shape[0], _CE_ROWS):
            chunk = pred[r:r + _CE_ROWS]
            m = chunk.amax(-1, keepdim=True).float()
            lse[r:r + _CE_ROWS] = m + torch.log(
                torch.exp(chunk.float() - m).sum(-1, keepdim=True))
        ctx.save_for_backward(pred, label, lse)
        picked = torch.gather(pred, 1, label[:, None]).float()
        return (lse - picked).to(pred.dtype)

    @staticmethod
    def backward(ctx, g):
        pred, label, lse = ctx.saved_tensors
        grad = torch.empty_like(pred)
        g = g.float()
        for r in range(0, pred.shape[0], _CE_ROWS):
            sm = torch.exp(pred[r:r + _CE_ROWS].float() - lse[r:r + _CE_ROWS])
            sm.scatter_add_(1, label[r:r + _CE_ROWS, None],
                            torch.full_like(lse[r:r + _CE_ROWS], -1.0))
            grad[r:r + _CE_ROWS] = sm * g[r:r + _CE_ROWS]
        return grad, None


def sparse_softmax_ce(pred, label, axis=-1):
    """Fused sparse-label softmax cross-entropy (reference
    ``_sparse_softmax_ce``): per element ``lse(pred) - pred[label]``,
    keepdims on the class axis, in ``pred``'s dtype.  Labels outside
    [0, V) are clipped, as the reference clips them."""
    ax = axis % pred.dim()
    V = pred.shape[ax]
    if label.dim() == pred.dim():
        label = label.squeeze(ax)
    lab = label.long().clamp(0, V - 1)
    moved = pred.movedim(ax, -1)
    flat = moved.reshape(-1, V)
    out = _SparseSoftmaxCE.apply(flat, lab.reshape(-1))
    return out.reshape(moved.shape[:-1] + (1,)).movedim(-1, ax)
