"""Legacy-surface and utility operators.

Port of ``mxnet_tpu/ops/legacy.py``, name for name:

- ``im2col``/``col2im``: the patch matrix of a convolution and its
  scatter-add inverse (``F.unfold``/``F.fold``, the same channel-major
  (c, kh, kw) row order as the reference's
  ``conv_general_dilated_patches``; overlapping patches accumulate).
- Module-era output heads ``LinearRegressionOutput``,
  ``LogisticRegressionOutput``, ``MAERegressionOutput`` and ``SVMOutput``:
  the forward is the identity (a sigmoid for the logistic head); the
  backward ignores the head gradient and returns the loss's gradient
  with respect to the data (the reference's ``custom_vjp``), here a
  ``torch.autograd.Function``.
- legacy indexing: ``choose_element_0index``, ``fill_element_0index``.
- activations the reference registers as standalone names: ``gelu``,
  ``selu``, ``elu``, ``prelu`` (calls into ``ops.nn``'s ``activation``
  and ``LeakyReLU``, one implementation each), ``erfc``, ``logit``.
- ``softmax_cross_entropy`` (summed sparse cross-entropy in f32),
  ``group_adagrad_update``, ``lans_update`` and ``rnn_param_concat``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .nn import LeakyReLU, activation
from .registry import alias, op

__all__ = [
    "im2col", "col2im", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
    "choose_element_0index", "fill_element_0index", "gelu", "selu", "elu",
    "prelu", "erfc", "logit", "softmax_cross_entropy",
    "group_adagrad_update", "lans_update", "rnn_param_concat",
]


def _pair(v, n=2):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v + (v[-1],) * (n - len(v)) if len(v) < n else v


# --------------------------------------------------------------------------- #
# im2col / col2im
# --------------------------------------------------------------------------- #

@op("im2col")
def im2col(data, *, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(N, C, H, W) -> (N, C*kh*kw, L) patch matrix, L = out_h*out_w."""
    return tF.unfold(data, _pair(kernel), dilation=_pair(dilate or 1),
                     padding=_pair(pad or 0), stride=_pair(stride or 1))


@op("col2im")
def col2im(data, *, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """Inverse of :func:`im2col`: scatter-add the (N, C*kh*kw, L) patch
    matrix back to (N, C, H, W); overlapping patches accumulate."""
    return tF.fold(data, _pair(output_size), _pair(kernel),
                   dilation=_pair(dilate or 1), padding=_pair(pad or 0),
                   stride=_pair(stride or 1))


# --------------------------------------------------------------------------- #
# Module-era output heads: identity-like forward, loss-defining backward
# --------------------------------------------------------------------------- #

class _Head(torch.autograd.Function):
    """``fwd(data)`` forward; backward ``dgrad(data, label) *
    grad_scale`` whatever the head gradient (the head is the loss), a
    zero gradient for the label."""

    @staticmethod
    def forward(ctx, data, label, fwd, dgrad, scale):
        ctx.save_for_backward(data, label)
        ctx.dgrad, ctx.scale = dgrad, scale
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        d = ctx.dgrad(data, label) * ctx.scale
        return d.to(data.dtype), torch.zeros_like(label), None, None, None


# the reference's "1/m": the gradient is scaled by the number of outputs
# per example (d.numel() // d.shape[0]), not by the batch size
def _num_outputs(d):
    return max(math.prod(d.shape[1:]), 1)


def _output_head(name, fwd, dgrad):
    def head(data, label, *, grad_scale=1.0):
        return _Head.apply(data, label, fwd, dgrad, float(grad_scale))

    head.__name__ = head.__qualname__ = name
    return op(name)(head)


LinearRegressionOutput = _output_head(
    "LinearRegressionOutput", lambda d: d.clone(),
    lambda d, l: (d - l.reshape(d.shape)) / _num_outputs(d))
MAERegressionOutput = _output_head(
    "MAERegressionOutput", lambda d: d.clone(),
    lambda d, l: torch.sign(d - l.reshape(d.shape)) / _num_outputs(d))
LogisticRegressionOutput = _output_head(
    "LogisticRegressionOutput", torch.sigmoid,
    lambda d, l: (torch.sigmoid(d) - l.reshape(d.shape)) / _num_outputs(d))


def _svm_grad(margin, reg, linear):
    def dgrad(data, label):
        n, k = data.shape[0], data.shape[-1]
        onehot = tF.one_hot(label.long().reshape(n), k).to(data.dtype)
        score_y = (data * onehot).sum(-1, keepdim=True)
        viol = ((data - score_y + margin) > 0) & (onehot == 0)
        if linear:
            dwrong = viol.to(data.dtype)
        else:                                   # squared hinge
            dwrong = torch.where(viol, 2.0 * (data - score_y + margin),
                                 torch.zeros_like(data))
        dright = -dwrong.sum(-1, keepdim=True) * onehot
        return (dwrong * (1 - onehot) + dright) * reg
    return dgrad


@op("SVMOutput")
def SVMOutput(data, label, *, margin=1.0, regularization_coefficient=1.0,
              use_linear=False):
    """Forward is the identity; the (squared) hinge gradient flows in
    backward."""
    return _Head.apply(data, label, lambda d: d.clone(),
                       _svm_grad(float(margin),
                                 float(regularization_coefficient),
                                 bool(use_linear)), 1.0)


# --------------------------------------------------------------------------- #
# legacy indexing
# --------------------------------------------------------------------------- #

@op("choose_element_0index")
def choose_element_0index(data, index):
    """Row-wise pick: out[i] = data[i, index[i]]."""
    idx = index.long().reshape(-1)
    return data.gather(-1, idx[:, None])[:, 0]


@op("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """out = lhs with out[i, rhs[i]] = mhs[i]."""
    idx = rhs.long().reshape(-1)
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    out = lhs.clone()
    out[rows, idx] = mhs.reshape(-1).to(lhs.dtype)
    return out


# --------------------------------------------------------------------------- #
# standalone activation ops
# --------------------------------------------------------------------------- #

@op("gelu")
def gelu(data, *, approximation="erf"):
    return activation(data, "erf_gelu" if approximation == "erf" else "gelu")


@op("selu")
def selu(data):
    return LeakyReLU(data, act_type="selu")


@op("elu")
def elu(data, *, alpha=1.0):
    return LeakyReLU(data, act_type="elu", slope=alpha)


@op("prelu")
def prelu(data, gamma):
    return LeakyReLU(data, gamma.to(data.dtype), act_type="prelu")


@op("erfc")
def erfc(data):
    return torch.special.erfc(data)


@op("logit")
def logit(data, *, eps=None):
    x = data.clamp(eps, 1 - eps) if eps else data
    return torch.log(x) - torch.log1p(-x)


# --------------------------------------------------------------------------- #
# fused softmax cross-entropy
# --------------------------------------------------------------------------- #

@op("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed cross-entropy over the batch, -sum_i log softmax(data)_i
    [label_i], in f32 (sparse labels, sum reduction)."""
    logp = torch.log_softmax(data.float(), dim=-1)
    lab = label.long().reshape(-1)
    return -logp.gather(-1, lab[:, None]).sum()


# --------------------------------------------------------------------------- #
# optimizer update ops
# --------------------------------------------------------------------------- #

@op("group_adagrad_update", differentiable=False)
def group_adagrad_update(weight, grad, history, *, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Contrib GroupAdaGrad: one accumulator per row (group)."""
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if g.dim() > 1:
        new_hist = history + (g * g).mean(dim=tuple(range(1, g.dim())),
                                          keepdim=True)
    else:
        new_hist = history + g * g
    upd = lr * g / (torch.sqrt(new_hist) + epsilon)
    return (weight.float() - upd).to(weight.dtype), \
        new_hist.to(history.dtype)


@op("lans_update", differentiable=False)
def lans_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, t=1, wd=0.0, rescale_grad=1.0):
    """LANS: LAMB with the gradient normalized each step."""
    w32 = weight.float()
    g = grad.float() * rescale_grad
    g = g / torch.linalg.vector_norm(g).clamp_min(1e-12)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g * g
    mhat = m / (1 - beta1 ** t)
    vhat = v / (1 - beta2 ** t)
    update = mhat / (torch.sqrt(vhat) + epsilon) + wd * w32
    wnorm = torch.linalg.vector_norm(w32)
    unorm = torch.linalg.vector_norm(update)
    trust = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                        torch.ones_like(wnorm))
    return (w32 - lr * trust * update).to(weight.dtype), \
        m.to(mean.dtype), v.to(var.dtype)


@op("rnn_param_concat", variadic=True)
def rnn_param_concat(*arrays, dim=0):
    """Flatten and concatenate the RNN weight list into the fused
    parameter vector (reference ``_rnn_param_concat``)."""
    return torch.cat([a.reshape(-1) if dim == 0 else a for a in arrays],
                     dim=0)


alias("_contrib_group_adagrad_update", "group_adagrad_update")
