"""The neural-network ops the GPT, BERT and ResNet paths reach, as thin
functions on tensors.  Port of the matching ops of
``mxnet_tpu/ops/nn.py``, with the same numerics: ``gelu`` is the tanh
approximation (``jax.nn.gelu``), ``erf_gelu`` the exact form; LayerNorm
statistics accumulate in f32 for half-precision inputs; FullyConnected
is ``x W^T`` then the bias add; ``log_softmax`` and the fused sparse
cross-entropy do their math in f32 and return the input's dtype.

The vision ops keep the reference's layouts at their interface: data
NCHW or NHWC, convolution weights OIHW in every layout.  ``convolution``
sends an NHWC 1x1 stride-1 convolution through ``conv_fused`` (K6 in the
backward) when its gate admits it, and everything else to
``F.conv2d`` (the reference leaves it to ``lax.conv_general_dilated``);
``batch_norm`` is the reference's shifted one-pass statistics with its
hand-written backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .conv_fused import conv1x1_nhwc, fused_bwd_supported

__all__ = ["activation", "layer_norm", "rms_norm", "fully_connected",
           "embedding",
           "dropout", "log_softmax", "pick", "sparse_softmax_ce",
           "convolution", "pooling", "batch_norm", "flatten"]

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


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis (the reference's ``RMSNorm`` op, the
    Llama family's norm): ``x * rsqrt(mean(x²) + eps) * gamma``, computed
    in f32 for bf16/f16 inputs and cast back once."""
    x32 = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * gamma.to(x32.dtype)).to(x.dtype)


def fully_connected(x, weight, bias=None):
    """``x W^T + b`` with ``weight`` (out, in), over the last axis."""
    y = torch.matmul(x, weight.t())
    return y + bias if bias is not None else y


def embedding(idx, weight):
    return weight[idx.long()]


def dropout(x, p=0.5, training=True, generator=None, axes=(), key=None):
    """Reference ``Dropout`` (``_DropoutImpl``): in training, keep each
    element with probability ``1 - p`` and scale it by ``1 / (1 - p)``;
    otherwise the identity.  With ``axes`` the mask has size 1 along
    those axes (one draw shared along them, as the reference's).  The
    mask is drawn from ``generator``, else from a generator seeded with
    the integer ``key``, else from the port's generator of ``x``'s device
    (``random.generator``), which a captured program registers with its
    graph, so every replay draws a fresh mask.  The reference draws
    threefry bits, which no torch generator reproduces."""
    if not training or p <= 0.0:
        return x
    if generator is None and key is not None:
        if _random._capturing():
            raise MXNetError("dropout(key=) under a CUDA graph capture: "
                             "a generator made from a host key cannot "
                             "join the graph; draw from the program's "
                             "key instead (no key=)")
        generator = torch.Generator(device=x.device)
        generator.manual_seed(int(key))
    gen = generator if generator is not None else \
        _random.generator(x.device)
    shape = tuple(1 if i in axes else n for i, n in enumerate(x.shape))
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - p
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


# ----------------------------------------------------------------------- #
# vision: convolution, pooling, BatchNorm
# ----------------------------------------------------------------------- #

def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v + (v[-1],) * (n - len(v)) if len(v) < n else v


def _later_dims(op, ndim):
    return MXNetError(f"{op}: {ndim}-D windows come with a later slice of "
                      "mxnet_tpu_torch (2-D only)")


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None):
    """Reference ``Convolution`` (2-D): data NCHW (``layout`` None or
    "NCHW") or NHWC, weight OIHW in every layout, then the bias add.  An
    NHWC 1x1 convolution without padding takes ``conv_fused.conv1x1_nhwc``
    (K6 in the backward) when ``fused_bwd_supported`` admits it; every
    other one takes ``F.conv2d`` (on a channels-last view for NHWC)."""
    ndim = len(kernel) if kernel else weight.dim() - 2
    if ndim != 2:
        raise _later_dims("convolution", ndim)
    stride = _pair(stride or 1, 2)
    dilate = _pair(dilate or 1, 2)
    pad = _pair(pad or 0, 2)
    use_bias = not no_bias and bias is not None
    if layout is None or layout.startswith("NC"):
        out = F.conv2d(data, weight, None, stride, pad, dilate, num_group)
        return out + bias.reshape(1, -1, 1, 1) if use_bias else out
    if all(p == 0 for p in pad) and fused_bwd_supported(
            data.shape, weight.shape, stride, dilate, num_group,
            itemsize=data.element_size(), dtype=data.dtype):
        out = conv1x1_nhwc(data, weight)
    else:
        x = data.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        out = F.conv2d(x, weight, None, stride, pad, dilate,
                       num_group).permute(0, 2, 3, 1)
    return out + bias.reshape(1, 1, 1, -1) if use_bias else out


def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Reference ``Pooling`` (2-D windows, global over any rank): max,
    avg, sum or lp (p = 2) over NCHW or channels-last data.  Windows
    reduce over the padded input, padding -inf for max and 0 otherwise;
    ``"full"`` (ceil) adds padding on the high side so the last window
    fits; avg divides the window sum by the window size, or with
    ``count_include_pad=False`` by the count of real elements."""
    ndim = len(kernel) if kernel else data.dim() - 2
    channels_last = layout is not None and layout[1] != "C"
    sp = tuple(range(1, 1 + ndim)) if channels_last else \
        tuple(range(2, 2 + ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=sp, keepdim=True)
        return data.mean(dim=sp, keepdim=True)
    if ndim != 2:
        raise _later_dims("pooling", ndim)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    kernel = tuple(kernel)
    stride = _pair(stride or kernel, 2)
    pad = _pair(pad or 0, 2)
    x = data.permute(0, 3, 1, 2) if channels_last else data
    pads = []
    for i in range(2):
        hi = pad[i]
        if pooling_convention == "full":
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            hi += (stride[i] - rem) % stride[i] if rem else 0
        pads.append((pad[i], hi))
    # PyTorch pads inside the window op only symmetrically, up to k // 2
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        padding = tuple(lo for lo, _ in pads)
    else:
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(x, (*pads[1], *pads[0]), value=fill)
        padding = 0
    if pool_type == "max":
        out = F.max_pool2d(x, kernel, stride, padding)
    elif pool_type == "lp":
        out = F.avg_pool2d(x.abs() ** 2.0, kernel, stride, padding,
                           divisor_override=1) ** 0.5
    else:
        out = F.avg_pool2d(x, kernel, stride, padding, divisor_override=1)
        if pool_type == "avg" and count_include_pad:
            out = out / (kernel[0] * kernel[1])
        elif pool_type == "avg":
            out = out / F.avg_pool2d(torch.ones_like(x), kernel, stride,
                                     padding, divisor_override=1)
    return out.permute(0, 2, 3, 1) if channels_last else out


def flatten(data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def _bn_layout(data, axis):
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    return red, bshape, data.numel() // max(1, data.shape[ax])


class _BatchNormStats(torch.autograd.Function):
    """The reference's ``_bn_stats_core``: forward with shifted one-pass
    batch statistics, backward in the hand-written closed form (not
    autograd of the forward).  Outputs ``(out, new_moving_mean,
    new_moving_var, mean, var)``; only ``out`` is differentiable."""

    @staticmethod
    def forward(ctx, data, gamma, beta, moving_mean, moving_var, eps,
                momentum, fix_gamma, use_global_stats, axis, training):
        red, bshape, n = _bn_layout(data, axis)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        if training and not use_global_stats:
            # statistics summed in f32 from the shift s = moving_mean (the
            # guard against E[x^2] - E[x]^2 cancellation), then rounded to
            # the moving statistics' dtype; everything after runs in that
            # dtype, as in the reference
            x32 = data.float() if data.dtype in (torch.float16,
                                                 torch.bfloat16) else data
            shift = moving_mean.float().reshape(bshape)
            d = x32 - shift
            s1 = d.sum(red) / n
            s2 = (d * d).sum(red) / n
            mean = (shift.reshape(-1) + s1).to(moving_mean.dtype)
            var = (s2 - s1 * s1).clamp_min(0.0).to(moving_var.dtype)
            new_mm = moving_mean * momentum + mean * (1 - momentum)
            new_mv = moving_var * momentum + var * (1 - momentum)
        else:
            mean, var = moving_mean.clone(), moving_var.clone()
            new_mm, new_mv = moving_mean.clone(), moving_var.clone()
        inv = torch.rsqrt(var + eps)
        out = (data - mean.reshape(bshape)) * (inv * g).reshape(bshape) + \
            beta.reshape(bshape)
        ctx.save_for_backward(data, gamma, mean, var)
        ctx.cfg = (eps, fix_gamma, use_global_stats, axis, training,
                   beta.dtype)
        ctx.mark_non_differentiable(new_mm, new_mv, mean, var)
        return out.to(data.dtype), new_mm, new_mv, mean, var

    @staticmethod
    def backward(ctx, g_out, *_):
        """dbeta = sum dy, dgamma = sum dy*xhat, dx = (gamma*inv) * (dy -
        (dbeta + xhat*dgamma) / n) with batch statistics, (gamma*inv) * dy
        with global ones; in f32, each cast back once."""
        data, gamma, mean, var = ctx.saved_tensors
        eps, fix_gamma, use_global_stats, axis, training, beta_dtype = \
            ctx.cfg
        red, bshape, n = _bn_layout(data, axis)
        x32 = data.float()
        g32 = g_out.float()
        inv = torch.rsqrt(var.float() + eps).reshape(bshape)
        xhat = (x32 - mean.float().reshape(bshape)) * inv
        dbeta = g32.sum(red)
        dgamma = (g32 * xhat).sum(red)
        geff = 1.0 if fix_gamma else gamma.float().reshape(bshape)
        if training and not use_global_stats:
            dx = (geff * inv) * (g32 - (dbeta.reshape(bshape) +
                                        xhat * dgamma.reshape(bshape)) / n)
        else:
            dx = (geff * inv) * g32
        dgam = torch.zeros_like(gamma) if fix_gamma else \
            dgamma.to(gamma.dtype)
        return (dx.to(data.dtype), dgam, dbeta.to(beta_dtype), None, None,
                None, None, None, None, None, None)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=True):
    """Reference ``_BatchNormStats``: returns ``(out, new_moving_mean,
    new_moving_var, batch_mean, batch_var)``; the caller commits the new
    moving statistics (``gluon.nn.BatchNorm`` does, in training mode).
    Out of training, or with ``use_global_stats``, the moving statistics
    normalize and come back unchanged."""
    return _BatchNormStats.apply(
        data, gamma, beta, moving_mean.detach(), moving_var.detach(),
        float(eps), float(momentum), bool(fix_gamma),
        bool(use_global_stats), int(axis), bool(training))
