"""The neural-network ops: the tensor functions the GPT, BERT and
ResNet paths call, and the reference's registered ``ops/nn.py`` ops
(``mx.nd.FullyConnected``, ``mx.nd.Convolution``, ...).  Port of
``mxnet_tpu/ops/nn.py``, with the same numerics: ``gelu`` is the tanh
approximation (``jax.nn.gelu``), ``erf_gelu`` the exact form; LayerNorm
statistics accumulate in f32 for half-precision inputs; FullyConnected
is ``x W^T`` then the bias add; ``log_softmax`` and the fused sparse
cross-entropy do their math in f32 and return the input's dtype.

Every op here is registered with ``@op(..., wrap=False)``: the module
keeps the tensor function (the models call it on tensors) and ``mx.nd``
exports the op's NDArray wrapper under the reference's name.  The
reference's detection and sampling ops (``ROIAlign``, ``box_nms``, the
``MultiBox`` family, ...) are not registered yet.

The vision ops keep the reference's layouts at their interface: data
channels-first (``layout`` None or "NC...") or channels-last, at 1, 2 or
3 spatial dims, convolution weights OI+spatial in every layout.
``convolution`` sends an NHWC 1x1 stride-1 convolution through
``conv_fused`` (K6 in the backward) when its gate admits it, and
everything else to ``F.conv1d/2d/3d`` (the reference leaves it to
``lax.conv_general_dilated``); ``batch_norm`` is the reference's shifted
one-pass statistics with its hand-written backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .conv_fused import conv1x1_nhwc, fused_bwd_supported
from .registry import OPS, alias, invoke, op

__all__ = ["activation", "layer_norm", "rms_norm", "fully_connected",
           "embedding",
           "dropout", "log_softmax", "pick", "sparse_softmax_ce",
           "convolution", "deconvolution", "pooling", "batch_norm",
           "flatten", "BatchNorm"]

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


def _half(x):
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def _axis_shape(data, ax):
    """The broadcast shape of a per-``ax`` vector over ``data``."""
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    return shape


def activation(x, act_type="relu"):
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type}")
    return fn(x)


def layer_norm(x, gamma, beta, eps=1e-5, axis=-1, output_mean_var=False):
    """LayerNorm over ``axis`` (the reference's ``LayerNorm`` op): ``(x -
    mean) * rsqrt(var + eps) * gamma + beta``, computed in f32 for
    bf16/f16 inputs and cast back; with ``output_mean_var`` also the
    mean and variance (f32 for such inputs)."""
    ax = axis % x.dim()
    x32 = _half(x)
    mean = x32.mean(ax, keepdim=True)
    var = (x32 - mean).square().mean(ax, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = _axis_shape(x, ax)
    out = ((x32 - mean) * inv * gamma.to(x32.dtype).reshape(shape) +
           beta.to(x32.dtype).reshape(shape)).to(x.dtype)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


def rms_norm(x, gamma, eps=1e-6, axis=-1):
    """RMSNorm over ``axis`` (the reference's ``RMSNorm`` op, the Llama
    family's norm): ``x * rsqrt(mean(x²) + eps) * gamma``, computed in
    f32 for bf16/f16 inputs and cast back once."""
    ax = axis % x.dim()
    x32 = _half(x)
    ms = x32.square().mean(ax, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) *
            gamma.to(x32.dtype).reshape(_axis_shape(x, ax))).to(x.dtype)


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


@op("log_softmax", wrap=False)
def log_softmax(x, *, axis=-1, temperature=None):
    """f32 math for half-precision inputs, the input's dtype out."""
    if temperature:
        x = x / temperature
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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}


def _spatial(op_name, ndim):
    if ndim not in _CONV:
        raise MXNetError(f"{op_name}: {ndim}-D windows are not supported "
                         "(1, 2 or 3 spatial dims)")
    return ndim


def _channels_first(data, ndim):
    """A channels-last input as a channels-first view (in the
    channels-last memory format the library kernels take)."""
    x = data.movedim(-1, 1)
    return x.contiguous(memory_format=_LAST[ndim]) if ndim in _LAST else x


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None):
    """Reference ``Convolution`` at 1, 2 or 3 spatial dims: data
    channels-first (``layout`` None or "NC...") or channels-last, weight
    OI+spatial in every layout, then the bias add.  An NHWC 1x1
    convolution without padding takes ``conv_fused.conv1x1_nhwc`` (K6 in
    the backward) when ``fused_bwd_supported`` admits it; every other one
    takes ``F.conv1d/2d/3d`` (on a channels-last view for NHWC)."""
    ndim = _spatial("convolution",
                    len(kernel) if kernel else weight.dim() - 2)
    stride = _pair(stride or 1, ndim)
    dilate = _pair(dilate or 1, ndim)
    pad = _pair(pad or 0, ndim)
    conv = _CONV[ndim]
    use_bias = not no_bias and bias is not None
    if layout is None or layout.startswith("NC"):
        out = conv(data, weight, None, stride, pad, dilate, num_group)
        return out + bias.reshape((1, -1) + (1,) * ndim) if use_bias \
            else out
    if ndim == 2 and all(p == 0 for p in pad) and fused_bwd_supported(
            data.shape, weight.shape, stride, dilate, num_group,
            itemsize=data.element_size(), dtype=data.dtype):
        out = conv1x1_nhwc(data, weight)
    else:
        out = conv(_channels_first(data, ndim), weight, None, stride, pad,
                   dilate, num_group).movedim(1, -1)
    return out + bias.reshape((1,) * (ndim + 1) + (-1,)) if use_bias \
        else out


def deconvolution(data, weight, bias=None, kernel=(), stride=(),
                  dilate=(), pad=(), adj=(), num_group=1, no_bias=True):
    """Reference ``Deconvolution`` (channels-first at 1, 2 or 3 spatial
    dims, weight (in, out / groups, *kernel)): the stride-dilated input,
    padded by ``(k_eff - 1 - pad, k_eff - 1 - pad + adj)``, correlated
    with the kernel as it is.  ``F.conv_transpose`` correlates with the
    kernel flipped, so the kernel is flipped first; its full output
    (padding 0) is then cut to ``[pad, pad + size)``, with zeros past
    its end where ``adj`` exceeds ``pad`` (no input reaches those)."""
    ndim = _spatial("deconvolution",
                    len(kernel) if kernel else weight.dim() - 2)
    stride = _pair(stride or 1, ndim)
    pad = _pair(pad or 0, ndim)
    dilate = _pair(dilate or 1, ndim)
    adj = _pair(adj or 0, ndim)
    w = weight.flip(tuple(range(2, 2 + ndim)))
    out = _CONV_T[ndim](data, w, None, stride, 0, 0, num_group, dilate)
    for i in range(ndim):
        ke = (weight.shape[2 + i] - 1) * dilate[i] + 1
        size = (data.shape[2 + i] - 1) * stride[i] - 2 * pad[i] + ke + \
            adj[i]
        have = out.shape[2 + i]
        out = out.narrow(2 + i, pad[i], min(size, have - pad[i]))
        if out.shape[2 + i] < size:
            tail = [0, 0] * (ndim - 1 - i) + [0, size - out.shape[2 + i]]
            out = F.pad(out, tail)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Reference ``Pooling`` (1-3 spatial dims, global over any rank):
    max, avg, sum or lp (p = 2) over channels-first or channels-last
    data.  Windows reduce over the padded input, padding -inf for max
    and 0 otherwise; ``"full"`` (ceil) adds padding on the high side so
    the last window fits; avg divides the window sum by the window size,
    or with ``count_include_pad=False`` by the count of real elements.
    1-D windows run as 2-D ones over a unit height."""
    ndim = len(kernel) if kernel else data.dim() - 2
    channels_last = layout is not None and layout[1] != "C"
    sp = tuple(range(1, 1 + ndim)) if channels_last else \
        tuple(range(2, 2 + ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=sp, keepdim=True)
        return data.mean(dim=sp, keepdim=True)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    if ndim == 0:       # no spatial dims: windows of one element
        return data.abs() if pool_type == "lp" else data
    _spatial("pooling", ndim)
    kernel = tuple(kernel)
    stride = _pair(stride or kernel, ndim)
    pad = _pair(pad or 0, ndim)
    x = data.movedim(-1, 1) if channels_last else data
    if channels_last and pool_type != "max":
        # PyTorch's CUDA average pool takes a channels-last tensor to its
        # NHWC kernels, whose backward disagrees with the CPU's (and the
        # reference's) under divisor_override (seen on an H100 with
        # count_include_pad=False); a channels-first copy avoids them
        x = x.contiguous()
    if ndim == 1:
        x = x.unsqueeze(2)
        kernel, stride, pad = (1,) + kernel, (1,) + stride, (0,) + pad
    nd = len(kernel)
    max_pool, avg_pool = (F.max_pool2d, F.avg_pool2d) if nd == 2 else \
        (F.max_pool3d, F.avg_pool3d)
    pads = []
    for i in range(nd):
        hi = pad[i]
        if pooling_convention == "full":
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            hi += (stride[i] - rem) % stride[i] if rem else 0
        pads.append((pad[i], hi))
    # the real elements (1) among the padding (0), for the average that
    # leaves the padding out
    real = torch.ones_like(x) if pool_type == "avg" and \
        not count_include_pad else None
    # PyTorch pads inside the window op only symmetrically, up to k // 2
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        padding = tuple(lo for lo, _ in pads)
    else:
        fill = float("-inf") if pool_type == "max" else 0.0
        flat = [p for pair in reversed(pads) for p in pair]
        x = F.pad(x, flat, value=fill)
        real = None if real is None else F.pad(real, flat)
        padding = 0
    if pool_type == "max":
        out = max_pool(x, kernel, stride, padding)
    elif pool_type == "lp":
        out = avg_pool(x.abs() ** 2.0, kernel, stride, padding,
                       divisor_override=1) ** 0.5
    else:
        out = avg_pool(x, kernel, stride, padding, divisor_override=1)
        if pool_type == "avg" and count_include_pad:
            out = out / math.prod(kernel)
        elif pool_type == "avg":
            out = out / avg_pool(real, kernel, stride, padding,
                                 divisor_override=1)
    if ndim == 1:
        out = out.squeeze(2)
    return out.movedim(1, -1) if channels_last else out


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


# ----------------------------------------------------------------------- #
# the registered ops of the reference's ops/nn.py (mx.nd.<name>)
# ----------------------------------------------------------------------- #

@op("Activation", wrap=False)
def Activation(data, *, act_type="relu"):
    return activation(data, act_type)


_SELU = (1.6732632423543772, 1.0507009873554805)


@op("LeakyReLU", wrap=False)
def LeakyReLU(data, gamma=None, *, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """Every ``act_type`` of the reference: leaky, prelu (``gamma`` per
    channel, axis 1), elu, selu, gelu (the exact form) and rrelu
    (inference: the mean of its slope bounds)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim() and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = _SELU
        return scale * torch.where(pos, data, alpha * torch.expm1(data))
    if act_type == "gelu":
        return activation(data, "erf_gelu")
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, s * data)
    raise MXNetError(f"unknown LeakyReLU act_type {act_type}")


@op("softmax", wrap=False)
def softmax(data, length=None, *, axis=-1, temperature=None,
            use_length=False):
    """Softmax over ``axis``; with ``use_length`` the positions at or past
    ``length`` (per row) are left out and come back 0."""
    x = data / temperature if temperature else data
    if use_length and length is not None:
        L = data.shape[axis]
        shape = [1] * data.dim()
        shape[axis] = L
        pos = torch.arange(L, device=data.device).reshape(shape)
        ln = length.reshape(tuple(length.shape) +
                            (1,) * (data.dim() - length.dim()))
        if axis not in (-1, data.dim() - 1):
            ln = ln.movedim(-1, axis)
        mask = pos < ln
        x = torch.where(mask, x, torch.full_like(x, float("-inf")))
        out = torch.softmax(x, dim=axis)
        return torch.where(mask, out, torch.zeros_like(out))
    return torch.softmax(x, dim=axis)


@op("_sparse_softmax_ce", wrap=False)
def _sparse_softmax_ce(pred, label, *, axis=-1):
    """``sparse_softmax_ce``; a label of ``pred``'s full shape picks one
    class per element (``lse(pred) - pred[label]`` at each)."""
    ax = axis % pred.dim()
    if label.dim() == pred.dim() and label.shape[ax] != 1:
        lab = label.long().clamp(0, pred.shape[ax] - 1)
        lse = torch.logsumexp(pred.float(), ax, keepdim=True)
        return (lse - torch.gather(pred, ax, lab).float()).to(pred.dtype)
    return sparse_softmax_ce(pred, label, axis)


@op("softmin", wrap=False)
def softmin(data, *, axis=-1):
    return torch.softmax(-data, dim=axis)


@op("SoftmaxActivation", wrap=False)
def SoftmaxActivation(data, *, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@op("FullyConnected", wrap=False)
def FullyConnected(data, weight, bias=None, *, num_hidden=0, no_bias=False,
                   flatten=True):
    """``x W^T + b``; with ``flatten`` the input is (N, ...) flattened to
    (N, in_units), else the product is over its last axis."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return fully_connected(x, weight, None if no_bias else bias)


@op("Convolution", wrap=False)
def Convolution(data, weight, bias=None, *, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=1024):
    """``convolution`` (the cuDNN knobs are accepted and ignored, as the
    reference ignores them)."""
    return convolution(data, weight, bias, kernel=kernel, stride=stride,
                       dilate=dilate, pad=pad, num_filter=num_filter,
                       num_group=num_group, no_bias=no_bias, layout=layout)


@op("Deconvolution", wrap=False)
def Deconvolution(data, weight, bias=None, *, kernel=(), stride=(),
                  dilate=(), pad=(), adj=(), num_filter=0, num_group=1,
                  no_bias=True, layout=None, target_shape=None,
                  cudnn_tune=None, cudnn_off=False, workspace=512):
    """``deconvolution``; channels-first whatever ``layout`` says, as in
    the reference."""
    return deconvolution(data, weight, bias, kernel=kernel, stride=stride,
                         dilate=dilate, pad=pad, adj=adj,
                         num_group=num_group, no_bias=no_bias)


@op("Pooling", wrap=False)
def Pooling(data, *, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout=None, cudnn_off=False):
    return pooling(data, kernel=kernel, pool_type=pool_type, stride=stride,
                   pad=pad, global_pool=global_pool,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad, layout=layout)


@op("_BatchNormStats", wrap=False)
def _batch_norm_stats(data, gamma, beta, moving_mean, moving_var, *,
                      eps=1e-5, momentum=0.9, fix_gamma=True,
                      use_global_stats=False, axis=1, training=True):
    """``batch_norm``: ``(out, new_moving_mean, new_moving_var,
    batch_mean, batch_var)``."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats, axis=axis,
                      training=training)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, **_ignored):
    """Reference ``mx.nd.BatchNorm`` (NDArrays in and out): one output,
    or ``(out, batch_mean, batch_var)`` with ``output_mean_var``, in
    training mode when ``autograd.is_training()``.  The moving
    statistics are not updated (the Gluon layer commits them)."""
    from .. import autograd

    outs = invoke(OPS["_BatchNormStats"],
                  [data, gamma, beta, moving_mean, moving_var],
                  dict(eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats, axis=axis,
                       training=autograd.is_training()))
    out, _mm, _mv, mean, var = outs
    return (out, mean, var) if output_mean_var else out


@op("LayerNorm", wrap=False)
def LayerNorm(data, gamma, beta, *, axis=-1, eps=1e-5,
              output_mean_var=False):
    return layer_norm(data, gamma, beta, eps, axis, output_mean_var)


def _moments(x, red):
    mean = x.mean(red, keepdim=True)
    return mean, (x - mean).square().mean(red, keepdim=True)


@op("InstanceNorm", wrap=False)
def InstanceNorm(data, gamma, beta, *, eps=1e-3):
    mean, var = _moments(data, tuple(range(2, data.dim())))
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


@op("GroupNorm", wrap=False)
def GroupNorm(data, gamma, beta, *, num_groups=1, eps=1e-5):
    n, c = data.shape[0], data.shape[1]
    x = data.reshape((n, num_groups, c // num_groups) +
                     tuple(data.shape[2:]))
    mean, var = _moments(x, tuple(range(2, x.dim())))
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@op("RMSNorm", wrap=False)
def RMSNorm(data, gamma, *, axis=-1, eps=1e-6):
    return rms_norm(data, gamma, eps, axis)


def _key_seed(key) -> int:
    """A generator seed from a key array's words (the reference's PRNG
    key), 63 bits of them."""
    words = key.detach().reshape(-1).to(torch.int64).cpu().tolist()
    seed = 0
    for w in words:
        seed = (seed * 0x100000001B3 + (w & 0xFFFFFFFF)) & (2 ** 63 - 1)
    return seed


@op("_DropoutImpl", wrap=False)
def _DropoutImpl(data, key, *, p=0.5, axes=()):
    """Dropout with an explicit key: the same key draws the same mask
    (from a generator seeded with the key's words; the reference draws
    threefry bits, which no torch generator reproduces)."""
    return dropout(data, p, True, axes=tuple(axes), key=_key_seed(key))


@op("Embedding", wrap=False)
def Embedding(data, weight, *, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    return embedding(data, weight)


def _onehot(label, v, dtype):
    """One-hot rows over ``v`` classes; a label outside [0, v) gives a
    row of zeros, as ``jax.nn.one_hot``."""
    lab = label.long().unsqueeze(-1)
    return (lab == torch.arange(v, device=label.device)).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward softmax; backward the cross-entropy gradient ``(p -
    onehot(label)) * grad_scale``, whatever the incoming gradient unless
    ``out_grad``: the reference's custom VJP."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        ctx.save_for_backward(data, label)
        ctx.cfg = cfg
        return torch.softmax(data, dim=cfg[0])

    @staticmethod
    def backward(ctx, g):
        d, lab = ctx.saved_tensors
        (axis, grad_scale, ignore_label, use_ignore, normalization,
         out_grad, smooth_alpha) = ctx.cfg
        dm = d.movedim(axis, -1) if axis != -1 else d
        p = torch.softmax(dm, dim=-1)
        v = dm.shape[-1]
        dist = lab.shape == d.shape
        if dist:
            lm = lab.movedim(axis, -1) if axis != -1 else lab
            onehot = lm.to(d.dtype)
        else:
            onehot = _onehot(lab, v, d.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / v
        grad = p - onehot
        scale = grad_scale
        if use_ignore and not dist:
            mask = lab.to(torch.int32) != int(ignore_label)
            grad = grad * mask[..., None].to(d.dtype)
            if normalization == "valid":
                scale = scale / mask.sum().clamp_min(1).to(d.dtype)
        if normalization == "batch":
            scale = scale / d.shape[0]
        grad = grad * scale
        if out_grad:
            grad = grad * (g.movedim(axis, -1) if axis != -1 else g)
        if axis != -1:
            grad = grad.movedim(-1, axis)
        return grad.to(d.dtype), None, None


@op("SoftmaxOutput", wrap=False)
def SoftmaxOutput(data, label, *, grad_scale=1.0, ignore_label=-1,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward; its backward is the cross-entropy gradient (the
    legacy Module loop's implicit ones).  ``multi_output`` softmaxes over
    axis 1 of ``(n, c, d1...)`` inputs with ``(n, d1...)`` labels."""
    axis = 1 if (multi_output and data.dim() > 2) else -1
    return _SoftmaxOutputFn.apply(
        data, label, (axis, grad_scale, ignore_label, use_ignore,
                      normalization, out_grad, smooth_alpha))


_CTC_NEG = -1e30


def _ctc_lse(a, b):
    m = torch.maximum(a, b)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.where((a <= _CTC_NEG) & (b <= _CTC_NEG),
                       torch.full_like(m, _CTC_NEG),
                       m + torch.log(torch.exp(a - m) + torch.exp(b - m)))


@op("CTCLoss", wrap=False)
def CTCLoss(data, label, data_lengths=None, label_lengths=None, *,
            use_data_lengths=False, use_label_lengths=False,
            blank_label="first"):
    """CTC by the alpha recursion in log space over (T, B, V) logits, the
    reference's: labels padded with -1, the blank first or last; the loss
    of each sequence, differentiated by autograd through the loop."""
    T, B, V = data.shape
    dev = data.device
    logp = torch.log_softmax(data, dim=-1)
    blank = 0 if blank_label == "first" else V - 1
    lab = label.to(torch.int64)
    Lmax = lab.shape[1]
    if label_lengths is not None and use_label_lengths:
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = ((lab >= 0) & (lab != -1)).sum(1)
        lab_len = torch.where(lab_len == 0, torch.full_like(lab_len, Lmax),
                              lab_len)
    if data_lengths is not None and use_data_lengths:
        t_len = data_lengths.to(torch.int64)
    else:
        t_len = torch.full((B,), T, dtype=torch.int64, device=dev)
    S = 2 * Lmax + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = torch.where(lab == -1, torch.full_like(lab, blank), lab)
    br = torch.arange(B, device=dev)
    col = torch.arange(S, device=dev)
    neg = torch.full((B, S), _CTC_NEG, dtype=logp.dtype, device=dev)
    alpha = torch.where(col == 0, logp[0, br, blank][:, None], neg)
    alpha = torch.where(col == 1, logp[0, br, ext[:, 1]][:, None], alpha)
    same = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, T):
        shifted1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        shifted2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1)
        a = _ctc_lse(alpha, shifted1)
        a = torch.where(same, a, _ctc_lse(a, shifted2))
        new = a + torch.gather(logp[t], 1, ext)
        alpha = torch.where((t < t_len)[:, None], new, alpha)
    end1 = 2 * lab_len
    end2 = (2 * lab_len - 1).clamp_min(0)
    return -_ctc_lse(alpha[br, end1], alpha[br, end2])


@op("MakeLoss", wrap=False)
def MakeLoss(data, *, grad_scale=1.0, valid_thresh=0.0,
             normalization="null"):
    return data


alias("make_loss", "MakeLoss")


def _sqrt_of(n, like):
    return torch.sqrt(torch.tensor(float(n), dtype=like.dtype,
                                   device=like.device))


@op("_contrib_interleaved_matmul_selfatt_qk", wrap=False)
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads=1):
    """(L, B, 3*E) interleaved q/k/v -> (B*heads, L, L) scaled scores."""
    L, B, E3 = queries_keys_values.shape
    hd = E3 // 3 // heads
    x = queries_keys_values.reshape(L, B, heads, 3 * hd)
    q = x[..., :hd].permute(1, 2, 0, 3).reshape(B * heads, L, hd)
    k = x[..., hd:2 * hd].permute(1, 2, 0, 3).reshape(B * heads, L, hd)
    return torch.matmul(q, k.transpose(-1, -2)) / _sqrt_of(hd, q)


@op("_contrib_interleaved_matmul_selfatt_valatt", wrap=False)
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads=1):
    """(B*heads, L, L) probabilities times the interleaved values ->
    (L, B, E)."""
    L, B, E3 = queries_keys_values.shape
    E = E3 // 3
    hd = E // heads
    x = queries_keys_values.reshape(L, B, heads, 3 * hd)
    v = x[..., 2 * hd:].permute(1, 2, 0, 3).reshape(B * heads, L, hd)
    out = torch.matmul(attention, v).reshape(B, heads, L, hd)
    return out.permute(2, 0, 1, 3).reshape(L, B, E)


def _resize_weights(n_in, n_out, device):
    """``jax.image.resize``'s bilinear weights along one axis, (n_in,
    n_out): a triangle kernel at half-pixel centres, widened by the
    downscale factor (antialiasing), each column normalized."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) +
              0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / \
        kscale
    w = (1.0 - x).clamp_min(0.0)
    tot = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(tot.abs() > eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_bilinear(data, height, width):
    """(N, C, H, W) -> (N, C, height, width) as ``jax.image.resize(...,
    "bilinear")``: one weighted sum along H, then one along W."""
    h, w = data.shape[2], data.shape[3]
    dt = data.dtype if data.is_floating_point() else torch.float32
    wh = _resize_weights(h, height, data.device).to(dt)
    ww = _resize_weights(w, width, data.device).to(dt)
    out = torch.einsum("nchw,hH->ncHw", data.to(dt), wh)
    return torch.einsum("ncHw,wW->ncHW", out, ww)


@op("UpSampling", wrap=False)
def UpSampling(data, *, scale=2, sample_type="nearest", num_args=1):
    """NCHW upsampling by ``scale``: nearest repeats each pixel, bilinear
    resizes."""
    n, c, h, w = data.shape
    if sample_type == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return _resize_bilinear(data, h * scale, w * scale)


@op("_contrib_BilinearResize2D", wrap=False)
def BilinearResize2D(data, *, height=0, width=0, scale_height=None,
                     scale_width=None, mode="size", align_corners=True):
    n, c, h, w = data.shape
    if scale_height is not None:
        height = int(round(h * scale_height))
        width = int(round(w * (scale_width or scale_height)))
    return _resize_bilinear(data, int(height), int(width))


alias("BilinearResize2D", "_contrib_BilinearResize2D")


@op("log_sigmoid", wrap=False)
def log_sigmoid(data):
    return activation(data, "log_sigmoid")


@op("hard_sigmoid", wrap=False)
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return (alpha * data + beta).clamp(0.0, 1.0)


@op("mish", wrap=False)
def mish(data):
    return activation(data, "mish")
