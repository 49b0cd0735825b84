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
detection and sampling ops (``ROIAlign``, ``ROIPooling``, ``box_nms``,
the ``MultiBox`` family, ``Proposal``, ...) are at the end; ``box_nms``
runs its loop in ``ops/box_nms.py`` (one kernel launch on the card).

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


# ----------------------------------------------------------------------- #
# detection and sampling (reference ops/nn.py:746-1333): region pooling,
# box_nms, the spatial transformer's grid and sampler, the SSD MultiBox
# family, fft/ifft, the RPN's Proposal, deformable convolution and the
# FlowNet correlation.  Constants are made on the device by fills (no
# host-to-device copy), and a division by a Python number divides by a
# tensor (the CUDA kernel of ``x / 0.1`` multiplies by the reciprocal), so
# MultiBoxPrior, MultiBoxTarget and MultiBoxDetection run inside a CUDA
# graph capture and give the CPU's values on the card.
# ----------------------------------------------------------------------- #

_CHUNK_BYTES = 1 << 30      # the largest temporary a chunk of ROIs makes


def _full(v, like, dtype=None):
    return torch.full((), v, dtype=dtype or like.dtype, device=like.device)


def _fdiv(x, v):
    """``x / v`` for a Python number ``v``, rounded as one division."""
    return x / _full(v, x)


def _clip(x, lo, hi):
    """``jnp.clip``: a maximum then a minimum, so a value at a bound takes
    half its gradient, as the reference's does."""
    return torch.minimum(torch.maximum(x, _full(lo, x)), _full(hi, x))


def _exact(fn, x):
    """``fn`` (``torch.exp``, ``torch.log``) of ``x`` taken in f64 and
    rounded once to ``x``'s dtype: the correctly rounded value, so the
    card and the CPU agree on it (each library's f32 ``exp`` misses it in
    the last ulp on some inputs: PyTorch's CPU one on ~1 %, XLA's on
    ~9 % of a million uniform draws in [-10, 10])."""
    return fn(x.double()).to(x.dtype)


def _chunks(total, per_item):
    """Slices of ``range(total)`` whose temporaries stay under
    ``_CHUNK_BYTES`` at ``per_item`` bytes an item."""
    step = max(1, _CHUNK_BYTES // max(per_item, 1))
    return [slice(i, min(i + step, total)) for i in range(0, total, step)]


def _roi_align_chunk(data, bidx, ys, xs, ph, pw, s):
    """ROIAlign of one chunk of ROIs (the reference's ``per_roi``,
    vectorized): ``ys`` (R, ph*s) and ``xs`` (R, pw*s) sample points."""
    c, h, w = data.shape[1:]
    r, p, q = bidx.shape[0], ys.shape[1], xs.shape[1]
    yy = _clip(ys, 0, h - 1)
    xx = _clip(xs, 0, w - 1)
    y0 = torch.floor(yy).long()
    x0 = torch.floor(xx).long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    wy = (yy - y0.to(yy.dtype))[:, None, :, None]
    wx = (xx - x0.to(xx.dtype))[:, None, None, :]
    rows = [data[bidx[:, None], :, y] for y in (y0, y1)]   # (R, P, c, w)

    def at(row, x):
        return row.gather(3, x[:, None, None, :].expand(r, p, c, q)) \
            .transpose(1, 2)                                  # (R, c, P, Q)

    v00, v01 = at(rows[0], x0), at(rows[0], x1)
    v10, v11 = at(rows[1], x0), at(rows[1], x1)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
           v10 * wy * (1 - wx) + v11 * wy * wx)
    return out.reshape(r, c, ph, s, pw, s).mean(dim=(3, 5))


@op("_contrib_ROIAlign", wrap=False)
def ROIAlign(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0,
             sample_ratio=2, position_sensitive=False, aligned=False):
    """``rois`` (R, 5) [batch_idx, x1, y1, x2, y2] in image coordinates ->
    (R, c, ph, pw): bilinear samples on a (ph*s, pw*s) grid a ROI, averaged
    over each bin's s x s.  The ROIs go in chunks whose temporaries stay
    under ``_CHUNK_BYTES``; each ROI's result is its own, so chunking
    changes no value.  Under autograd a chunk is checkpointed (its forward
    runs again in the backward), so what is kept for the backward is the
    inputs, not every chunk's samples."""
    from torch.utils.checkpoint import checkpoint

    n, c, h, w = data.shape
    ph, pw = pooled_size
    rois = rois.float()
    bidx = rois[:, 0].long()
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    least = _full(1.0 if not aligned else 1e-6, x1)
    bin_h = _fdiv(torch.maximum(y2 - y1, least), ph)
    bin_w = _fdiv(torch.maximum(x2 - x1, least), pw)
    s = max(int(sample_ratio), 1)
    iy = _fdiv(torch.arange(ph * s, device=data.device).float() + 0.5, s)
    ix = _fdiv(torch.arange(pw * s, device=data.device).float() + 0.5, s)
    ys = y1[:, None] + bin_h[:, None] * iy[None, :]
    xs = x1[:, None] + bin_w[:, None] * ix[None, :]
    out_dtype = torch.promote_types(data.dtype, torch.float32)
    if rois.shape[0] == 0:
        return torch.zeros((0, c, ph, pw), dtype=out_dtype,
                           device=data.device)
    per_roi = c * (2 * ph * s * w + 8 * ph * s * pw * s) * 4
    grad = torch.is_grad_enabled() and (data.requires_grad or
                                        rois.requires_grad)
    parts = []
    for sl in _chunks(rois.shape[0], per_roi):
        args = (data, bidx[sl], ys[sl], xs[sl], ph, pw, s)
        parts.append(checkpoint(_roi_align_chunk, *args, use_reentrant=False)
                     if grad else _roi_align_chunk(*args))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


alias("ROIAlign", "_contrib_ROIAlign")


def _roi_pool_bins(rois, spatial_scale, h, w, ph, pw):
    """Each ROI's bin index of every pixel row and column, -1 outside it
    (the reference's ``ybin``/``xbin``): (R, h), (R, w) and the batch
    indices."""
    rois = rois.float()
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).long()[:, None]
                      for i in (1, 2, 3, 4))
    ys = torch.arange(h, device=rois.device)[None, :]
    xs = torch.arange(w, device=rois.device)[None, :]
    roi_h = (y2 - y1 + 1).clamp_min(1)
    roi_w = (x2 - x1 + 1).clamp_min(1)
    ybin = torch.where((ys >= y1) & (ys <= y2), ((ys - y1) * ph) // roi_h,
                       torch.full_like(ys, -1))
    xbin = torch.where((xs >= x1) & (xs <= x2), ((xs - x1) * pw) // roi_w,
                       torch.full_like(xs, -1))
    return bidx, ybin, xbin


def _roi_pool_max(img, ybin, xbin, ph, pw):
    """Each bin's max over its pixels, -inf for an empty bin: the max over
    x within each column bin, then over y within each row bin (max is
    exact, so the values are the reference's joint max bit for bit)."""
    ninf = _full(float("-inf"), img)
    cols = torch.stack([torch.where((xbin == j)[:, None, None, :], img,
                                    ninf).amax(-1) for j in range(pw)], -1)
    return torch.stack([torch.where((ybin == i)[:, None, :, None], cols,
                                    ninf).amax(2) for i in range(ph)], 2)


def _to_pixels(t, ybin, xbin):
    """(R, c, ph, pw) bin values at every pixel of (R, c, h, w)."""
    r, c = t.shape[:2]
    h, w = ybin.shape[1], xbin.shape[1]
    t = t.gather(2, ybin.clamp_min(0)[:, None, :, None].expand(
        r, c, h, t.shape[3]))
    return t.gather(3, xbin.clamp_min(0)[:, None, None, :].expand(r, c, h, w))


class _ROIPooling(torch.autograd.Function):
    """ROIPooling with the reference's gradient: ``reduce_max``'s VJP
    splits a bin's cotangent equally among the pixels that tie for its
    max (nested maxima would not: 2 ties in one row and 1 in another give
    1/4, 1/4, 1/2).  Forward and backward go over chunks of ROIs."""

    @staticmethod
    def forward(ctx, data, rois, spatial_scale, ph, pw):
        n, c, h, w = data.shape
        bidx, ybin, xbin = _roi_pool_bins(rois, spatial_scale, h, w, ph, pw)
        per_roi = 4 * c * h * w * data.element_size()
        raw = torch.cat([_roi_pool_max(data[bidx[sl]], ybin[sl], xbin[sl],
                                       ph, pw)
                         for sl in _chunks(bidx.shape[0], per_roi)]) \
            if bidx.shape[0] else data.new_zeros((0, c, ph, pw))
        ctx.save_for_backward(data, bidx, ybin, xbin, raw)
        ctx.ph_pw = (ph, pw)
        return torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))

    @staticmethod
    def backward(ctx, g):
        data, bidx, ybin, xbin, raw = ctx.saved_tensors
        ph, pw = ctx.ph_pw
        grad = torch.zeros_like(data)
        c, h, w = data.shape[1:]
        binsy = torch.arange(ph, device=data.device)[None, :, None]
        binsx = torch.arange(pw, device=data.device)[None, :, None]
        per_roi = 6 * c * h * w * 4
        for sl in _chunks(bidx.shape[0], per_roi):
            img, yb, xb, top = data[bidx[sl]], ybin[sl], xbin[sl], raw[sl]
            inbin = ((yb >= 0)[:, :, None] & (xb >= 0)[:, None, :])[:, None]
            ties = inbin & (img == _to_pixels(top, yb, xb))
            count = torch.einsum("rcyx,riy,rjx->rcij", ties.to(g.dtype),
                                 (yb[:, None, :] == binsy).to(g.dtype),
                                 (xb[:, None, :] == binsx).to(g.dtype))
            share = torch.where(torch.isfinite(top) & (count > 0),
                                g[sl] / count.clamp_min(1),
                                torch.zeros_like(g[sl]))
            part = torch.where(ties, _to_pixels(share, yb, xb),
                               torch.zeros_like(img))
            grad.index_add_(0, bidx[sl], part.to(grad.dtype))
        return grad, None, None, None, None


@op("ROIPooling", wrap=False)
def ROIPooling(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0):
    """Max pooling of each ROI (R, 5) [batch_idx, x1, y1, x2, y2] over a
    (ph, pw) grid of bins -> (R, c, ph, pw), 0 for an empty bin: the
    reference's masked max computed separably, in chunks of ROIs."""
    ph, pw = pooled_size
    return _ROIPooling.apply(data, rois.detach(), spatial_scale, ph, pw)


@op("_contrib_box_nms", differentiable=False, wrap=False)
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Greedy NMS over rows ``(..., n, K)`` [id?, score, x1, y1, x2, y2,
    ...]: every suppressed row, every row under ``valid_thresh`` and every
    row past the ``topk`` best gets score -1; nothing else changes.  The
    loop runs in ``ops.box_nms.nms_scores``: on the card one launch of
    ``csrc/box_nms.cu``, on the CPU the reference's loop."""
    from .box_nms import nms_scores, score_order

    shape = data.shape
    n = shape[-2]
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    scores = flat[..., score_index]
    start = max(0, min(coord_start, shape[-1] - 4))     # dynamic_slice's
    boxes = flat[..., start:start + 4]
    ids = flat[..., id_index] if id_index >= 0 and not force_suppress \
        else None
    keep_lim = n if topk < 0 else min(topk, n)
    new = nms_scores(scores, boxes, ids, score_order(scores), keep_lim,
                     overlap_thresh, valid_thresh)
    out = flat.clone()
    out[..., score_index] = new
    return out.reshape(shape)


alias("box_nms", "_contrib_box_nms")


def _linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` in f32, its formula: ``start *
    (1 - t) + stop * t`` at ``t = i / (num - 1)``, the end point appended
    (``torch.linspace`` fills from both ends and may differ in the last
    ulp)."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    t = _fdiv(torch.arange(num - 1, device=device).float(), num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


@op("GridGenerator", wrap=False)
def GridGenerator(data, *, transform_type="affine", target_shape=(0, 0)):
    """Affine (N, 6) -> sampling grid (N, 2, H, W) in [-1, 1] coordinates
    (the spatial transformer's grid; pairs with BilinearSampler)."""
    h, w = target_shape
    theta = data.reshape(-1, 2, 3)
    gy, gx = torch.meshgrid(_linspace(-1.0, 1.0, h, data.device),
                            _linspace(-1.0, 1.0, w, data.device),
                            indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    out = torch.einsum("nij,jk->nik", theta.float(), coords)
    return out.reshape(-1, 2, h, w)


def _bilinear_at(flat, yy, xx, h, w):
    """The reference's four-corner bilinear sample with zeros outside:
    ``flat`` (B, c, h*w), ``yy``/``xx`` (B, ...) -> (B, c, ...)."""
    b, c = flat.shape[:2]
    y0 = torch.floor(yy).long()
    x0 = torch.floor(xx).long()
    wy = (yy - y0.to(yy.dtype))[:, None]
    wx = (xx - x0.to(xx.dtype))[:, None]

    def at(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
        v = flat.gather(2, idx.expand(b, c, idx.shape[2])).reshape(
            (b, c) + tuple(yi.shape[1:]))
        return torch.where(inside[:, None], v, torch.zeros_like(v))

    return (at(y0, x0) * (1 - wy) * (1 - wx) +
            at(y0, x0 + 1) * (1 - wy) * wx +
            at(y0 + 1, x0) * wy * (1 - wx) +
            at(y0 + 1, x0 + 1) * wy * wx)


@op("BilinearSampler", wrap=False)
def BilinearSampler(data, grid, *, cudnn_off=False):
    """Sample NCHW ``data`` at ``grid`` (N, 2, H', W') of [-1, 1] (x, y)
    coordinates, zeros outside -> (N, C, H', W')."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_at(data.reshape(n, c, h * w), gy, gx, h, w)


@op("_contrib_MultiBoxPrior", differentiable=False, wrap=False)
def MultiBoxPrior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes for one feature map: data (N, C, H, W) -> (1,
    H*W*(len(sizes)+len(ratios)-1), 4) corner boxes in [0, 1], f32."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, device=dev).float() + offsets[0]) * step_y
    cx = (torch.arange(w, device=dev).float() + offsets[1]) * step_x
    whs = [(s * (ratios[0] ** 0.5), s / (ratios[0] ** 0.5)) for s in sizes]
    whs += [(sizes[0] * (r ** 0.5), sizes[0] / (r ** 0.5))
            for r in ratios[1:]]
    whs = torch.stack([torch.full((), v, device=dev)
                       for pair in whs for v in pair]).reshape(-1, 2)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([gx, gy], -1).reshape(-1, 1, 2)
    half = whs.reshape(1, -1, 2) / 2.0
    boxes = torch.cat([centers - half, centers + half], -1).reshape(1, -1, 4)
    return boxes.clamp(0.0, 1.0) if clip else boxes


alias("MultiBoxPrior", "_contrib_MultiBoxPrior")


def _iou_matrix(a, b):
    """a (A, 4), b (..., B, 4) corner boxes -> (..., A, B) IoU, the
    reference's ``_iou_matrix`` expression."""
    ax1, ay1, ax2, ay2 = (a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
    area_b = (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0)
    return inter / (area_a + area_b - inter).clamp_min(1e-12)


def _anchor_frame(anchor):
    a = anchor.shape[1]
    anc = anchor.reshape(a, 4)
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = (anc[:, 2] - anc[:, 0]).clamp_min(1e-12)
    ah = (anc[:, 3] - anc[:, 1]).clamp_min(1e-12)
    return anc, acx, acy, aw, ah


@op("_contrib_MultiBoxTarget", differentiable=False, wrap=False)
def MultiBoxTarget(anchor, label, cls_pred, *, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchors (1, A, 4), labels (N, O, 5) [cls, x1,
    y1, x2, y2] (class -1 pads) -> (loc_target (N, A*4), loc_mask (N,
    A*4), cls_target (N, A)).  An anchor is positive at IoU >=
    ``overlap_threshold`` with its best object, or when some valid object
    has it as its best anchor (the reference scatters these with
    duplicate indices, where a padded row's pick can undo a valid one;
    ROADMAP §3).  The negative-mining arguments are accepted and
    ignored, as the reference's are."""
    anc, acx, acy, aw, ah = _anchor_frame(anchor)
    a = anc.shape[0]
    n, o = label.shape[:2]
    vx, vy, vw, vh = variances
    valid = label[..., 0] >= 0                                  # (N, O)
    boxes = label[..., 1:5]
    iou = torch.where(valid[:, None, :], _iou_matrix(anc, boxes),
                      _full(-1.0, label))                       # (N, A, O)
    best_obj = iou.argmax(2)                                    # (N, A)
    best_iou = iou.gather(2, best_obj[..., None])[..., 0]
    best_anchor = iou.argmax(1)                                 # (N, O)
    forced = ((best_anchor[:, :, None] ==
               torch.arange(a, device=anc.device)) &
              valid[:, :, None]).any(1)                         # (N, A)
    pos = (best_iou >= overlap_threshold) | forced
    gt = boxes.gather(1, best_obj[..., None].expand(n, a, 4))
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-12)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-12)
    loc = torch.stack([_fdiv((gcx - acx) / aw, vx),
                       _fdiv((gcy - acy) / ah, vy),
                       _fdiv(_exact(torch.log, gw / aw), vw),
                       _fdiv(_exact(torch.log, gh / ah), vh)], -1)
    loc = torch.where(pos[..., None], loc, torch.zeros_like(loc))
    mask = pos.to(loc.dtype).repeat_interleave(4, dim=1)
    cls = torch.where(pos, label[..., 0].gather(1, best_obj) + 1.0,
                      torch.zeros_like(best_iou))
    return loc.reshape(n, -1), mask, cls


alias("MultiBoxTarget", "_contrib_MultiBoxTarget")


def multibox_rows(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                  variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection's rows before NMS: (N, A, 6) [cls_id, score, x1,
    y1, x2, y2], the decoded boxes and each anchor's best class (-1 and
    score -1 under ``threshold``)."""
    n, c, a = cls_prob.shape
    anc, acx, acy, aw, ah = _anchor_frame(anchor)
    vx, vy, vw, vh = variances
    loc = loc_pred.reshape(n, a, 4)
    cx = loc[..., 0] * vx * aw + acx
    cy = loc[..., 1] * vy * ah + acy
    w = _exact(torch.exp, loc[..., 2] * vw) * aw
    h = _exact(torch.exp, loc[..., 3] * vh) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:]
    best = fg.argmax(1)                                         # (N, A)
    score = fg.gather(1, best[:, None])[:, 0]
    keep = score > threshold
    cls_id = torch.where(keep, best.float(), _full(-1.0, score, torch.float32))
    score = torch.where(keep, score, _full(-1.0, score))
    return torch.cat([cls_id[..., None], score[..., None], boxes], -1)


@op("_contrib_MultiBoxDetection", differentiable=False, wrap=False)
def MultiBoxDetection(cls_prob, loc_pred, anchor, *, clip=True,
                      threshold=0.01, nms_threshold=0.5, force_suppress=False,
                      variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD inference decode: class probabilities (N, C, A), offsets (N,
    A*4), anchors (1, A, 4) -> (N, A, 6) rows [cls_id, score, x1, y1, x2,
    y2] (cls_id -1: background or under ``threshold``), then ``box_nms``
    per class (one kernel launch on the card)."""
    rows = multibox_rows(cls_prob, loc_pred, anchor, clip, threshold,
                         variances)
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


alias("MultiBoxDetection", "_contrib_MultiBoxDetection")


@op("fft", differentiable=False, wrap=False)
def fft(data, *, compute_size=128):
    """Real input -> interleaved [real, imag] along the last axis."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], -1)
    return inter.reshape(tuple(data.shape[:-1]) + (data.shape[-1] * 2,))


@op("ifft", differentiable=False, wrap=False)
def ifft(data, *, compute_size=128):
    """Inverse of ``fft`` (interleaved input), times the length."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2)).float()
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp, dim=-1).real * n


alias("_contrib_fft", "fft")
alias("_contrib_ifft", "ifft")


def _proposal_base(scales, ratios, fs, device):
    """The RPN's base anchors, (A, 4) f32, computed as the reference's:
    ``sqrt(size / r)`` of the f32-rounded quotient, in f32."""
    base = []
    for r in ratios:
        for s in scales:
            size = fs * fs * float(s) * float(s)
            w = torch.sqrt(torch.tensor(size / r, dtype=torch.float32))
            h = w * r
            cx = cy = (fs - 1) / 2.0
            base.append(torch.stack([cx - (w - 1) / 2, cy - (h - 1) / 2,
                                     cx + (w - 1) / 2, cy + (h - 1) / 2]))
    return torch.stack(base).to(device)


def proposal_rows(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_min_size=16, scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                  feature_stride=16):
    """Proposal's rows before NMS: (N, pre, 6) [0, score, x1, y1, x2, y2],
    the ``rpn_pre_nms_top_n`` best anchors' decoded, clipped boxes in
    descending score order (a stable sort), under-``rpn_min_size`` boxes
    scored -1."""
    from .box_nms import score_order

    n, two_a, hh, ww = cls_prob.shape
    a = two_a // 2
    dev = cls_prob.device
    fs = float(feature_stride)
    base = _proposal_base(scales, ratios, fs, dev)
    sx = torch.arange(ww, device=dev).float() * fs
    sy = torch.arange(hh, device=dev).float() * fs
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    anchors = (shifts + base[None]).reshape(-1, 4)
    score = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(n, -1)
    d = bbox_pred.permute(0, 2, 3, 1).reshape(n, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = _exact(torch.exp, d[..., 2].clamp(-10, 10)) * aw
    h = _exact(torch.exp, d[..., 3].clamp(-10, 10)) * ah
    info = im_info[:, :, None]
    x1 = (cx - 0.5 * (w - 1)).clamp_min(0).minimum(info[:, 1] - 1)
    y1 = (cy - 0.5 * (h - 1)).clamp_min(0).minimum(info[:, 0] - 1)
    x2 = (cx + 0.5 * (w - 1)).clamp_min(0).minimum(info[:, 1] - 1)
    y2 = (cy + 0.5 * (h - 1)).clamp_min(0).minimum(info[:, 0] - 1)
    min_sz = rpn_min_size * info[:, 2]
    ok = ((x2 - x1 + 1) >= min_sz) & ((y2 - y1 + 1) >= min_sz)
    score = torch.where(ok, score, _full(-1.0, score))
    order = score_order(score)[:, :min(rpn_pre_nms_top_n, anchors.shape[0])]
    return torch.stack([torch.zeros_like(order, dtype=score.dtype)] +
                       [t.gather(1, order) for t in (score, x1, y1, x2, y2)],
                       -1)


@op("_contrib_Proposal", differentiable=False, wrap=False)
def Proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """The RPN's proposals: ``proposal_rows`` (anchors over the feature
    grid, decoded deltas, clipped, small boxes scored -1, the best
    ``rpn_pre_nms_top_n``), ``box_nms`` at ``threshold``, the
    ``rpn_post_nms_top_n`` best -> rois (N*post, 5) [batch_idx, x1, y1,
    x2, y2] (and scores (N*post, 1))."""
    from .box_nms import score_order

    rows = proposal_rows(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                         rpn_min_size, scales, ratios, feature_stride)
    n, pre = rows.shape[:2]
    kept = box_nms(rows, overlap_thresh=threshold, valid_thresh=0.0, topk=-1,
                   coord_start=2, score_index=1, id_index=0,
                   force_suppress=True)
    post = min(rpn_post_nms_top_n, pre)
    order2 = score_order(kept[..., 1])[:, :post]
    sel = kept.gather(1, order2[..., None].expand(n, post, 6))
    batch_idx = torch.arange(n, device=rows.device).float() \
        .repeat_interleave(post)
    rois = torch.cat([batch_idx[:, None], sel[..., 2:6].reshape(-1, 4)], -1)
    if output_score:
        return rois, sel[..., 1:2].reshape(-1, 1)
    return rois


alias("Proposal", "_contrib_Proposal")


@op("_contrib_DeformableConvolution", wrap=False)
def DeformableConvolution(data, offset, weight, bias=None, *, kernel=(),
                          stride=(), dilate=(), pad=(), num_filter=0,
                          num_group=1, num_deformable_group=1, no_bias=False,
                          layout="NCHW", workspace=1024):
    """Deformable convolution v1: ``data`` (N, C, H, W) sampled
    bilinearly at each tap's offset point (``offset`` (N, 2*G*kh*kw, Ho,
    Wo), (dy, dx) pairs a deformable group G and tap), then one (N*Ho*Wo,
    C*kh*kw) x (C*kh*kw, F) product.  Each channel group is sampled only
    at its own group's offsets (the reference samples every group for
    every channel and keeps the diagonal: the same values with G times the
    memory)."""
    kh, kw = kernel
    sh, sw = _pair(stride or 1, 2)
    dh, dw = _pair(dilate or 1, 2)
    ph, pw = _pair(pad or 0, 2)
    n, c, hh, ww = data.shape
    ho = (hh + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (ww + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    g = num_deformable_group
    k = kh * kw
    dev = data.device
    oy = torch.arange(ho, device=dev) * sh - ph
    ox = torch.arange(wo, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    off = offset.reshape(n, g, k, 2, ho, wo)
    sy = base_y.permute(2, 0, 1)[None, None] + off[:, :, :, 0]
    sx = base_x.permute(2, 0, 1)[None, None] + off[:, :, :, 1]
    # (N, G, K, Ho, Wo) -> (N*G, Ho, Wo, K): the reference's tap order
    sy = sy.permute(0, 1, 3, 4, 2).reshape(n * g, ho, wo, k)
    sx = sx.permute(0, 1, 3, 4, 2).reshape(n * g, ho, wo, k)
    cg = c // g
    cols = _bilinear_at(data.reshape(n * g, cg, hh * ww), sy, sx, hh, ww)
    cols = cols.reshape(n, c, ho, wo, k)
    cols2 = cols.permute(0, 2, 3, 1, 4).reshape(n * ho * wo, c * k)
    wmat = weight.reshape(num_filter, c * k).t()
    out = torch.matmul(cols2, wmat).reshape(n, ho, wo, num_filter)
    out = out.permute(0, 3, 1, 2)
    if not no_bias and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


alias("DeformableConvolution", "_contrib_DeformableConvolution")


@op("Correlation", wrap=False)
def Correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation: for each displacement (dy, dx) within
    ``max_displacement`` (step ``stride2``) the channel mean of ``data1``
    times ``data2`` shifted by it, 0 where the shift leaves the padded
    grid, box-summed over ``kernel_size`` ("SAME") and divided by its
    area, cropped by ``max_displacement`` + the kernel radius, every
    ``stride1``-th position -> (N, D*D, Ho, Wo).  Each displacement
    multiplies two slices of the padded inputs (views), so autograd keeps
    no shifted copy (the reference rolls a whole copy each time)."""
    n, c, h, w = data1.shape
    p = pad_size
    a = F.pad(data1, (p, p, p, p))
    b = F.pad(data2, (p, p, p, p))
    hp, wp = h + 2 * p, w + 2 * p
    steps = max_displacement // stride2
    disps = [d * stride2 for d in range(-steps, steps + 1)]
    ksz = kernel_size
    border = max_displacement + (ksz - 1) // 2
    outs = []
    for dy in disps:
        for dx in disps:
            y0, y1 = max(0, -dy), hp - max(0, dy)
            x0, x1 = max(0, -dx), wp - max(0, dx)
            if y1 <= y0 or x1 <= x0:
                corr = a.new_zeros((n, hp, wp))
            else:
                sa = a[:, :, y0:y1, x0:x1]
                sb = b[:, :, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
                prod = sa * sb if is_multiply else (sa - sb).abs()
                corr = F.pad(prod.mean(1), (x0, wp - x1, y0, hp - y1))
            if ksz > 1:
                lo, hi = (ksz - 1) // 2, ksz // 2
                corr = F.avg_pool2d(F.pad(corr, (lo, hi, lo, hi))[:, None],
                                    ksz, stride=1, divisor_override=1)[:, 0]
                corr = _fdiv(corr, ksz * ksz)
            outs.append(corr)
    out = torch.stack(outs, 1)
    return out[:, :, border:hp - border:stride1, border:wp - border:stride1]
