"""Operator-corpus extensions: the spatial-transformer pipeline, LRN,
cumulative ops, indexing utilities, the bitwise family, masked softmax,
reductions and statistics, array manipulation and the remaining tensor
ops of the reference's test surface.

Port of ``mxnet_tpu/ops/extended.py``, name for name, with NumPy's
semantics where the reference calls ``jnp``:

- ``median`` averages the two middle values and ``quantile``/
  ``percentile`` take the ``method=`` names (``linear``, ``lower``,
  ``higher``, ``midpoint``, ``nearest``) through one sort
  (``_quantile``); ``torch.median`` returns the lower middle value and
  ``torch.quantile`` refuses inputs over 2**24 elements.
- ``unique_op`` and ``bincount_op`` keep static output sizes (padding
  with ``fill_value``, dropping counts at or past ``length``; a bincount
  without a length raises), with no host read.
- ``masked_softmax``/``masked_log_softmax`` fill masked entries with
  ``-1e30`` and zero them (``-inf`` for the log) afterwards, so a fully
  masked row is all zeros (all ``-inf``).
- ``left_shift``/``right_shift`` go through int64 (``jnp``'s results for
  shifts past the width), ``gcd``/``lcm`` too; ``floor_divide``,
  ``remainder`` and ``fmod`` keep NumPy's sign conventions (torch's
  match them).
- ``interp_op``, ``trapz_op``, ``polyval_op``, ``resize_op`` (cyclic)
  and ``khatri_rao`` are written out as the reference defines them.
- ``digamma`` is torch's: -inf at 0 where the reference gives nan.
- ``clip_global_norm`` computes its norm with ``global_norm_sq``, the
  body ``gluon.utils.clip_global_norm`` uses too, and never reads it back
  to the host.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .defs import _dims, _float, _int_result
from .nn import _full
from .registry import alias, get_op, op

__all__ = [
    "SpatialTransformer", "LRN", "cumsum", "cumprod", "batch_take",
    "digamma", "moments", "ravel_multi_index", "unravel_index",
    "masked_softmax", "masked_log_softmax", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "left_shift", "right_shift", "tril",
    "triu", "trace", "tensordot", "kron", "outer", "khatri_rao",
    "index_array", "arange_like", "allclose_op", "logsumexp",
    "log1mexp", "relu6", "hard_swish", "logaddexp", "ldexp",
    "copysign", "heaviside", "nextafter", "hypot", "floor_divide",
    "remainder", "fmod", "gcd", "lcm", "isnan", "isinf", "isfinite",
    "isposinf", "isneginf", "searchsorted", "bincount_op", "diff",
    "ediff1d", "interp_op", "trapz_op", "cross_op", "vdot_op",
    "inner_op", "polyval_op", "unique_op", "global_norm_sq",
]


# --------------------------------------------------------------------------- #
# spatial transformer networks: GridGenerator + BilinearSampler
# --------------------------------------------------------------------------- #

@op("SpatialTransformer")
def SpatialTransformer(data, loc, *, target_shape=(0, 0),
                       transform_type="affine", sampler_type="bilinear",
                       cudnn_off=False):
    """Affine grid from ``loc`` (N, 6), then bilinear sampling of NCHW
    ``data``: the port's ``GridGenerator`` and ``BilinearSampler``."""
    grid = get_op("GridGenerator").fn(loc, transform_type=transform_type,
                                      target_shape=tuple(target_shape))
    return get_op("BilinearSampler").fn(data, grid)


@op("LRN")
def LRN(data, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels:
    ``x / (k + alpha / n * sum(x**2 over the window)) ** beta``; the
    window sum is a difference of channel cumulative sums."""
    sq = torch.square(data)                             # (N, C, H, W)
    half = nsize // 2
    padded = torch.nn.functional.pad(sq, (0, 0, 0, 0, half, half))
    csum = torch.nn.functional.pad(torch.cumsum(padded, dim=1),
                                   (0, 0, 0, 0, 1, 0))
    win = csum[:, nsize:] - csum[:, :-nsize]
    norm = (knorm + alpha / nsize * win) ** beta
    return data / norm


# --------------------------------------------------------------------------- #
# cumulative / scan
# --------------------------------------------------------------------------- #

def _cum(fn, a, axis, dtype):
    x = a.reshape(-1) if axis is None else a
    out = fn(x, dim=0 if axis is None else axis)
    if not a.is_floating_point() and a.dtype != torch.int64:
        out = out.to(torch.int32)
    return out.to(torch_dtype(dtype)) if dtype else out


@op("cumsum")
def cumsum(a, *, axis=None, dtype=None):
    return _cum(torch.cumsum, a, axis, dtype)


@op("cumprod")
def cumprod(a, *, axis=None, dtype=None):
    return _cum(torch.cumprod, a, axis, dtype)


@op("logsumexp")
def logsumexp(data, *, axis=None, keepdims=False):
    return torch.logsumexp(data, dim=_dims(axis, data.dim()),
                           keepdim=keepdims)


# --------------------------------------------------------------------------- #
# indexing utilities
# --------------------------------------------------------------------------- #

@op("batch_take")
def batch_take(a, indices):
    """out[i] = a[i, indices[i]] (negative indices count from the end)."""
    idx = indices.to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + a.shape[1], idx)
    return torch.gather(a, 1, idx[:, None])[:, 0]


@op("ravel_multi_index", differentiable=False)
def ravel_multi_index(data, *, shape):
    """(ndim, n) coordinate rows -> flat indices."""
    strides, s = [], 1
    for d in reversed(shape):
        strides.append(s)
        s *= d
    out = data[0] * strides[-1]
    for i, st in enumerate(reversed(strides[:-1]), start=1):
        out = out + data[i] * st
    return out


@op("unravel_index", differentiable=False)
def unravel_index(data, *, shape):
    """flat indices -> (ndim, n) coordinate rows; an index past the end
    maps to the last position, one below -1 to the first (jnp's
    clamping; -1 is the last element)."""
    idx = data.to(torch.int64).reshape(-1)
    coords = [None] * len(shape)
    for i, s in reversed(list(enumerate(shape))):
        idx, coords[i] = torch.div(idx, s, rounding_mode="floor"), \
            torch.remainder(idx, s)
    oob_pos, oob_neg = idx > 0, idx < -1
    out = [torch.where(oob_pos, s - 1, torch.where(oob_neg, 0, c))
           for s, c in zip(shape, coords)]
    return torch.stack(out, dim=0).to(data.dtype)


@op("index_array", differentiable=False)
def index_array(data, *, axes=None):
    """An int32 array whose value at (i, j, ...) is its own index vector
    along ``axes`` (the reference's effective dtype)."""
    shape = tuple(data.shape)
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    comps = []
    for ax in axes:
        view = [1] * len(shape)
        view[ax] = shape[ax]
        comps.append(torch.arange(shape[ax], dtype=torch.int32,
                                  device=data.device).reshape(view)
                     .expand(shape))
    return torch.stack(comps, dim=-1)


@op("arange_like", differentiable=False)
def arange_like(data, *, start=0.0, step=1.0, repeat=1, axis=None):
    """arange shaped like the input (or of its ``axis`` length), in the
    input's dtype."""
    dev = data.device
    if axis is None:
        n = data.numel()
        m = -(-n // repeat)                     # distinct values
        out = start + step * torch.arange(m, dtype=data.dtype, device=dev)
        return torch.repeat_interleave(out, repeat)[:n].reshape(data.shape)
    n = data.shape[axis]
    return start + step * torch.arange(n, dtype=data.dtype, device=dev)


@op("searchsorted", differentiable=False)
def searchsorted(a, v, *, side="left"):
    dt = torch.result_type(a, v)
    return torch.searchsorted(a.to(dt).contiguous(), v.to(dt).contiguous(),
                              right=side == "right", out_int32=True)


@op("unique_op", differentiable=False)
def unique_op(data, *, size=None, fill_value=0):
    """The sorted distinct values of ``data``, padded with ``fill_value``
    (or cut) to ``size`` (default: the input's size).  Static shapes:
    each distinct value is scattered to its rank, no host read."""
    n = size or data.numel()
    s = torch.sort(data.reshape(-1)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = torch.where(first & (rank < n), rank, torch.full_like(rank, n))
    out = torch.full((n + 1,), fill_value, dtype=s.dtype, device=s.device)
    return out.scatter(0, slot, s)[:n]


# --------------------------------------------------------------------------- #
# masked softmax family
# --------------------------------------------------------------------------- #

def _masked_scores(data, mask, temperature):
    s = data / _full(temperature, data)
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, _full(-1e30, s))
    return s


@op("masked_softmax")
def masked_softmax(data, mask=None, *, axis=-1, temperature=1.0,
                   normalize=True):
    p = torch.softmax(_masked_scores(data, mask, temperature), dim=axis)
    if mask is not None:
        p = torch.where(mask.to(torch.bool), p, torch.zeros_like(p))
    return p


@op("masked_log_softmax")
def masked_log_softmax(data, mask=None, *, axis=-1, temperature=1.0):
    out = torch.log_softmax(_masked_scores(data, mask, temperature),
                            dim=axis)
    if mask is not None:
        out = torch.where(mask.to(torch.bool), out,
                          _full(-math.inf, out))
    return out


# --------------------------------------------------------------------------- #
# bitwise / integer ops
# --------------------------------------------------------------------------- #

@op("bitwise_and", differentiable=False)
def bitwise_and(a, b):
    return torch.bitwise_and(a, b)


@op("bitwise_or", differentiable=False)
def bitwise_or(a, b):
    return torch.bitwise_or(a, b)


@op("bitwise_xor", differentiable=False)
def bitwise_xor(a, b):
    return torch.bitwise_xor(a, b)


@op("bitwise_not", differentiable=False)
def bitwise_not(a):
    return torch.bitwise_not(a)


def _shift(a, b, left):
    """``a << b`` / ``a >> b`` in the promoted integer dtype, through
    int64: a shift by a negative count or by the width or more gives 0
    (``<<``, logical ``>>``) or the sign fill (arithmetic ``>>``)."""
    dt = torch.result_type(a, b)
    width = torch.iinfo(dt).bits
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    oob = (b64 < 0) | (b64 >= width)
    sh = b64.clamp(0, width - 1)
    if left:
        out = torch.where(oob, torch.zeros_like(a64), a64 << sh)
    else:
        fill = torch.where(a64 < 0, torch.full_like(a64, -1),
                           torch.zeros_like(a64))
        out = torch.where(oob, fill, a64 >> sh)
    return out.to(dt)


@op("left_shift", differentiable=False)
def left_shift(a, b):
    return _shift(a, b, True)


@op("right_shift", differentiable=False)
def right_shift(a, b):
    return _shift(a, b, False)


@op("gcd", differentiable=False)
def gcd(a, b):
    return torch.gcd(a.to(torch.int64), b.to(torch.int64)).to(a.dtype)


@op("lcm", differentiable=False)
def lcm(a, b):
    return torch.lcm(a.to(torch.int64), b.to(torch.int64)).to(a.dtype)


# --------------------------------------------------------------------------- #
# triangles / contractions
# --------------------------------------------------------------------------- #

@op("tril")
def tril(data, *, k=0):
    return torch.tril(data, diagonal=k)


@op("triu")
def triu(data, *, k=0):
    return torch.triu(data, diagonal=k)


@op("trace")
def trace(data, *, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(data, offset=offset, dim1=axis1, dim2=axis2)
    return _int_result(d.sum(-1), data)


@op("tensordot")
def tensordot(a, b, *, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else x
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


@op("kron")
def kron(a, b):
    return torch.kron(a, b)


@op("outer")
def outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


@op("vdot_op")
def vdot_op(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


@op("inner_op")
def inner_op(a, b):
    return torch.inner(a, b)


@op("cross_op")
def cross_op(a, b, *, axisa=-1, axisb=-1, axisc=-1, axis=None):
    """The cross product of 3-vectors (and 2-vectors, as NumPy: the z
    component for two, a zero-padded product for one) along ``axisa`` /
    ``axisb``, placed along ``axisc``; ``axis`` sets all three."""
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.movedim(a, axisa, -1), torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = torch.nn.functional.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = torch.nn.functional.pad(b, (0, 1))
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    out = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                       a0 * b1 - a1 * b0], dim=-1)
    return torch.movedim(out, -1, axisc)


@op("khatri_rao", variadic=True)
def khatri_rao(*matrices):
    """Column-wise Kronecker product."""
    out = matrices[0]
    for m in matrices[1:]:
        n = out.shape[1]
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, n)
    return out


# --------------------------------------------------------------------------- #
# pointwise additions
# --------------------------------------------------------------------------- #

def _clip(x, lo, hi):
    """``jnp.clip``: a maximum then a minimum against scalars (ties split
    the gradient, as jax's)."""
    return torch.minimum(torch.maximum(x, _full(lo, x)), _full(hi, x))


@op("digamma")
def digamma(data):
    return torch.digamma(data)


@op("relu6")
def relu6(data):
    return _clip(data, 0.0, 6.0)


@op("hard_swish")
def hard_swish(data):
    return data * _clip(data + 3.0, 0.0, 6.0) / 6.0


@op("log1mexp")
def log1mexp(data):
    """log(1 - exp(x)) for x < 0, numerically stable."""
    return torch.where(data > -0.6931471805599453,          # -log 2
                       torch.log(-torch.expm1(data)),
                       torch.log1p(-torch.exp(data)))


@op("logaddexp")
def logaddexp(a, b):
    return torch.logaddexp(a, b)


@op("ldexp")
def ldexp(a, b):
    return a * torch.pow(2.0, b)


@op("copysign")
def copysign(a, b):
    return torch.copysign(a, b)


@op("heaviside", differentiable=False)
def heaviside(a, b):
    """0 below zero, ``b`` at zero, 1 above."""
    dt = torch.result_type(a, b)
    a, b = a.to(dt), b.to(dt)
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


@op("nextafter", differentiable=False)
def nextafter(a, b):
    dt = torch.result_type(a, b)
    return torch.nextafter(a.to(dt), b.to(dt))


@op("hypot")
def hypot(a, b):
    return torch.hypot(a, b)


@op("floor_divide", differentiable=False)
def floor_divide(a, b):
    return torch.floor_divide(a, b)


@op("remainder", differentiable=False)
def remainder(a, b):
    return torch.remainder(a, b)


@op("fmod", differentiable=False)
def fmod(a, b):
    return torch.fmod(a, b)


@op("isnan", differentiable=False)
def isnan(a):
    return torch.isnan(a)


@op("isinf", differentiable=False)
def isinf(a):
    return torch.isinf(a)


@op("isfinite", differentiable=False)
def isfinite(a):
    return torch.isfinite(a)


@op("isposinf", differentiable=False)
def isposinf(a):
    return torch.isposinf(a)


@op("isneginf", differentiable=False)
def isneginf(a):
    return torch.isneginf(a)


# --------------------------------------------------------------------------- #
# statistics / numerics
# --------------------------------------------------------------------------- #

@op("moments")
def moments(data, *, axes=None, keepdims=False):
    """(mean, variance) over ``axes``: two passes, the variance the mean
    of the squared deviations from the mean."""
    dims = _dims(axes, data.dim())
    mean = torch.mean(data, dim=dims, keepdim=keepdims)
    mk = mean
    if not keepdims:
        for d in sorted(d % data.dim() for d in dims):
            mk = mk.unsqueeze(d)
    var = torch.mean(torch.square(data - mk), dim=dims, keepdim=keepdims)
    return mean, var


@op("bincount_op", differentiable=False)
def bincount_op(data, weights=None, *, minlength=0, length=None):
    """Counts (or summed weights) of the values in [0, ``length``):
    negative values count as 0 and values at or past the length are
    dropped.  Static length: ``length`` or ``minlength`` is required."""
    n = length or minlength
    if not n:
        raise ValueError("bincount_op needs a static length= or "
                         "minlength= bound")
    x = data.reshape(-1).to(torch.int64).clamp_min(0)
    keep = x < n
    w = torch.ones_like(x, dtype=torch.int32) if weights is None \
        else weights.reshape(-1)
    w = torch.where(keep, w, torch.zeros_like(w))
    out = torch.zeros(n, dtype=w.dtype, device=x.device)
    return out.index_add(0, torch.where(keep, x, torch.zeros_like(x)), w)


@op("diff")
def diff(a, *, n=1, axis=-1):
    return torch.diff(a, n=n, dim=axis)


@op("ediff1d")
def ediff1d(a):
    return torch.diff(a.reshape(-1))


@op("interp_op")
def interp_op(x, xp, fp, *, left=None, right=None):
    """One-dimensional linear interpolation (``jnp.interp``): the segment
    from ``searchsorted(xp, x, 'right')`` clipped to [1, len - 1], a
    zero-width segment giving its left value, and ``left``/``right``
    (default: the end values) outside ``xp``."""
    x, xp, fp = _float(x), _float(xp), _float(fp)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = torch.abs(dx) <= eps * eps        # np.spacing(eps): eps is 2**k
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    lo = fp[0] if left is None else _full(left, f)
    hi = fp[-1] if right is None else _full(right, f)
    f = torch.where(x < xp[0], lo, f)
    return torch.where(x > xp[-1], hi, f)


@op("trapz_op")
def trapz_op(y, x=None, *, dx=1.0, axis=-1):
    """The composite trapezoidal rule along ``axis``:
    ``0.5 * sum(dx * (y[1:] + y[:-1]))``."""
    y = _float(y)
    if x is None:
        d = dx
    elif x.dim() == 1:
        d = torch.diff(_float(x))
    else:
        d = torch.movedim(torch.diff(_float(x), dim=axis), axis, -1)
    y = torch.movedim(y, axis, -1)
    return 0.5 * (d * (y[..., 1:] + y[..., :-1])).sum(-1)


@op("polyval_op")
def polyval_op(p, x):
    """Horner's rule over the coefficients, highest first."""
    dt = torch.promote_types(_float(p).dtype, _float(x).dtype)
    p, x = p.to(dt), x.to(dt)
    y = torch.zeros(torch.broadcast_shapes(p.shape[1:], x.shape),
                    dtype=dt, device=x.device)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@op("allclose_op", differentiable=False)
def allclose_op(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    dt = torch.promote_types(_float(a).dtype, _float(b).dtype)
    return torch.all(torch.isclose(a.to(dt), b.to(dt), rtol=rtol,
                                   atol=atol, equal_nan=equal_nan))


# reference-name aliases
alias("_ravel_multi_index", "ravel_multi_index")
alias("_unravel_index", "unravel_index")
alias("_contrib_index_array", "index_array")
alias("_contrib_arange_like", "arange_like")
alias("_contrib_allclose", "allclose_op")
alias("softmax_cross_entropy_mask", "masked_log_softmax")


# --------------------------------------------------------------------------- #
# reductions / statistics
# --------------------------------------------------------------------------- #

@op("var")
def var(a, *, axis=None, ddof=0, keepdims=False):
    return torch.var(_float(a), dim=_dims(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


@op("std")
def std(a, *, axis=None, ddof=0, keepdims=False):
    return torch.std(_float(a), dim=_dims(axis, a.dim()), correction=ddof,
                     keepdim=keepdims)


@op("ptp")
def ptp(a, *, axis=None, keepdims=False):
    dims = _dims(axis, a.dim())
    return torch.amax(a, dim=dims, keepdim=keepdims) - \
        torch.amin(a, dim=dims, keepdim=keepdims)


def _quantile(a, q, axis, method, keepdims):
    """``jnp.quantile``: a slice holding a NaN gives NaN; otherwise the
    sorted slice at ``q * (n - 1)`` (f32 positions), combined as
    ``method`` says."""
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    a = _float(a)
    nd = a.dim()
    keep_shape = None
    if axis is None:
        keep_shape = [1] * nd if keepdims else None
        a, axis = a.reshape(-1), 0
    elif isinstance(axis, (list, tuple)):
        axes = tuple(a % nd for a in _dims(axis, nd))
        keep_shape = [1 if i in axes else s for i, s in enumerate(a.shape)]
        rest = [i for i in range(nd) if i not in axes]
        a = a.permute(rest + list(axes))
        a = a.reshape(tuple(a.shape[:len(rest)]) + (-1,))
        axis = a.dim() - 1
    else:
        axis = axis % nd
    q = torch.as_tensor(q, dtype=torch.float32).to(a.device) \
        if not isinstance(q, torch.Tensor) else q.to(torch.float32)
    a = torch.where(torch.isnan(a).any(dim=axis, keepdim=True),
                    _full(math.nan, a), a)
    a = torch.sort(a, dim=axis).values
    n = a.shape[axis]
    pos = q * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).to(torch.int64)
    high = high.clamp(0, n - 1).to(torch.int64)
    qdim = q.dim()

    def take(idx):
        v = torch.index_select(a, axis, idx.reshape(-1))
        v = torch.movedim(v, axis, 0)
        if qdim == 0:
            v = v[0]
        if keepdims and keep_shape is None:
            v = v.unsqueeze(axis + qdim)
        return v

    lo_v, hi_v = take(low), take(high)
    extra = lo_v.dim() - qdim
    lw = lw.reshape(tuple(lw.shape) + (1,) * extra)
    hw = hw.reshape(tuple(hw.shape) + (1,) * extra)
    if method == "linear":
        out = lo_v.to(torch.float32) * lw + hi_v.to(torch.float32) * hw
    elif method == "lower":
        out = lo_v
    elif method == "higher":
        out = hi_v
    elif method == "nearest":
        out = torch.where(hw <= 0.5, lo_v, hi_v)
    else:
        out = (lo_v + hi_v) * 0.5
    if keepdims and keep_shape is not None:
        out = out.reshape(tuple(q.shape) + tuple(keep_shape))
    return out.to(a.dtype)


@op("median")
def median(a, *, axis=None, keepdims=False):
    """The mean of the two middle values for an even count (``jnp``'s
    ``midpoint``)."""
    return _quantile(a, 0.5, axis, "midpoint", keepdims)


@op("percentile")
def percentile(a, *, q, axis=None, keepdims=False,
               interpolation="linear"):
    qt = torch.as_tensor(q, dtype=torch.float32).to(a.device)
    return _quantile(a, qt / _full(100.0, qt), axis, interpolation,
                     keepdims)


@op("quantile")
def quantile(a, *, q, axis=None, keepdims=False, interpolation="linear"):
    return _quantile(a, q, axis, interpolation, keepdims)


@op("average")
def average(a, weights=None, *, axis=None):
    """The mean, or with ``weights`` (the shape of ``a``, or 1-D along
    ``axis``) ``sum(a * w) / sum(w)``."""
    a = _float(a)
    if weights is None:
        return torch.mean(a, dim=_dims(axis, a.dim()))
    w = weights.to(a.dtype)
    if w.shape != a.shape:
        view = [1] * a.dim()
        view[axis % a.dim()] = w.shape[0]
        w = w.reshape(view)
    dims = _dims(axis, a.dim())
    return torch.sum(a * w, dim=dims) / \
        torch.sum(w.expand(a.shape), dim=dims)


def _nancount(a, dims, keepdims):
    return torch.sum(~torch.isnan(a), dim=dims, keepdim=keepdims)


def _nanmean(a, dims, keepdims):
    """The sum of the non-NaN values over their count (an all-NaN slice
    gives NaN, and no gradient reaches its inputs, as in jax)."""
    total = torch.sum(torch.where(torch.isnan(a), torch.zeros_like(a), a),
                      dim=dims, keepdim=keepdims)
    return total / _nancount(a, dims, keepdims).to(a.dtype)


@op("nanmean")
def nanmean(a, *, axis=None, keepdims=False):
    a = _float(a)
    return _nanmean(a, _dims(axis, a.dim()), keepdims)


@op("nanvar")
def nanvar(a, *, axis=None, ddof=0, keepdims=False):
    """``jnp.nanvar``: the squared deviations from the NaN-free mean over
    the count of non-NaN values less ``ddof`` (NaN where that is not
    positive)."""
    a = _float(a)
    dims = _dims(axis, a.dim())
    mean = _nanmean(a, dims, True)
    nan = torch.isnan(a)
    centered = torch.where(nan, torch.zeros_like(a), a - mean)
    total = torch.sum(torch.square(centered), dim=dims, keepdim=keepdims)
    count = (_nancount(a, dims, keepdims) - ddof).to(a.dtype)
    return torch.where(count > 0, total / count, _full(math.nan, total))


@op("nanstd")
def nanstd(a, *, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(nanvar.__wrapped__(a, axis=axis, ddof=ddof,
                                         keepdims=keepdims))


def _nanext(a, axis, keepdims, fn, fill):
    dims = _dims(axis, a.dim())
    nan = torch.isnan(a)
    out = fn(torch.where(nan, _full(fill, a), a), dim=dims,
             keepdim=keepdims)
    return torch.where(nan.all(dim=dims, keepdim=keepdims) if dims
                       else nan, _full(math.nan, out), out)


@op("nanmax")
def nanmax(a, *, axis=None, keepdims=False):
    return _nanext(a, axis, keepdims, torch.amax, -math.inf)


@op("nanmin")
def nanmin(a, *, axis=None, keepdims=False):
    return _nanext(a, axis, keepdims, torch.amin, math.inf)


def _nanarg(a, axis, fn, fill):
    nan = torch.isnan(a)
    x = torch.where(nan, _full(fill, a), a)
    if axis is None:
        return torch.where(nan.all(), -1, fn(x)).to(torch.int32)
    return torch.where(nan.all(dim=axis), -1, fn(x, dim=axis)).to(
        torch.int32)


@op("nanargmax", differentiable=False)
def nanargmax(a, *, axis=None):
    """Index of the largest non-NaN value; -1 for an all-NaN slice."""
    return _nanarg(a, axis, torch.argmax, -math.inf)


@op("nanargmin", differentiable=False)
def nanargmin(a, *, axis=None):
    return _nanarg(a, axis, torch.argmin, math.inf)


@op("count_nonzero", differentiable=False)
def count_nonzero(a, *, axis=None, keepdims=False):
    return torch.sum(a != 0, dim=_dims(axis, a.dim()),
                     keepdim=keepdims).to(torch.int32)


@op("histogram_op", differentiable=False)
def histogram_op(data, *, bin_cnt=10, range=None):
    """Counts over ``bin_cnt`` equal bins of ``range`` (default (0, 1))
    and the ``bin_cnt + 1`` edges (``jnp.histogram``: the last bin
    includes its right edge, values outside are dropped; the counts in
    the data's float dtype)."""
    lo, hi = range if range is not None else (0.0, 1.0)
    x = _float(data).reshape(-1)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    dev, dt = x.device, x.dtype
    step = torch.arange(bin_cnt, dtype=dt, device=dev) / \
        _full(float(bin_cnt), x)
    edges = torch.cat([_full(lo, x) * (1.0 - step) + _full(hi, x) * step,
                       _full(hi, x).reshape(1)])
    idx = torch.searchsorted(edges, x.contiguous(), right=True)
    idx = torch.where(x == edges[-1], bin_cnt, idx)
    keep = idx <= bin_cnt
    counts = torch.zeros(bin_cnt + 2, dtype=dt, device=dev).index_add(
        0, torch.where(keep, idx, bin_cnt + 1),
        torch.ones_like(x))
    return counts[1:bin_cnt + 1], edges


# --------------------------------------------------------------------------- #
# array manipulation
# --------------------------------------------------------------------------- #

@op("roll")
def roll(a, *, shift, axis=None):
    sh = tuple(shift) if isinstance(shift, (list, tuple)) else shift
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.roll(a, sh, dims=ax)


@op("rot90")
def rot90(a, *, k=1, axes=(0, 1)):
    return torch.rot90(a, k, dims=list(axes))


@op("fliplr")
def fliplr(a):
    return torch.fliplr(a)


@op("flipud")
def flipud(a):
    return torch.flipud(a)


@op("atleast_1d")
def atleast_1d(a):
    return torch.atleast_1d(a)


@op("atleast_2d")
def atleast_2d(a):
    return torch.atleast_2d(a)


@op("atleast_3d")
def atleast_3d(a):
    return torch.atleast_3d(a)


@op("hstack", variadic=True)
def hstack(*arrays):
    return torch.hstack(list(arrays))


@op("vstack", variadic=True)
def vstack(*arrays):
    return torch.vstack(list(arrays))


@op("dstack", variadic=True)
def dstack(*arrays):
    return torch.dstack(list(arrays))


@op("column_stack", variadic=True)
def column_stack(*arrays):
    return torch.column_stack(list(arrays))


@op("meshgrid", variadic=True)
def meshgrid(*arrays, indexing="xy"):
    return tuple(torch.meshgrid(*arrays, indexing=indexing))


@op("hsplit")
def hsplit(a, *, indices_or_sections):
    return tuple(torch.hsplit(a, _sections(indices_or_sections)))


@op("vsplit")
def vsplit(a, *, indices_or_sections):
    return tuple(torch.vsplit(a, _sections(indices_or_sections)))


@op("dsplit")
def dsplit(a, *, indices_or_sections):
    return tuple(torch.dsplit(a, _sections(indices_or_sections)))


def _sections(s):
    return list(s) if isinstance(s, (list, tuple)) else s


@op("moveaxis")
def moveaxis(a, *, source, destination):
    return torch.movedim(a, source, destination)


@op("rollaxis")
def rollaxis(a, *, axis, start=0):
    """NumPy's ``rollaxis``: ``axis`` moved to stand before ``start``."""
    n = a.dim()
    axis = axis % n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    if axis == start:
        return a
    order = [i for i in range(n) if i != axis]
    order.insert(start, axis)
    return a.permute(order)


@op("nan_to_num")
def nan_to_num(a, *, copy=True, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


@op("resize_op")
def resize_op(a, *, new_shape):
    """``np.resize``: the flattened input repeated cyclically to the new
    size, reshaped."""
    new_shape = tuple(new_shape)
    total = math.prod(new_shape)
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(new_shape, dtype=a.dtype, device=a.device)
    reps = -(-total // flat.numel())
    return flat.repeat(reps)[:total].reshape(new_shape)


@op("broadcast_arrays", variadic=True)
def broadcast_arrays(*arrays):
    return tuple(torch.broadcast_tensors(*arrays))


@op("squared_difference")
def squared_difference(a, b):
    return torch.square(a - b)


@op("reset_arrays", variadic=True, differentiable=False)
def reset_arrays(*arrays, num_arrays=None):
    """Zeros like each array (the reference returns new zero arrays)."""
    return tuple(torch.zeros_like(a) for a in arrays)


def global_norm_sq(tensors):
    """The sum of squares of every element of ``tensors``, in float32, as
    a device scalar (the body of the ``clip_global_norm`` op and of
    ``gluon.utils.clip_global_norm``)."""
    return torch.stack([t.detach().to(torch.float32).square().sum()
                        for t in tensors]).sum()


@op("clip_global_norm", variadic=True, differentiable=False)
def clip_global_norm(*arrays, max_norm, scale=1.0):
    """Every array times ``min(1, max_norm / (|g| * scale + 1e-12))``,
    ``|g|`` the global L2 norm (no host read)."""
    total = torch.sqrt(global_norm_sq(arrays))
    ratio = torch.clamp_max(_full(max_norm, total) / (total * scale + 1e-12),
                            1.0)
    return tuple((a * ratio).to(a.dtype) for a in arrays)
