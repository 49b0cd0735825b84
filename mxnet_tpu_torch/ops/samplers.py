"""Registered random-sampling ops, the fused multi-tensor optimizer
updates, two int8 inference ops and the contrib stragglers.

Port of ``mxnet_tpu/ops/samplers.py``, name for name:

- ``_random_*``: tensor-shaped draws with scalar parameters, made on the
  current context's device.
- ``sample_*``: per-element parameter arrays; ``sample_normal(mu, sigma,
  shape=(s,))`` draws ``s`` values for every element of ``mu`` (the
  output shape is the parameter's shape + ``shape``).
- ``multi_adamw_update``, ``multi_lamb_update`` and the
  ``preloaded_multi_*`` SGD updates (variadic; a loop over the
  per-tensor body, as the reference's).  The ``preloaded_`` ops read
  ``lrs``/``wds`` as device arrays and never read them back to the host,
  so a CUDA graph captures them.
- ``quantized_pooling_int8``/``quantized_act_int8`` with their own affine
  int8 convention (below), ``_contrib_index_copy``/``_contrib_index_add``,
  ``_contrib_div_sqrt_dim``, ``_contrib_gradientmultiplier``,
  ``quadratic`` and ``IdentityAttachKLSparseReg``.

Every draw takes one ``random.next_key()`` and derives its values from
it (``random.key_bits``): counter-based, so a draw under a program's
traced key is fresh at every replay and equals the eager call under the
same key.  Uniform, randint, bernoulli and shuffle are closed-form
integer functions of the bits, the same on every device; the normal and
exponential transforms go through ``erfinv``/``log`` in float64 and
round once.  Gamma (Marsaglia--Tsang) and Poisson (inversion below
``_PTRS_LAM``, Hormann's PTRS above) are rejection samplers run for a
fixed number of rounds on every element, each round on sub-streams of
its own: a graph captures them, and an element still unaccepted after
the last round (probability below 1e-15) keeps a deterministic
fallback.  ``sample_multinomial`` draws by inverse CDF over one
cumulative sum a row (float64), not the reference's ``n``-fold repeat of
the logits, which at a 50,257-token vocabulary and 4,096 draws a row
would be gigabytes.  JAX's threefry bits are not reproduced.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import torch_dtype
from .nn import _fdiv, pooling
from .registry import alias, op

__all__: list = []

_GAMMA_ROUNDS = 12      # Marsaglia-Tsang accepts >= 95.1 % a round
_PTRS_ROUNDS = 16       # PTRS accepts >= 89 % a round (lam >= 10)
_PTRS_LAM = 10.0        # inversion below, PTRS at and above
_INV_STEPS = 48         # P(Poisson(10) >= 48) < 1e-17
_POISSON_STREAM = 32    # gamma uses sub-streams 1..25, Poisson from here


def _key():
    return _random.next_key()


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device():
    from ..context import current_context
    return current_context().torch_device()


def _count(shape):
    return math.prod(shape)


# --------------------------------------------------------------------------- #
# transforms of the key's bits (float64 inside, one rounding out)
# --------------------------------------------------------------------------- #

_NBITS = {torch.float16: 11, torch.bfloat16: 8}


def _unit(key, n, device, dtype, stream=0):
    """``n`` draws in [0, 1) of ``dtype``: the top mantissa-width bits
    (24 for f32, 53 for f64 from two words), exact in ``dtype``."""
    if dtype == torch.float64:
        hi = _random.key_bits(key, n, device, stream)
        lo = _random.key_bits(key, n, device, stream + 1)
        return ((hi >> 5) * (2 ** 26) + (lo >> 6)).to(torch.float64) * \
            (2.0 ** -53)
    nb = _NBITS.get(dtype, 24)
    bits = _random.key_bits(key, n, device, stream)
    return ((bits >> (32 - nb)).to(torch.float32) * (2.0 ** -nb)).to(dtype)


def _open64(key, n, device, stream):
    """float64 in (0, 1): ``(bits + 0.5) * 2**-32``."""
    bits = _random.key_bits(key, n, device, stream)
    return (bits.to(torch.float64) + 0.5) * (2.0 ** -32)


def _normal64(key, n, device, stream=0):
    """Standard normals in float64: ``sqrt(2) erfinv(2u - 1)``."""
    u = _open64(key, n, device, stream)
    return torch.erfinv(u * 2.0 - 1.0) * math.sqrt(2.0)


def _exponential64(key, n, device, stream=0):
    """Unit exponentials in float64: ``-log(u)``, u in (0, 1]."""
    bits = _random.key_bits(key, n, device, stream)
    return -torch.log((bits.to(torch.float64) + 1.0) * (2.0 ** -32))


def _gamma64(key, alpha, n, device):
    """Gamma(alpha, 1) draws in float64 (Marsaglia and Tsang, 2000):
    ``alpha`` a float or a float64 tensor of ``n`` elements; alpha < 1
    draws Gamma(alpha + 1) times ``u ** (1 / alpha)``.  Round ``r`` reads
    sub-streams ``2r + 1`` (the normal) and ``2r + 2`` (the uniform);
    the boost's uniform is sub-stream ``2 * _GAMMA_ROUNDS + 1``."""
    a = alpha.to(torch.float64) if isinstance(alpha, torch.Tensor) else \
        torch.full((n,), float(alpha), dtype=torch.float64, device=device)
    small = a < 1.0
    a1 = torch.where(small, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = torch.rsqrt(d * 9.0)
    out = d.clone()                         # the fallback: the mode
    done = torch.zeros(n, dtype=torch.bool, device=device)
    for r in range(_GAMMA_ROUNDS):
        z = _normal64(key, n, device, 2 * r + 1)
        u = _open64(key, n, device, 2 * r + 2)
        v = (z * c + 1.0) ** 3
        pos = v > 0
        lv = torch.log(torch.where(pos, v, torch.ones_like(v)))
        ok = pos & (torch.log(u) < z * z * 0.5 + d - d * v + d * lv)
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    boost = _open64(key, n, device, 2 * _GAMMA_ROUNDS + 1)
    return torch.where(small, out * boost ** (1.0 / a), out)


def _poisson_inversion(key, lam, n, device, stream):
    """Poisson(lam < _PTRS_LAM) by sequential inversion: the count of
    CDF values below one uniform, over ``_INV_STEPS`` terms."""
    u = _open64(key, n, device, stream)
    p = torch.exp(-lam)
    cdf = p
    k = (u > cdf).to(torch.float64)
    for j in range(1, _INV_STEPS):
        p = p * lam / j
        cdf = cdf + p
        k = k + (u > cdf).to(torch.float64)
    return k


def _poisson_ptrs(key, lam, n, device, stream):
    """Poisson(lam >= _PTRS_LAM) by transformed rejection with squeeze
    (Hormann, 1993), ``_PTRS_ROUNDS`` rounds of two sub-streams each;
    the fallback is ``floor(lam)``."""
    slam = torch.sqrt(lam)
    loglam = torch.log(lam)
    b = slam * 2.53 + 0.931
    a = b * 0.02483 - 0.059
    inv_alpha = 1.1328 / (b - 3.4) + 1.1239
    vr = 0.9277 - 3.6224 / (b - 2.0)
    out = torch.floor(lam)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    for r in range(_PTRS_ROUNDS):
        u = _open64(key, n, device, stream + 2 * r) - 0.5
        v = _open64(key, n, device, stream + 2 * r + 1)
        us = 0.5 - torch.abs(u)
        k = torch.floor((a * 2.0 / us + b) * u + lam + 0.43)
        fast = (us >= 0.07) & (v <= vr)
        slow = (k >= 0) & ~((us < 0.013) & (v > us)) & (
            torch.log(v) + torch.log(inv_alpha) - torch.log(a / (us * us) + b)
            <= -lam + k * loglam - torch.lgamma(k + 1.0))
        ok = fast | slow
        out = torch.where(ok & ~done, k, out)
        done = done | ok
    return out


def _poisson64(key, lam, n, device):
    """Poisson draws in float64; ``lam`` a float or a float64 tensor of
    ``n`` elements (a tensor takes both paths and selects per element)."""
    stream = _POISSON_STREAM
    if not isinstance(lam, torch.Tensor):
        t = torch.full((n,), float(lam), dtype=torch.float64, device=device)
        if lam < _PTRS_LAM:
            return _poisson_inversion(key, t, n, device, stream)
        return _poisson_ptrs(key, t, n, device, stream + 1)
    lam = lam.to(torch.float64)
    low = _poisson_inversion(key, lam.clamp(max=_PTRS_LAM), n, device,
                             stream)
    high = _poisson_ptrs(key, lam.clamp(min=_PTRS_LAM), n, device,
                         stream + 1)
    return torch.where(lam < _PTRS_LAM, low, high)


def categorical(key, probs, n):
    """``n`` draws a row from the categorical distributions in the last
    axis of ``probs`` (unnormalized, non-negative): inverse CDF over one
    float64 cumulative sum a row, 53-bit uniforms from sub-streams 1 and
    2.  Returns int64 of shape ``probs.shape[:-1] + (n,)``."""
    lead, v = tuple(probs.shape[:-1]), probs.shape[-1]
    rows = _count(lead)
    cdf = torch.cumsum(probs.reshape(rows, v).to(torch.float64)
                       .clamp_min(0.0), dim=-1)
    total = cdf[:, -1:]
    u = _unit(key, rows * n, probs.device, torch.float64, 1).reshape(rows, n)
    target = torch.minimum(u * total,
                           torch.nextafter(total, torch.zeros_like(total)))
    idx = torch.searchsorted(cdf, target.contiguous(), right=True)
    return idx.clamp_max(v - 1).reshape(lead + (n,))


# --------------------------------------------------------------------------- #
# _random_* (scalar-parameter draws)
# --------------------------------------------------------------------------- #

@op("_random_uniform", differentiable=False)
def _random_uniform(*, low=0.0, high=1.0, shape=(), dtype="float32"):
    s, dt, dev = _shape(shape), torch_dtype(dtype), _device()
    u = _unit(_key(), _count(s), dev, dt)
    return (u * (high - low) + low).reshape(s)


@op("_random_normal", differentiable=False)
def _random_normal(*, loc=0.0, scale=1.0, shape=(), dtype="float32"):
    s, dt, dev = _shape(shape), torch_dtype(dtype), _device()
    z = _normal64(_key(), _count(s), dev).to(dt)
    return (z * scale + loc).reshape(s)


@op("_random_gamma", differentiable=False)
def _random_gamma(*, alpha=1.0, beta=1.0, shape=(), dtype="float32"):
    s, dt, dev = _shape(shape), torch_dtype(dtype), _device()
    g = _gamma64(_key(), float(alpha), _count(s), dev).to(dt)
    return (g * beta).reshape(s)


@op("_random_exponential", differentiable=False)
def _random_exponential(*, lam=1.0, shape=(), dtype="float32"):
    s, dt, dev = _shape(shape), torch_dtype(dtype), _device()
    e = _exponential64(_key(), _count(s), dev).to(dt)
    return _fdiv(e, lam).reshape(s)


@op("_random_poisson", differentiable=False)
def _random_poisson(*, lam=1.0, shape=(), dtype="float32"):
    s, dev = _shape(shape), _device()
    k = _poisson64(_key(), float(lam), _count(s), dev)
    return k.to(torch_dtype(dtype)).reshape(s)


def _nb64(key, k, p, n, device):
    """The gamma--Poisson mixture of the negative binomials: Poisson of
    ``Gamma(k) * (1 - p) / p`` (``k``, ``p`` floats or float64 tensors)."""
    scale = (1.0 - p) / p if not isinstance(p, torch.Tensor) else \
        (1.0 - p) / p.clamp_min(1e-12)
    return _poisson64(key, _gamma64(key, k, n, device) * scale, n, device)


@op("_random_negative_binomial", differentiable=False)
def _random_negative_binomial(*, k=1, p=0.5, shape=(), dtype="float32"):
    s, dev = _shape(shape), _device()
    return _nb64(_key(), float(k), float(p), _count(s), dev).to(
        torch_dtype(dtype)).reshape(s)


@op("_random_generalized_negative_binomial", differentiable=False)
def _random_generalized_negative_binomial(*, mu=1.0, alpha=1.0, shape=(),
                                          dtype="float32"):
    s, dev = _shape(shape), _device()
    k = 1.0 / alpha
    p = k / (k + mu)
    return _nb64(_key(), k, p, _count(s), dev).to(
        torch_dtype(dtype)).reshape(s)


@op("_random_randint", differentiable=False)
def _random_randint(*, low=0, high=1, shape=(), dtype="int32"):
    """``low + floor(bits * span / 2**32)`` for spans up to 2**31, else a
    63-bit word modulo the span: integer ops only."""
    s, dev = _shape(shape), _device()
    n, span = _count(s), int(high) - int(low)
    key = _key()
    bits = _random.key_bits(key, n, dev)
    if span <= 2 ** 31:
        r = (bits * span) >> 32
    else:
        lo = _random.key_bits(key, n, dev, 1)
        r = (((bits >> 1) << 32) | lo) % span
    return (r + int(low)).to(torch_dtype(dtype)).reshape(s)


# --------------------------------------------------------------------------- #
# sample_* (per-element parameter arrays; draws `shape` extra dims)
# --------------------------------------------------------------------------- #

def _ex(param, shape):
    """``param[..., None, ...]`` with one trailing axis per draw axis."""
    return param.reshape(tuple(param.shape) + (1,) * len(_shape(shape)))


def _full_param(param, shape):
    s = tuple(param.shape) + _shape(shape)
    return _ex(param, shape).expand(s).reshape(-1), s


@op("sample_uniform", differentiable=False)
def sample_uniform(low, high, *, shape=(), dtype="float32"):
    s = tuple(low.shape) + _shape(shape)
    u = _unit(_key(), _count(s), low.device, torch_dtype(dtype)).reshape(s)
    return _ex(low, shape) + _ex(high - low, shape) * u


@op("sample_normal", differentiable=False)
def sample_normal(mu, sigma, *, shape=(), dtype="float32"):
    s = tuple(mu.shape) + _shape(shape)
    z = _normal64(_key(), _count(s), mu.device).to(
        torch_dtype(dtype)).reshape(s)
    return _ex(mu, shape) + _ex(sigma, shape) * z


@op("sample_gamma", differentiable=False)
def sample_gamma(alpha, beta, *, shape=(), dtype="float32"):
    a, s = _full_param(alpha.to(torch.float64), shape)
    g = _gamma64(_key(), a, a.numel(), alpha.device).to(
        torch_dtype(dtype)).reshape(s)
    return g * _ex(beta, shape).expand(s)


@op("sample_exponential", differentiable=False)
def sample_exponential(lam, *, shape=(), dtype="float32"):
    s = tuple(lam.shape) + _shape(shape)
    e = _exponential64(_key(), _count(s), lam.device).to(
        torch_dtype(dtype)).reshape(s)
    return e / _ex(lam, shape).expand(s)


@op("sample_poisson", differentiable=False)
def sample_poisson(lam, *, shape=(), dtype="float32"):
    lam64, s = _full_param(lam.to(torch.float64), shape)
    k = _poisson64(_key(), lam64, lam64.numel(), lam.device)
    return k.to(torch_dtype(dtype)).reshape(s)


@op("sample_negative_binomial", differentiable=False)
def sample_negative_binomial(k, p, *, shape=(), dtype="float32"):
    """Per-element NB(k, p) draws: the gamma--Poisson mixture of
    ``_random_negative_binomial`` (k and p rounded to f32 first, as the
    reference's)."""
    kk, s = _full_param(k.to(torch.float32).to(torch.float64), shape)
    pp, _ = _full_param(p.to(torch.float32).to(torch.float64), shape)
    return _nb64(_key(), kk, pp, kk.numel(), k.device).to(
        torch_dtype(dtype)).reshape(s)


@op("sample_generalized_negative_binomial", differentiable=False)
def sample_generalized_negative_binomial(mu, alpha, *, shape=(),
                                         dtype="float32"):
    """Per-element GNB(mu, alpha) draws: k = 1/alpha, p = k/(k+mu)."""
    mm, s = _full_param(mu.to(torch.float32).to(torch.float64), shape)
    aa, _ = _full_param(alpha.to(torch.float32).to(torch.float64), shape)
    kk = 1.0 / aa.clamp_min(1e-12)
    pp = kk / (kk + mm)
    return _nb64(_key(), kk, pp, kk.numel(), mu.device).to(
        torch_dtype(dtype)).reshape(s)


@op("sample_multinomial", differentiable=False)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    """Rows of ``data`` are probability vectors; ``shape`` draws a row.
    With ``get_prob`` also the log of each drawn entry's probability."""
    s = _shape(shape)
    n = max(_count(s), 1)
    lead = tuple(data.shape[:-1])
    draws = categorical(_key(), data, n)
    out = draws.reshape(lead + s)
    if get_prob:
        p = torch.gather(data.reshape(-1, data.shape[-1]), 1,
                         draws.reshape(-1, n)).reshape(out.shape)
        return out.to(torch_dtype(dtype)), torch.log(p)
    return out.to(torch_dtype(dtype))


# --------------------------------------------------------------------------- #
# fused multi-tensor optimizer ops (variadic, reference aggregate path);
# these clip at clip_gradient > 0
# --------------------------------------------------------------------------- #

def _chunk(args, n_per):
    n = len(args) // n_per
    return [args[i * n_per:(i + 1) * n_per] for i in range(n)]


def _per(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _grad32(g, rescale_grad, clip_gradient):
    g = g.to(torch.float32) * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _adam_moments(g, m, v, beta1, beta2, step_count):
    """The new moments and their bias-corrected values, each divided by
    ``1 - beta ** t`` as one division (a tensor divisor: CUDA multiplies
    by the reciprocal of a Python one)."""
    nm = beta1 * m + (1 - beta1) * g
    nv = beta2 * v + (1 - beta2) * g * g
    return nm, nv, _fdiv(nm, 1 - beta1 ** step_count), \
        _fdiv(nv, 1 - beta2 ** step_count)


@op("multi_adamw_update", variadic=True)
def multi_adamw_update(*args, lrs, etas, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, wds=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, step_count=1):
    """Fused AdamW over N params: args = [w0,g0,m0,v0, w1,g1,m1,v1, ...];
    returns the updated (w, m, v) triples flattened."""
    groups = _chunk(list(args), 4)
    n = len(groups)
    outs = []
    for (w, g, m, v), lr, eta, wd in zip(groups, _per(lrs, n),
                                         _per(etas, n), _per(wds, n)):
        g = _grad32(g, rescale_grad, clip_gradient)
        nm, nv, mhat, vhat = _adam_moments(g, m, v, beta1, beta2,
                                           step_count)
        w32 = w.to(torch.float32)
        nw = w32 - (lr * mhat / (torch.sqrt(vhat) + epsilon)
                    + wd * w32) * eta
        outs += [nw.to(w.dtype), nm.to(m.dtype), nv.to(v.dtype)]
    return tuple(outs)


@op("multi_lamb_update", variadic=True)
def multi_lamb_update(*args, learning_rates, wds=0.0, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=1,
                      rescale_grad=1.0, lower_bound=-1.0,
                      upper_bound=-1.0, clip_gradient=-1.0,
                      bias_correction=True):
    """Fused LAMB over N params; the trust ratio is ``|w| / |update|``
    where both norms are positive, else 1."""
    groups = _chunk(list(args), 4)
    n = len(groups)
    outs = []
    for (w, g, m, v), lr, wd in zip(groups, _per(learning_rates, n),
                                    _per(wds, n)):
        w32 = w.to(torch.float32)
        g = _grad32(g, rescale_grad, clip_gradient)
        nm, nv, mhat, vhat = _adam_moments(g, m, v, beta1, beta2,
                                           step_count)
        if not bias_correction:
            mhat, vhat = nm, nv
        upd = mhat / (torch.sqrt(vhat) + epsilon) + wd * w32
        wnorm = torch.linalg.vector_norm(w32)
        if lower_bound > 0:
            wnorm = torch.clamp_min(wnorm, lower_bound)
        if upper_bound > 0:
            wnorm = torch.clamp_max(wnorm, upper_bound)
        unorm = torch.linalg.vector_norm(upd)
        trust = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                            torch.ones_like(wnorm))
        outs += [(w32 - lr * trust * upd).to(w.dtype), nm.to(m.dtype),
                 nv.to(v.dtype)]
    return tuple(outs)


@op("preloaded_multi_sgd_update", variadic=True)
def preloaded_multi_sgd_update(*args, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """[w0,g0, w1,g1, ..., lrs, wds]: the learning rates and weight
    decays are device arrays (element ``i`` for tensor ``i``)."""
    lrs, wds = args[-2], args[-1]
    outs = []
    for i, (w, g) in enumerate(_chunk(list(args[:-2]), 2)):
        g = _grad32(g, rescale_grad, clip_gradient)
        w32 = w.to(torch.float32)
        outs.append((w32 - lrs[i] * (g + wds[i] * w32)).to(w.dtype))
    return tuple(outs)


@op("preloaded_multi_sgd_mom_update", variadic=True)
def preloaded_multi_sgd_mom_update(*args, momentum=0.9, rescale_grad=1.0,
                                   clip_gradient=-1.0):
    """[w0,g0,mom0, ..., lrs, wds] with device-resident lrs/wds."""
    lrs, wds = args[-2], args[-1]
    outs = []
    for i, (w, g, mom) in enumerate(_chunk(list(args[:-2]), 3)):
        g = _grad32(g, rescale_grad, clip_gradient)
        w32 = w.to(torch.float32)
        nmom = momentum * mom - lrs[i] * (g + wds[i] * w32)
        outs += [(w32 + nmom).to(w.dtype), nmom.to(mom.dtype)]
    return tuple(outs)


# --------------------------------------------------------------------------- #
# additional int8 inference ops
# --------------------------------------------------------------------------- #

# int8 affine convention shared by the quantized_* ops below (the
# reference's, kept even where ops/quantization.py uses another):
#   real = (q + 128) * scale + min,  scale = (max - min) / 255
# (q = -128 maps to min, q = 127 to max)

def _affine_scale(min_data, max_data):
    return torch.clamp_min(max_data - min_data, 1e-12) / 255.0


@op("quantized_pooling_int8", differentiable=False)
def quantized_pooling_int8(data, min_data, max_data, *, kernel=(),
                           pool_type="max", stride=(), pad=(),
                           global_pool=False):
    """int8 pooling: max-pool runs on the int8 values (order-preserving);
    the others dequantize, pool in f32 and requantize."""
    kw = dict(kernel=kernel, stride=stride, pad=pad,
              global_pool=global_pool)
    if pool_type == "max":
        out = pooling(data.to(torch.float32), pool_type="max", **kw)
        return out.to(data.dtype), min_data, max_data
    scale = _affine_scale(min_data, max_data)
    x = (data.to(torch.float32) + 128.0) * scale + min_data
    out = pooling(x, pool_type=pool_type, **kw)
    q = torch.clamp(torch.round((out - min_data) / scale) - 128.0,
                    -128, 127).to(torch.int8)
    return q, min_data, max_data


@op("quantized_act_int8", differentiable=False)
def quantized_act_int8(data, min_data, max_data, *, act_type="relu"):
    """int8 ReLU: clamp at the zero point; the calibrated range is
    returned unchanged, so consumers dequantize the clamped values."""
    if act_type != "relu":
        raise ValueError(f"quantized_act_int8: unsupported {act_type}")
    scale = _affine_scale(min_data, max_data)
    # ceil: the clamp floor is the smallest non-negative representable
    # value (a relu output must dequantize to >= 0)
    zero = torch.ceil(-min_data / scale) - 128.0
    out = torch.maximum(data.to(torch.int32), zero.to(torch.int32))
    return out.to(torch.int8), min_data, max_data


# --------------------------------------------------------------------------- #
# small contrib stragglers
# --------------------------------------------------------------------------- #

@op("_contrib_index_copy")
def index_copy(old, index, new):
    """out = old with out[index[i]] = new[i]."""
    return old.index_copy(0, index.long(), new.to(old.dtype))


@op("_contrib_index_add")
def index_add(old, index, new):
    return old.index_add(0, index.long(), new.to(old.dtype))


@op("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(last_dim), the attention-scale helper op."""
    root = torch.sqrt(torch.full((), float(data.shape[-1]),
                                 dtype=torch.float32, device=data.device))
    return data / root.to(data.dtype)


class _GradMultiplier(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``scalar``
    (a gradient reversal when negative)."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scalar).to(g.dtype), None


@op("_contrib_gradientmultiplier")
def gradientmultiplier(data, *, scalar=1.0):
    return _GradMultiplier.apply(data, scalar)


@op("quadratic")
def quadratic(data, *, a=0.0, b=0.0, c=0.0):
    """a x**2 + b x + c (the reference's tutorial op, part of its public
    op list)."""
    return a * data * data + b * data + c


@op("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, *, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity, as in the reference (its KL sparsity penalty is a
    training-script concern under tape autograd)."""
    return data


alias("random_uniform", "_random_uniform")
alias("random_normal", "_random_normal")
alias("random_gamma", "_random_gamma")
alias("random_exponential", "_random_exponential")
alias("random_poisson", "_random_poisson")
alias("random_negative_binomial", "_random_negative_binomial")
alias("random_generalized_negative_binomial",
      "_random_generalized_negative_binomial")
alias("random_randint", "_random_randint")
alias("multinomial", "sample_multinomial")
alias("interp", "interp_op")
