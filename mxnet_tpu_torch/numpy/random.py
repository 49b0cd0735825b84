"""``mx.np.random`` — NumPy's random API over the port's key streams.

Port of ``mxnet_tpu/numpy/random.py``.  Each draw takes one
``random.next_key()`` (two for ``beta``, ``f`` and
``negative_binomial``) and turns the key's counter-based bits
(``random.key_bits``' streams) into its distribution with the
transforms of ``ops/samplers.py``: float64 inside and one rounding out.
JAX's threefry bits are not reproduced, so a seed gives other values
than the reference's; the distributions, dtypes and shapes are its own.
The integer draws (``randint``, ``choice`` without ``p``,
``permutation``, ``shuffle``) use integer operations on the bits only,
so one seed gives the same values on the card and on the CPU.  A draw
is made on ``ctx`` (default: the current context), one with array
parameters on their device, and runs as one registered op (``_npr_*``,
not differentiable).
"""
from __future__ import annotations

import math

import torch

from .. import random as _base
from ..ndarray.ndarray import NDArray  # noqa: F401
from ..ops import samplers as _s
from ..ops.registry import Op, invoke
from .multiarray import _coerce_arr, _device_of, _tdt, ndarray

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "shuffle", "permutation", "gamma", "beta",
           "exponential", "poisson", "multinomial", "binomial",
           "lognormal", "laplace", "gumbel", "logistic", "chisquare",
           "standard_normal", "multivariate_normal", "pareto", "power",
           "rayleigh", "weibull", "geometric", "negative_binomial", "f"]

seed = _base.seed


def _shp(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _count(shape):
    return math.prod(shape)


def _sample(name, fn, extra=(), ctx=None):
    """``fn(key, device, *tensors)`` as one ``_npr_<name>`` op over the
    array parameters ``extra``, on their device or ``ctx``'s."""
    key = _base.next_key()
    arrays = [_coerce_arr(e) for e in extra]
    if ctx is not None:
        device = ctx.torch_device()
    else:
        device = _device_of(arrays)
    out = invoke(Op(name=f"_npr_{name}", differentiable=False,
                    fn=lambda *ts: fn(key, device, *[
                        t.to(device) for t in ts])), arrays, {})
    return out if type(out) is ndarray else ndarray(out._data)


def _f32(t, dtype=None):
    return t.to(_tdt(dtype) or torch.float32)


def _open(key, n, device, stream=0):
    return _s._open64(key, n, device, stream)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    shp = _shp(size)
    return _sample("uniform", lambda k, d: _f32(
        _s._unit(k, _count(shp), d, torch.float64) * (high - low) + low,
        dtype).reshape(shp), ctx=ctx)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    shp = _shp(size)
    return _sample("normal", lambda k, d: _f32(
        _s._normal64(k, _count(shp), d) * scale + loc, dtype).reshape(shp),
        ctx=ctx)


def standard_normal(size=None, dtype=None):
    return normal(0.0, 1.0, size, dtype)


def randn(*size):
    return normal(0.0, 1.0, size or None)


def rand(*size):
    return uniform(0.0, 1.0, size or None)


def _below(key, n, high, device, stream=0):
    """``n`` integers in [0, high) from the key's bits (integer ops
    only: the same on every device)."""
    return _base.key_bits(key, n, device, stream) % int(high)


def randint(low, high=None, size=None, dtype=None):
    if high is None:
        low, high = 0, low
    shp = _shp(size)
    dt = _tdt(dtype) or torch.int32
    return _sample("randint", lambda k, d: (
        _below(k, _count(shp), high - low, d) + int(low)).to(dt).reshape(
            shp))


def _perm(key, n, device):
    return torch.argsort(_base.key_bits(key, n, device), stable=True)


def choice(a, size=None, replace=True, p=None):
    shp = _shp(size)
    n_out = _count(shp)

    def pick(k, d, n, prob):
        if prob is not None:
            return _s.categorical(k, prob.reshape(1, -1), n_out).reshape(-1)
        if replace:
            return _below(k, n_out, n, d)
        return _perm(k, n, d)[:n_out]

    if isinstance(a, int):
        extra = [] if p is None else [p]
        return _sample("choice", lambda k, d, *pr: pick(
            k, d, a, pr[0] if pr else None).to(torch.int32).reshape(shp),
            extra)
    extra = [a] + ([] if p is None else [p])
    return _sample("choice", lambda k, d, arr, *pr: arr.reshape(-1)[pick(
        k, d, arr.shape[0], pr[0] if pr else None)].reshape(
            shp + tuple(arr.shape[1:])), extra)


def permutation(x):
    if isinstance(x, int):
        return _sample("permutation", lambda k, d: _perm(k, x, d).to(
            torch.int32))
    return _sample("permutation", lambda k, d, a: a[_perm(
        k, a.shape[0], d)], [x])


def shuffle(x):
    """Shuffle ``x`` along axis 0 in place (the handle is rebound)."""
    r = permutation(x)
    x._rebind(r._data)
    return None


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None):
    shp = _shp(size)
    return _sample("gamma", lambda k, d: _f32(
        _s._gamma64(k, float(shape), _count(shp), d) * scale,
        dtype).reshape(shp), ctx=ctx)


def beta(a, b, size=None, dtype=None, ctx=None):
    shp = _shp(size)
    k2 = _base.next_key()

    def fn(k, d):
        n = _count(shp)
        x = _s._gamma64(k, float(a), n, d)
        y = _s._gamma64(k2, float(b), n, d)
        return _f32(x / (x + y), dtype).reshape(shp)
    return _sample("beta", fn, ctx=ctx)


def exponential(scale=1.0, size=None):
    shp = _shp(size)
    return _sample("exponential", lambda k, d: _f32(
        _s._exponential64(k, _count(shp), d) * scale).reshape(shp))


def poisson(lam=1.0, size=None):
    shp = _shp(size)
    return _sample("poisson", lambda k, d: _s._poisson64(
        k, float(lam), _count(shp), d).to(torch.int32).reshape(shp))


def multinomial(n, pvals, size=None):
    shp = _shp(size)

    def fn(k, d, p):
        rows = _count(shp)
        cats = p.shape[-1]
        draws = _s.categorical(k, p.reshape(1, cats).expand(rows, cats),
                               int(n))
        counts = torch.zeros((rows, cats), dtype=torch.float32, device=d)
        counts.scatter_add_(1, draws, torch.ones_like(draws,
                                                      dtype=torch.float32))
        return counts.reshape(shp + (cats,))
    return _sample("multinomial", fn, [pvals])


def binomial(n, p, size=None):
    shp = _shp(size)

    def fn(k, d):
        rows, n_ = _count(shp), int(n)
        u = _s._unit(k, rows * n_, d, torch.float64).reshape(rows, n_)
        return (u < p).sum(-1).to(torch.float32).reshape(shp)
    return _sample("binomial", fn)


def lognormal(mean=0.0, sigma=1.0, size=None):
    shp = _shp(size)
    return _sample("lognormal", lambda k, d: _f32(torch.exp(
        _s._normal64(k, _count(shp), d) * sigma + mean)).reshape(shp))


def laplace(loc=0.0, scale=1.0, size=None):
    shp = _shp(size)

    def fn(k, d):
        u = _open(k, _count(shp), d) - 0.5
        return _f32(loc - scale * torch.sign(u) *
                    torch.log1p(-2.0 * torch.abs(u))).reshape(shp)
    return _sample("laplace", fn)


def gumbel(loc=0.0, scale=1.0, size=None):
    shp = _shp(size)
    return _sample("gumbel", lambda k, d: _f32(
        loc - scale * torch.log(-torch.log(_open(k, _count(shp), d)))
    ).reshape(shp))


def logistic(loc=0.0, scale=1.0, size=None):
    shp = _shp(size)

    def fn(k, d):
        u = _open(k, _count(shp), d)
        return _f32(loc + scale * torch.log(u / (1.0 - u))).reshape(shp)
    return _sample("logistic", fn)


def chisquare(df, size=None):
    shp = _shp(size)
    return _sample("chisquare", lambda k, d: _f32(
        2.0 * _s._gamma64(k, float(df) / 2.0, _count(shp), d)).reshape(shp))


def multivariate_normal(mean, cov, size=None):
    shp = _shp(size)

    def fn(k, d, m, c):
        dim = m.shape[-1]
        lower = torch.linalg.cholesky(c.to(torch.float64))
        z = _s._normal64(k, _count(shp) * dim, d).reshape(-1, dim)
        out = z @ lower.T + m.to(torch.float64)
        return out.to(torch.float32).reshape(shp + (dim,))
    return _sample("multivariate_normal", fn, [mean, cov])


def pareto(a, size=None):
    shp = _shp(size)
    return _sample("pareto", lambda k, d: _f32(torch.expm1(
        _s._exponential64(k, _count(shp), d) / float(a))).reshape(shp))


def power(a, size=None):
    """X = U^(1/a) (NumPy's power distribution)."""
    shp = _shp(size)
    return _sample("power", lambda k, d: _f32(
        _open(k, _count(shp), d) ** (1.0 / float(a))).reshape(shp))


def rayleigh(scale=1.0, size=None):
    shp = _shp(size)
    return _sample("rayleigh", lambda k, d: _f32(scale * torch.sqrt(
        -2.0 * torch.log(_open(k, _count(shp), d)))).reshape(shp))


def weibull(a, size=None):
    shp = _shp(size)
    return _sample("weibull", lambda k, d: _f32(
        _s._exponential64(k, _count(shp), d) ** (1.0 / float(a))).reshape(
            shp))


def geometric(p, size=None):
    shp = _shp(size)
    return _sample("geometric", lambda k, d: (torch.floor(
        torch.log(_open(k, _count(shp), d)) / math.log1p(-float(p))) + 1.0
    ).to(torch.int32).reshape(shp))


def negative_binomial(n, p, size=None):
    """Gamma-Poisson mixture (NumPy's semantics)."""
    shp = _shp(size)
    k2 = _base.next_key()

    def fn(k, d):
        cnt = _count(shp)
        lam = _s._gamma64(k, float(n), cnt, d) * (1.0 - p) / p
        return _s._poisson64(k2, lam, cnt, d).to(torch.int32).reshape(shp)
    return _sample("negative_binomial", fn)


def f(dfnum, dfden, size=None):
    shp = _shp(size)
    k2 = _base.next_key()

    def fn(k, d):
        cnt = _count(shp)
        num = 2.0 * _s._gamma64(k, float(dfnum) / 2.0, cnt, d) / dfnum
        den = 2.0 * _s._gamma64(k2, float(dfden) / 2.0, cnt, d) / dfden
        return _f32(num / den).reshape(shp)
    return _sample("f", fn)

