"""Distribution checks of the port's random draws, shared by
``tests/test_torch_samplers.py`` (2**15 draws a row on the CPU) and
``chip_smoke.py`` (2**24 draws an op on the card).  JAX-free.

``DRAW_CASES`` lists every ``_random_*`` and ``sample_*`` op with its
parameters and, for each row of its output, the distribution it must
follow, named as in ``scipy.stats``.  ``check_draws`` holds a sample
(a torch tensor, on any device) to it:

- the mean and the variance within 6 standard errors (the variance's
  from the distribution's fourth central moment);
- a continuous row's Kolmogorov--Smirnov statistic (sorted and held
  against the CDF on the sample's device, in float64), a discrete row's
  chi-square over the values with 5 or more expected draws (the tails
  pooled), at p >= 1e-6.
"""
import math

import numpy as onp
import torch

P_MIN = 1e-6
SE_MAX = 6.0

_SQRT2 = math.sqrt(2.0)


def _f(*v):
    return onp.asarray(v, onp.float32)


# (id, op, parameter arrays, kwargs, one distribution a row); a
# distribution is (scipy name, *scipy args); the ``shape`` kwarg is
# filled in by the caller (the draws a row)
DRAW_CASES = [
    ("uniform", "_random_uniform", [], dict(low=-1.0, high=3.0),
     [("uniform", -1.0, 4.0)]),
    ("normal", "_random_normal", [], dict(loc=0.5, scale=2.0),
     [("norm", 0.5, 2.0)]),
    ("gamma", "_random_gamma", [], dict(alpha=2.5, beta=1.5),
     [("gamma", 2.5, 0.0, 1.5)]),
    ("gamma_small", "_random_gamma", [], dict(alpha=0.4, beta=2.0),
     [("gamma", 0.4, 0.0, 2.0)]),
    ("exponential", "_random_exponential", [], dict(lam=2.0),
     [("expon", 0.0, 0.5)]),
    ("poisson_small", "_random_poisson", [], dict(lam=4.0),
     [("poisson", 4.0)]),
    ("poisson_large", "_random_poisson", [], dict(lam=40.0),
     [("poisson", 40.0)]),
    ("negative_binomial", "_random_negative_binomial", [],
     dict(k=3, p=0.4), [("nbinom", 3, 0.4)]),
    ("generalized_negative_binomial",
     "_random_generalized_negative_binomial", [], dict(mu=4.0, alpha=0.25),
     [("nbinom", 4.0, 0.5)]),
    ("randint", "_random_randint", [], dict(low=-3, high=7),
     [("randint", -3, 7)]),
    ("sample_uniform", "sample_uniform", [_f(0.0, 10.0), _f(1.0, 20.0)], {},
     [("uniform", 0.0, 1.0), ("uniform", 10.0, 10.0)]),
    ("sample_normal", "sample_normal", [_f(0.0, 10.0), _f(1.0, 0.1)], {},
     [("norm", 0.0, 1.0), ("norm", 10.0, 0.1)]),
    ("sample_gamma", "sample_gamma", [_f(0.7, 3.0), _f(1.0, 2.0)], {},
     [("gamma", 0.7, 0.0, 1.0), ("gamma", 3.0, 0.0, 2.0)]),
    ("sample_exponential", "sample_exponential", [_f(1.0, 4.0)], {},
     [("expon", 0.0, 1.0), ("expon", 0.0, 0.25)]),
    ("sample_poisson", "sample_poisson", [_f(2.0, 25.0)], {},
     [("poisson", 2.0), ("poisson", 25.0)]),
    ("sample_negative_binomial", "sample_negative_binomial",
     [_f(2.0, 5.0), _f(0.3, 0.6)], {},
     [("nbinom", 2.0, 0.3), ("nbinom", 5.0, 0.6)]),
    ("sample_generalized_negative_binomial",
     "sample_generalized_negative_binomial", [_f(3.0, 8.0), _f(0.5, 0.2)],
     {}, [("nbinom", 2.0, 0.4), ("nbinom", 5.0, 5.0 / 13.0)]),
    ("sample_multinomial", "sample_multinomial",
     [_f([0.1, 0.2, 0.7], [0.5, 0.25, 0.25]).reshape(2, 3)], {},
     [("categorical", 0.1, 0.2, 0.7), ("categorical", 0.5, 0.25, 0.25)]),
]


def scipy_dist(spec):
    from scipy import stats

    name, *args = spec
    if name == "categorical":
        return stats.rv_discrete(values=(onp.arange(len(args)), args))
    return getattr(stats, name)(*args)


def _is_discrete(spec):
    return spec[0] in ("poisson", "nbinom", "randint", "categorical")


def _cdf(spec, x):
    """The CDF of a continuous ``spec`` on float64 tensor ``x``."""
    name, *a = spec
    if name == "uniform":
        return ((x - a[0]) / a[1]).clamp(0.0, 1.0)
    if name == "norm":
        return torch.special.ndtr((x - a[0]) / a[1])
    if name == "expon":
        return -torch.expm1(-(x - a[0]).clamp_min(0.0) / a[1])
    if name == "gamma":
        z = ((x - a[1]) / a[2]).clamp_min(0.0)
        return torch.special.gammainc(torch.full_like(z, a[0]), z)
    raise ValueError(name)


def ks(x, spec):
    """(statistic, p) of the one-sample Kolmogorov--Smirnov test."""
    from scipy import stats

    x = torch.sort(x.reshape(-1).to(torch.float64)).values
    n = x.numel()
    f = _cdf(spec, x)
    i = torch.arange(1, n + 1, dtype=torch.float64, device=x.device)
    d = float(torch.maximum((i / n - f).max(), (f - (i - 1) / n).max()))
    return d, float(stats.kstwo.sf(d, n))


def chi2(x, spec):
    """(statistic, p) of the chi-square test over the integer values
    with 5 or more expected draws, each tail pooled into one bin."""
    from scipy import stats

    dist = scipy_dist(spec)
    n = x.numel()
    lo = int(dist.ppf(1e-12)) - 1
    hi = int(dist.ppf(1 - 1e-12)) + 1
    v = x.reshape(-1).to(torch.int64).clamp(lo, hi) - lo
    counts = torch.bincount(v, minlength=hi - lo + 1).cpu().numpy()
    ks_ = onp.arange(lo, hi + 1)
    expected = n * dist.pmf(ks_)
    expected[0] = n * dist.cdf(lo)
    expected[-1] = n * dist.sf(hi - 1)
    keep = expected >= 5
    first, last = onp.argmax(keep), len(keep) - onp.argmax(keep[::-1]) - 1
    obs = onp.concatenate([[counts[:first + 1].sum()],
                           counts[first + 1:last], [counts[last:].sum()]])
    exp = onp.concatenate([[expected[:first + 1].sum()],
                           expected[first + 1:last],
                           [expected[last:].sum()]])
    obs, exp = obs[exp > 0], exp[exp > 0]
    exp = exp * obs.sum() / exp.sum()
    stat = float(((obs - exp) ** 2 / exp).sum())
    return stat, float(stats.chi2.sf(stat, len(obs) - 1))


def moments_z(x, spec):
    """(mean z, variance z): each sample moment's distance from the
    distribution's in standard errors."""
    dist = scipy_dist(spec)
    n = x.numel()
    xd = x.reshape(-1).to(torch.float64)
    mean = float(xd.mean())
    var = float(xd.var(correction=1))
    m, v = float(dist.mean()), float(dist.var())
    mu4 = float(dist.moment(4)) - 4 * m * float(dist.moment(3)) + \
        6 * m * m * float(dist.moment(2)) - 3 * m ** 4
    se_var = math.sqrt(max(mu4 - v * v, 1e-300) / n)
    return (mean - m) / math.sqrt(v / n), (var - v) / se_var


def check_draws(x, specs):
    """Hold every row of ``x`` (rows along the first axis when there are
    several specs) to its distribution; returns one dict a row and
    raises ``AssertionError`` on a failed gate."""
    rows = [x] if len(specs) == 1 else list(x.reshape(len(specs), -1))
    out = []
    for row, spec in zip(rows, specs):
        zm, zv = moments_z(row, spec)
        stat, p = chi2(row, spec) if _is_discrete(spec) else ks(row, spec)
        res = dict(dist=spec[0], mean_z=zm, var_z=zv, stat=stat, p=p)
        out.append(res)
        assert abs(zm) <= SE_MAX and abs(zv) <= SE_MAX and p >= P_MIN, res
    return out
