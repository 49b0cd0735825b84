"""Weight initializers.

Port of ``mxnet_tpu/initializer.py``, whole: the base class's name
rules, ``InitDesc``, ``Zero``, ``One``, ``Constant``, ``Uniform``,
``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``,
``LSTMBias``, ``Load`` and ``Mixed``.
An initializer draws from an explicit seeded ``torch.Generator`` in f32
and casts to the parameter's dtype; ``Orthogonal`` draws from the
counter-based ``random.key_bits`` streams under a key taken from that
generator, and factors in f64 before its one rounding.  The reference
draws threefry bits, which no torch generator reproduces, so the numbers
differ; the distributions and the name rules are the reference's, and
parity tests carry weights across instead (``models/convert.py``).
``Load`` and ``Mixed`` fill an array themselves (their own
``__call__``), as a parameter's own initializer too.

``Initializer.__call__(desc, arr)`` fills one Gluon parameter's array,
as the reference's does: an explicit initializer in ``desc.attrs
["__init__"]`` (the parameter's own, ``weight_initializer=`` and the
like) wins over the name rules.  It draws from ``mx.random``'s generator
on the array's device unless it is handed one (``Block.initialize(...,
seed=)``).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Load", "Mixed", "register", "create"]

_REGISTRY: dict = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An initializer from an instance, a registered name or None."""
    if init is None or isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {init}")
        return _REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter's name carrying its init attributes (reference
    ``InitDesc``): ``attrs["__init__"]`` is the parameter's own
    initializer."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


class Initializer:
    """Base class.  ``generate(name, shape, ...)`` applies the reference's
    name rules: gamma -> 1; beta and bias -> 0; running/moving mean -> 0;
    running/moving var -> 1; min/max -> 0; anything else
    ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def generate(self, name, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        name = name.lower()
        if name.endswith("gamma"):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.endswith("beta") or name.endswith("bias"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if "running_mean" in name or "moving_mean" in name:
            return torch.zeros(shape, dtype=dtype, device=device)
        if ("running_var" in name or "moving_var" in name
                or "moving_avg" in name):
            return torch.ones(shape, dtype=dtype, device=device)
        if name.endswith("min") or name.endswith("max"):
            return torch.zeros(shape, dtype=dtype, device=device)
        return self._init_weight(name, shape, dtype, device, generator)

    def __call__(self, desc, arr, generator=None):
        """Fill the NDArray ``arr`` in place for the parameter ``desc``
        (reference ``Initializer.__call__``).  The parameter's own
        initializer (``desc.attrs["__init__"]``) bypasses the name rules,
        so ``bias_initializer="ones"`` is not turned back into zeros."""
        from . import random as _random

        t = arr._data
        gen = generator if generator is not None else \
            _random.generator(t.device)
        name = str(desc)
        own = getattr(desc, "attrs", {}).get("__init__")
        with torch.no_grad():
            if own:
                ini = create(own)
                if type(ini).__call__ is not Initializer.__call__:
                    # Load and Mixed fill the array themselves
                    ini(InitDesc(name), arr, generator=gen)
                    return
                val = ini._init_weight(name, t.shape, torch.float32,
                                       t.device, gen)
            else:
                val = self.generate(name, t.shape, torch.float32, t.device,
                                    gen)
            arr._rebind(val.to(t.dtype))

    init_weight = __call__

    def _init_weight(self, name, shape, dtype, device, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, name, shape, dtype, device, generator):
        return torch.zeros(shape, dtype=dtype, device=device)


@register
class One(Initializer):
    def _init_weight(self, name, shape, dtype, device, generator):
        return torch.ones(shape, dtype=dtype, device=device)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every element ``value`` (a number or an array broadcast to the
    shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, dtype, device, generator):
        v = self.value
        if hasattr(v, "asnumpy"):
            v = v.asnumpy()
        return torch.as_tensor(v, dtype=dtype).to(device).broadcast_to(
            tuple(shape)).clone()


def _uniform(shape, scale, device, generator):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (2.0 * scale) - scale


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, dtype, device, generator):
        return _uniform(shape, self.scale, device, generator).to(dtype)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, dtype, device, generator):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * self.sigma).to(dtype)


def _key(generator):
    """A key of the counter-based streams (``random.key_bits``): drawn
    from ``generator`` (so ``initialize(seed=)`` fixes it), else
    ``random.next_key()``."""
    from . import random as _random

    if generator is None:
        return _random.next_key()
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                             device=generator.device,
                             dtype=torch.int64).item())


def _key_unit(key, n, device, stream):
    """``n`` f64 draws in [0, 1) of sub-stream ``stream`` of ``key``."""
    from . import random as _random

    bits = _random.key_bits(key, n, device, stream)
    return (bits >> 8).to(torch.float64) * (2.0 ** -24)


@register
class Orthogonal(Initializer):
    """Reference ``Orthogonal``: a (out, prod(rest)) matrix drawn
    U(-1, 1) (``rand_type="uniform"``) or N(0, 1) (Box-Muller of two
    sub-streams), its SVD's U if that has the matrix's shape, else its
    Vᵀ, times ``scale``.  The draws are counter-based under one key; the
    factorization runs in f64 and the result is rounded once."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, shape, dtype, device, generator):
        nout = shape[0]
        nin = int(math.prod(shape[1:])) if len(shape) > 1 else 1
        key = _key(generator)
        n = nout * nin
        if self.rand_type == "uniform":
            tmp = _key_unit(key, n, device, 0) * 2.0 - 1.0
        else:
            u1 = _key_unit(key, n, device, 0)
            u2 = _key_unit(key, n, device, 1)
            tmp = torch.sqrt(-2.0 * torch.log1p(-u1)) * \
                torch.cos(2.0 * math.pi * u2)
        u, _, v = torch.linalg.svd(tmp.reshape(nout, nin),
                                   full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * q).reshape(tuple(shape)).to(dtype)


@register
class Xavier(Initializer):
    """Reference ``Xavier``: ``scale = sqrt(magnitude / factor)`` with
    the factor the average, the fan-in or the fan-out; for an (O, I,
    *kernel) weight ``fan_in = I * prod(kernel)`` and ``fan_out = O *
    prod(kernel)``.  ``rnd_type`` "uniform" draws U(-scale, scale),
    "gaussian" N(0, scale^2)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, name, shape):
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2 param, got shape "
                             f"{tuple(shape)} for {name}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, shape, dtype, device, generator):
        scale = self.scale(name, shape)
        if self.rnd_type == "uniform":
            return _uniform(shape, scale, device, generator).to(dtype)
        if self.rnd_type == "gaussian":
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * scale).to(dtype)
        raise MXNetError(f"bad rnd_type {self.rnd_type}")


@register
class MSRAPrelu(Xavier):
    """Reference ``MSRAPrelu`` (He et al. 2015): ``Xavier("gaussian",
    factor_type, 2 / (1 + slope**2))``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Reference ``Bilinear``: the bilinear upsampling kernel of a
    (..., kh, kw) Deconvolution weight, ``(1 - |x / f - c|) * (1 - |y /
    f - c|)`` with ``f = ceil(kw / 2)``, ``c = (2f - 1 - f % 2) / 2f``,
    computed in f64 as the reference's loop does, then rounded."""

    def _init_weight(self, name, shape, dtype, device, generator):
        n = int(math.prod(shape))
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        return torch.from_numpy(w.astype(np.float32).reshape(
            tuple(shape))).to(device=device, dtype=dtype)


@register
class LSTMBias(Initializer):
    """Reference ``LSTMBias``: ``forget_bias`` on the forget gate's
    quarter (gates i, f, c, o), zero elsewhere."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, shape, dtype, device, generator):
        b = torch.zeros(tuple(shape), dtype=torch.float32)
        h = shape[0] // 4
        b[h:2 * h] = self.forget_bias
        return b.to(device=device, dtype=dtype)


def _host(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


@register
class Load(Initializer):
    """Reference ``Load``: each parameter from ``param`` (a dict of
    arrays, or a ``.params`` file read by ``nd.load``; ``arg:``/``aux:``
    prefixes dropped), else ``default_init``, else an error."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .context import cpu
            from .ndarray.serialization import load

            param = load(param, ctx=cpu())
        if not isinstance(param, dict):
            raise MXNetError("Load: param must be a dict of arrays or a "
                             ".params file of named arrays")
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, desc, arr, generator=None):
        name = str(desc)
        if name in self.param:
            data = _host(self.param[name])
            if tuple(data.shape) != tuple(arr.shape):
                raise MXNetError(f"Load: shape mismatch for {name}: "
                                 f"{data.shape} vs {arr.shape}")
            t = arr._data
            arr._rebind(torch.from_numpy(np.ascontiguousarray(data)).to(
                device=t.device, dtype=t.dtype))
        elif self.default_init is not None:
            self.default_init(desc, arr, generator=generator)
        else:
            raise MXNetError(f"Load: no init for {name}")


@register
class Mixed(Initializer):
    """Reference ``Mixed``: the initializer of the first regex pattern
    that matches the parameter's name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns/initializers length mismatch")
        self.map = [(re.compile(p), i) for p, i in
                    zip(patterns, initializers)]

    def __call__(self, desc, arr, generator=None):
        for pat, ini in self.map:
            if pat.match(str(desc)):
                ini(desc, arr, generator=generator)
                return
        raise MXNetError(
            f"Mixed: no pattern matched {desc}; add a '.*' catch-all")
