"""Weight initializers.

Port of ``mxnet_tpu/initializer.py`` (the base class's name rules,
``InitDesc``, ``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal``,
``Xavier``; the others come with later slices).
An initializer draws from an explicit seeded ``torch.Generator`` in f32
and casts to the parameter's dtype.  The reference draws threefry bits,
which no torch generator reproduces, so the numbers differ; the
distributions and the name rules are the reference's, and parity tests
carry weights across instead (``models/convert.py``).

``Initializer.__call__(desc, arr)`` fills one Gluon parameter's array,
as the reference's does: an explicit initializer in ``desc.attrs
["__init__"]`` (the parameter's own, ``weight_initializer=`` and the
like) wins over the name rules.  It draws from ``mx.random``'s generator
on the array's device unless it is handed one (``Block.initialize(...,
seed=)``).
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant",
           "Uniform", "Normal", "Xavier", "register", "create"]

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
                val = create(own)._init_weight(name, t.shape, torch.float32,
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
