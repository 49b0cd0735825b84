"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict``.

Port of ``mxnet_tpu/gluon/parameter.py``.  A ``Parameter`` owns one
``NDArray`` (``data()``), made a variable by ``attach_grad(grad_req)``.
That array's tensor is the very ``nn.Parameter`` registered on every
block the parameter belongs to (``ndarray._leaf`` adopts it), so
``data()``, the module's ``named_parameters()``, ``gluon.Trainer`` and
``parallel.SPMDTrainer`` read and update one storage.  ``grad()`` is the
gradient a backward of ``autograd`` leaves, following ``grad_req``:
``write`` replaces it, ``add`` adds to it, ``null`` keeps none (the
tensor does not require a gradient; BatchNorm's running statistics).

A parameter is created as soon as its shape is known: when its block is
built (``Block._place``), else at the block's first forward, after the
block inferred the shape (deferred initialization).  ``initialize``
fills it, or records where and how to fill it once the shape is known.

``grad()``'s buffer is allocated at first use: by the first backward of
``autograd`` that writes it, or the first ``grad()`` or ``zero_grad()``.
The fused train step and ``parallel.SPMDTrainer`` take their gradients
from ``torch.autograd.grad`` and allocate none.

Every operation that replaces a parameter's tensor (creation, deferred
initialization, ``cast``, ``reset_ctx``, loading) raises one
process-wide storage generation (``generation()``): a captured CUDA
graph reads the tensors it was captured with, so a cached graph compares
that one integer at each call and is captured again when it moved.

The reference's per-context replicas (``initialize`` on several
contexts) and its mesh sharding (``set_sharding``, ``var``) are not
ported: the port runs on one card.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "generation"]


_GENERATION = [0]


def generation() -> int:
    """The storage generation: raised whenever a parameter's tensor is
    replaced."""
    return _GENERATION[0]


def _bump():
    _GENERATION[0] += 1


class DeferredInitializationError(MXNetError):
    """``data()`` was called before the parameter's shape is known."""


def _shape_is_known(shape) -> bool:
    if shape is None:
        return False
    return all(s is not None and s > 0 for s in shape)


def _one_device(ctx):
    """The torch device of ``ctx`` (a ``Context`` or a list of one);
    several contexts raise."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f"initialize on {len(ctx)} contexts {list(ctx)}: the "
                "reference's per-context replicas are not ported, the port "
                "runs one card; pass one context")
        ctx = ctx[0]
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return torch.device(ctx)


class Parameter:
    """A tensor held by blocks (reference ``Parameter``)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("sparse parameter storage is not supported by "
                             "mxnet_tpu_torch")
        self.name = name
        self._data = None
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = None
        self.grad_req = grad_req if differentiable else "null"
        self._filled = False
        # (init, torch device, default initializer, generator) until the
        # shape is known
        self._deferred_init = None
        # (block, attribute) pairs whose module registers the tensor
        self._owners = []

    # ------------------------------------------------------------------ #
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        arr = self._data
        if arr is None:
            return
        if req == "null":
            arr._grad, arr._grad_req = None, "null"
            arr._data.requires_grad_(False)
        else:
            arr.attach_grad(req, lazy=True)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if new_shape is None:
            return
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape) or any(
                    s not in (0, None) and s != n
                    for s, n in zip(self._shape, new_shape))):
            raise MXNetError(f"shape mismatch for {self.name}: "
                             f"{self._shape} vs {new_shape}")
        self._shape = new_shape

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    # ------------------------------------------------------------------ #
    # the tensor and the blocks that register it
    # ------------------------------------------------------------------ #
    def _attach(self, block, attr):
        """Register this parameter's tensor as ``block.<attr>`` in the
        module's ``_parameters`` (now, or when it is created)."""
        self._owners.append((block, attr))
        # a None entry keeps the attribute's place in the module's order
        # until the tensor exists
        block._parameters[attr] = None if self._data is None \
            else self._data._data

    def _create(self, device):
        """Allocate the tensor on ``device`` (moving it there if it
        exists elsewhere); its values are set by the caller."""
        if not _shape_is_known(self._shape):
            raise DeferredInitializationError(
                f"parameter {self.name} has unknown shape {self._shape}")
        device = torch.device(device)
        if self._data is not None:
            leaf = self._data._data
            if leaf.device != device:
                with torch.no_grad():
                    leaf.data = leaf.data.to(device)
                self._fresh_grad()
                _bump()
            return
        leaf = nn.Parameter(torch.empty(self._shape, device=device,
                                        dtype=torch_dtype(self.dtype)),
                            requires_grad=self._grad_req != "null")
        self._data = NDArray(leaf)
        if self._grad_req != "null":
            self._data.attach_grad(self._grad_req, lazy=True)
        for block, attr in self._owners:
            block._parameters[attr] = leaf
        _bump()

    def _fresh_grad(self):
        """Drop the gradient buffer (allocated again, on the tensor's
        device and dtype, at its next use)."""
        self._data._grad = None

    def _device(self):
        return self._data._data.device if self._data is not None else None

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Fill the parameter, or, while its shape is unknown, record how
        and where (``ctx``, default the current context; a created
        parameter stays where it is) to fill it at the first forward."""
        default_init = init_mod.create(default_init) or init_mod.Uniform()
        if self._filled and not force_reinit:
            return
        if ctx is not None:
            device = _one_device(ctx)
        elif self._data is not None:
            device = self._device()
        else:
            device = current_context().torch_device()
        if not _shape_is_known(self._shape):
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"cannot initialize {self.name}: shape {self._shape} "
                    "unknown and allow_deferred_init=False")
            self._deferred_init = (init, device, default_init, generator)
            return
        self._init_impl(init, device, default_init, generator)

    def _init_impl(self, init, device, default_init, generator):
        own = init_mod.create(init if init is not None else self.init)
        self._create(device)
        desc = init_mod.InitDesc(
            self.name, {"__init__": own} if own is not None else {})
        default_init(desc, self._data, generator=generator)
        self._filled = True
        self._deferred_init = None

    def _finish_deferred_init(self):
        """Create and fill a parameter whose shape its block just
        inferred."""
        if self._data is not None:
            return
        if self._deferred_init is None:
            raise MXNetError(f"parameter {self.name} is not initialized; "
                             "call initialize() first")
        if not _shape_is_known(self._shape):
            raise DeferredInitializationError(
                f"parameter {self.name} has unknown shape {self._shape}; "
                "run a forward pass to infer it or set the shape")
        self._init_impl(*self._deferred_init)

    # ------------------------------------------------------------------ #
    # access
    # ------------------------------------------------------------------ #
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter {self.name} deferred; forward once to infer "
                "shapes")
        raise MXNetError(f"parameter {self.name} not initialized; call "
                         ".initialize() first")

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        return self._data

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad_req == "null" or self._data._grad_req == "null":
            raise MXNetError(
                f"cannot get grad for {self.name}: grad_req is 'null'")
        return self._data._grad_buffer()

    def list_data(self):
        return [self.data()]

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [self._data.context]

    def _write(self, src):
        """Copy ``src`` (NDArray, tensor or array) into the tensor, cast
        to its dtype, in place."""
        if isinstance(src, NDArray):
            src = src._data
        leaf = self._data._data
        src = torch.as_tensor(np.asarray(src)) if not isinstance(
            src, torch.Tensor) else src
        with torch.no_grad():
            leaf.copy_(src.detach().reshape(leaf.shape))
        self._filled = True

    def set_data(self, data):
        """Replace the values, keeping the tensor and its gradient
        (reference ``set_data``)."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError(f"parameter {self.name} not initialized")
            self._create(self._deferred_init[1])
            self._deferred_init = None
        self._write(data)

    def _load_init(self, src, ctx=None, cast_dtype=False):
        """Set the values from a loaded array (``load_parameters``,
        ``ParameterDict.load``): on ``ctx``, else where the parameter is
        or was to be created, else the current context; cast to the
        parameter's dtype, or with ``cast_dtype`` the parameter takes the
        array's dtype.  A deferred parameter takes the array's shape."""
        self.shape = tuple(src.shape)
        if cast_dtype:
            self.cast(src.dtype)
        if ctx is not None:
            device = _one_device(ctx)
        elif self._data is not None:
            device = self._device()
        elif self._deferred_init is not None:
            device = self._deferred_init[1]
        else:
            device = current_context().torch_device()
        self._create(device)
        self._deferred_init = None
        self._write(src)
        _bump()

    def zero_grad(self):
        if self._data is not None and self._data._grad_req != "null":
            self._data._grad_buffer()
            self._data.zero_grad()

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (gradient reset to zero)."""
        device = _one_device(ctx)
        if self._data is not None:
            self._create(device)
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], device,
                                   *self._deferred_init[2:])

    def cast(self, dtype):
        """Convert the tensor (in place: it stays the module's) and its
        gradient to ``dtype``."""
        self.dtype = dtype
        if self._data is None:
            return
        leaf = self._data._data
        dt = torch_dtype(dtype)
        if leaf.dtype != dt:
            with torch.no_grad():
                leaf.data = leaf.data.to(dt)
            self._fresh_grad()
            _bump()

    # -- JAX-only parts of the reference ------------------------------- #
    def set_sharding(self, sharding):
        raise MXNetError("set_sharding: GSPMD sharding is the JAX package's; "
                         "the port runs one card")

    def var(self):
        raise MXNetError("Parameter.var: the port has no symbolic graph")


class Constant(Parameter):
    """A parameter that never trains, with a fixed value (reference
    ``Constant``)."""

    def __init__(self, name, value):
        arr = value.asnumpy() if isinstance(value, NDArray) else \
            np.asarray(value, np.float32)
        self.value = arr
        super().__init__(name, grad_req="null", shape=arr.shape,
                         dtype=arr.dtype, init=init_mod.Constant(arr))


class ParameterDict:
    """Ordered name -> ``Parameter`` with prefix scoping and sharing
    (reference ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        lines = "\n".join(f"  {p!r}" for p in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{lines}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs) -> Parameter:
        """Get or create ``prefix + name`` (the shared dict first)."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            for k, v in kwargs.items():
                if k == "shape":
                    param.shape = v
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def get_constant(self, name, value=None) -> Constant:
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant {full} and no value given")
            param = Constant(full, value)
            self._params[full] = param
        return param

    def _get_impl(self, full):
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter {k}")
            self._params[k] = v

    # -- bulk ops ------------------------------------------------------- #
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Initialize every parameter with ``init`` (default
        ``Uniform()``) through its name rules.  ``seed`` draws from
        generators of that seed, one a device, in this dict's order;
        without it from ``mx.random``'s."""
        default = init_mod.create(init) or init_mod.Uniform()
        gens = {}
        for p in self._params.values():
            gen = None
            if seed is not None:
                dev = _one_device(ctx) if ctx is not None else (
                    p._device() or current_context().torch_device())
                gen = gens.get(dev)
                if gen is None:
                    gen = gens[dev] = torch.Generator(
                        device=dev).manual_seed(int(seed))
            p.initialize(None, ctx, default, force_reinit=force_reinit,
                         generator=gen)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import serialization
        arrays = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arrays[name] = p.data()
        serialization.save(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        loaded = _load_file(filename)
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p._load_init(loaded[name], ctx)
            elif not allow_missing:
                raise MXNetError(f"missing parameter {name} in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)}")


def _load_file(filename):
    """A ``.params`` file's named arrays, read to the host (each
    parameter then copies its own to its device)."""
    from ..context import cpu
    from ..ndarray import serialization

    loaded = serialization.load(filename, ctx=cpu())
    if not isinstance(loaded, dict):
        raise MXNetError(f"{filename} holds an unnamed list of arrays, not "
                         "parameters")
    return loaded

