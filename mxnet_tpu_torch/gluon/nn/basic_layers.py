"""Basic layers.

Port of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``Activation``, ``Flatten``.  Their parameters are Gluon
``Parameter``s (``dense0_weight``) whose tensors the module registers
under the attribute's name.  A size
left at 0 (``in_units``, ``in_channels``) is inferred from the first
input.  ``device`` (a port extension) creates the parameters at once on
that device and needs every size; without it the parameters with known
shapes are created on the current context.

``BatchNorm`` keeps the reference's four parameters: ``gamma`` and
``beta`` train unless ``scale``/``center`` is off (``fix_gamma = not
scale``), ``running_mean``/``running_var`` never train (``grad_req=
"null"``).  In training mode it normalizes with the batch statistics and
commits the new moving statistics in place, as the reference's
``commit_aux`` does; training mode is ``autograd.is_training()`` in a
call made with NDArrays and ``nn.Module.training`` in one made with
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.nn import (activation, batch_norm, dropout, flatten,
                       fully_connected)
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Activation", "Flatten"]


class _Stack:
    """Blocks run in order (``Sequential`` and ``HybridSequential``)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self.prefix)
            for block in children[key]:
                net.register_child(block)
            return net
        return children[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


class HybridSequential(_Stack, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)


class Dense(HybridBlock):
    """``act(x W^T + b)``; weight (units, in_units).  With ``flatten``
    the input is (N, ...) flattened to (N, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._units, self._flatten = units, flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation) if activation else None
        self._place(device)

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        p = self._parameters
        if self._flatten:
            x = flatten(x)
        out = fully_connected(x, p["weight"], p.get("bias"))
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Reference ``gluon.nn.Dropout``: ``ops.nn.dropout`` at ``rate``
    (the mask shared along ``axes``) in training mode, the identity
    otherwise.  Its masks come from the device generator, which a
    hybridized or fused step's graph advances at every replay."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        if self._rate <= 0:
            return x
        return dropout(x, self._rate, self._is_training(), axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (1 for NCHW, -1 for NHWC) with
    moving statistics (``ops.nn.batch_norm``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None, dtype=None):
        super().__init__(prefix=prefix, params=params)
        self._axis, self._momentum, self._eps = axis, momentum, epsilon
        self._scale, self._use_global_stats = scale, use_global_stats
        c = (in_channels,)
        kw = dict(shape=c, dtype=dtype, allow_deferred_init=True)
        with self.name_scope():
            self.gamma = self.params.get("gamma", init=gamma_initializer,
                                         differentiable=scale, **kw)
            self.beta = self.params.get("beta", init=beta_initializer,
                                        differentiable=center, **kw)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null",
                init=running_mean_initializer, differentiable=False, **kw)
            self.running_var = self.params.get(
                "running_var", grad_req="null",
                init=running_variance_initializer, differentiable=False,
                **kw)
        self._place(device)

    def infer_shape(self, x, *args):
        ch = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (ch,)

    def forward(self, x):
        p = self._parameters
        training = self._is_training()
        out, new_mm, new_mv, _, _ = batch_norm(
            x, p["gamma"], p["beta"], p["running_mean"], p["running_var"],
            eps=self._eps, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training and not self._use_global_stats:
            with torch.no_grad():
                p["running_mean"].copy_(new_mm)
                p["running_var"].copy_(new_mv)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation

    def forward(self, x):
        return activation(x, self._act_type)


class Flatten(HybridBlock):
    def forward(self, x):
        return flatten(x)
