"""Basic layers.

Port of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``HybridSequential``,
``Dense``, ``BatchNorm``, ``Activation``, ``Flatten``.  ``BatchNorm``
keeps the reference's four parameters: ``gamma`` and ``beta`` train
unless ``scale``/``center`` is off (``fix_gamma = not scale``), and
``running_mean``/``running_var`` never train; in training mode
(``nn.Module.train()``) each forward commits the new moving statistics
in place, as the reference's ``commit_aux`` does.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from ...ops.nn import activation, batch_norm, flatten, fully_connected
from ...base import torch_dtype
from ..block import HybridBlock, deferred

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation",
           "Flatten"]


class HybridSequential(HybridBlock):
    """Blocks run in order.  ``prefix`` is the reference's name scope:
    a non-empty prefix (a ResNet stage's ``"stage1_"``) opens a scope of
    its own for the reference's parameter names (``models/convert.py``);
    it does not change the port's names."""

    def __init__(self, prefix=None):
        super().__init__()
        self._prefix = prefix or ""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)
        return self

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """``x W^T + b``; weight (units, in_units).  With ``flatten`` the
    input is (N, ...) flattened to (N, in_units)."""

    def __init__(self, units, use_bias=True, flatten=True, dtype="float32",
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, device=None):
        super().__init__()
        if not in_units:
            raise deferred("Dense", "in_units")
        dev, dt = resolve_device(device), torch_dtype(dtype)
        self._flatten = flatten
        self._param("weight", (units, in_units), dev, dt, weight_initializer)
        if use_bias:
            self._param("bias", (units,), dev, dt, bias_initializer)
        else:
            self.bias = None

    def forward(self, x):
        if self._flatten:
            x = flatten(x)
        return fully_connected(x, self.weight, self.bias)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (1 for NCHW, -1 for NHWC) with
    moving statistics (``ops.nn.batch_norm``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, dtype=None):
        super().__init__()
        if not in_channels:
            raise deferred("BatchNorm", "in_channels")
        dev, dt = resolve_device(device), torch_dtype(dtype)
        self._axis, self._momentum, self._eps = axis, momentum, epsilon
        self._scale, self._use_global_stats = scale, use_global_stats
        c = (in_channels,)
        self._param("gamma", c, dev, dt, gamma_initializer, scale)
        self._param("beta", c, dev, dt, beta_initializer, center)
        self._param("running_mean", c, dev, dt, running_mean_initializer,
                    False)
        self._param("running_var", c, dev, dt, running_variance_initializer,
                    False)

    def forward(self, x):
        out, new_mm, new_mv, _, _ = batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._eps, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=self.training)
        if self.training and not self._use_global_stats:
            with torch.no_grad():
                self.running_mean.copy_(new_mm)
                self.running_var.copy_(new_mv)
        return out


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return activation(x, self._act_type)


class Flatten(HybridBlock):
    def forward(self, x):
        return flatten(x)
