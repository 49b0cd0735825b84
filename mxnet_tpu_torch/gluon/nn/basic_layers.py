"""Basic layers.

Port of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``Activation``, ``Flatten`` with a ``forward`` on tensors (the models'
paths) and the reference's ``hybrid_forward``, which a symbol capture
runs (``Block._capture_runs``: an exported graph records the
reference's ops); ``LayerNorm``, ``RMSNorm``, ``InstanceNorm``, ``GroupNorm``,
``Embedding``, ``Lambda``, ``HybridLambda``, ``LeakyReLU``, ``PReLU``,
``ELU``, ``SELU``, ``GELU``, ``Swish`` and ``SyncBatchNorm`` (BatchNorm
on one card) written with ``hybrid_forward`` over ``mx.nd`` as the
reference writes them.  Their parameters are Gluon
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

from ...amp.amp import layer_cast
from ...ops.nn import (activation, batch_norm, dropout, flatten,
                       fully_connected)
from ..block import Block, HybridBlock, _nd_call

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Activation", "Flatten", "LayerNorm", "RMSNorm",
           "InstanceNorm", "GroupNorm", "Embedding", "Lambda",
           "HybridLambda", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SyncBatchNorm"]


class _Stack:
    """Blocks run in order (``Sequential`` and ``HybridSequential``)."""

    _capture_runs = "forward"

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

    _capture_runs = "hybrid_forward"

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
        # the reference's F.FullyConnected, cast as amp.init says
        out = fully_connected(*layer_cast("FullyConnected", x, p["weight"],
                                          p.get("bias")))
        return self.act(out) if self.act is not None else out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Reference ``gluon.nn.Dropout``: ``ops.nn.dropout`` at ``rate``
    (the mask shared along ``axes``) in training mode, the identity
    otherwise.  Its masks come from the device generator, which a
    hybridized or fused step's graph advances at every replay."""

    _capture_runs = "hybrid_forward"

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        if self._rate <= 0:
            return x
        return dropout(x, self._rate, self._is_training(), axes=self._axes)

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (1 for NCHW, -1 for NHWC) with
    moving statistics (``ops.nn.batch_norm``)."""

    _capture_runs = "hybrid_forward"

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
            self._commit(new_mm, new_mv)
        return out

    def _commit(self, new_mm, new_mv):
        p = self._parameters
        with torch.no_grad():
            p["running_mean"].copy_(new_mm)
            p["running_var"].copy_(new_mv)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd

        training = autograd.is_training()
        out, new_mm, new_mv, _, _ = F._BatchNormStats(
            x, gamma, beta, running_mean, running_var, eps=self._eps,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training and not self._use_global_stats:
            self._commit(new_mm._data, new_mv._data)
        return out


class Activation(HybridBlock):
    _capture_runs = "hybrid_forward"

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation

    def forward(self, x):
        return activation(x, self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Flatten(HybridBlock):
    _capture_runs = "hybrid_forward"

    def forward(self, x):
        return flatten(x)

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class SyncBatchNorm(BatchNorm):
    """The reference's cross-device BatchNorm: on one card, BatchNorm
    over axis 1 (the port runs no data-parallel mesh, so the batch is
    the global batch)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)


class _Norm(HybridBlock):
    """A norm layer with ``gamma`` (and ``beta`` unless ``beta`` is
    None) of the input's channel count along ``axis``."""

    def __init__(self, axis, epsilon, in_channels, gamma_initializer,
                 beta_initializer=None, scale=True, center=True,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._axis, self._eps = axis, epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            if beta_initializer is not None:
                self.beta = self.params.get(
                    "beta", shape=(in_channels,), init=beta_initializer,
                    allow_deferred_init=True, differentiable=center)
        self._place(device)

    def infer_shape(self, x, *args):
        ch = x.shape[self._axis]
        for p in self._reg_params.values():
            p.shape = (ch,)

    def __repr__(self):
        return f"{type(self).__name__}(axis={self._axis}, eps={self._eps})"


class LayerNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, in_channels, gamma_initializer,
                         beta_initializer, scale, center, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class RMSNorm(_Norm):
    """Root-mean-square norm (the Llama family's; the reference's
    addition)."""

    def __init__(self, axis=-1, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, in_channels, gamma_initializer,
                         **kwargs)

    def hybrid_forward(self, F, x, gamma):
        return F.RMSNorm(x, gamma, axis=self._axis, eps=self._eps)


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, in_channels, gamma_initializer,
                         beta_initializer, scale, center, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class GroupNorm(_Norm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, in_channels, gamma_initializer,
                         beta_initializer, scale, center, **kwargs)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._eps)


class Embedding(HybridBlock):
    """Index -> row lookup; weight (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim, self._output_dim = input_dim, output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)
        self._place(device)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Lambda(Block):
    """A function of NDArrays as a block (``function`` or the name of an
    ``mx.nd`` op)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F
            function = getattr(F, function)
        self._func = function

    _capture_runs = "forward"

    def forward(self, *args):
        return _nd_call(self, self._func, args, {})


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` (or the ``mx.nd`` op of that name) as a
    hybrid block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = lambda F, *a: getattr(F, function)(*a)
        else:
            self._func = function

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope per channel (axis 1)."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or init_mod.Constant(0.25))
        self._place(device)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, the exact form (``approximation="erf"``) or the tanh one."""

    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._approx = approximation

    def hybrid_forward(self, F, x):
        return F.Activation(
            x, act_type="gelu" if self._approx != "erf" else "erf_gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        if self._beta == 1.0:
            return F.Activation(x, act_type="swish")
        return x * F.sigmoid(self._beta * x)
