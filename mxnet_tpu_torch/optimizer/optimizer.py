"""Optimizers: the reference's update rules on torch tensors.

Port of ``mxnet_tpu/optimizer/optimizer.py`` (the base class, SGD, Adam
and AdamW).  Every optimizer defines one update rule
``_update_rule(weight, grad, state, lr, wd, t) -> (new_weight,
new_state)``, the reference's own formula, with the reference's bias
correction and weight-decay placement (AdamW is not
``torch.optim.AdamW``: its decay is scaled by the bias-corrected
``lr_t`` and epsilon is added to the uncorrected ``sqrt(v)``).

``apply`` is the one place a rule meets a parameter, with the
reference's dtype discipline (``Optimizer._apply_one`` /
``SPMDTrainer._make_step_fn``): without multi-precision the gradient is
cast to the weight's dtype before rescale and clip, and the new weight
is rounded back; with ``multi_precision`` and a half-precision weight
the f32 master copy is updated and then rounded into the weight.  The
weight is updated in place; the new state is returned.  Both
``gluon.Trainer`` and ``parallel.SPMDTrainer`` go through it.

Learning-rate schedulers and the fused multi-tensor executables of the
reference belong to later slices of the port and are absent here.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "register", "create"]

_REGISTRY: dict = {}
_HALF = (torch.float16, torch.bfloat16)


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name}")
    return _REGISTRY[name.lower()](**kwargs)


def _cast_like(ref, new):
    """Cast each tensor of ``new`` to the dtype of the matching tensor of
    ``ref`` (a state keeps its dtype from step to step)."""
    if isinstance(ref, tuple):
        return tuple(_cast_like(a, b) for a, b in zip(ref, new))
    if isinstance(ref, torch.Tensor):
        return new.to(ref.dtype)
    return new


class Optimizer:
    """Base optimizer (reference anchor ``class Optimizer``)."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, multi_precision=False, param_dict=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: dict = {}
        self.param_dict = dict(param_dict or {})
        self.lr_mult: dict = {}
        self.wd_mult: dict = {}

    # -- lr/wd plumbing ---------------------------------------------------- #
    @property
    def learning_rate(self):
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _get_lr(self, index):
        """``lr`` times the parameter's ``lr_mult`` attribute (a trainer's
        ``param_dict``) or the index's ``set_lr_mult`` entry."""
        lr = self.learning_rate
        if index in self.param_dict:
            return lr * getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            return wd * getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd * self.wd_mult.get(index, 1.0)

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    # -- state ------------------------------------------------------------- #
    def create_state(self, index, weight):
        """The state tensors of one parameter (None for a stateless
        rule)."""
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype in _HALF:
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _use_mp(self, weight, state):
        return (self.multi_precision and weight.dtype in _HALF
                and isinstance(state, tuple) and len(state) == 2
                and getattr(state[0], "dtype", None) == torch.float32)

    # -- update ------------------------------------------------------------ #
    def _update_rule(self, weight, grad, state, lr, wd, t):
        """Pure: (w, g, state, lr, wd, step) -> (new_w, new_state)."""
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, weight, grad, state, lr, wd, t, rescale, use_mp):
        """One parameter's update with the reference's dtype discipline;
        ``weight`` is updated in place, the new state returned."""
        clip = self.clip_gradient
        if use_mp:
            master, inner = state
            g = grad.float() * rescale
            if clip is not None:
                g = g.clamp(-clip, clip)
            new_master, new_inner = self._update_rule(master, g, inner, lr,
                                                      wd, t)
            weight.copy_(new_master)
            return (new_master, _cast_like(inner, new_inner))
        g = grad.to(weight.dtype) * rescale
        if clip is not None:
            g = g.clamp(-clip, clip)
        new_w, new_state = self._update_rule(weight.detach(), g, state, lr,
                                             wd, t)
        weight.copy_(new_w)
        return _cast_like(state, new_state)

    def update(self, index, weight, grad, state):
        """Update one parameter in place (reference ``Optimizer.update``,
        with the per-index update count that gives Adam its step ``t``);
        returns the new state."""
        return self._update(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        """``update`` through the f32 master copy when multi-precision
        holds for this weight (reference ``update_multi_precision``)."""
        return self._update(index, weight, grad, state,
                            self._use_mp(weight, state))

    def _update(self, index, weight, grad, state, use_mp):
        self._update_count(index)
        return self.apply(weight, grad, state, self._get_lr(index),
                          self._get_wd(index),
                          self._index_update_count[index],
                          self.rescale_grad, use_mp)


@register
class SGD(Optimizer):
    """SGD with momentum (reference anchors ``sgd_update`` /
    ``sgd_mom_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight.detach())

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if self.momentum == 0.0:
            return w - lr * g, None
        mom = state * self.momentum - lr * g
        return w + mom, mom


@register
class Adam(Optimizer):
    """Reference anchor ``adam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        w = weight.detach()
        return (torch.zeros_like(w), torch.zeros_like(w))  # mean, var

    def _moments(self, g, state, t):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        lr_scale = math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        return m, v, lr_scale

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        m, v, lr_scale = self._moments(g, state, t)
        return w - lr * lr_scale * m / (v.sqrt() + self.epsilon), (m, v)


@register
class AdamW(Adam):
    """Decoupled weight decay (reference contrib ``adamw_update``):
    ``w - lr_t * (m / (sqrt(v) + eps) + wd * w)``."""

    def _update_rule(self, w, g, state, lr, wd, t):
        m, v, lr_scale = self._moments(g, state, t)
        return w - lr * lr_scale * (m / (v.sqrt() + self.epsilon) +
                                    wd * w), (m, v)
