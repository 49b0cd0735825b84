"""The imperative trainer: ``loss.backward()`` then ``step(batch_size)``.

Port of ``mxnet_tpu/gluon/trainer.py`` ``Trainer`` on one device.  Over
Gluon ``Parameter``s (a ``ParameterDict`` in its order, a dict by sorted
key, a list, or a Gluon block's ``collect_params()``) it reads each
gradient from ``Parameter.grad()``, where a backward of ``autograd``
leaves it following ``grad_req``, and a gradient rebound there in
between (``g *= scale``) is the one applied.  A PyTorch ``backward`` on
the module's tensors leaves the gradient in the tensor's ``.grad``
instead; ``step`` takes it from there first.  Parameters whose
``grad_req`` is ``null`` are skipped; ``lr_mult``/``wd_mult`` come from
each ``Parameter``.  As in MXNet, a gradient that no backward refreshed
since the last step is stale: it raises, or with
``ignore_stale_grad=True`` the parameter is skipped.

Over a plain ``nn.Module`` (its ``parameters()``) or tensors, the
gradients are the tensors' ``.grad``: MXNet's ``backward()`` on a
non-scalar loss is ``loss.backward(torch.ones_like(loss))`` there, and
after the update the gradients are released, so the next backward
writes them afresh (``grad_req='write'``).

``step(batch_size)`` rescales by ``1 / batch_size`` and applies the
optimizer with the reference's dtype discipline (``Optimizer.apply``).
Gradient accumulation (``update_interval``), kvstores and
``save_states``/``load_states`` belong to the fused train step of a
later slice and raise ``MXNetError``.
"""
from __future__ import annotations

import weakref

import torch
from torch import nn

from .. import optimizer as opt_mod
from ..base import MXNetError
from .block import Block
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "", "device", "local")


def _later(what):
    return MXNetError(f"Trainer: {what} is not ported yet; it comes with a "
                      "later slice of mxnet_tpu_torch")


def _param_list(params):
    """(the parameters in the reference's order, whether they are Gluon
    ``Parameter``s)."""
    if isinstance(params, Block):
        params = params.collect_params()
    if isinstance(params, ParameterDict):
        params = list(params.values())
    elif isinstance(params, nn.Module):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = [params[k] for k in sorted(params)]
    elif not isinstance(params, (list, tuple)):
        raise MXNetError("params must be a ParameterDict, a dict, a list "
                         "or an nn.Module")
    params = list(params)
    gluon = bool(params) and all(isinstance(p, Parameter) for p in params)
    for p in params:
        if not isinstance(p, Parameter if gluon else torch.Tensor):
            raise MXNetError(f"invalid parameter {p!r}")
    return params, gluon


class Trainer:
    """``params``: see the module docstring."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, update_interval=1):
        self._params, self._gluon = _param_list(params)
        if int(update_interval) != 1:
            raise _later("update_interval (gradient accumulation)")
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore or \
                compression_params:
            raise _later("a kvstore")
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        # the gradient tensor each Parameter's last update consumed
        self._consumed = [None] * len(self._params)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size`` and update (reference
        ``Trainer.step``; there is nothing to allreduce on one device)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step``."""
        self._optimizer.rescale_grad = self._scale / float(batch_size)
        if self._gluon:
            self._update_params(ignore_stale_grad)
        else:
            self._update_tensors(ignore_stale_grad)

    def _apply(self, i, weight, grad):
        if not self._states_created[i]:
            self._states[i] = \
                self._optimizer.create_state_multi_precision(i, weight)
            self._states_created[i] = True
        self._states[i] = self._optimizer.update_multi_precision(
            i, weight, grad, self._states[i])

    def _update_params(self, ignore_stale_grad):
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            arr = p._data
            if arr is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(f"parameter {p.name} is not initialized; "
                                 "call initialize() and run a forward pass "
                                 "first")
            leaf = arr._data
            if leaf.grad is not None:       # left by a PyTorch backward
                arr._commit_grad(leaf.grad)
                leaf.grad = None
            grad = arr._grad._data
            seen = self._consumed[i]
            if seen is not None and seen() is grad:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"gradient of parameter {p.name} has not been updated "
                    "by a backward since the last step; run backward, or "
                    "step(ignore_stale_grad=True) to skip it")
            self._apply(i, leaf, grad)
            self._consumed[i] = weakref.ref(grad)

    def _update_tensors(self, ignore_stale_grad):
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"parameter {i} {tuple(p.shape)} has no gradient: run "
                    "backward first, or step(ignore_stale_grad=True)")
            self._apply(i, p, p.grad)
            p.grad = None

    def zero_grad(self):
        for p in self._params:
            if self._gluon:
                p.zero_grad()
            elif p.grad is not None:
                p.grad.zero_()

    def save_states(self, fname):
        raise _later("save_states (optimizer state checkpoints)")

    def load_states(self, fname):
        raise _later("load_states (optimizer state checkpoints)")
