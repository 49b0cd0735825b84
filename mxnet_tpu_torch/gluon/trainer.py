"""The imperative trainer: ``loss.backward()`` then ``step(batch_size)``.

Port of ``mxnet_tpu/gluon/trainer.py`` ``Trainer`` on one device.
Gradients come from PyTorch's autograd; MXNet's ``backward()`` on a
non-scalar loss uses a head gradient of ones, which is
``loss.backward(torch.ones_like(loss))`` here.  ``step(batch_size)``
rescales the summed gradients by ``1 / batch_size`` and applies the
optimizer to every parameter that has a gradient, with the reference's
dtype discipline (``Optimizer.apply``).  After the update the gradients
are released, so the next backward writes them afresh, as the
reference's ``grad_req='write'`` does (PyTorch's backward otherwise
adds to them).

Gradient accumulation (``update_interval``) and kvstores belong to
later slices of the port and raise ``MXNetError``; ``save_states``,
``load_states`` and ``fused_step`` are absent until then.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import optimizer as opt_mod
from ..base import MXNetError

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "", "device", "local")


def _later(what):
    return MXNetError(f"Trainer: {what} is not ported yet; it comes with a "
                      "later slice of mxnet_tpu_torch")


class Trainer:
    """``params``: a dict of name -> parameter (taken in sorted-name
    order, as the reference does), a list of parameters, or an
    ``nn.Module`` (its ``parameters()``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, update_interval=1):
        if isinstance(params, nn.Module):
            params = list(params.parameters())
        elif isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        elif not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a dict, a list or an "
                             "nn.Module")
        for p in params:
            if not isinstance(p, torch.Tensor):
                raise MXNetError(f"invalid parameter {p!r}")
        if int(update_interval) != 1:
            raise _later("update_interval (gradient accumulation)")
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore or \
                compression_params:
            raise _later("a kvstore")
        self._params = list(params)
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
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"parameter {i} {tuple(p.shape)} has no gradient: run "
                    "backward first, or step(ignore_stale_grad=True)")
            if not self._states_created[i]:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, p)
                self._states_created[i] = True
            self._states[i] = self._optimizer.update_multi_precision(
                i, p, p.grad, self._states[i])
            p.grad = None

    def zero_grad(self):
        for p in self._params:
            if p.grad is not None:
                p.grad.zero_()
