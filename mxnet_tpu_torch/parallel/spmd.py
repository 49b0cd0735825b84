"""The performance-path trainer: ``step(data, label)`` runs forward, the
mean loss, backward and the optimizer update of every parameter.

Port of ``mxnet_tpu/parallel/spmd.py`` ``SPMDTrainer`` on one device.
The reference compiles the step into one program over a device mesh;
here it runs eagerly on the block's device, with the same numerics: the
loss is the mean of the loss function's per-sample output, gradients of
the trainable parameters (``requires_grad``) come from autograd (a
parameter the loss does not reach gets a zero gradient, as
``jax.value_and_grad`` gives it), and each update follows the
reference's multi-precision / plain dtype discipline
(``Optimizer.apply``) with the trainer's step count as Adam's ``t``.

The trainable parameters are collected after the first forward, so a
Gluon net whose layers infer their sizes there (deferred initialization)
trains all of them.

``run_steps`` is a Python loop over the leading axis of ``data`` and
``label``; it returns the losses as one device tensor and reads nothing
back to the host inside the loop.  A mesh or sharding rules over more
than one device belong to a later slice of the port and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError

__all__ = ["SPMDTrainer"]


def _mesh_devices(mesh):
    """How many devices ``mesh`` names: None is the block's own device;
    a device or device string is one; a list, tuple or dict (axis ->
    size) names their count (or product)."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return 1
    if isinstance(mesh, dict):
        n = 1
        for size in mesh.values():
            n *= int(size)
        return n
    if isinstance(mesh, (list, tuple)):
        return len(mesh)
    raise MXNetError(f"SPMDTrainer: unsupported mesh {mesh!r}")


class SPMDTrainer:
    def __init__(self, block, loss_fn: Callable, optimizer,
                 optimizer_params: Optional[dict] = None, mesh=None,
                 rules=None, dp_axis: str = "dp", donate: bool = True):
        if _mesh_devices(mesh) != 1:
            raise MXNetError(
                "SPMDTrainer: a mesh over more than one device is not "
                "ported yet; it comes with a later slice of "
                "mxnet_tpu_torch (one device here)")
        # ``rules`` and ``dp_axis`` shard nothing on one device, and
        # ``donate`` is moot: the update is in place
        self._block = block
        self._loss_fn = loss_fn
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, opt_mod.Optimizer):
            self._opt = optimizer
            self._rescale = float(optimizer_params.pop(
                "rescale_grad", optimizer.rescale_grad))
        else:
            self._rescale = float(optimizer_params.pop("rescale_grad", 1.0))
            self._opt = opt_mod.create(optimizer, **optimizer_params)
        self._t = 0
        self._params: list = []
        self._states: list = []
        self._mp: list = []

    @property
    def optimizer(self):
        return self._opt

    @property
    def learning_rate(self):
        return self._opt.learning_rate

    def set_learning_rate(self, lr):
        self._opt.set_learning_rate(lr)

    def _ensure_built(self):
        if self._params:
            return
        self._params = [p for p in self._block.parameters()
                        if p.requires_grad]
        if not self._params:
            raise MXNetError("SPMDTrainer: the block has no trainable "
                             "parameter")
        self._states = [self._opt.create_state_multi_precision(i, p)
                        for i, p in enumerate(self._params)]
        self._mp = [self._opt._use_mp(p, s)
                    for p, s in zip(self._params, self._states)]

    def _device(self):
        """The block's device (None while every parameter waits on the
        first forward: the data then stays where it is)."""
        p = next(self._block.parameters(), None)
        return None if p is None else p.device

    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            dev = self._device()
            return x if dev is None else x.to(dev)
        return torch.as_tensor(x, device=self._device())

    def _forward_loss(self, data, label):
        self._block.train()
        out = self._block(data)
        out0 = out[0] if isinstance(out, (list, tuple)) else out
        return self._loss_fn(out0, label).mean()

    def step(self, data, label, batch_size: Optional[int] = None):
        """One train step; returns the loss as a device scalar (nothing
        is read back to the host).  ``batch_size`` divides the gradient
        (the gradient is the mean loss's, so the default is 1)."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        loss = self._forward_loss(data, label)
        self._ensure_built()
        self._t += 1
        self._opt.num_update = self._t
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        lr = self._opt.learning_rate
        rescale = self._rescale / (batch_size if batch_size else 1.0)
        for i, (p, g) in enumerate(zip(self._params, grads)):
            if g is None:
                g = torch.zeros_like(p)
            self._states[i] = self._opt.apply(
                p, g, self._states[i], lr * getattr(p, "lr_mult", 1.0),
                self._opt.wd * getattr(p, "wd_mult", 1.0), self._t,
                rescale, self._mp[i])
        return loss.detach()

    def run_steps(self, data, label, batch_size: Optional[int] = None):
        """``data``/``label`` carry a leading steps axis (N, batch, ...);
        runs N steps and returns the (N,) losses as a device tensor."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        return torch.stack([self.step(data[i], label[i], batch_size)
                            for i in range(data.shape[0])])
