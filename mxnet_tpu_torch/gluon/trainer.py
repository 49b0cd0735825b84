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
optimizer with the reference's dtype discipline, one grouped apply a
(multi-precision, dtype) group (``Optimizer.multi_update``, the fused
step's own apply).

``Trainer(update_interval=N)`` accumulates gradients over a window of N
micro-batches: ``step`` applies the optimizer at every Nth call, rescaled
once by ``1 / (N * batch_size)``, which needs ``grad_req='add'`` (a
``'write'`` buffer would keep only the last micro-batch), and
``allreduce_grads``/``update`` refuse to run mid-window.
``fused_step(loss_fn, *batch)`` runs forward, loss, backward, the
window's accumulation and the apply as one program (``gluon/
fused_step.py``): one CUDA-graph replay a call on the card.  It and
``step`` share one window, the same optimizer states (updated in place
by both, since a captured graph reads those tensors) and the same
update counts.

``save_states``/``load_states`` write and read the reference's pickle
(``num_update``, ``index_update_count``, the states as numpy arrays in
the reference's nesting, ``created``), so a file moves both ways between
the packages (``ndarray/serialization.py``; bf16 states without
``ml_dtypes``).  A load copies into the states that exist, in place (a
captured fused step reads their storage, and its next replay continues
from the loaded states), creates the others, and resets the
accumulation window and every fused step's ring.  Both are refused
mid-window.

Kvstores other than the local ones and ``data_sharding`` raise
``MXNetError``.
"""
from __future__ import annotations

import weakref

import numpy as np
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


def _copy_state(dst, src, what):
    """Copy a loaded state ``src`` (numpy arrays or tensors in a state's
    nesting) into the state ``dst`` in place, refusing another structure,
    shape or dtype."""
    if dst is None or src is None:
        if dst is not None or src is not None:
            raise MXNetError(f"load_states: {what} is None on one side only")
        return
    nested = isinstance(src, (tuple, list))
    if isinstance(dst, tuple) != nested or nested and len(src) != len(dst):
        raise MXNetError(f"load_states: {what} has another structure than "
                         "the optimizer's state")
    if nested:
        for k, (a, b) in enumerate(zip(dst, src)):
            _copy_state(a, b, f"{what}[{k}]")
        return
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src))
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise MXNetError(
            f"load_states: {what} is {tuple(src.shape)} {src.dtype} in the "
            f"file and {tuple(dst.shape)} {dst.dtype} in the trainer")
    with torch.no_grad():
        dst.copy_(src)


class Trainer:
    """``params``: see the module docstring."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, update_interval=1):
        self._params, self._gluon = _param_list(params)
        self._update_interval = int(update_interval)
        if self._update_interval < 1:
            raise MXNetError("update_interval must be >= 1")
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
        self._window_pos = 0        # micro-batches seen in this window
        # True while FusedStep's phase-by-phase path drives step(): it
        # accumulates 'write' gradients itself
        self._accum_managed = False
        # id(loss_fn) -> FusedStep (strong references keep ids unique)
        self._fused_steps = {}

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
        ``Trainer.step``; there is nothing to allreduce on one device).
        With ``update_interval=N``, ``batch_size`` is the micro-batch's:
        the first N-1 calls of a window only count, the Nth rescales once
        by ``1 / (N * batch_size)``, updates and zeroes the ``'add'``
        buffers."""
        N = self._update_interval
        if N > 1:
            self._window_pos += 1
            if self._window_pos == 1 and self._gluon and \
                    not self._accum_managed:
                bad = [p.name for p in self._params if p.grad_req == "write"]
                if bad:
                    self._window_pos = 0
                    raise MXNetError(
                        f"Trainer(update_interval={N}) with step() "
                        "requires grad_req='add' so micro-batch gradients "
                        "accumulate; these parameters have grad_req="
                        f"'write' (first: {bad[0]}) and each backward "
                        "would overwrite, not accumulate. Set grad_req="
                        "'add' (zero_grad() is then automatic at the "
                        "window boundary) or drive the window with "
                        "fused_step(), which accumulates on the device.")
            if self._window_pos < N:
                return
            self._window_pos = 0
            self._do_update(batch_size * N, ignore_stale_grad)
            if self._gluon:
                for p in self._params:
                    if p.grad_req == "add":
                        p.zero_grad()
            return
        self._do_update(batch_size, ignore_stale_grad)

    def _check_window_boundary(self, what):
        if self._update_interval > 1 and self._window_pos != 0:
            raise MXNetError(
                f"{what} called mid-accumulation window (micro-batch "
                f"{self._window_pos}/{self._update_interval} of "
                f"Trainer(update_interval={self._update_interval})): "
                "applying partial gradients would corrupt the accumulated "
                "update; call it only at the window boundary (after the "
                "Nth backward), or let step()/fused_step() drive the "
                "window")

    def allreduce_grads(self):
        """The reference's explicit allreduce, for the clip-then-update
        pattern: nothing to reduce on one card, refused mid-window."""
        self._check_window_boundary("allreduce_grads()")

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step``; with ``update_interval=N`` it
        rescales by ``1 / (N * batch_size)`` and is refused mid-window."""
        self._check_window_boundary("update()")
        self._do_update(batch_size * self._update_interval,
                        ignore_stale_grad)

    def _do_update(self, batch_size, ignore_stale_grad):
        self._optimizer.rescale_grad = self._scale / float(batch_size)
        if self._gluon:
            self._update_params(ignore_stale_grad)
        else:
            self._update_tensors(ignore_stale_grad)

    def _ensure_state(self, i):
        """Create parameter ``i``'s optimizer state once (shared by the
        fused step and the phase-by-phase update)."""
        if not self._states_created[i]:
            self._states[i] = \
                self._optimizer.create_state_multi_precision(
                    i, self._weight(i))
            self._states_created[i] = True

    def _weight(self, i):
        p = self._params[i]
        if not self._gluon:
            return p
        if p._data is None:
            raise MXNetError(f"parameter {p.name} is not initialized; call "
                             "initialize() and run a forward pass first")
        return p._data._data

    def _apply(self, idxs, weights, grads):
        for i in idxs:
            self._ensure_state(i)
        # updates the states in place: a captured fused step reads them
        self._optimizer.multi_update(
            idxs, weights, grads, [self._states[i] for i in idxs])

    def _update_params(self, ignore_stale_grad):
        idxs, weights, grads = [], [], []
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
            grad = arr._grad_buffer()._data
            seen = self._consumed[i]
            if seen is not None and seen() is grad:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"gradient of parameter {p.name} has not been updated "
                    "by a backward since the last step; run backward, or "
                    "step(ignore_stale_grad=True) to skip it")
            idxs.append(i)
            weights.append(leaf)
            grads.append(grad)
            self._consumed[i] = weakref.ref(grad)
        if idxs:
            self._apply(idxs, weights, grads)

    def _update_tensors(self, ignore_stale_grad):
        idxs, weights, grads = [], [], []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"parameter {i} {tuple(p.shape)} has no gradient: run "
                    "backward first, or step(ignore_stale_grad=True)")
            idxs.append(i)
            weights.append(p)
            grads.append(p.grad)
        if idxs:
            self._apply(idxs, weights, grads)
        for p in weights:
            p.grad = None

    def zero_grad(self):
        """Zero the gradient of every parameter that has one (the
        ``grad_req='add'`` accumulators' reset)."""
        for p in self._params:
            if self._gluon:
                if p.grad_req != "null":
                    p.zero_grad()
            elif p.grad is not None:
                p.grad.zero_()

    def fused_step(self, loss_fn, *batch, batch_size=None,
                   data_sharding=None):
        """One training step as one program: forward, loss, backward,
        the gradient rescale and the optimizer apply (``gluon/
        fused_step.py``), a CUDA-graph replay on the card.
        ``loss_fn(*batch)`` takes NDArrays and returns the per-sample
        loss, or ``(loss, *extras)``; define it once outside the loop
        (the step is cached by ``id(loss_fn)``).  ``batch_size`` defaults
        to ``batch[0].shape[0]``.  With ``update_interval=N`` the
        gradients accumulate on the device and the apply, rescaled by
        ``1 / (N * batch_size)``, runs at every Nth call.  The
        parameters' ``grad()`` buffers are never touched.
        ``MXNET_FUSED_STEP=0`` runs the phase-by-phase step instead."""
        from .fused_step import FusedStep

        if not self._gluon:
            raise MXNetError(
                "fused_step needs a Trainer over Gluon Parameters (a "
                "block's collect_params()); over an nn.Module or tensors "
                "use backward() and step(), or parallel.SPMDTrainer")
        if data_sharding is not None:
            raise MXNetError("fused_step: data_sharding lays a batch over "
                             "several devices; the port runs one card")
        fs = self._fused_steps.get(id(loss_fn))
        if fs is None:
            if len(self._fused_steps) >= 16:
                self._fused_steps.pop(next(iter(self._fused_steps)))
                if not getattr(self, "_fused_evict_warned", False):
                    import warnings
                    warnings.warn(
                        "fused_step: more than 16 distinct loss_fn objects "
                        "seen; define the loss_fn once outside the "
                        "training loop, or every call captures again",
                        stacklevel=2)
                    self._fused_evict_warned = True
            fs = self._fused_steps[id(loss_fn)] = FusedStep(self, loss_fn)
        return fs(batch, batch_size)

    def save_states(self, fname):
        """Pickle the optimizer's update counts and states (reference
        ``Trainer.save_states``); refused mid-window, where the
        accumulated gradients would be lost."""
        from ..ndarray import serialization

        self._check_window_boundary("save_states()")
        opt = self._optimizer
        serialization.save_states(fname, {
            "num_update": opt.num_update,
            "index_update_count": dict(opt._index_update_count),
            "states": [s if c else None for s, c in
                       zip(self._states, self._states_created)],
            "created": list(self._states_created)})

    def load_states(self, fname):
        """Load a states file of either package (reference
        ``Trainer.load_states``): in place into the states that exist,
        each checked for structure, shape and dtype; the others are
        created first.  The accumulation window and the fused steps'
        rings start afresh."""
        from ..ndarray import serialization

        self._check_window_boundary("load_states()")
        payload = serialization.load_states(fname)
        states, created = payload["states"], list(payload["created"])
        if len(states) != len(self._params) or \
                len(created) != len(self._params):
            raise MXNetError(
                f"load_states: the file holds {len(states)} states, the "
                f"trainer has {len(self._params)} parameters")
        for i, (saved, made) in enumerate(zip(states, created)):
            if not (made or self._states_created[i]):
                continue
            self._ensure_state(i)
            if not made:
                # the state the next update would create, written into
                # the tensors a captured step reads
                saved = self._optimizer.create_state_multi_precision(
                    i, self._weight(i))
            _copy_state(self._states[i], saved, f"state {i}")
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(
            payload["index_update_count"])
        self._window_pos = 0
        for fs in self._fused_steps.values():
            if fs._accum is not None:
                for a in fs._accum:
                    a.zero_()
            fs._legacy_accum = None
