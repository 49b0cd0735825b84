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
weight is updated in place; the new state is returned.  The
per-parameter ``update`` and ``parallel.SPMDTrainer`` go through it.

``fused_step_apply`` is the multi-tensor apply of ``Trainer.step``
(through ``multi_update``) and of the fused train step
(``gluon/fused_step.py``, inside a program that a CUDA graph captures):
learning rates, weight decays, step counts and the gradient rescale are
device tensors, so one graph serves every step.  ``_apply_one`` copies
the reference's dtype discipline line for line, which differs from
``apply`` in two places: the f32 ``lr``/``wd`` tensors promote a
low-precision update to f32 (as the reference's traced f32 scalars do),
and Adam's bias correction is computed on the device in f32 from the
step tensor (as ``-expm1(t log beta)``, which keeps f32 within ~1e-7 of
``apply``'s host f64, where the reference's ``1 - beta ** t`` loses
1.3e-5).  ``SPMDTrainer`` asks for its reference's own arithmetic
(``spmd``; ``SGD._spmd_rule``).  ``MXNET_FUSED_OPTIMIZER=0`` makes
``multi_update`` run the per-parameter ``update_multi_precision`` loop
instead, bit for bit the path before the grouped apply.

An optimizer built with ``lr_scheduler=`` reads its learning rate from
the scheduler at every update (``optimizer/lr_scheduler.py``).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "register", "create",
           "apply_counters", "reset_apply_counters", "fused_enabled"]

_REGISTRY: dict = {}
_HALF = (torch.float16, torch.bfloat16)

# grouped applies of ``multi_update`` (reference names):
#   fused_calls      grouped applies (one a group a step)
#   fused_params     parameters those applies served
#   fallback_params  parameters that took the per-parameter loop
apply_counters = {"fused_calls": 0, "fused_params": 0, "fallback_params": 0}


def reset_apply_counters():
    for k in apply_counters:
        apply_counters[k] = 0


def fused_enabled() -> bool:
    """``MXNET_FUSED_OPTIMIZER=0`` restores the per-parameter update loop
    (read per call)."""
    return os.environ.get("MXNET_FUSED_OPTIMIZER", "1") != "0"


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


def _tensor(x):
    return x._data if hasattr(x, "_data") else x


def _assign(dst, src):
    """Copy the tensors of ``src`` into those of ``dst`` (a state's
    structure: a tensor, a tuple of them, or None), in place."""
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _assign(a, b)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        dst.copy_(src.reshape(dst.shape))


def _write(dst, values, words=()):
    """Copy the numbers ``values``, then the uint32 ``words`` as raw bits
    (a program's keys, read on the device through an int32 view), into
    the f32 vector ``dst``.  On the card the copy leaves from pinned
    memory without blocking the host; PyTorch's pinned allocator keeps
    the block from reuse until the copy has run, so a later write cannot
    overtake it."""
    n = len(values)
    host = np.empty(n + len(words), dtype=np.float32)
    host[:n] = values
    host[n:].view(np.uint32)[:] = words
    host = torch.from_numpy(host)
    dst.copy_(host.pin_memory() if dst.is_cuda else host, non_blocking=True)
    return dst


class Optimizer:
    """Base optimizer (reference anchor ``class Optimizer``)."""

    # every rule of the port is a pure function of its operands (the
    # reference's SGLD, which draws host noise, is not ported)
    _fusable = True

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
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
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "active")
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

    def _spmd_rule(self, weight, grad, state, lr, wd, t):
        """``_update_rule`` on a weight without a master copy as the
        reference's jitted ``SPMDTrainer`` step computes it: the rule
        itself unless a subclass says otherwise (ROADMAP §3)."""
        return self._update_rule(weight, grad, state, lr, wd, t)

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

    # -- the fused apply ---------------------------------------------------- #
    def _hyper_key(self):
        """The scalar hyperparameters the rules read as Python numbers
        (momentum, betas, epsilon, ...): part of a captured step's key, so
        changing one captures again.  Per-step quantities (lr, wd,
        rescale, step counts) are device operands and left out."""
        skip = {"rescale_grad", "num_update", "begin_num_update", "lr",
                "wd", "clip_gradient"}
        return tuple(sorted(
            (k, v) for k, v in self.__dict__.items()
            if k not in skip and isinstance(v, (bool, int, float, str))))

    def _apply_one(self, w, g, s, lr, wd, t, rescale, clip, use_mp,
                   has_clip, spmd=False):
        """One parameter's update with device operands (``lr``, ``wd``:
        f32 tensors of the weight's rank, so that they promote it as the
        reference's traced f32 scalars do, where a 0-dim tensor would
        not; ``t``, ``rescale``: f32 scalars; ``clip`` a number read when
        the step is captured): the reference's ``_apply_one``, dtype for
        dtype.  Pure: returns ``(new_weight, new_state)`` before their
        rounding, which the in-place copies into the weight and the
        state tensors do (``copy_`` rounds as the reference's ``astype``
        does).  ``spmd``: a weight without a master copy takes the
        reference ``SPMDTrainer`` step's arithmetic instead (its
        ``step_fn``: the gradient rescaled in f32, then rounded;
        ``_spmd_rule``)."""
        if use_mp:
            master, inner = s
            g2 = g.float() * rescale
            if has_clip:
                g2 = g2.clamp(-clip, clip)
            nm, ni = self._update_rule(master, g2, inner, lr, wd, t)
            return nm, (nm, ni)
        # the gradient reaches the weight's dtype before the clip: cast
        # first, then rescaled, as on the per-parameter path (rescaled in
        # f32, then cast, on the SPMD path); the f32 lr/wd then promote
        # the rule's arithmetic to f32 before the rounding back
        if spmd:
            g2 = (g.float() * rescale).to(w.dtype)
        else:
            g2 = g.to(w.dtype) * rescale.to(w.dtype)
        if has_clip:
            g2 = g2.clamp(-clip, clip)
        rule = self._spmd_rule if spmd else self._update_rule
        return rule(w, g2, s, lr, wd, t)

    @torch.no_grad()
    def fused_step_apply(self, ws, gs, ss, mp_flags, lrs, wds, ts, rescale,
                         spmd=False):
        """The multi-tensor apply of ``multi_update`` and of the fused
        train step: every weight, master copy and state updated in place
        (their storage is what a captured graph reads and writes);
        ``lrs``, ``wds``, ``ts`` are f32 vectors with one entry a
        parameter, ``rescale`` the device scalar that carries the
        accumulation window's 1/(N*batch).  ``clip_gradient`` is read
        here, when the step is captured (it is part of the step's key).
        ``spmd``: the reference ``SPMDTrainer`` step's arithmetic on
        weights without a master copy (``_apply_one``).  Returns
        ``(ws, ss)``."""
        has_clip = self.clip_gradient is not None
        clip = float(self.clip_gradient) if has_clip else 0.0
        # each parameter's lr and wd as views of the weight's rank, made
        # by one reshape and one unbind a rank (the host's cost of the
        # apply is a few calls a parameter)
        ranks = {w.dim() for w in ws}
        lr_of = {r: lrs.reshape(-1, *[1] * r).unbind() for r in ranks}
        wd_of = {r: wds.reshape(-1, *[1] * r).unbind() for r in ranks}
        ts = ts.unbind()
        for i, (w, g, s, mp) in enumerate(zip(ws, gs, ss, mp_flags)):
            r = w.dim()
            nw, ns = self._apply_one(w, g, s, lr_of[r][i], wd_of[r][i],
                                     ts[i], rescale, clip, mp, has_clip,
                                     spmd)
            w.copy_(nw)
            _assign(s, ns)
        return ws, ss

    def multi_update(self, indices, weights, grads, states):
        """Update many parameters (tensors or NDArrays) as the reference's
        ``multi_update`` does: grouped by (multi-precision, dtype,
        device), each group's learning rates, weight decays and step
        counts one device vector, and ``fused_step_apply`` over the group
        (the fused train step's own apply, so the two cannot drift).
        Weights and states are updated in place; returns ``states``.
        ``MXNET_FUSED_OPTIMIZER=0`` runs ``update_multi_precision``
        parameter by parameter, bit for bit the per-parameter loop, and
        writes its states into the same tensors."""
        ws = [_tensor(w) for w in weights]
        gs = [_tensor(g) for g in grads]
        if not (fused_enabled() and self._fusable):
            for pos, idx in enumerate(indices):
                _assign(states[pos], self.update_multi_precision(
                    idx, ws[pos], gs[pos], states[pos]))
                apply_counters["fallback_params"] += 1
            return list(states)
        groups: dict = {}
        for pos, w in enumerate(ws):
            use_mp = self._use_mp(w, states[pos])
            groups.setdefault((use_mp, w.dtype, w.device), []).append(pos)
        for (use_mp, _dt, dev), poss in groups.items():
            lrs, wds, ts = [], [], []
            for pos in poss:
                idx = indices[pos]
                self._update_count(idx)
                lrs.append(self._get_lr(idx))
                wds.append(self._get_wd(idx))
                ts.append(self._index_update_count[idx])
            n = len(poss)
            hyper = _write(torch.empty(3 * n + 1, dtype=torch.float32,
                                       device=dev),
                           lrs + wds + ts + [self.rescale_grad])
            self.fused_step_apply(
                [ws[p] for p in poss], [gs[p] for p in poss],
                [states[p] for p in poss], [use_mp] * n, hyper[:n],
                hyper[n:2 * n], hyper[2 * n:3 * n], hyper[3 * n])
            apply_counters["fused_calls"] += 1
            apply_counters["fused_params"] += n
        return list(states)


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

    def _spmd_rule(self, w, g, state, lr, wd, t):
        """``_update_rule`` as the reference's jitted ``SPMDTrainer`` step
        computes it (``mxnet_tpu/parallel/spmd.py:257-281``): there
        ``wd`` and the momentum are Python numbers, which JAX turns into
        the weight's dtype first (weak types), and XLA rounds ``wd * w``
        to that dtype but keeps the sum and the momentum's product in
        f32.  ``wd`` is the f32 device operand here, rounded the same
        way.  On an f32 weight this is ``_update_rule`` bit for bit.
        ``tests/test_torch_spmd.py`` holds a bf16 weight to the
        reference ulp for ulp."""
        g = g.float() + (w * wd.to(w.dtype)).float()
        if self.momentum == 0.0:
            return w - lr * g, None
        momentum = float(torch.tensor(self.momentum, dtype=w.dtype))
        mom = state.float() * momentum - lr * g
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
        if isinstance(t, torch.Tensor):
            # the fused step's f32 device step count.  1 - beta ** t as
            # -expm1(t log beta): the reference's f32 ``1 - 0.999 ** t``
            # loses 1.3e-5 of its value at t=1 (0.999 is not an f32)
            lr_scale = torch.sqrt(-torch.expm1(t * math.log(self.beta2))) \
                / -torch.expm1(t * math.log(self.beta1))
        else:
            lr_scale = math.sqrt(1 - self.beta2 ** t) / \
                (1 - self.beta1 ** t)
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

