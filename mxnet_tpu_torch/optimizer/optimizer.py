"""Optimizers: the reference's update rules on torch tensors.

Port of ``mxnet_tpu/optimizer/optimizer.py``: the base class and the
reference's fifteen optimizers (SGD, NAG, Adam, AdamW, Nadam, LAMB,
LARS, RMSProp, AdaGrad, AdaDelta, Ftrl, FTML, Signum, DCASGD, SGLD),
registered under the reference's names, with its ``adagrad`` and
``adadelta`` aliases.  Every optimizer defines one update rule
``_update_rule(weight, grad, state, lr, wd, t) -> (new_weight,
new_state)``, the reference's own formula, with the reference's bias
correction and weight-decay placement (AdamW is not
``torch.optim.AdamW``: its decay is scaled by the bias-corrected
``lr_t`` and epsilon is added to the uncorrected ``sqrt(v)``).

``apply`` is the one place a rule meets a parameter on the
per-parameter path, with the reference's dtype discipline: without
multi-precision the gradient is cast to the weight's dtype before
rescale and clip, and the new weight is rounded back; with
``multi_precision`` and a half-precision weight the f32 master copy is
updated and then rounded into the weight.  The weight is updated in
place; the new state is returned.  The per-parameter ``update`` goes
through it.

``fused_step_apply`` is the multi-tensor apply of ``Trainer.step``
(through ``multi_update``), of the fused train step (``gluon/
fused_step.py``, inside a program that a CUDA graph captures) and of
``parallel.SPMDTrainer``: learning rates, weight decays, step counts
and the gradient rescale are device tensors, so one graph serves every
step.  ``_apply_one`` copies the reference's dtype discipline line for
line: the f32 ``lr``/``wd`` tensors promote a low-precision update to
f32 (as the reference's traced f32 scalars do), and on f32 arithmetic
Adam's bias correction is computed on the device from the step tensor
(as ``-expm1(t log beta)``, which keeps f32 within ~1e-7 of ``apply``'s
host f64, where the reference's ``1 - beta ** t`` loses 1.3e-5).
``MXNET_FUSED_OPTIMIZER=0`` makes ``multi_update`` run the
per-parameter ``update_multi_precision`` loop instead, bit for bit the
path before the grouped apply.

Half-precision weights without a master copy take the reference's
constant typing (``_Half``): JAX turns a Python number that meets a
bf16 array into bf16 first (a weak type), so ``0.9`` is ``0.8984375``
and Adam's ``0.999`` is ``1.0`` on a bf16 state, while a strong f32
operand (the Gluon path's traced ``lr`` and ``wd``) promotes the
expression to f32.  Inside the reference's jitted apply XLA then keeps
the arithmetic between the arrays' own roundings in f32 (a clip, a
comparison, a norm round their operand or result); the eager
per-parameter path rounds after every operation.  On the SPMD path
``wd`` is a Python number, and XLA rounds ``wd * w`` to the weight's
dtype.  ``tests/test_torch_optimizer_bf16.py`` holds SGD, Adam and
AdamW to the reference's ``multi_update`` ulp for ulp.

An optimizer built with ``lr_scheduler=`` reads its learning rate from
the scheduler at every update (``optimizer/lr_scheduler.py``).
"""
from __future__ import annotations

import functools
import math
import operator
import os

import numpy as np
import torch

from ..base import MXNetError

__all__ = [
    "Optimizer", "SGD", "NAG", "Adam", "AdamW", "Nadam", "LAMB", "LARS",
    "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "FTML", "Signum", "DCASGD",
    "SGLD", "register", "create", "apply_counters", "reset_apply_counters",
    "fused_enabled"]

_REGISTRY: dict = {}
_HALF = (torch.float16, torch.bfloat16)

# grouped applies of ``multi_update`` (reference names):
#   fused_calls      grouped applies (one a group chunk a step)
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


# --------------------------------------------------------------------------- #
# the reference's constant typing on half-precision operands
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _rounded(c, dtype):
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


class _Half:
    """An operand of a rule on a half-precision weight without a master
    copy, as the reference computes it: a node of the rule's expression,
    typed as JAX types it (``dtype``: a Python number that meets a half
    operand is rounded to its dtype, a strong f32 operand makes the
    result f32), valued when the rule has returned (``_evaluate``).

    Which half results are rounded is XLA's on the CPU: a half operation
    read by an f32 operation is computed there in f32 from its rounded
    operands (one level, for that use only); every other half result is
    rounded, and a clip, a comparison, a ``where`` and a norm's sum read
    their operands rounded.  ``tests/test_torch_optimizer_bf16.py``
    holds SGD, Adam and AdamW to the reference's jitted ``multi_update``
    ulp for ulp on this reading.  The eager per-parameter path rounds
    every half result (one dispatch an operation), and a ``sticky`` leaf
    (the SPMD path's ``wd``, a Python number there) rounds every result
    it enters.  A leaf has the ``shape`` and ``device`` of its tensor."""

    __slots__ = ("op", "args", "dtype", "value", "sticky", "barrier",
                 "rounds")

    def __init__(self, op, args, dtype, value=None, sticky=False,
                 barrier=False):
        self.op, self.args, self.dtype, self.value = op, args, dtype, value
        self.sticky, self.barrier = sticky, barrier
        # never computed in f32 for a reader: a barrier, or a sticky
        # operand
        self.rounds = barrier or any(
            isinstance(a, _Half) and a.sticky for a in args)

    @classmethod
    def leaf(cls, x, dtype, sticky=False):
        """``x`` (a tensor holding values of ``dtype``) as a half
        operand."""
        return cls(None, (), dtype, x.to(dtype), sticky)

    @property
    def shape(self):
        return self.value.shape

    @property
    def device(self):
        return self.value.device

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A tensor's operator meeting a ``_Half`` (``lr * g``): the
        reflected operator of the ``_Half``, without the failed tensor
        call that would precede it."""
        t, h = args
        return getattr(h, _REFLECTED[func.__name__])(t)

    def _op(self, op, *args, barrier=False, dtype=None):
        if dtype is None:       # a strong f32 operand makes it f32
            dtype = self.dtype
            for a in args:
                d = getattr(a, "dtype", None)
                if d is not None and d not in _HALF:
                    dtype = d
                    break
        return _Half(op, (self,) + args, dtype, barrier=barrier)

    def __add__(self, o):
        return self._op(operator.add, o)

    def __radd__(self, o):
        return self._op(_RADD, o)

    def __sub__(self, o):
        return self._op(operator.sub, o)

    def __rsub__(self, o):
        return self._op(_RSUB, o)

    def __mul__(self, o):
        return self._op(operator.mul, o)

    def __rmul__(self, o):
        return self._op(_RMUL, o)

    def __truediv__(self, o):
        return self._op(operator.truediv, o)

    def __rtruediv__(self, o):
        return self._op(_RTRUEDIV, o)

    def __neg__(self):
        return self._op(operator.neg)

    def __gt__(self, o):
        return self._op(operator.gt, o, barrier=True, dtype=torch.bool)

    def __and__(self, o):
        return self._op(operator.and_, o, dtype=torch.bool)

    def __rand__(self, o):
        return self._op(operator.and_, o, dtype=torch.bool)

    def sqrt(self):
        return self._op(torch.sqrt)

    def square(self):
        return self._op(torch.square)

    def abs(self):
        return self._op(torch.abs)

    def sign(self):
        return self._op(torch.sign)

    def clone(self):
        return self._op(torch.clone)

    def clamp(self, lo=None, hi=None):
        return self._op(_clamp, lo, hi, barrier=True)


# the reflected operator of a tensor method a ``_Half`` meets
_REFLECTED = {"add": "__radd__", "sub": "__rsub__", "mul": "__rmul__",
              "div": "__rtruediv__", "__and__": "__rand__"}


def _flipped(op, a, b):
    return op(b, a)


# the reflected operators, operands swapped back to the reference's order
_RADD, _RSUB, _RMUL, _RTRUEDIV = (
    functools.partial(_flipped, op) for op in
    (operator.add, operator.sub, operator.mul, operator.truediv))


def _clamp(x, lo, hi):
    return x.clamp(lo, hi)


def _evaluate(out, eager):
    """The values of the rule's outputs ``out`` (a nest of tuples, None,
    tensors and ``_Half``s): a rounded half result is a tensor of its
    dtype (PyTorch computes a half operation in f32 and rounds once, as
    XLA does), a result kept in f32 an f32 tensor; ``eager`` rounds every
    half result."""
    memo: dict = {}
    widened: dict = {}

    def wide(t):
        """A half tensor in f32, converted once."""
        if t.dtype not in _HALF:
            return t
        if id(t) not in widened:
            widened[id(t)] = (t, t.float())
        return widened[id(t)][1]

    def node(x, wide_read):
        if x.value is not None:
            return x.value
        key = (id(x), wide_read)
        if key in memo:
            return memo[key]
        half = x.dtype in _HALF
        keep = half and wide_read and not (eager or x.rounds)
        if x.dtype == torch.bool:       # a comparison: its operand's
            cdt = next((a.dtype for a in x.args if isinstance(a, _Half)),
                       torch.float32)
        else:
            cdt = x.dtype
        # an f32 operation lets a half operand be computed in f32
        wide_args = not (eager or x.barrier or half)
        args = []
        promotes = False
        for a in x.args:
            if isinstance(a, _Half):
                a = node(a, wide_args)
            elif isinstance(a, (int, float)) and cdt in _HALF:
                a = _rounded(float(a), cdt)
            if isinstance(a, torch.Tensor) and a.dtype == torch.float32 \
                    and a.dim():
                promotes = True
            args.append(a)
        if (keep or wide_args) and not promotes:
            # computed in f32 with no dimensioned f32 operand to promote
            # the half ones: they are widened first
            args = [wide(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
        v = x.op(*args)
        if half and not keep and v.dtype != x.dtype:
            v = v.to(x.dtype)
        memo[key] = v
        return v

    def plain(x):
        if isinstance(x, tuple):
            return tuple(plain(a) for a in x)
        if isinstance(x, _Half):
            return node(x, False)
        return x

    return plain(out)


def _wrap(x):
    """A state (a tensor, a tuple of them or None) with its half-precision
    tensors as ``_Half`` leaves."""
    if isinstance(x, tuple):
        return tuple(_wrap(a) for a in x)
    if isinstance(x, torch.Tensor) and x.dtype in _HALF:
        return _Half.leaf(x, x.dtype)
    return x


def _where(cond, a, b):
    """``jnp.where(cond, a, b)``: the branches promoted to one dtype."""
    h = next((x for x in (cond, a, b) if isinstance(x, _Half)), None)
    if h is None:
        return torch.where(cond, a, b)
    strong = [x.dtype for x in (a, b) if isinstance(x, (_Half, torch.Tensor))]
    dtype = next((d for d in strong if d not in _HALF), None) or \
        next((d for d in strong if d in _HALF), torch.float32)
    return _Half(torch.where, (cond, a, b), dtype, barrier=True)


def _sumsq(x):
    return x.float().square().sum()


def _norm(x):
    """``jnp.linalg.norm`` of the whole array.  On a half operand XLA sums
    the squares in f32, rounds the sum to the operand's dtype and takes
    the square root as a half operation."""
    if isinstance(x, _Half):
        return x._op(_sumsq, barrier=True).sqrt()
    return torch.linalg.vector_norm(x)


def _sqrt(x):
    return math.sqrt(x) if isinstance(x, (int, float)) else x.sqrt()


def _bias(beta, t, half):
    """``1 - beta ** t``: on the host in f64 for a Python step; on the
    device for a step tensor, as ``-expm1(t log beta)`` in f32
    arithmetic, or as the reference writes it (``torch.pow`` in f32,
    XLA's own ``pow`` to the bit at small ``t``) where the reference's
    typing is followed (``half``)."""
    if not isinstance(t, torch.Tensor):
        return 1 - beta ** t
    if half:
        return 1 - torch.pow(beta, t)
    return -torch.expm1(t * math.log(beta))


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

    # SGLD draws its noise inside the rule: the reference keeps it out of
    # the grouped apply and the fused step, and so does the port
    _fusable = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 aggregate_num=None, use_fused_step=None):
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
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})
        self.lr_mult: dict = {}
        self.wd_mult: dict = {}
        # parameters a grouped apply serves at most (None: the group)
        self.aggregate_num = aggregate_num

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
        ``param_dict``), the index's ``set_lr_mult`` entry, or the entry
        of its name in ``param_idx2name``."""
        lr = self.learning_rate
        if index in self.param_dict:
            return lr * getattr(self.param_dict[index], "lr_mult", 1.0)
        if index in self.lr_mult:
            return lr * self.lr_mult[index]
        if index in self.idx2name:
            return lr * self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            return wd * getattr(self.param_dict[index], "wd_mult", 1.0)
        if index in self.wd_mult:
            return wd * self.wd_mult[index]
        if index in self.idx2name:
            return wd * self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

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
        ``weight`` is updated in place, the new state returned.  A
        half-precision weight without a master copy is updated as the
        reference's per-parameter ``update`` computes it: every
        operation rounded to its dtype, its Python numbers (``lr`` and
        ``wd`` too) turned into it first (``_Half``)."""
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
        if weight.dtype in _HALF:
            dt = weight.dtype
            g = _Half.leaf(grad.to(dt), dt) * rescale
            if clip is not None:
                g = g.clamp(-clip, clip)
            new_w, new_state = _evaluate(self._update_rule(
                _Half.leaf(weight.detach(), dt), g, _wrap(state), lr, wd, t),
                eager=True)
        else:
            g = grad.to(weight.dtype) * rescale
            if clip is not None:
                g = g.clamp(-clip, clip)
            new_w, new_state = self._update_rule(weight.detach(), g, state,
                                                 lr, wd, t)
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
                "wd", "clip_gradient", "aggregate_num"}
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
        does).  ``spmd``: the reference ``SPMDTrainer`` step's typing
        instead (its ``step_fn``: the gradient rescaled in f32, then
        rounded; ``wd`` a Python number, so ``wd * w`` in the weight's
        dtype)."""
        if use_mp:
            master, inner = s
            g2 = g.float() * rescale
            if has_clip:
                g2 = g2.clamp(-clip, clip)
            nm, ni = self._update_rule(master, g2, inner, lr, wd, t)
            return nm, (nm, ni)
        if w.dtype not in _HALF:
            g2 = g.to(w.dtype) * rescale.to(w.dtype)
            if has_clip:
                g2 = g2.clamp(-clip, clip)
            return self._update_rule(w, g2, s, lr, wd, t)
        dt = w.dtype
        if spmd:
            g2 = _Half.leaf((g.float() * rescale).to(dt), dt)
            wd = _Half.leaf(wd.to(dt), dt, sticky=True)
        else:
            g2 = _Half.leaf(g.to(dt), dt) * _Half.leaf(rescale.to(dt), dt)
        if has_clip:
            g2 = g2.clamp(-clip, clip)
        return _evaluate(self._update_rule(_Half.leaf(w, dt), g2, _wrap(s),
                                           lr, wd, t), eager=False)

    @torch.no_grad()
    def fused_step_apply(self, ws, gs, ss, mp_flags, lrs, wds, ts, rescale,
                         spmd=False):
        """The multi-tensor apply of ``multi_update``, of the fused train
        step and of ``SPMDTrainer``: every weight, master copy and state
        updated in place (their storage is what a captured graph reads
        and writes); ``lrs``, ``wds``, ``ts`` are f32 vectors with one
        entry a parameter, ``rescale`` the device scalar that carries the
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
        device), each group cut into chunks of ``aggregate_num``, each
        chunk's learning rates, weight decays and step counts one device
        vector, and ``fused_step_apply`` over the chunk (the fused train
        step's own apply, so the two cannot drift).  Weights and states
        are updated in place; returns ``states``.
        ``MXNET_FUSED_OPTIMIZER=0``, or an optimizer that cannot be fused
        (SGLD), runs ``update_multi_precision`` parameter by parameter,
        bit for bit the per-parameter loop, and writes its states into
        the same tensors."""
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
        agg = self.aggregate_num or None
        for (use_mp, _dt, dev), poss in groups.items():
            for c in range(0, len(poss), agg or len(poss)):
                chunk = poss[c:c + agg] if agg else poss
                lrs, wds, ts = [], [], []
                for pos in chunk:
                    idx = indices[pos]
                    self._update_count(idx)
                    lrs.append(self._get_lr(idx))
                    wds.append(self._get_wd(idx))
                    ts.append(self._index_update_count[idx])
                n = len(chunk)
                hyper = _write(torch.empty(3 * n + 1, dtype=torch.float32,
                                           device=dev),
                               lrs + wds + ts + [self.rescale_grad])
                self.fused_step_apply(
                    [ws[p] for p in chunk], [gs[p] for p in chunk],
                    [states[p] for p in chunk], [use_mp] * n, hyper[:n],
                    hyper[n:2 * n], hyper[2 * n:3 * n], hyper[3 * n])
                apply_counters["fused_calls"] += 1
                apply_counters["fused_params"] += n
        return list(states)


def _zeros(weight):
    return torch.zeros_like(weight.detach())


# --------------------------------------------------------------------------- #
# the momentum family
# --------------------------------------------------------------------------- #

@register
class SGD(Optimizer):
    """SGD with momentum (reference anchors ``sgd_update`` /
    ``sgd_mom_update``).  ``lazy_update`` is accepted as in the
    reference (dense gradients only)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if self.momentum == 0.0:
            return w - lr * g, None
        mom = state * self.momentum - lr * g
        return w + mom, mom


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference anchor ``nag_mom_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kwargs)

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if self.momentum == 0.0:
            return w - lr * g, None
        mom = state * self.momentum + g
        return w - lr * (g + self.momentum * mom), mom


@register
class Signum(Optimizer):
    """Sign-SGD with momentum (reference anchor ``signum_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _update_rule(self, w, g, state, lr, wd, t):
        if self.momentum == 0.0:
            return w - lr * (g.sign() + self.wd_lh * w), None
        mom = self.momentum * state - (1 - self.momentum) * (g + wd * w)
        return w - lr * ((-mom).sign() + self.wd_lh * w), mom


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (reference anchor ``DCASGD``): the gradient
    is corrected by ``lamda * g * g * (w - w_prev)``.  The state is
    ``(momentum or None, previous weight)``; the previous weight is a
    copy, taken before the update writes the weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, weight.detach().clone())

    def _update_rule(self, w, g, state, lr, wd, t):
        mom, prev_w = state
        comp = g + wd * w + self.lamda * g * g * (w - prev_w)
        # the weight before this update, apart from its storage: the
        # apply writes the weight in place before the state
        prev = w.clone()
        if mom is None:
            return w - lr * comp, (None, prev)
        mom = self.momentum * mom - lr * comp
        return w + mom, (mom, prev)


# --------------------------------------------------------------------------- #
# the adaptive family
# --------------------------------------------------------------------------- #

@register
class Adam(Optimizer):
    """Reference anchor ``adam_update``.  ``lazy_update`` is accepted as
    in the reference (dense gradients only)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))     # mean, var

    def _moments(self, g, state):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        return m, v

    def _lr_t(self, lr, t, half):
        """``lr`` with the bias correction: the reference's ``lr *
        sqrt(coef2) / coef1`` on the reference's typing (``half``), else
        ``lr`` times one scale."""
        coef1 = _bias(self.beta1, t, half)
        coef2 = _bias(self.beta2, t, half)
        if half:
            return lr * _sqrt(coef2) / coef1
        return lr * (_sqrt(coef2) / coef1)

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        m, v = self._moments(g, state)
        lr_t = self._lr_t(lr, t, isinstance(w, _Half))
        return w - lr_t * m / (v.sqrt() + self.epsilon), (m, v)


@register
class AdamW(Adam):
    """Decoupled weight decay (reference contrib ``adamw_update``):
    ``w - lr_t * (m / (sqrt(v) + eps) + wd * w)``."""

    def _update_rule(self, w, g, state, lr, wd, t):
        m, v = self._moments(g, state)
        lr_t = self._lr_t(lr, t, isinstance(w, _Half))
        return w - lr_t * (m / (v.sqrt() + self.epsilon) + wd * w), (m, v)


@register
class Nadam(Adam):
    """Adam with Nesterov momentum and the reference's momentum schedule;
    the schedule's running product is a 0-d f32 state, so the rule stays
    a pure function of its operands."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def _update_rule(self, w, g, state, lr, wd, t):
        m, v, m_sched = state
        g = g + wd * w
        momentum_t = self.beta1 * (1 - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t1 = self.beta1 * (1 - 0.5 * 0.96 **
                                    ((t + 1) * self.schedule_decay))
        m_sched = m_sched * momentum_t
        m_schedule_next = m_sched * momentum_t1
        g_prime = g / (1 - m_sched)
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        m_prime = m / (1 - m_schedule_next)
        v_prime = v / _bias(self.beta2, t, isinstance(w, _Half))
        m_bar = (1 - momentum_t) * g_prime + momentum_t1 * m_prime
        return (w - lr * m_bar / (v_prime.sqrt() + self.epsilon),
                (m, v, m_sched))


@register
class RMSProp(Optimizer):
    """Reference anchor ``rmsprop_update`` (centered variant =
    ``rmspropalex_update``), with ``clip_weights``."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if not self.centered:
            (n,) = state
            n = self.rho * n + (1 - self.rho) * g.square()
            new_w = w - lr * g / (n + self.epsilon).sqrt()
            new_state = (n,)
        else:
            n, mg, delta = state
            n = self.rho * n + (1 - self.rho) * g.square()
            mg = self.rho * mg + (1 - self.rho) * g
            delta = self.momentum * delta - \
                lr * g / (n - mg.square() + self.epsilon).sqrt()
            new_w = w + delta
            new_state = (n, mg, delta)
        if self.clip_weights:
            new_w = new_w.clamp(-self.clip_weights, self.clip_weights)
        return new_w, new_state


@register
class AdaGrad(Optimizer):
    """Reference anchor ``AdaGrad`` (alias ``adagrad``)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        hist = state + g.square()
        return w - lr * g / (hist.sqrt() + self.epsilon), hist


@register
class AdaDelta(Optimizer):
    """Reference anchor ``AdaDelta`` (alias ``adadelta``); ``lr`` scales
    the step as in the reference."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _update_rule(self, w, g, state, lr, wd, t):
        acc_g, acc_delta = state
        g = g + wd * w
        acc_g = self.rho * acc_g + (1 - self.rho) * g.square()
        delta = (acc_delta + self.epsilon).sqrt() / \
            (acc_g + self.epsilon).sqrt() * g
        acc_delta = self.rho * acc_delta + (1 - self.rho) * delta.square()
        return w - lr * delta, (acc_g, acc_delta)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference anchor ``ftrl_update``):
    state ``(z, n)``; it divides by ``lr`` as the reference does."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))     # z, n

    def _update_rule(self, w, g, state, lr, wd, t):
        z, n = state
        sigma = ((n + g.square()).sqrt() - n.sqrt()) / lr
        z = z + g - sigma * w
        n = n + g.square()
        new_w = _where(
            z.abs() > self.lamda1,
            -(z - z.sign() * self.lamda1) /
            ((self.beta + n.sqrt()) / lr + wd), 0.0)
        return new_w, (z, n)


@register
class FTML(Optimizer):
    """Follow the moving leader (reference anchor ``ftml_update``): state
    ``(d, v, z)``, the bias terms raised to the step ``t``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def _update_rule(self, w, g, state, lr, wd, t):
        d, v, z = state
        half = isinstance(w, _Half)
        g = g + wd * w
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        d_t = _bias(self.beta1, t, half) / lr * \
            ((v / _bias(self.beta2, t, half)).sqrt() + self.epsilon)
        sigma = d_t - self.beta1 * d
        z = self.beta1 * z + (1 - self.beta1) * g - sigma * w
        return -z / d_t, (d_t, v, z)


# --------------------------------------------------------------------------- #
# the layer-wise family: a trust ratio from per-parameter norms, on the
# device (a ``where`` on the norms, no host read, no Python branch)
# --------------------------------------------------------------------------- #

@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (reference anchors
    ``lamb_update_phase1/2``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _update_rule(self, w, g, state, lr, wd, t):
        m, v = state
        half = isinstance(w, _Half)
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        if self.bias_correction:
            mhat = m / _bias(self.beta1, t, half)
            vhat = v / _bias(self.beta2, t, half)
        else:
            mhat, vhat = m, v
        update = mhat / (vhat.sqrt() + self.epsilon) + wd * w
        wnorm = _norm(w)
        unorm = _norm(update)
        if self.lower_bound is not None or self.upper_bound is not None:
            wnorm = wnorm.clamp(self.lower_bound, self.upper_bound)
        trust = _where((wnorm > 0) & (unorm > 0), wnorm / unorm, 1.0)
        return w - lr * trust * update, (m, v)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference ``LARS``)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    def _update_rule(self, w, g, state, lr, wd, t):
        wnorm = _norm(w)
        gnorm = _norm(g)
        trust = _where(
            (wnorm > 0) & (gnorm > 0),
            self.eta * wnorm / (gnorm + wd * wnorm + self.epsilon), 1.0)
        g = g + wd * w
        mom = self.momentum * state + lr * trust * g
        return w - mom, mom


# --------------------------------------------------------------------------- #
# noise
# --------------------------------------------------------------------------- #

def _normal(like):
    """Standard normal noise of ``like``'s shape, dtype and device, drawn
    from the port's generator of that device (the one ``Dropout`` draws
    from, which a captured program registers, so each replay draws
    anew)."""
    from .. import random as _random

    dt = like.dtype
    return torch.randn(like.shape, generator=_random.generator(like.device),
                       dtype=dt, device=like.device)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr / 2 * (g + wd *
    w) + N(0, lr)``.  Its noise is drawn inside the rule, so the grouped
    apply and the fused step take the per-parameter path, as in the
    reference."""

    _fusable = False

    def create_state(self, index, weight):
        return None

    def _update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        noise = _normal(w)
        if isinstance(w, _Half):
            noise = _Half.leaf(noise, w.dtype)
        noise = noise * _sqrt(lr)
        return w - 0.5 * lr * g + noise, None


# the reference's aliases
_REGISTRY["adagrad"] = AdaGrad
_REGISTRY["adadelta"] = AdaDelta
