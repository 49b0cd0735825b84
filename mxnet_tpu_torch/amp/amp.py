"""AMP — automatic mixed precision, port of ``mxnet_tpu/amp/amp.py``.

Reference surface (``python/mxnet/contrib/amp/amp.py``): ``amp.init()``
patches the op namespace by the cast lists (``lists.py``);
``amp.init_trainer`` attaches the dynamic loss scaler to a ``Trainer``;
``amp.scale_loss``; ``convert_hybrid_block`` for low-precision inference.

- ``init(target_dtype)`` wraps the ``mx.nd`` wrappers named in the lists:
  a target op casts its float inputs to ``target_dtype``, an f32 op to
  float32, a widest-type op to the widest float input.  A
  ``hybrid_forward`` block reaches them as ``F.<op>``.
- The port's ``gluon.nn.Dense`` and ``Conv2D`` compute on tensors
  (``ops.nn``) rather than through ``mx.nd``, where the reference's call
  ``F.FullyConnected`` and ``F.Convolution``; they cast their inputs by
  the same lists through :func:`layer_cast`, so a ``gluon.nn`` model
  under ``amp.init`` computes as the reference's does.
- bfloat16 is the default target; ``float16`` engages the loss scaler's
  dynamic scale (``init_trainer``) as in the reference, and attention
  runs the flash kernels' fp16 instantiations.
- ``convert_model`` casts a symbol's f32 parameters to the target dtype.
"""
from __future__ import annotations

import contextlib
import functools
import logging

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from . import lists
from .loss_scaler import LossScaler

_amp_state = {
    "initialized": False,
    "target_dtype": None,
    "originals": {},   # name -> the unpatched mx.nd wrapper
    "policy": {},      # op name -> a torch dtype, or "widest"
}


def _is_float(x):
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data.is_floating_point()
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _dtype_of(x):
    from ..ndarray import NDArray
    return x._data.dtype if isinstance(x, NDArray) else x.dtype


def _cast(x, dtype):
    """``x`` (an NDArray or a tensor) in ``dtype`` when it is a float of
    another type; anything else unchanged.  An NDArray casts through the
    recorded ``cast`` op, so gradients flow back in its own type."""
    if not _is_float(x) or _dtype_of(x) == dtype:
        return x
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        return x.astype(dtype)
    return x.to(dtype)


def _cast_tree(a, dtype):
    if isinstance(a, (list, tuple)):
        return [_cast_tree(x, dtype) for x in a]
    return _cast(a, dtype)


def _widest(args):
    flat = []
    for a in args:
        flat.extend(a if isinstance(a, (list, tuple)) else [a])
    floats = [_dtype_of(a) for a in flat if _is_float(a)]
    if not floats:
        return None
    return max(floats, key=lambda d: torch.finfo(d).bits)


def _apply_policy(policy, args, kwargs):
    if policy == "widest":
        dtype = _widest(args)
        if dtype is None:
            return args, kwargs
    else:
        dtype = policy
    return ([_cast_tree(a, dtype) for a in args],
            {k: _cast_tree(v, dtype) for k, v in kwargs.items()})


def _wrap(fn, policy):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        args, kwargs = _apply_policy(policy, args, kwargs)
        return fn(*args, **kwargs)
    wrapper._amp_wrapped = True
    return wrapper


def layer_cast(opname, *tensors):
    """The inputs of a ``gluon.nn`` layer's op cast by the lists as
    ``init`` set them (unchanged when amp is off or the op is in no
    list); ``None`` entries pass through."""
    policy = _amp_state["policy"].get(opname)
    if policy is None:
        return tensors
    args, _ = _apply_policy(policy, list(tensors), {})
    return tuple(args)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Patch the ``mx.nd`` namespace with cast-inserting wrappers
    (reference ``amp.init()``)."""
    if _amp_state["initialized"]:
        return
    if target_dtype not in ("float16", "bfloat16"):
        raise MXNetError("target_dtype must be float16 or bfloat16")
    from .. import ndarray as nd_mod

    target = torch_dtype(target_dtype)
    policy = {}
    for name in (target_precision_ops or lists.TARGET_DTYPE_OPS):
        policy.setdefault(name, target)
    for name in (fp32_ops or lists.FP32_OPS):
        policy.setdefault(name, torch.float32)
    for name in lists.WIDEST_TYPE_CASTS:
        policy.setdefault(name, "widest")
    for name, pol in policy.items():
        fn = getattr(nd_mod, name, None)
        if fn is None or getattr(fn, "_amp_wrapped", False):
            continue
        _amp_state["originals"][name] = fn
        setattr(nd_mod, name, _wrap(fn, pol))
    _amp_state["policy"] = policy
    _amp_state["initialized"] = True
    _amp_state["target_dtype"] = target_dtype
    logging.info("AMP initialized (target dtype %s)", target_dtype)


def _uninit():
    """Restore the unpatched wrappers (the tests' hook)."""
    from .. import ndarray as nd_mod
    for name, fn in _amp_state["originals"].items():
        setattr(nd_mod, name, fn)
    _amp_state["originals"].clear()
    _amp_state["policy"] = {}
    _amp_state["initialized"] = False
    _amp_state["target_dtype"] = None


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a ``gluon.Trainer`` (reference
    ``amp.init_trainer``): each ``step`` first reads whether any gradient
    overflowed (one host read), skips the update if one did and divides
    the gradients by the loss scale otherwise.  The initial scale is
    2^16 for float16 and 1 for bfloat16."""
    if not _amp_state["initialized"]:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return trainer
    scaler = LossScaler(init_scale=2.0 ** 16
                        if _amp_state["target_dtype"] == "float16" else 1.0)
    trainer._amp_loss_scaler = scaler
    orig_step = trainer.step

    @functools.wraps(orig_step)
    def amp_step(batch_size, ignore_stale_grad=False):
        overflow = scaler.has_overflow(trainer._params)
        if not overflow:
            saved = trainer._scale
            trainer._scale = saved / scaler.loss_scale
            try:
                orig_step(batch_size, ignore_stale_grad)
            finally:
                trainer._scale = saved
        else:
            logging.warning("AMP: gradient overflow, skipping step "
                            "(loss scale %.1f -> %.1f)", scaler.loss_scale,
                            scaler.loss_scale / 2)
        scaler.update_scale(overflow)

    trainer.step = amp_step
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as L: L.backward()``.  The
    product is recorded inside ``record()`` or out of it, so the
    backward reaches the loss's graph either way, as in the reference."""
    from .. import autograd

    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    with autograd.record(train_mode=autograd.is_training()):
        if isinstance(loss, (list, tuple)):
            scaled = [l * scaler.loss_scale for l in loss]
        else:
            scaled = loss * scaler.loss_scale
    yield scaled


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  **kwargs):
    """Offline conversion of a ``(symbol, params)`` checkpoint for
    low-precision inference (reference ``amp.convert_model``): every f32
    array of ``arg_params`` and ``aux_params`` cast to ``target_dtype``;
    the graph is returned as it is."""
    new_args = {k: v.astype(target_dtype) if v.dtype == np.float32 else v
                for k, v in arg_params.items()}
    new_aux = {k: v.astype(target_dtype) if v.dtype == np.float32 else v
               for k, v in aux_params.items()}
    return sym, new_args, new_aux


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None):
    """Cast a HybridBlock's parameters for low-precision inference
    (reference ``amp.convert_hybrid_block``)."""
    block.cast(target_dtype)
    block.hybridize()
    return block
