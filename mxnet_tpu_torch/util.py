"""``mx.util`` — the NumPy-semantics switches and environment helpers.

Port of ``mxnet_tpu/util.py``.  ``set_np()`` makes ``default_array``
(and so the user's array factory) hand out ``mx.np.ndarray``s instead
of ``mx.nd.NDArray``s; torch tensors have NumPy's zero-size and zero-dim
shapes natively, so ``np_shape`` is on from the start and the switch is
kept for the reference's API.  The state is per thread, as the
reference's.  ``get_gpu_count``/``get_gpu_memory`` read the card through
``torch.cuda``: ``(free, total)`` bytes, as ``mx.context.
gpu_memory_info`` gives them.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

__all__ = ["is_np_shape", "is_np_array", "set_np_shape", "set_np",
           "reset_np", "np_shape", "np_array", "use_np", "use_np_array",
           "use_np_shape", "environment", "getenv", "setenv",
           "get_gpu_count", "get_gpu_memory", "default_array"]


class _State(threading.local):
    np_shape = True         # each thread starts from these
    np_array = False


_state = _State()


def is_np_shape():
    """Zero-dim and zero-size shapes on?  True from the start (torch
    shapes are NumPy's); kept for the reference's API."""
    return _state.np_shape


def is_np_array():
    return _state.np_array


def set_np_shape(active):
    prev, _state.np_shape = _state.np_shape, bool(active)
    return prev


def set_np(shape=True, array=True):
    """``mx.npx.set_np()``: NumPy semantics on (the array class and
    shapes)."""
    _state.np_shape = bool(shape)
    _state.np_array = bool(array)


def reset_np():
    set_np(shape=True, array=False)


@contextlib.contextmanager
def np_shape(active=True):
    prev = set_np_shape(active)
    try:
        yield
    finally:
        set_np_shape(prev)


@contextlib.contextmanager
def np_array(active=True):
    prev, _state.np_array = _state.np_array, bool(active)
    try:
        yield
    finally:
        _state.np_array = prev


def use_np_array(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_array(True):
            return func(*args, **kwargs)
    return wrapper


def use_np_shape(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)
    return wrapper


def use_np(func):
    """Decorator: run with both switches on.  A class passes through
    (its arrays follow the data: an op on ``mx.np`` arrays returns one)."""
    if isinstance(func, type):
        return func
    return use_np_array(use_np_shape(func))


def default_array(source_array, ctx=None, dtype=None):
    """An array of the active flavour: ``mx.np`` after ``set_np()``, else
    ``mx.nd``; on ``ctx``, by default the current context (``gpu(0)``)."""
    if is_np_array():
        from .numpy import array as np_array_fn
        return np_array_fn(source_array, dtype=dtype, ctx=ctx)
    from .ndarray import array as nd_array_fn
    return nd_array_fn(source_array, ctx=ctx, dtype=dtype)


@contextlib.contextmanager
def environment(*args):
    """``with environment('MXNET_X', '1'):`` or ``environment({k: v})``:
    environment variables set for the block (``None`` deletes one)."""
    if len(args) == 2:
        updates = {args[0]: args[1]}
    elif len(args) == 1 and isinstance(args[0], dict):
        updates = args[0]
    else:
        raise ValueError("environment(name, value) or environment(dict)")
    saved = {k: os.environ.get(k) for k in updates}
    try:
        for k, v in updates.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)


def get_gpu_count():
    """``torch.cuda.device_count()``: the cards this process sees."""
    from .context import num_gpus
    return num_gpus()


def get_gpu_memory(gpu_dev_id=0):
    """``(free, total)`` bytes of card ``gpu_dev_id``
    (``torch.cuda.mem_get_info``); raises ``MXNetError`` without CUDA."""
    from .context import gpu_memory_info
    return gpu_memory_info(gpu_dev_id)
