"""The op registry: one table ``name -> Op`` behind ``mx.nd``.

Counterpart of ``mxnet_tpu/ops/registry.py``.  Each implementation is a
pure function on torch tensors; ``torch.autograd`` gives its gradient.
``mx.nd.<name>`` is generated from this table (``ndarray/__init__.py``).

Dispatch (the reference's ``MXImperativeInvokeEx -> Imperative::Invoke``)::

    wrapper -> invoke() -> fn(*tensors) -> NDArray outputs

``invoke`` runs the implementation under ``torch.enable_grad()`` only
while ``autograd.is_recording()`` (and the op is differentiable), and
under ``torch.no_grad()`` otherwise: as in MXNet, only ops inside
``record()`` reach the tape, even on arrays with an attached gradient.
The reference's profiler hooks, symbol capture and ``NaiveEngine`` are
not ported yet.
"""
from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..base import MXNetError

__all__ = ["Op", "register", "alias", "get_op", "list_ops", "invoke", "op",
           "OPS"]

OPS: dict[str, "Op"] = {}
_ALIASES: dict[str, str] = {}


@dataclass
class Op:
    """One registered operator."""

    name: str
    fn: Callable  # pure torch fn: fn(*tensors, **static_kwargs)
    variadic: bool = False  # first arg is a list of arrays (e.g. concat)
    differentiable: bool = True

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def register(name: str, fn: Callable, **kw) -> Op:
    if name in OPS:
        raise MXNetError(f"op {name} already registered")
    o = Op(name=name, fn=fn, **kw)
    OPS[name] = o
    return o


def alias(new: str, existing: str) -> None:
    _ALIASES[new] = existing


def get_op(name: str) -> Op:
    name = _ALIASES.get(name, name)
    if name not in OPS:
        raise MXNetError(f"unknown op {name}")
    return OPS[name]


def list_ops() -> list[str]:
    return sorted(OPS)


def _unwrap(x):
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        # an array whose graph a backward freed enters as a constant
        return x._data.detach() if x._freed else x._data
    return x


def invoke(opref: Op, array_args: Sequence, kwargs: dict, out=None):
    """Run an op on NDArray (or tensor) inputs; returns NDArray(s).

    ``array_args`` are the tensor inputs, ``kwargs`` the static
    parameters.  With ``out=`` the result is rebound into that array."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    tensors = [_unwrap(a) for a in array_args]
    recording = autograd.is_recording() and opref.differentiable
    with torch.enable_grad() if recording else torch.no_grad():
        results = opref.fn(*tensors, **kwargs)
    multi = isinstance(results, (tuple, list))
    outs = [NDArray(r) for r in (results if multi else [results])]
    if out is not None:
        if multi:
            raise MXNetError("out= not supported for multi-output ops")
        return out._rebind(outs[0]._data)
    return outs if multi else outs[0]


def op(name: Optional[str] = None, variadic: bool = False,
       differentiable: bool = True):
    """Decorator.  The decorated function is the pure torch
    implementation; the returned callable is the NDArray-facing wrapper.
    The leading positional parameters are the tensor inputs; keyword-only
    parameters are static."""

    def deco(fn):
        opname = name or fn.__name__
        o = register(opname, fn, variadic=variadic,
                     differentiable=differentiable)
        sig = inspect.signature(fn)
        arr_names = [p.name for p in sig.parameters.values()
                     if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        n_arr = len(arr_names)

        @functools.wraps(fn)
        def wrapper(*args, out=None, **kwargs):
            if variadic:
                arrays = list(args[0]) if len(args) == 1 and isinstance(
                    args[0], (list, tuple)) else list(args)
                return invoke(o, arrays, kwargs, out=out)
            arrays = list(args[:n_arr])
            if args[n_arr:]:
                raise MXNetError(
                    f"{opname}: too many positional args "
                    f"(expected {n_arr} tensors; pass params as keywords)")
            # tensor params passed as keywords land in positional slots
            for nm in arr_names[len(arrays):]:
                arrays.append(kwargs.pop(nm, None))
            while arrays and arrays[-1] is None:
                arrays.pop()
            return invoke(o, arrays, kwargs, out=out)

        wrapper._op = o
        return wrapper

    return deco
