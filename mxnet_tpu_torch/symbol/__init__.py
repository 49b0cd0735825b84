"""``mx.sym``: the symbolic graph namespace over the op registry.

Port of ``mxnet_tpu/symbol/__init__.py``.  A builder for every
registered op (``mx.sym.FullyConnected``, ``mx.sym.RNN``, ...) is made
from the same table that serves ``mx.nd``, at its first use.  Importing
this package wires the capture hook into ``registry.invoke``.
"""
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     Executor, capture, current_capture, infer_args,
                     _make_builder)
from ..base import MXNetError
from ..ops import registry as _registry

# the op corpus is registered before any builder is made
from .. import ndarray as _nd  # noqa: F401

_registry._capture_get = current_capture


def __getattr__(name):
    try:
        _registry.get_op(name)
    except MXNetError:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.symbol' has no attribute {name!r}")
    b = _make_builder(name)
    globals()[name] = b
    return b


def zeros(shape, dtype="float32", name=None):
    """As in the reference: a graph has no constant without an input;
    bind a ``Variable`` instead."""
    raise NotImplementedError(
        "mx.sym.zeros: bind a Variable instead (a graph holds no "
        "constant made without an input)")
