"""``mx.nd`` namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: the NDArray class plus
one wrapper per op of the registry, generated from the ported op modules
(``ops/defs.py``), with the reference's alias names, and ``save``,
``load``, ``concatenate``, ``Dropout`` and ``Custom``.
``mx.nd.random``, ``image``, ``sparse``, ``contrib`` and the ops of the
other op modules are not ported yet.
"""
from .ndarray import NDArray, array, empty, from_torch, waitall
from ..ops.defs import arange, eye, full, linspace, ones, zeros
from ..ops import defs as _defs
from ..ops.registry import _ALIASES as _alias_map
from .serialization import load, save

_by_opname = {}
for _name, _obj in vars(_defs).items():
    if callable(_obj) and getattr(_obj, "_op", None) is not None:
        globals()[_name] = _obj
        _by_opname[_obj._op.name] = _obj
        if _obj._op.name != _name:
            globals().setdefault(_obj._op.name, _obj)

stop_gradient = _defs.stop_gradient
Dropout = _defs.Dropout

# alias names (Concat, SequenceMask, elemwise_add, ...) resolve to the same
# wrappers, mirroring the reference's duplicate CamelCase/snake_case surface
for _new, _target in _alias_map.items():
    if _target in _by_opname and _new not in globals():
        globals()[_new] = _by_opname[_target]


def concatenate(arrays, axis=0):
    return _defs.concat(list(arrays), dim=axis)


def Custom(*data, op_type=None, **kwargs):
    """Invoke a registered Python custom op (reference ``mx.nd.Custom``)."""
    from ..operator import _invoke_custom
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return _invoke_custom(op_type, list(data), kwargs)
