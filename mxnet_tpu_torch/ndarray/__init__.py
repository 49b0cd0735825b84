"""``mx.nd`` namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: the NDArray class plus
one wrapper per op of the registry, generated from every ported op
module (``ops/defs.py``, ``ops/nn.py``, ``ops/attention.py``,
``ops/image_ops.py``, ``ops/quantization.py``, ``ops/rnn.py``,
``ops/linalg.py``, ``ops/legacy.py``, ``ops/optimizer_ops.py``,
``ops/extended.py``, ``ops/samplers.py``) under the op's name (and
``ops/defs.py``'s, ``ops/optimizer_ops.py``'s, ``ops/extended.py``'s and
``ops/samplers.py``'s Python names), with the reference's alias names,
and ``save``, ``load``, ``concatenate``, ``BatchNorm``, ``Dropout`` and
``Custom``; ``mx.nd.image`` (the eleven ``_image_*`` ops under their
short names), ``mx.nd.contrib``, and ``mx.nd.random`` (the module
``mx.random``) with the legacy ``random_*``/``sample_multinomial``/
``shuffle`` names over its functions, as in the reference.
``ring_attention`` raises ``MXNetError`` (``ops.registry.NOT_PORTED``).
``mx.nd.sparse`` (``row_sparse`` and ``csr`` storage, its three
registered ops) and ``mx.nd.cast_storage``.
"""
import types as _types

from .ndarray import NDArray, array, empty, from_torch, waitall
from ..ops.defs import arange, eye, full, linspace, ones, zeros
from ..ops import attention as _attention
from .. import random as _random_mod
from ..ops import defs as _defs
from ..ops import extended as _extended
from ..ops import image_ops as _image_ops  # noqa: F401 (registers its ops)
from ..ops import legacy as _legacy  # noqa: F401
from ..ops import linalg as _linalg  # noqa: F401
from ..ops import nn as _nn
from ..ops import optimizer_ops as _optimizer_ops
from ..ops import quantization as _quantization  # noqa: F401
from ..ops import rnn as _rnn  # noqa: F401
from ..ops import samplers as _samplers
from ..ops.registry import OPS as _OPS
from ..ops.registry import _ALIASES as _alias_map
from .serialization import load, save

for _mod in (_defs, _optimizer_ops, _extended, _samplers):
    for _name, _obj in vars(_mod).items():
        if callable(_obj) and getattr(_obj, "_op", None) is not None:
            globals()[_name] = _obj
_by_opname = {_name: _o.wrapper for _name, _o in _OPS.items()}
for _name, _wrapper in _by_opname.items():
    globals().setdefault(_name, _wrapper)

stop_gradient = _defs.stop_gradient
Dropout = _defs.Dropout
BatchNorm = _nn.BatchNorm
ring_attention = _attention.ring_attention

# alias names (Concat, SequenceMask, elemwise_add, ...) resolve to the same
# wrappers, mirroring the reference's duplicate CamelCase/snake_case surface
for _new, _target in _alias_map.items():
    if _target in _by_opname and _new not in globals():
        globals()[_new] = _by_opname[_target]

# random sampling surface: mx.nd.random.* and the legacy mx.nd.random_*
# names (over mx.random's functions, as in the reference)
random = _random_mod
random_uniform = _random_mod.uniform
random_normal = _random_mod.normal
random_randint = _random_mod.randint
random_gamma = _random_mod.gamma
random_exponential = _random_mod.exponential
random_poisson = _random_mod.poisson
sample_multinomial = _random_mod.multinomial
shuffle = _random_mod.shuffle


# mx.nd.image: the reference's short names over the _image_* ops
image = _types.ModuleType(__name__ + ".image")
for _short in ("to_tensor", "normalize", "resize", "crop", "flip_left_right",
               "flip_top_bottom", "random_flip_left_right",
               "random_flip_top_bottom", "random_brightness",
               "random_contrast", "random_saturation"):
    setattr(image, _short, _by_opname["_image_" + _short])

from . import contrib  # noqa: E402  (its names are this module's)
from . import sparse  # noqa: E402
cast_storage = sparse.cast_storage


def concatenate(arrays, axis=0):
    return _defs.concat(list(arrays), dim=axis)


def Custom(*data, op_type=None, **kwargs):
    """Invoke a registered Python custom op (reference ``mx.nd.Custom``)."""
    from ..operator import _invoke_custom
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    return _invoke_custom(op_type, list(data), kwargs)
