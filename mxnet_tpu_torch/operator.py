"""``mx.operator`` — Python custom operators.

Counterpart of ``mxnet_tpu/operator.py``.  A ``CustomOp`` invocation runs
the user's ``forward`` eagerly on NDArrays and puts one node on the
autograd graph whose backward calls the user's ``backward``
(``autograd.Function`` underneath).

``out_data``, ``aux`` and ``in_grad`` are allocated on the inputs'
device (and ``in_grad`` in each input's dtype), not on the default
context as in the reference, so a custom op on ``mx.gpu()`` under a
``with mx.cpu():`` scope stays on the card.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError, torch_dtype
from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_REGISTRY = {}


class CustomOp:
    """User forward/backward (reference ``mx.operator.CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Honour ``req`` (reference ``CustomOp.assign``): ``null`` leaves
        ``dst``, ``add`` adds, ``write``/``inplace`` replace."""
        if req in ("null", 0):
            return
        src = src._data if isinstance(src, NDArray) else src
        if req in ("add", 3):
            dst._rebind(dst._data + src)
        else:
            dst._rebind(torch.as_tensor(src, dtype=dst._data.dtype,
                                        device=dst._data.device))


class CustomOpProp:
    """Shape/type/creation metadata (reference ``CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """``@mx.operator.register("myop")`` over a CustomOpProp subclass."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered():
    return dict(_REGISTRY)


def _zeros(shape, dtype, device):
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=device))


class _CustomFn(autograd.Function):
    """One custom-op invocation on the graph.  Its state lives on the
    instance, which the graph drops after a non-retaining backward, so the
    op's buffers are freed then by reference counting (a class made per
    call would hold them in a reference cycle until the cyclic collector
    ran)."""

    def __init__(self, op, inputs, out_data, aux):
        super().__init__()
        self.op, self.inputs, self.out_data, self.aux = \
            op, inputs, out_data, aux

    def forward(self, *xs):
        self.op.forward(is_train=autograd.is_training(),
                        req=["write"] * len(self.out_data), in_data=list(xs),
                        out_data=self.out_data, aux=self.aux)
        outs = [NDArray(o._data) for o in self.out_data]
        return outs if len(outs) > 1 else outs[0]

    def backward(self, *ograds):
        in_grad = [_zeros(x.shape, x._data.dtype, x._data.device)
                   for x in self.inputs]
        self.op.backward(req=["write"] * len(self.inputs),
                         out_grad=list(ograds), in_data=list(self.inputs),
                         out_data=self.out_data, in_grad=in_grad,
                         aux=self.aux)
        return tuple(in_grad)


def _invoke_custom(op_type, inputs, kwargs):
    """``mx.nd.Custom(*data, op_type=...)`` dispatch path."""
    if op_type not in _REGISTRY:
        raise MXNetError(f"custom op {op_type!r} is not registered")
    if not inputs or not all(isinstance(x, NDArray) for x in inputs):
        raise MXNetError("Custom takes NDArray inputs")
    prop = _REGISTRY[op_type](**kwargs)
    in_shapes = [list(x.shape) for x in inputs]
    in_shapes, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    in_types = [x.dtype for x in inputs]
    _, out_types, _ = prop.infer_type(in_types)
    op = prop.create_operator(inputs[0].context, in_shapes, in_types)
    device = inputs[0]._data.device
    out_data = [_zeros(s, t, device) for s, t in zip(out_shapes, out_types)]
    aux = [_zeros(s, in_types[0], device) for s in aux_shapes]
    return _CustomFn(op, list(inputs), out_data, aux)(*inputs)
