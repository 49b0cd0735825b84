"""``mx.npx`` — the NumPy-extension namespace (reference
``python/mxnet/numpy_extension/``), port of
``mxnet_tpu/numpy_extension/__init__.py``: the neural-network ops that
NumPy has no name for, control flow, and the ``set_np``/``reset_np``
switches.

Every nn op goes through the port's registered op (``_call``), so
``npx.convolution`` of a stride-1 1x1 convolution's backward reaches K6
under ``MXNET_FUSED_CONV_BWD=1``, ``npx.rnn`` reaches ``fused_rnn`` and
``npx.multibox_detection`` reaches ``box_nms`` (the reference raises
``NotImplementedError`` there).

Control flow runs as Python loops over registered ops, where the
reference compiles ``lax.scan``/``while_loop``/``cond``: ``foreach``
loops over the leading axis and stacks the outputs; ``while_loop`` reads
its predicate on the host each iteration and stops at
``max_iterations``, so inside a CUDA-graph capture (where no host read
is possible) it raises ``MXNetError``; ``cond`` reads its predicate on
the host, and inside a capture runs both branches and selects on the
device.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from ..context import cpu, gpu, num_gpus, current_context  # noqa: F401
from ..ndarray.ndarray import NDArray
from ..numpy.multiarray import _coerce_arr, _real, _run, ndarray  # noqa: F401
from ..ops.registry import Op, invoke  # noqa: F401
from ..util import (set_np, reset_np, is_np_array, is_np_shape,  # noqa: F401
                    np_array, np_shape, use_np)

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "seed",
           "relu", "sigmoid", "softmax", "log_softmax", "activation",
           "batch_norm", "layer_norm", "fully_connected", "convolution",
           "pooling", "dropout", "embedding", "one_hot", "pick", "topk",
           "reshape_like", "arange_like", "gamma", "erf", "erfinv",
           "gelu", "leaky_relu", "batch_dot", "broadcast_like",
           "sequence_mask", "smooth_l1", "multibox_detection", "waitall"]

seed = _random.seed


def _np_out(r):
    if isinstance(r, (list, tuple)):
        return [x.as_np_ndarray() if isinstance(x, NDArray) else x
                for x in r]
    return r.as_np_ndarray() if isinstance(r, NDArray) else r


def _call(opname, *args, **kwargs):
    """The registered op ``opname`` (``mx.nd``'s) on ``args``, its
    outputs as ``mx.np`` arrays."""
    from .. import ndarray as F
    fn = getattr(F, opname)
    dev = next((a._data.device for a in args if isinstance(a, NDArray)),
               None)
    return _np_out(fn(*[_coerce_arr(a, dev) for a in args], **kwargs))


def relu(data):
    return _call("relu", data)


def sigmoid(data):
    return _call("sigmoid", data)


def gelu(data):
    return _call("Activation", data, act_type="gelu")


def leaky_relu(data, gamma=0.01):
    return _call("LeakyReLU", data, act_type="leaky", slope=gamma)


def activation(data, act_type="relu"):
    return _call("Activation", data, act_type=act_type)


def softmax(data, axis=-1, length=None, temperature=None):
    kw = {"axis": axis}
    if temperature is not None:
        kw["temperature"] = temperature
    if length is not None:
        return _call("softmax", data, length, use_length=True, **kw)
    return _call("softmax", data, **kw)


def log_softmax(data, axis=-1):
    return _call("log_softmax", data, axis=axis)


def fully_connected(x, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    return _call("FullyConnected", x, weight,
                 *([] if no_bias or bias is None else [bias]),
                 num_hidden=num_hidden or weight.shape[0],
                 no_bias=no_bias or bias is None, flatten=flatten)


def convolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=0, num_group=1,
                no_bias=False, layout=None):
    args = [data, weight] + ([] if no_bias or bias is None else [bias])
    return _call("Convolution", *args, kernel=kernel,
                 stride=stride or (), dilate=dilate or (), pad=pad or (),
                 num_filter=num_filter, num_group=num_group,
                 no_bias=no_bias or bias is None,
                 layout=layout or "NCHW")


def pooling(data, kernel=(2, 2), pool_type="max", stride=None, pad=None,
            global_pool=False, **kwargs):
    return _call("Pooling", data, kernel=kernel, pool_type=pool_type,
                 stride=stride or (), pad=pad or (),
                 global_pool=global_pool, **kwargs)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    return _call("BatchNorm", x, gamma, beta, running_mean, running_var,
                 eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                 use_global_stats=use_global_stats, axis=axis)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _call("LayerNorm", data, gamma, beta, axis=axis, eps=eps)


def dropout(data, p=0.5, axes=(), mode="training"):
    return _call("Dropout", data, p=p, axes=axes, mode=mode)


def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    return _call("Embedding", data, weight,
                 input_dim=input_dim or weight.shape[0],
                 output_dim=output_dim or weight.shape[1])


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _call("one_hot", data, depth=depth, on_value=on_value,
                 off_value=off_value, dtype=dtype)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    return _call("pick", data, index, axis=axis, keepdims=keepdims,
                 mode=mode)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    return _call("topk", data, axis=axis, k=k, ret_typ=ret_typ,
                 is_ascend=is_ascend)


def reshape_like(lhs, rhs):
    return _run("reshape_like", lambda x, y: torch.reshape(x, y.shape),
                [lhs, rhs])


def arange_like(data, start=0.0, step=1.0, axis=None):
    def impl(x):
        n = x.numel() if axis is None else x.shape[axis]
        return start + step * torch.arange(n, dtype=torch.float32,
                                           device=x.device)
    return _run("arange_like", impl, [data])


def gamma(data):
    return _run("gamma", lambda x: torch.exp(torch.lgamma(_real(x))), [data])


def erf(data):
    return _run("erf", lambda x: torch.erf(_real(x)), [data])


def erfinv(data):
    return _run("erfinv", lambda x: torch.erfinv(_real(x)), [data])


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    return _call("batch_dot", a, b, transpose_a=transpose_a,
                 transpose_b=transpose_b)


def broadcast_like(lhs, rhs):
    return _call("broadcast_like", lhs, rhs)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    args = [data] + ([sequence_length] if sequence_length is not None else [])
    return _call("SequenceMask", *args,
                 use_sequence_length=use_sequence_length, value=value,
                 axis=axis)


def smooth_l1(data, scalar=1.0):
    return _call("smooth_l1", data, scalar=scalar)


def multibox_detection(cls_prob, loc_pred, anchor, **kwargs):
    """SSD's detection output: the registered ``MultiBoxDetection`` op,
    whose non-maximum suppression is ``box_nms`` (the reference raises
    ``NotImplementedError`` here)."""
    return _call("MultiBoxDetection", cls_prob, loc_pred, anchor, **kwargs)


def waitall():
    from ..ndarray import waitall as _w
    return _w()


def _masked(x, m, axis, temperature):
    xs = x / temperature if temperature != 1.0 else x
    if m:
        xs = torch.where(m[0].to(torch.bool), xs,
                         torch.full_like(xs, -torch.inf))
    return xs


def masked_softmax(data, mask=None, axis=-1, temperature=1.0):
    """Softmax over ``axis`` with a boolean mask (False: excluded)."""
    def fn(x, *m):
        xs = _masked(x, m, axis, temperature)
        out = torch.exp(xs - torch.amax(xs, dim=axis, keepdim=True))
        out = torch.where(torch.isfinite(xs), out, torch.zeros_like(out))
        return out / torch.clamp(out.sum(dim=axis, keepdim=True),
                                 min=1e-12)

    args = [data] + ([mask] if mask is not None else [])
    return _np_out(invoke(Op(name="_npx_masked_softmax", fn=fn),
                          [_coerce_arr(a) for a in args], {}))


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0):
    def fn(x, *m):
        xs = _masked(x, m, axis, temperature)
        mx_ = torch.amax(xs, dim=axis, keepdim=True)
        lse = torch.log(torch.clamp(torch.exp(xs - mx_).sum(
            dim=axis, keepdim=True), min=1e-12)) + mx_
        return xs - lse

    args = [data] + ([mask] if mask is not None else [])
    return _np_out(invoke(Op(name="_npx_masked_log_softmax", fn=fn),
                          [_coerce_arr(a) for a in args], {}))


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return _call("GroupNorm", data, gamma, beta, num_groups=num_groups,
                 eps=eps)


def instance_norm(data, gamma, beta, eps=1e-3):
    return _call("InstanceNorm", data, gamma, beta, eps=eps)


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    return _call("RMSNorm", data, gamma, axis=axis, eps=eps)


def gather_nd(data, indices):
    return _call("gather_nd", data, indices)


def scatter_nd(data, indices, shape):
    return _call("scatter_nd", data, indices, shape=shape)


def slice(data, begin, end, step=None):  # noqa: A001
    return _call("slice", data, begin=tuple(begin), end=tuple(end),
                 step=tuple(step) if step else None)


def slice_axis(data, axis, begin, end):
    return _call("slice_axis", data, axis=axis, begin=begin, end=end)


def stop_gradient(data):
    return _call("BlockGrad", data)


def _index_tensors(indices, device):
    idx = indices if isinstance(indices, tuple) else (indices,)
    out = []
    for i in idx:
        if isinstance(i, NDArray):
            i = i._data
        out.append(torch.as_tensor(i, device=device).to(torch.int64)
                   if not isinstance(i, torch.Tensor)
                   else i.to(device=device, dtype=torch.int64))
    return tuple(out)


def index_update(data, indices, val):
    """``data`` with ``data[indices] = val`` (functional: a new array)."""
    def fn(x, v):
        return torch.index_put(x, _index_tensors(indices, x.device),
                               v.to(x.dtype))
    return _np_out(invoke(Op(name="_npx_index_update", fn=fn),
                          [_coerce_arr(data), _coerce_arr(val)], {}))


def index_add(data, indices, val):
    """``data`` with ``val`` added at ``indices`` (repeated indices add
    up; functional)."""
    def fn(x, v):
        return torch.index_put(x, _index_tensors(indices, x.device),
                               v.to(x.dtype), accumulate=True)
    return _np_out(invoke(Op(name="_npx_index_add", fn=fn),
                          [_coerce_arr(data), _coerce_arr(val)], {}))


def _nd(x):
    return x.as_nd_ndarray() if isinstance(x, NDArray) else x


def _np_list(v):
    if isinstance(v, (list, tuple)):
        return [_np_out(x) for x in v]
    return _np_out(v)


def foreach(body, data, init_states):
    """Run ``body(x, states) -> (out, states)`` over the leading axis of
    ``data`` (a Python loop of registered ops); returns the stacked
    outputs and the final states."""
    from .. import ndarray as F

    multi_data = isinstance(data, (list, tuple))
    n = (data[0] if multi_data else data).shape[0]
    states = [_nd(s) for s in init_states] \
        if isinstance(init_states, (list, tuple)) else _nd(init_states)
    outs = []
    for i in range(n):
        x = [_nd(d)[i] for d in data] if multi_data else _nd(data)[i]
        out, states = body(x, states)
        outs.append(out)
    if isinstance(outs[0], (list, tuple)):
        stacked = [F.stack(*[o[j] for o in outs], axis=0)
                   for j in range(len(outs[0]))]
    else:
        stacked = F.stack(*outs, axis=0)
    return _np_list(stacked), _np_list(states)


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _truth(p):
    if isinstance(p, NDArray):
        return bool(p._data.reshape(-1)[0].item())
    return bool(p)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``loop_vars = func(loop_vars)`` while ``cond(loop_vars)`` holds,
    at most ``max_iterations`` times.  The predicate is read on the host
    each iteration, so inside a CUDA-graph capture this raises
    ``MXNetError`` (the reference's ``lax.while_loop`` decides on the
    device)."""
    if _capturing():
        raise MXNetError(
            "npx.while_loop reads its predicate on the host each "
            "iteration, which a CUDA-graph capture cannot do; run it "
            "outside the capture (or unroll it with a fixed count)")
    vs = [_nd(v) for v in loop_vars]
    i = 0
    while (max_iterations is None or i < max_iterations) and \
            _truth(cond(vs)):
        vs = list(func(vs))
        i += 1
    return [_np_out(v) for v in vs]


def cond(pred, then_func, else_func, inputs):
    """``then_func(inputs)`` if ``pred`` else ``else_func(inputs)``: the
    predicate is read on the host; inside a CUDA-graph capture both
    branches run and the device selects."""
    vs = [_nd(v) for v in inputs]
    if _capturing():
        from .. import ndarray as F

        t, e = then_func(vs), else_func(vs)
        p = _coerce_arr(pred)
        pick_ = (lambda a, b: _np_out(F.where(
            F.broadcast_like(p.as_nd_ndarray().reshape((1,) * a.ndim)
                             .astype(a.dtype), a), a, b)))
        if isinstance(t, (list, tuple)):
            return [pick_(a, b) for a, b in zip(t, e)]
        return pick_(t, e)
    out = then_func(vs) if _truth(pred) else else_func(vs)
    if isinstance(out, (list, tuple)):
        return [_np_out(v) for v in out]
    return _np_out(out)


def multinomial(data, shape=None, get_prob=False):
    from ..numpy import random as npr
    return npr.multinomial(1, data, size=shape)


def shuffle(data):
    return _np_out(_random.shuffle(data))


def load(fname):
    from ..ndarray import load as _l
    out = _l(fname)
    if isinstance(out, dict):
        return {k: _np_out(v) for k, v in out.items()}
    return [_np_out(v) for v in out]


def save(fname, data):
    from ..ndarray import save as _s
    return _s(fname, data)


def rnn(data, parameters, state, *args, **kwargs):
    """The fused RNN op (the registered ``fused_rnn``)."""
    from ..ndarray import fused_rnn as _fused
    return _np_out(_fused(data, parameters, state, *args, **kwargs))



