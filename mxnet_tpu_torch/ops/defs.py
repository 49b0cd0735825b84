"""Core operator corpus (tensor and math ops) of ``mx.nd``.

Counterpart of ``mxnet_tpu/ops/defs.py``: the same op names, argument
names and semantics (MXNet's reshape codes, ``dot``'s full transpose,
comparison ops returning the input's float dtype, ``argmax`` returning
float32, integer arguments truncated as ``astype(int32)`` does), each a
pure function on torch tensors registered through ``@op``; gradients
come from ``torch.autograd``.  Python numbers that reach a binary op are
0-d host tensors (see ``ndarray._coerce``), which torch takes as scalars
on any device.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import alias, invoke, op

_max = builtins.max
_min = builtins.min


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(axis)
    return int(axis)


def _dims(axis, ndim):
    """A reduction's dims as a tuple (all of them for None)."""
    axis = _norm_axis(axis)
    if axis is None:
        return tuple(range(ndim))
    return (axis,) if isinstance(axis, int) else axis


def _float(x):
    return x if x.is_floating_point() else x.float()


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ======================================================================= #
# elementwise unary
# ======================================================================= #

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "round": torch.round,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc, "square": torch.square,
    "sqrt": torch.sqrt, "cbrt": _cbrt, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "arcsin": torch.asin,
    "arccos": torch.acos, "arctan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "arcsinh": torch.asinh,
    "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "negative": torch.neg, "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": torch.relu,
    "identity": lambda x: x,
}

_g = globals()
for _name, _fn in _UNARY.items():
    def _make(f):
        def impl(data):
            return f(data)
        return impl
    _impl = _make(_fn)
    _impl.__name__ = _name
    _g[_name] = op(_name)(_impl)

alias("_copy", "identity")
abs = _g["abs"]  # noqa: A001
round = _g["round"]  # noqa: A001


@op("softrelu")
def softrelu(data):
    return F.softplus(data)


@op("BlockGrad", differentiable=True)
def BlockGrad(data):
    return data.detach()


def stop_gradient(data):
    return BlockGrad(data)


alias("stop_gradient", "BlockGrad")


@op("shape_array", differentiable=False)
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@op("size_array", differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@op("cast")
def cast(data, *, dtype):
    return data.to(torch_dtype(dtype))


alias("Cast", "cast")


@op("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


# ======================================================================= #
# elementwise binary (broadcasting); the elemwise_* and broadcast_*
# families share implementations, as in the reference
# ======================================================================= #

def _scalar_pair(lhs, rhs):
    """torch's binary functions want a tensor first: give a Python number
    the other operand's dtype as a 0-d host tensor."""
    if not isinstance(lhs, torch.Tensor):
        lhs = torch.tensor(lhs, dtype=rhs.dtype)
    if not isinstance(rhs, torch.Tensor):
        rhs = torch.tensor(rhs, dtype=lhs.dtype)
    return lhs, rhs


_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "arctan2": torch.atan2,
}
for _name, _fn in _BINARY.items():
    def _makeb(f):
        def impl(lhs, rhs):
            return f(*_scalar_pair(lhs, rhs))
        return impl
    _impl = _makeb(_fn)
    _impl.__name__ = _name
    _g[_name] = op(_name)(_impl)

for _short, _long in [("add", "broadcast_add"), ("subtract", "broadcast_sub"),
                      ("multiply", "broadcast_mul"),
                      ("divide", "broadcast_div"),
                      ("modulo", "broadcast_mod"),
                      ("power", "broadcast_power"),
                      ("maximum", "broadcast_maximum"),
                      ("minimum", "broadcast_minimum"),
                      ("elemwise_add", "broadcast_add"),
                      ("elemwise_sub", "broadcast_sub"),
                      ("elemwise_mul", "broadcast_mul"),
                      ("elemwise_div", "broadcast_div")]:
    alias(_short, _long)
    _g[_short] = _g[_long]

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}
for _name, _fn in _CMP.items():
    def _makec(f):
        def impl(lhs, rhs):
            lhs, rhs = _scalar_pair(lhs, rhs)
            # MXNet comparison ops return the input float dtype (1.0/0.0)
            dt = torch.result_type(lhs, rhs)
            if dt == torch.bool:
                dt = torch.float32
            return f(lhs, rhs).to(dt)
        return impl
    _impl = _makec(_fn)
    _impl.__name__ = _name
    _g[_name] = op(_name, differentiable=False)(_impl)

for _short, _long in [("equal", "broadcast_equal"),
                      ("not_equal", "broadcast_not_equal"),
                      ("greater", "broadcast_greater"),
                      ("greater_equal", "broadcast_greater_equal"),
                      ("lesser", "broadcast_lesser"),
                      ("lesser_equal", "broadcast_lesser_equal"),
                      ("logical_and", "broadcast_logical_and"),
                      ("logical_or", "broadcast_logical_or"),
                      ("logical_xor", "broadcast_logical_xor")]:
    alias(_short, _long)
    _g[_short] = _g[_long]


@op("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.broadcast_to(rhs.shape)


@op("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


def _tie(x, bound, above):
    """d/dx of ``max(x, bound)`` (``above``) or ``min(x, bound)`` as JAX
    takes it: 1 on the kept side, 0 on the other, 1/2 at a tie."""
    keep = (x > bound) if above else (x < bound)
    return keep.to(x.dtype) + (x == bound).to(x.dtype) * 0.5


class _Clip(torch.autograd.Function):
    """``min(max(x, a_min), a_max)`` with the reference's gradient
    (``jnp.clip``): an element at a bound gets half the incoming
    gradient, as XLA splits a tie of ``max``/``min``; ``torch.clamp``
    would pass all of it.  ReLU6 (``clip(x, 0, 6)``) meets such ties
    wherever a channel is exactly zero."""

    @staticmethod
    def forward(ctx, x, a_min, a_max):
        ctx.save_for_backward(x)
        ctx.bounds = (a_min, a_max)
        return torch.clamp(x, a_min, a_max)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a_min, a_max = ctx.bounds
        w = torch.ones_like(x)
        if a_min is not None:
            w = _tie(x, a_min, True)
            x = torch.clamp(x, min=a_min)
        if a_max is not None:
            w = w * _tie(x, a_max, False)
        return g * w, None, None


@op("clip")
def clip(data, *, a_min, a_max):
    if not data.is_floating_point():
        return torch.clamp(data, a_min, a_max)
    return _Clip.apply(data, a_min, a_max)


@op("add_n", variadic=True)
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


alias("ElementWiseSum", "add_n")


# ======================================================================= #
# reductions
# ======================================================================= #

def _excl(axis, ndim, exclude):
    if not exclude or axis is None:
        return axis
    ax = (axis,) if isinstance(axis, int) else axis
    ax = tuple(a % ndim for a in ax)
    return tuple(i for i in range(ndim) if i not in ax)


def _int_result(out, data):
    """JAX sums booleans to int32 and keeps other integer dtypes."""
    if data.dtype == torch.bool:
        return out.to(torch.int32)
    return out if data.is_floating_point() else out.to(data.dtype)


@op("sum")
def sum(data, *, axis=None, keepdims=False, exclude=False):  # noqa: A001
    dims = _dims(_excl(_norm_axis(axis), data.dim(), exclude), data.dim())
    return _int_result(torch.sum(data, dim=dims, keepdim=keepdims), data)


@op("mean")
def mean(data, *, axis=None, keepdims=False, exclude=False):
    dims = _dims(_excl(_norm_axis(axis), data.dim(), exclude), data.dim())
    return torch.mean(_float(data), dim=dims, keepdim=keepdims)


@op("prod")
def prod(data, *, axis=None, keepdims=False):
    out = data
    for d in sorted((a % _max(data.dim(), 1)
                     for a in _dims(axis, data.dim())), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return _int_result(out, data)


@op("nansum")
def nansum(data, *, axis=None, keepdims=False):
    return torch.nansum(data, dim=_dims(axis, data.dim()), keepdim=keepdims)


@op("nanprod")
def nanprod(data, *, axis=None, keepdims=False):
    return prod.__wrapped__(torch.where(torch.isnan(data),
                                        torch.ones_like(data), data),
                            axis=axis, keepdims=keepdims)


@op("max")
def max(data, *, axis=None, keepdims=False):  # noqa: A001
    return torch.amax(data, dim=_dims(axis, data.dim()), keepdim=keepdims)


@op("min")
def min(data, *, axis=None, keepdims=False):  # noqa: A001
    return torch.amin(data, dim=_dims(axis, data.dim()), keepdim=keepdims)


@op("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    dims = _dims(axis, data.dim())
    if ord == 1:
        return torch.sum(torch.abs(data), dim=dims, keepdim=keepdims)
    if ord != 2:
        raise MXNetError(f"norm: only ord=1 or 2 supported, got {ord}")
    return torch.sqrt(torch.sum(torch.square(data), dim=dims,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        return out.reshape((1,) * data.dim()) if keepdims else out
    return fn(data, dim=axis, keepdim=keepdims)


@op("argmax", differentiable=False)
def argmax(data, *, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims).to(torch.float32)


@op("argmin", differentiable=False)
def argmin(data, *, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims).to(torch.float32)


@op("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


# ======================================================================= #
# ordering
# ======================================================================= #

@op("topk", differentiable=False)
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    vals, idx = torch.topk(data, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idx.to(torch_dtype(dtype)))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idx, 1.0)
    return idx.to(torch_dtype(dtype))


@op("sort")
def sort(data, *, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@op("argsort", differentiable=False)
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(torch_dtype(dtype))


# ======================================================================= #
# linalg
# ======================================================================= #

def _reverse(a):
    return a.permute(*range(a.dim() - 1, -1, -1))


@op("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """MXNet dot: contract lhs's last axis with rhs's first (reference
    ``src/operator/tensor/dot.cc``); a transpose flag reverses all of
    that operand's axes.  The 2-D case is one cuBLAS GEMM."""
    a, b = lhs, rhs
    if transpose_a and a.dim() > 1:
        a = _reverse(a)
    if transpose_b and b.dim() > 1:
        b = _reverse(b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() == 2 and b.dim() == 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@op("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@op("matmul")
def matmul(lhs, rhs):
    return torch.matmul(lhs, rhs)


@op("linalg_gemm2")
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0):
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b)


@op("linalg_syrk")
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    a = A.transpose(-1, -2) if transpose else A
    return alpha * torch.matmul(a, a.transpose(-1, -2))


@op("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@op("linalg_trsm")
def linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Triangular solve (reference ``linalg_trsm``): ``op(A)·X = alpha·B``,
    or ``X·op(A) = alpha·B`` with ``rightside``."""
    a = A.transpose(-1, -2) if transpose else A
    upper = lower if transpose else not lower
    return torch.linalg.solve_triangular(a, B * alpha, upper=upper,
                                         left=not rightside)


@op("L2Normalization")
def L2Normalization(data, *, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    else:  # spatial
        ax = tuple(range(2, data.dim()))
    n = torch.sqrt(torch.sum(torch.square(data), dim=ax, keepdim=True)
                   + eps)
    return data / n


# ======================================================================= #
# shape manipulation
# ======================================================================= #

@op("reshape")
def reshape(data, *, shape):
    return data.reshape(_mx_reshape(tuple(data.shape), shape))


@op("reshape_like")
def reshape_like(lhs, rhs):
    """Reference ``reshape_like``: reshape lhs to rhs's shape."""
    return lhs.reshape(rhs.shape)


@op("unique", differentiable=False)
def unique(data):
    """Sorted distinct values (dynamic output shape)."""
    return torch.unique(data, sorted=True)


@op("_onnx_expand")
def _onnx_expand(data, *, shape):
    """ONNX ``Expand``: the output shape is the numpy broadcast of the
    input's shape and ``shape``."""
    shape = tuple(int(s) for s in shape)
    out = np.broadcast_shapes(tuple(data.shape), shape)
    full = (1,) * (len(out) - data.dim()) + tuple(data.shape)
    return data.reshape(full).broadcast_to(out)


def _mx_reshape(ishape, shape):
    """MXNet special codes: 0 (keep dim), -1 (infer), -2 (copy rest),
    -3 (merge two dims), -4 (split dim)."""
    if all(isinstance(s, int) and s > 0 or s == -1 for s in shape):
        return tuple(shape)
    out = []
    i = 0
    k = 0
    shape = list(shape)
    while k < len(shape):
        s = shape[k]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            out.append(ishape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(ishape[i:])
            i = len(ishape)
        elif s == -3:
            out.append(ishape[i] * ishape[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[k + 1], shape[k + 2]
            if a == -1:
                a = ishape[i] // b
            if b == -1:
                b = ishape[i] // a
            out.extend([a, b])
            i += 1
            k += 2
        else:
            raise MXNetError(f"bad reshape code {s}")
        k += 1
    return tuple(out)


alias("Reshape", "reshape")


@op("transpose")
def transpose(data, *, axes=None):
    return data.permute(*axes) if axes else _reverse(data)


@op("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(axis)


@op("squeeze")
def squeeze(data, *, axis=None):
    return data.squeeze() if axis is None else data.squeeze(axis)


@op("flatten")
def flatten(data):
    return data.reshape(data.shape[0], -1)


alias("Flatten", "flatten")


@op("broadcast_to")
def broadcast_to(data, *, shape):
    tgt = tuple(o if s == 0 else s for s, o in zip(shape, data.shape)) \
        if len(shape) == data.dim() else tuple(shape)
    return data.broadcast_to(tgt)


@op("broadcast_axis")
def broadcast_axis(data, *, axis, size):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.broadcast_to(tuple(tgt))


alias("broadcast_axes", "broadcast_axis")


@op("swapaxes")
def swapaxes(data, *, dim1=0, dim2=1):
    return data.transpose(dim1, dim2)


alias("SwapAxis", "swapaxes")


@op("concat", variadic=True)
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


alias("Concat", "concat")


@op("stack", variadic=True)
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@op("split")
def split(data, *, num_outputs, axis=1, squeeze_axis=False):
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


alias("SliceChannel", "split")


def _slice_dim(t, axis, b, e, s):
    """``t[..., b:e:s, ...]`` along ``axis``; torch slicing takes no
    negative step, so that case gathers the indices Python's slice
    names."""
    if s is None or s > 0:
        idx = [builtins.slice(None)] * t.dim()
        idx[axis] = builtins.slice(b, e, s)
        return t[tuple(idx)]
    rows = range(*builtins.slice(b, e, s).indices(t.shape[axis]))
    return t.index_select(axis, torch.tensor(list(rows), dtype=torch.long,
                                             device=t.device))


@op("slice")
def slice(data, *, begin, end, step=None):  # noqa: A001
    nd = data.dim()
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = (tuple(step) + (None,) * (nd - len(step))) if step \
        else (None,) * nd
    out = data
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        if (b, e, s) != (None, None, None):
            out = _slice_dim(out, axis, b, e, s)
    return out


alias("crop", "slice")


@op("slice_axis")
def slice_axis(data, *, axis, begin, end):
    return _slice_dim(data, axis, begin, end, None)


@op("slice_like")
def slice_like(data, shape_like, *, axes=None):
    axes = axes or tuple(range(data.dim()))
    idx = [builtins.slice(None)] * data.dim()
    for a in axes:
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@op("tile")
def tile(data, *, reps):
    return torch.tile(data, tuple(reps))


@op("repeat")
def repeat(data, *, repeats, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


@op("flip")
def flip(data, *, axis):
    return torch.flip(data, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


alias("reverse", "flip")


@op("pad")
def pad(data, *, mode="constant", pad_width=(), constant_value=0):
    pairs = list(zip(pad_width[::2], pad_width[1::2]))
    while pairs and pairs[0] == (0, 0):    # torch pads trailing dims
        pairs.pop(0)
    flat = [p for pair in reversed(pairs) for p in pair]
    tmode = {"constant": "constant", "edge": "replicate",
             "reflect": "reflect"}[mode]
    if tmode == "constant":
        return F.pad(data, flat, mode="constant", value=constant_value)
    return F.pad(data, flat, mode=tmode)


alias("Pad", "pad")


@op("diag")
def diag(data, *, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@op("depth_to_space")
def depth_to_space(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@op("space_to_depth")
def space_to_depth(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ======================================================================= #
# indexing
# ======================================================================= #

@op("take")
def take(a, indices, *, axis=0, mode="clip"):
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    out = a.index_select(axis, idx.reshape(-1))
    axis = axis % a.dim()
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@op("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    idx = index.long().unsqueeze(axis).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@op("gather_nd")
def gather_nd(data, indices):
    return data[tuple(indices.long())]


@op("scatter_nd")
def scatter_nd(data, indices, *, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data, accumulate=True)


@op("one_hot", differentiable=False)
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
            dtype="float32"):
    # out-of-range indices give a row of off_value, as jax.nn.one_hot's
    # zeros do
    oh = (indices.long().unsqueeze(-1) ==
          torch.arange(depth, device=indices.device)).float()
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@op("boolean_mask")
def boolean_mask(data, index, *, axis=0):
    keep = torch.nonzero(index.bool()).reshape(-1)
    return data.index_select(axis, keep)


def _seq_shape(L, ndim, axis):
    return (L,) + (1,) * (ndim - 1) if axis == 0 \
        else (1, L) + (1,) * (ndim - 2)


@op("sequence_mask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    L = data.shape[axis]
    pos = torch.arange(L, device=data.device).reshape(
        _seq_shape(L, data.dim(), axis))
    sl = sequence_length.reshape(
        ((1, -1) if axis == 0 else (-1, 1)) + (1,) * (data.dim() - 2))
    return torch.where(pos < sl, data,
                       torch.tensor(value, dtype=data.dtype))


alias("SequenceMask", "sequence_mask")


@op("sequence_last")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.long() - 1
    if axis == 0:
        return data[last, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), last]


alias("SequenceLast", "sequence_last")


@op("sequence_reverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    # reverse only the first sequence_length elements along axis 0
    L = data.shape[0]
    pos = torch.arange(L, device=data.device).reshape(
        (L,) + (1,) * (data.dim() - 1))
    sl = sequence_length.long().reshape((1, -1) + (1,) * (data.dim() - 2))
    src = torch.where(pos < sl, sl - 1 - pos, pos)
    return torch.gather(data, 0, src.expand(data.shape))


alias("SequenceReverse", "sequence_reverse")


def _index(data, key):
    """``NDArray.__getitem__``: basic and advanced indexing, recorded like
    any op (the index tensors are constants of the closure)."""
    from .registry import Op

    return invoke(Op(name="_index", fn=lambda d: d[key]), [data], {})


# ======================================================================= #
# creation ops (no tensor inputs -> plain functions, not @op)
# ======================================================================= #

def _make(fn, ctx, dtype, *args, **kw):
    from ..context import current_context
    from ..ndarray.ndarray import NDArray

    dev = (ctx if ctx is not None else current_context()).torch_device()
    return NDArray(fn(*args, dtype=torch_dtype(dtype or "float32"),
                      device=dev, **kw))


def zeros(shape, ctx=None, dtype="float32"):
    return _make(torch.zeros, ctx, dtype, shape)


def ones(shape, ctx=None, dtype="float32"):
    return _make(torch.ones, ctx, dtype, shape)


def full(shape, val, ctx=None, dtype="float32"):
    return _make(torch.full, ctx, dtype, shape, val)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = _make(torch.arange, ctx, dtype, start, stop, step)
    if repeat > 1:
        out._data = torch.repeat_interleave(out._data, repeat)
    return out


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    def fn(dtype, device):
        n = num - 1 if endpoint else num
        step = (stop - start) / n if n > 0 else 0.0
        i = torch.arange(num, dtype=torch.float64, device=device)
        out = start + i * step
        if endpoint and num > 1:
            out[-1] = stop
        return out.to(dtype)
    return _make(fn, ctx, dtype)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    def fn(dtype, device):
        r = torch.arange(N, device=device)[:, None]
        c = torch.arange(M or N, device=device)[None, :]
        return (c - r == k).to(dtype)
    return _make(fn, ctx, dtype)


@op("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@op("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@op("full_like")
def full_like(data, *, fill_value=0.0):
    return torch.full_like(data, fill_value)


# ----------------------------------------------------------------------- #
# AMP support ops (reference ``all_finite`` / ``multi_all_finite``: the
# overflow probes of the dynamic loss scaler)
# ----------------------------------------------------------------------- #

@op("all_finite", differentiable=False)
def all_finite(data, *, init_output=True):
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@op("multi_all_finite", differentiable=False, variadic=True)
def multi_all_finite(*arrays, num_arrays=0, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = torch.logical_and(ok, torch.isfinite(a).all())
    return ok.to(torch.float32).reshape(1)


@op("amp_cast")
def amp_cast(data, *, dtype="float16"):
    return data.to(torch_dtype(dtype))


@op("amp_multicast", differentiable=True, variadic=True)
def amp_multicast(*arrays, num_outputs=0, cast_narrow=False):
    """Cast all inputs to the widest (or narrowest) common float dtype."""
    pick_ = _min if cast_narrow else _max
    target = pick_((a.dtype for a in arrays),
                   key=lambda d: d.itemsize * 8 if d.is_floating_point
                   else 0)
    return tuple(a.to(target) for a in arrays)


# ----------------------------------------------------------------------- #
# Dropout (reference: the plain function ``Dropout`` over the op
# ``_DropoutImpl``; here one unregistered op, so the registry keeps the
# ops the parity cases cover)
# ----------------------------------------------------------------------- #

def Dropout(data, key=None, *, p=0.5, mode="training", axes=(),
            cudnn_off=False, training=None):
    """Reference ``Dropout``: applies in training mode
    (``autograd.is_training()``, or ``training=``) or with ``mode=
    'always'``, and is the identity otherwise or at ``p <= 0``.  The mask
    comes from ``ops.nn.dropout``: a generator seeded with the integer
    ``key`` when one is given (the same key, the same mask), else the
    port's device generator, which a captured program's graph advances
    at every replay."""
    from .. import autograd
    from .nn import dropout
    from .registry import Op

    if training is None:
        training = autograd.is_training()
    if (not training and mode != "always") or p <= 0.0:
        return data
    return invoke(Op("Dropout", lambda x: dropout(
        x, p, True, axes=tuple(axes), key=key)), [data], {})
