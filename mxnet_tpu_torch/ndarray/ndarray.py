"""NDArray — the imperative tensor handle.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An ``NDArray`` is a
handle over a ``torch.Tensor``; its context is the tensor's device.
PyTorch dispatches to the card asynchronously, as the reference's engine
did, so ``wait_to_read`` synchronises and ``waitall`` is
``torch.cuda.synchronize``.

In-place operators rebind the handle to a new tensor (``x += y`` makes
``x`` point at ``x + y``), as the reference does: a torch in-place op on
a tensor that autograd saved for a backward would fail its version
check.  An array with an attached gradient (``attach_grad``) holds a
leaf tensor that requires a gradient; rebinding it outside
``autograd.record()`` makes the new tensor the leaf, so ``w -= lr *
w.grad`` keeps ``w`` a variable.  The gradient lands in the persistent
``.grad`` handle through a post-accumulate hook on the leaf, following
``grad_req`` (``write`` replaces, ``add`` adds, ``null`` never records).

A Gluon ``Parameter``'s array adopts the ``nn.Parameter`` its block
registers (``_leaf``), so the module, the array and the trainers share
one storage: rebinding such an array outside ``record()`` writes the new
values into that tensor, and its hook hands a gradient to ``.grad`` only
in a backward of ``autograd``; a PyTorch ``backward`` on the module's
tensors leaves the gradient in the tensor's ``.grad``, as PyTorch does.

Sparse storage (``tostype("row_sparse" | "csr")``) lives in
``ndarray/sparse.py``; a Python operator with a sparse operand goes
through its storage-aware dispatch.  Differences from the reference:
``asnumpy`` of a bfloat16 array returns float32 (numpy has no bfloat16);
``dtype`` is a numpy dtype, or ``torch.bfloat16`` for bfloat16.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..base import MXNetError, dtype_name, numeric_types, torch_dtype
from ..context import Context, current_context, from_torch_device

__all__ = ["NDArray", "array", "empty", "waitall", "from_torch",
           "to_device"]


def _ops():
    from ..ops import defs
    return defs


# every live array that a recorded op produced, by id, weakly: a backward
# that frees its graph marks those it reached (``autograd._free``)
_RECORDED: "weakref.WeakValueDictionary[int, NDArray]" = \
    weakref.WeakValueDictionary()


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_freed", "__weakref__")

    # True on the sparse subclasses (ndarray/sparse.py): one attribute
    # read keeps sparse dispatch off the dense operators' path
    _sparse_kind = False

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, not "
                             f"{type(data).__name__}")
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._freed = False
        if data.grad_fn is not None:
            _RECORDED[id(self)] = self

    # ------------------------------------------------------------------ #
    # identity / metadata
    # ------------------------------------------------------------------ #
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return np.dtype(dtype_name(self._data.dtype))

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return from_torch_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    def __repr__(self):
        shape = "x".join(map(str, self.shape)) or "scalar"
        return f"{self.asnumpy()!r}\n<NDArray {shape} @{self.context}>"

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __index__(self):
        return int(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------------ #
    # engine analogs and host copies
    # ------------------------------------------------------------------ #
    def wait_to_read(self):
        """Reference ``NDArray::WaitToRead``: wait for the card."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # at least 1-d, as the reference's (``np.ascontiguousarray``); a
        # copy, as MXNet's: a CPU tensor's numpy view would follow the
        # in-place updates of a parameter
        out = np.ascontiguousarray(t.cpu().numpy())
        if t.device.type == "cpu" and np.shares_memory(out, t.numpy()):
            out = out.copy()
        return out

    def item(self):
        return self.asnumpy().item()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not a scalar")
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    def astorch(self) -> torch.Tensor:
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # ------------------------------------------------------------------ #
    # mutation-as-rebind
    # ------------------------------------------------------------------ #
    def _rebind(self, data: torch.Tensor):
        """Point this handle at ``data``.  A variable (attached gradient)
        keeps being one: a tensor that no recorded op produced becomes
        its new leaf.  An adopted ``nn.Parameter`` takes such a tensor's
        values in place, so it stays the module's parameter."""
        cur = self._data
        if isinstance(cur, torch.nn.Parameter) and data.grad_fn is None \
                and data is not cur and data.shape == cur.shape:
            with torch.no_grad():
                cur.copy_(data)
            self._freed = False
            return self
        if self._grad_req != "null" and data.grad_fn is None:
            data = _leaf(data, self)
        self._data = data
        self._freed = False
        if data.grad_fn is not None:
            _RECORDED[id(self)] = self
        return self

    # ------------------------------------------------------------------ #
    # autograd surface
    # ------------------------------------------------------------------ #
    def attach_grad(self, grad_req: str = "write", stype=None, lazy=False):
        """Allocate a zero gradient buffer and make this array a variable
        (reference ``NDArray.attach_grad``).  With ``lazy`` (a Gluon
        ``Parameter``'s array) the buffer is allocated at its first use
        instead (``_grad_buffer``).  ``stype`` is accepted and the buffer
        is dense, as in the reference."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req}")
        if stype not in (None, "default", "row_sparse", "csr"):
            raise MXNetError(f"unknown gradient storage {stype!r}")
        self._grad = None if lazy else self._zeros_grad()
        self._grad_req = grad_req
        self._freed = False
        self._data = _leaf(self._data, self) if grad_req != "null" \
            else self._data.detach()

    @property
    def grad(self):
        return self._grad_buffer()

    def _zeros_grad(self) -> "NDArray":
        gdt = self._data.dtype if self._data.is_floating_point() \
            else torch.float32
        return NDArray(torch.zeros(self.shape, dtype=gdt,
                                   device=self._data.device))

    def _grad_buffer(self) -> "NDArray":
        """The gradient buffer, allocated (zero) at its first use."""
        if self._grad is None and self._grad_req != "null":
            self._grad = self._zeros_grad()
        return self._grad

    def zero_grad(self):
        if self._grad is not None:
            self._grad._rebind(torch.zeros_like(self._grad._data))

    def _commit_grad(self, g: torch.Tensor):
        buf = self._grad_buffer()
        if buf is None or self._grad_req == "null":
            return
        g = g.detach().to(buf._data.dtype)
        if self._grad_req == "add":
            g = buf._data + g
        buf._rebind(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self) -> "NDArray":
        return _like(self, self._data.detach())

    # ------------------------------------------------------------------ #
    # conversion / movement
    # ------------------------------------------------------------------ #
    def astype(self, dtype, copy=True):
        return _ops().cast(self, dtype=dtype_name(torch_dtype(dtype)))

    def copy(self) -> "NDArray":
        return _like(self, self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            other._rebind(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        if isinstance(other, Context):
            return self.as_in_context(other)
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        dev = ctx.torch_device()
        if self._data.device == dev:
            return self
        return _like(self, self._data.detach().to(dev))

    as_in_ctx = as_in_context

    def as_nd_ndarray(self) -> "NDArray":
        """This array as an ``mx.nd.NDArray``: the same tensor (and so
        the same recorded graph) and the same gradient buffer."""
        if type(self) is NDArray:
            return self
        return _view_as(self, NDArray)

    def as_np_ndarray(self):
        """This array as an ``mx.np.ndarray``, sharing the tensor and the
        gradient buffer (reference ``NDArray.as_np_ndarray``)."""
        from ..numpy.multiarray import ndarray as np_ndarray

        if type(self) is np_ndarray:
            return self
        return _view_as(self, np_ndarray)

    def tostype(self, stype):
        if stype == "default":
            return self
        from .sparse import tostype as _tostype
        return _tostype(self, stype)

    # ------------------------------------------------------------------ #
    # shape ops (through the op registry so autograd sees them)
    # ------------------------------------------------------------------ #
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _ops().reshape(self, shape=tuple(kwargs.get("shape", shape)))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _ops().transpose(self, axes=tuple(axes) if axes else None)

    @property
    def T(self):
        return self.transpose()

    def expand_dims(self, axis):
        return _ops().expand_dims(self, axis=axis)

    def squeeze(self, axis=None):
        return _ops().squeeze(self, axis=axis)

    def flatten(self):
        return _ops().flatten(self)

    def broadcast_to(self, shape):
        return _ops().broadcast_to(self, shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def swapaxes(self, dim1, dim2):
        return _ops().swapaxes(self, dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _ops().split(self, num_outputs=num_outputs, axis=axis,
                            squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return _ops().slice(self, begin=tuple(begin), end=tuple(end),
                            step=tuple(step) if step else None)

    def slice_axis(self, axis, begin, end):
        return _ops().slice_axis(self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _ops().take(self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _ops().one_hot(self, depth=depth, on_value=on_value,
                              off_value=off_value, dtype=dtype)

    def tile(self, reps):
        return _ops().tile(self, reps=tuple(reps))

    def repeat(self, repeats, axis=None):
        return _ops().repeat(self, repeats=repeats, axis=axis)

    def flip(self, axis):
        return _ops().flip(self, axis=axis)

    def pad(self, mode="constant", pad_width=None, constant_value=0):
        return _ops().pad(self, mode=mode, pad_width=tuple(pad_width),
                          constant_value=constant_value)

    def diag(self, k=0):
        return _ops().diag(self, k=k)

    # reductions --------------------------------------------------------- #
    def sum(self, axis=None, keepdims=False):
        return _ops().sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _ops().mean(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _ops().max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _ops().min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return _ops().prod(self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _ops().norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _ops().argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _ops().argmin(self, axis=axis, keepdims=keepdims)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _ops().topk(self, axis=axis, k=k, ret_typ=ret_typ,
                           is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return _ops().sort(self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True, dtype="float32"):
        return _ops().argsort(self, axis=axis, is_ascend=is_ascend,
                              dtype=dtype)

    # elementwise methods ------------------------------------------------ #
    def abs(self):
        return _ops().abs(self)

    def exp(self):
        return _ops().exp(self)

    def log(self):
        return _ops().log(self)

    def sqrt(self):
        return _ops().sqrt(self)

    def square(self):
        return _ops().square(self)

    def relu(self):
        return _ops().relu(self)

    def sigmoid(self):
        return _ops().sigmoid(self)

    def tanh(self):
        return _ops().tanh(self)

    def softmax(self, axis=-1):
        from ..ops.registry import OPS
        return OPS["softmax"].wrapper(self, axis=axis)

    def log_softmax(self, axis=-1):
        from ..ops.registry import OPS
        return OPS["log_softmax"].wrapper(self, axis=axis)

    def clip(self, a_min, a_max):
        return _ops().clip(self, a_min=a_min, a_max=a_max)

    def round(self):
        return _ops().round(self)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _ops().dot(self, other, transpose_a=transpose_a,
                          transpose_b=transpose_b)

    # ------------------------------------------------------------------ #
    # python operators
    # ------------------------------------------------------------------ #
    def _binop(self, other, name, reverse=False):
        if self._sparse_kind or getattr(other, "_sparse_kind", False):
            from .sparse import binop
            return binop(self, other, name, reverse)
        fn = getattr(_ops(), name)
        if reverse:
            return fn(_coerce(other, self), self)
        return fn(self, _coerce(other, self))

    def __add__(self, o):
        return self._binop(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", reverse=True)

    def __matmul__(self, o):
        return _ops().matmul(self, o)

    def __neg__(self):
        return _ops().negative(self)

    def __abs__(self):
        return self.abs()

    def __eq__(self, o):
        return self._binop(o, "broadcast_equal")

    def __ne__(self, o):
        return self._binop(o, "broadcast_not_equal")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal")

    def __hash__(self):
        return id(self)

    # in-place: rebind (tape-visible when recording) --------------------- #
    def __iadd__(self, o):
        return self._rebind(self.__add__(o)._data)

    def __isub__(self, o):
        return self._rebind(self.__sub__(o)._data)

    def __imul__(self, o):
        return self._rebind(self.__mul__(o)._data)

    def __itruediv__(self, o):
        return self._rebind(self.__truediv__(o)._data)

    # ------------------------------------------------------------------ #
    # indexing
    # ------------------------------------------------------------------ #
    def __getitem__(self, key):
        return _ops()._index(self, key=_index_key(key, self._data.device))

    def __setitem__(self, key, value):
        from .. import autograd
        if self._data.grad_fn is not None and autograd.is_recording():
            raise MXNetError(
                "in-place assignment to an array produced inside "
                "autograd.record() is not differentiable; use concat/where "
                "instead")
        if isinstance(value, NDArray):
            value = value._data
        new = self._data.detach().clone()
        new[_index_key(key, new.device)] = value
        self._rebind(new)


def _out_class(args) -> type:
    """The array class of a call's outputs (the reference's
    ``_wrap_like``): its first array argument's, so an ``mx.np`` array
    stays one, or a dense ``NDArray`` where that one is sparse."""
    for a in args:
        if isinstance(a, NDArray):
            cls = type(a)
            return NDArray if cls._sparse_kind else cls
    return NDArray


def _like(ref: NDArray, data: torch.Tensor) -> NDArray:
    """``data`` in the class ``_out_class`` gives ``ref``."""
    return _out_class((ref,))(data)


def _view_as(arr: NDArray, cls) -> NDArray:
    """``arr`` under another array class: one tensor, one gradient
    buffer (allocated now, so both handles see the same one)."""
    out = cls(arr._data)
    out._grad = arr._grad_buffer()
    out._grad_req = arr._grad_req
    out._freed = arr._freed
    return out


def _leaf(data: torch.Tensor, owner: NDArray) -> torch.Tensor:
    """A leaf tensor holding ``data``'s values whose accumulated gradient
    is handed to ``owner``'s ``.grad`` after every backward.  An
    ``nn.Parameter`` is adopted as it is (hooked once), not copied: a
    Gluon ``Parameter``'s array and its block then hold one tensor."""
    adopt = isinstance(data, torch.nn.Parameter)
    t = data if adopt else data.detach()
    if not t.is_floating_point():
        return t
    t.requires_grad_(True)
    if adopt and getattr(t, "_mx_hooked", False):
        return t
    ref = weakref.ref(owner)

    def commit(leaf):
        if adopt:
            from .. import autograd
            if not autograd._in_backward:
                return          # a PyTorch backward: keep torch's .grad
        g, leaf.grad = leaf.grad, None
        nd = ref()
        if nd is not None and g is not None:
            nd._commit_grad(g)

    t.register_post_accumulate_grad_hook(commit)
    if adopt:
        t._mx_hooked = True
    return t


def _index_key(key, device):
    """NDArray (and numpy) indices -> long tensors; tuples recurse."""
    if isinstance(key, NDArray):
        key = key._data
    if isinstance(key, np.ndarray):
        key = torch.from_numpy(key)
    if isinstance(key, torch.Tensor):
        key = key.to(device)
        return key if key.dtype == torch.bool else key.long()
    if isinstance(key, tuple):
        return tuple(_index_key(k, device) for k in key)
    return key


def _coerce(x, like: NDArray):
    """A binary operator's other operand: NDArrays pass; a Python number
    becomes a 0-d host tensor of ``like``'s dtype (the reference's
    ``jnp.asarray(x, like.dtype)``), which torch takes as a scalar
    argument on any device, so no copy to the card is made."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, numeric_types):
        return NDArray(torch.tensor(x, dtype=like._data.dtype))
    if isinstance(x, (np.ndarray, list, tuple)):
        return array(x, ctx=like.context)
    raise TypeError(f"cannot coerce {type(x)} to NDArray")


# ---------------------------------------------------------------------- #
# creation
# ---------------------------------------------------------------------- #

def _default_dtype(a: np.ndarray):
    """The reference keeps JAX's 32-bit defaults: float64 and int64
    sources become float32 and int32 unless a dtype is given."""
    return {np.dtype(np.float64): torch.float32,
            np.dtype(np.int64): torch.int32}.get(a.dtype)


def array(source, ctx: Context = None, dtype=None) -> NDArray:
    """``mx.nd.array`` — from numpy, a list, a torch tensor or an
    NDArray, on ``ctx`` (default: the current context, ``gpu(0)`` unless
    a ``with mx.cpu():`` scope says otherwise)."""
    if isinstance(source, NDArray):
        source = source._data.detach()
    if isinstance(source, torch.Tensor):
        dev = ctx.torch_device() if ctx is not None else source.device
        dt = torch_dtype(dtype) if dtype is not None else source.dtype
        return NDArray(source.to(device=dev, dtype=dt, copy=True))
    ctx = ctx if ctx is not None else current_context()
    dev = ctx.torch_device()
    host = np.asarray(source)
    dt = torch_dtype(dtype) if dtype is not None else _default_dtype(host)
    t = torch.from_numpy(np.array(host, order="C"))
    t = t.to(device=dev, dtype=dt, copy=True)
    if ctx.device_type == "cpu_pinned":
        t = t.pin_memory()
    return NDArray(t)


# the reference keeps JAX's 32-bit defaults even where a 64-bit dtype is
# asked for by name (``nd.array(x, dtype=str(x.dtype))``)
_HOST_32 = {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.int64): np.dtype(np.int32)}


def _host(a, dtype=None) -> NDArray:
    """A host (CPU) NDArray holding a copy of ``a`` (numpy, list,
    NDArray, tensor), whatever the current context: the data pipeline's
    samples and transforms live on the host, and a batch reaches the card
    once (``gluon.data.DataLoader``).  64-bit dtypes become 32-bit, as in
    the reference."""
    a = _as_np(a)
    dt = np.dtype(dtype) if dtype is not None else a.dtype
    dt = _HOST_32.get(dt, dt)
    return NDArray(torch.from_numpy(np.array(a, dtype=dt, order="C")))


def _as_np(x) -> np.ndarray:
    """``x`` as numpy for reading: a view of a host tensor's memory (the
    caller must not write it), a copy of a card's (bfloat16 as float32)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type == "cpu" and x.dtype != torch.bfloat16:
            return x.numpy()
        return x.float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.cpu().numpy()
    return np.asarray(x)


def empty(shape, ctx=None, dtype=None):
    return _ops().zeros(shape, ctx=ctx, dtype=dtype)


def from_torch(x: torch.Tensor) -> NDArray:
    return NDArray(x)


def waitall():
    """Reference ``mx.nd.waitall``: wait for all work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------- #
# device placement (the data loader's host-to-device stage)
# ---------------------------------------------------------------------- #

_ONE_CARD = ("the port runs on one card: a batch is placed on one "
             "device, and placement across several (a sharding, a list "
             "of more than one device) is not ported")


def _placement_target(device):
    """The torch device a placement spec names: a ``Context``, a
    ``torch.device`` or a device string, or a one-element list of one.
    ``None`` stays ``None`` (no placement).  A sharding or a list of
    more than one device raises ``MXNetError``: the reference lands such
    a batch pre-sharded across a mesh in one ``device_put``, and the
    port has one card (the reference's ``ring_attention`` is refused
    the same way)."""
    if device is None:
        return None
    if isinstance(device, Context):
        return device.torch_device()
    if isinstance(device, (torch.device, str)):
        return from_torch_device(torch.device(device)).torch_device()
    if isinstance(device, (list, tuple)):
        if not device:
            raise MXNetError("empty device list")
        if len(device) > 1:
            raise MXNetError(f"{len(device)} devices given: {_ONE_CARD}")
        return _placement_target(device[0])
    if hasattr(device, "device_set") or "Sharding" in type(device).__name__:
        raise MXNetError(f"a sharding was given: {_ONE_CARD}")
    raise MXNetError(
        f"cannot interpret {device!r} as a Context, a torch device or a "
        "one-element list of one")


def to_device(data, device):
    """Place a batch on a device: ``data`` is an ``NDArray``, a numpy
    array, a torch tensor, or a nested list/tuple/dict of them (what a
    batchify function gives); ``device`` is what :func:`_placement_target`
    reads.  Returns the same structure with every array leaf an
    ``NDArray`` on the device.  Each copy is issued ``non_blocking`` on
    the current stream, so a copy from page-locked memory is in flight
    when this returns (the loader's ring issues it on its copy stream and
    records an event after it); a leaf already on the device is kept."""
    target = _placement_target(device)
    if target is None:
        return data
    return _place_tree(data, target)


def _place_tree(x, target):
    if isinstance(x, NDArray):
        return _like(x, x._data.detach().to(target, non_blocking=True))
    if isinstance(x, torch.Tensor):
        return NDArray(x.detach().to(target, non_blocking=True))
    if isinstance(x, np.ndarray):
        return array(x, ctx=from_torch_device(target))
    if isinstance(x, tuple) and hasattr(x, "_fields"):   # namedtuple
        return type(x)(*(_place_tree(v, target) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_place_tree(v, target) for v in x)
    if isinstance(x, dict):
        return {k: _place_tree(v, target) for k, v in x.items()}
    return x
