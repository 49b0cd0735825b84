"""``mx.np`` — the NumPy-semantics array namespace.

Port of ``mxnet_tpu/numpy/multiarray.py``.  ``ndarray`` is the
``NDArray`` subclass with NumPy's comparisons (boolean results) and
methods; every function runs one ``invoke`` of an ``Op`` named
``_np_<name>`` (``_run``), so ``autograd`` records it, the profiler
names its kernels after it and ``MXNET_ENGINE_TYPE=NaiveEngine`` waits
for it, and its result takes the class of its first array argument.

Dtypes are the reference's: JAX with 64-bit types off.  Every result
that torch would give as ``float64``, ``int64`` or ``complex128`` is
``float32``, ``int32`` or ``complex64`` (``_canon``); a float64 or int64
source becomes 32-bit in ``array``; a Python number is a "weak" operand
that does not widen an array's dtype (a 0-d tensor, which torch's
promotion treats the same way); functions of real values (``sin``,
``mean``, ``median``, ...) give ``float32`` on integers and booleans;
``sum``/``prod`` of small integers give ``int32``, ``cumsum``/
``cumprod`` keep the integer type.

Arrays are made on ``ctx``, by default the current context (``gpu(0)``,
which raises ``MXNetError`` without CUDA; ``with mx.cpu():`` is the
host).  Functions whose result's shape depends on the data (``unique``,
``nonzero``, ``argwhere``, ``flatnonzero``, ``extract``, the set
operations) read the data on the host, as the reference does; they
cannot run inside a CUDA-graph capture and raise ``MXNetError`` there.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..base import WIDE_UNSIGNED as _WIDE_UNSIGNED
from ..base import MXNetError, numeric_types
from ..base import int_result_type as _int_result_type
from ..ndarray.ndarray import NDArray
from ..ops.registry import Op, invoke

newaxis = None
pi = onp.pi
e = onp.e
euler_gamma = onp.euler_gamma
inf = onp.inf
nan = onp.nan

# dtype aliases
float16 = onp.float16
float32 = onp.float32
float64 = onp.float64
bfloat16 = torch.bfloat16
int8 = onp.int8
int16 = onp.int16
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
bool_ = onp.bool_
dtype = onp.dtype

# JAX without 64-bit types: what each wide torch dtype becomes
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32,
          torch.uint64: torch.uint32, torch.complex128: torch.complex64}
_NP2T = {"float16": torch.float16, "float32": torch.float32,
         "float64": torch.float32, "int8": torch.int8,
         "int16": torch.int16, "int32": torch.int32, "int64": torch.int32,
         "uint8": torch.uint8, "uint16": torch.uint16,
         "uint32": torch.uint32, "uint64": torch.uint32,
         "bool": torch.bool, "complex64":
         torch.complex64, "complex128": torch.complex64}


class ndarray(NDArray):
    """NumPy-semantics array (reference ``mx.np.ndarray``): comparisons
    give boolean arrays, and ``std``/``var``/``reshape``/``T``/... follow
    NumPy; everything else is ``NDArray``'s."""

    __slots__ = ()

    def __repr__(self):
        t = self._data.detach()
        return repr(t.float().cpu().numpy() if t.dtype == torch.bfloat16
                    else t.cpu().numpy())

    def __eq__(self, o):
        return _run("equal", torch.eq, [self, o])

    def __ne__(self, o):
        return _run("not_equal", torch.ne, [self, o])

    def __lt__(self, o):
        return _run("less", torch.lt, [self, o])

    def __le__(self, o):
        return _run("less_equal", torch.le, [self, o])

    def __gt__(self, o):
        return _run("greater", torch.gt, [self, o])

    def __ge__(self, o):
        return _run("greater_equal", torch.ge, [self, o])

    def __hash__(self):
        return id(self)

    def std(self, axis=None, ddof=0, keepdims=False):
        return std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def cumsum(self, axis=None):
        return cumsum(self, axis=axis)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return reshape(self, shape)

    def flatten(self):
        return reshape(self, (-1,))

    def ravel(self):
        return reshape(self, (-1,))

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        from ..ops.defs import convert

        dt = _tdt(dtype)
        return _run1("astype", lambda x: convert(x, dt), self)

    def mean(self, axis=None, keepdims=False):
        return mean(self, axis=axis, keepdims=keepdims)

    def sum(self, axis=None, keepdims=False):
        return sum(self, axis=axis, keepdims=keepdims)  # noqa: A001

    def dot(self, b):
        return dot(self, b)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes if axes else None)

    def squeeze(self, axis=None):
        return squeeze(self, axis)

    @property
    def T(self):
        return transpose(self, None)


# --------------------------------------------------------------------------- #
# bridge machinery
# --------------------------------------------------------------------------- #

def _tdt(dt):
    """A torch dtype from a NumPy/torch dtype or name, 64-bit types as
    their 32-bit ones (``None`` stays ``None``)."""
    if dt is None or isinstance(dt, torch.dtype):
        return _CANON.get(dt, dt)
    name = onp.dtype(dt).name if not isinstance(dt, str) or \
        dt not in ("bfloat16",) else dt
    if name == "bfloat16":
        return torch.bfloat16
    if name not in _NP2T:
        raise MXNetError(f"mx.np: unsupported dtype {dt!r}")
    return _NP2T[name]


def _canon(r):
    """The reference's dtype of a result: 64-bit types as 32-bit."""
    if isinstance(r, torch.Tensor):
        dt = _CANON.get(r.dtype)
        return r if dt is None else r.to(dt)
    if isinstance(r, (tuple, list)):
        return type(r)(_canon(x) for x in r)
    return r


def _device_of(arrays):
    for a in arrays:
        if isinstance(a, NDArray):
            return a._data.device
    from ..context import current_context
    return current_context().torch_device()


def _host_tensor(x, device):
    """A NumPy array, list or NumPy scalar as a tensor on ``device``
    (``jnp.asarray``: 64-bit types become 32-bit)."""
    a = onp.asarray(x)
    if a.dtype == object:
        raise MXNetError(f"mx.np: cannot make an array of {type(x)}")
    t = torch.from_numpy(onp.array(a, order="C", copy=True))
    dt = _CANON.get(t.dtype)
    if dt is not None:
        t = t.to(dt)
    return t.to(device)


def _coerce_arr(x, device=None):
    """An operand as an array: an ``NDArray`` passes; a Python number is
    a 0-d host tensor (weak, as JAX's Python scalars: it does not widen an
    array's dtype, and torch takes it beside an array on any device);
    anything array-like is an ``ndarray`` on ``device`` (default: the
    current context)."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, (bool, int, float, complex)):
        return ndarray(torch.tensor(x))
    if isinstance(x, (onp.ndarray, list, tuple, onp.generic)):
        if device is None:
            device = _device_of(())
        return ndarray(_host_tensor(x, device))
    if isinstance(x, torch.Tensor):
        return ndarray(x)
    return x


def _run(name, fn, arrays, static=None):
    """One ``invoke`` of ``_np_<name>`` over ``arrays`` (coerced, legacy
    ``NDArray``s promoted to ``ndarray`` so the result is one); the
    result's dtypes are the reference's (``_canon``).  A 0-d host operand
    beside card arrays moves to the card where the op is not
    elementwise."""
    dev = None
    for a in arrays:
        if isinstance(a, NDArray):
            dev = a._data.device
            break
    coerced = []
    for a in arrays:
        a = _coerce_arr(a, dev)
        if isinstance(a, NDArray) and type(a) is not ndarray:
            a = a.as_np_ndarray()
        coerced.append(a)

    def run(*ts):
        if dev is not None and dev.type == "cuda":
            ts = [t.to(dev) if isinstance(t, torch.Tensor) and
                  t.device != dev else t for t in ts]
        if [t for t in ts if isinstance(t, torch.Tensor) and
                t.dtype in _WIDE_UNSIGNED]:
            return _unsigned_run(name, fn, ts)
        return _canon(fn(*ts))

    return invoke(Op(name=f"_np_{name}", fn=run), coerced, static or {})


# the functions whose integer result takes its operands' promoted type
_PROMOTING = frozenset((
    "add", "subtract", "multiply", "floor_divide", "mod", "remainder",
    "fmod", "power", "maximum", "minimum", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm"))
# the reductions that accumulate in the default integer (uint32 for an
# unsigned operand)
_ACCUMULATING = frozenset(("sum", "prod", "nansum", "nanprod", "cumsum",
                           "cumprod"))


def _unsigned_run(name, fn, ts):
    """``fn`` over operands with an unsigned type wider than 8 bits:
    they compute as int64, and an integer result takes the type JAX
    gives it (a Python number is weak: it does not take part)."""
    dts = [t.dtype for t in ts if isinstance(t, torch.Tensor) and not (
        t.dtype == torch.bool or t.is_floating_point() or t.is_complex()
        or t.dim() == 0 and t.dtype == torch.int64)]
    out = fn(*[t.to(torch.int64) if isinstance(t, torch.Tensor) and
               t.dtype in _WIDE_UNSIGNED else t for t in ts])
    back = None
    if name in _PROMOTING:
        back = _int_result_type(dts)
    elif name in _ACCUMULATING and _int_result_type(dts) in (
            torch.uint8, torch.uint16, torch.uint32):
        back = torch.uint32

    def cast(r):
        if back is not None and isinstance(r, torch.Tensor) and \
                r.dtype == torch.int64:
            return r.to(back)
        return _canon(r)
    return type(out)(cast(r) for r in out) \
        if isinstance(out, (tuple, list)) else cast(out)


def _run1(name, fn, a):
    return _run(name, fn, [a])


def _into(out, r):
    if out is not None:
        out._rebind(r._data)
        return out
    return r


def _make_unary(name, tfn):
    def wrapper(x, out=None, **kwargs):
        return _into(out, _run(name, tfn, [x]))
    wrapper.__name__ = name
    return wrapper


def _make_binary(name, tfn):
    def wrapper(x1, x2, out=None, **kwargs):
        return _into(out, _run(name, tfn, [x1, x2]))
    wrapper.__name__ = name
    return wrapper


def _host(x):
    """An operand's values on the host (NumPy), for the functions whose
    result's shape depends on the data; refused inside a capture."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "mx.np: this function's result shape depends on the data, "
            "which it reads on the host: it cannot run inside a CUDA-graph "
            "capture")
    if isinstance(x, NDArray):
        return x.asnumpy() if x._data.dtype != torch.bfloat16 else \
            x._data.float().cpu().numpy()
    return onp.asarray(x)


def _dev_array(a, device):
    """A host NumPy result as an ``ndarray`` on ``device``."""
    return ndarray(_host_tensor(a, device))


def _shp(shape):
    return (shape,) if isinstance(shape, (int, onp.integer)) else \
        tuple(int(s) for s in shape)


def _ax(axis):
    if isinstance(axis, list):
        return tuple(axis)
    return axis


def _dims(x, axis):
    """``axis`` as a tuple of non-negative dims (``None``: all)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(a % _imax(x.dim(), 1) for a in axis)
    return (axis % _imax(x.dim(), 1),)


def _real(x):
    """``x`` as a real floating tensor (integers and booleans as f32)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _inexact(*ts):
    """Operands promoted together, integers to f32 (JAX's rule for the
    functions of real values)."""
    dt = ts[0].dtype if len(ts) == 1 else _result(*ts)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    return [t.to(dt) for t in ts]


def _result(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.result_type(torch.empty((1,) * _imax(ts[0].dim(), 1),
                                           dtype=dt), t)
    return dt


def _matmul_dtype(a, b):
    """Integer products on the card run in float64 (cuBLAS has no
    integer GEMM); exact below 2**53."""
    dt = _result(a, b)
    if a.is_cuda and not (dt.is_floating_point or dt.is_complex):
        return a.to(torch.float64), b.to(torch.float64), dt
    return a.to(dt), b.to(dt), None


def _mm(fn):
    def run(a, b):
        a, b, back = _matmul_dtype(a, b)
        r = fn(a, b)
        return r if back is None else r.to(back)
    return run


# --------------------------------------------------------------------------- #
# creation
# --------------------------------------------------------------------------- #

def _ctx_device(ctx):
    if ctx is None:
        from ..context import current_context
        return current_context().torch_device()
    return ctx.torch_device()


def array(object, dtype=None, ctx=None):  # noqa: A002
    """An ``ndarray`` from an array, a list or a number, on ``ctx``
    (default: the array's device, else the current context); float64 and
    int64 sources become 32-bit unless ``dtype`` says otherwise (and a
    64-bit ``dtype`` is 32-bit too, as in the reference)."""
    dt = _tdt(dtype)
    if isinstance(object, NDArray):
        t = object._data.detach()
        dev = t.device if ctx is None else ctx.torch_device()
        return ndarray(t.to(device=dev, dtype=dt or t.dtype, copy=True))
    if isinstance(object, torch.Tensor):
        dev = object.device if ctx is None else ctx.torch_device()
        return ndarray(object.detach().to(device=dev,
                                          dtype=dt or _CANON.get(
                                              object.dtype, object.dtype),
                                          copy=True))
    t = _host_tensor(object, _ctx_device(ctx))
    return ndarray(t if dt is None else t.to(dt))


def asarray(a, dtype=None):
    return a if isinstance(a, ndarray) and dtype is None else array(a, dtype)


def zeros(shape, dtype=float32, order="C", ctx=None):
    return ndarray(torch.zeros(_shp(shape), dtype=_tdt(dtype or "float32"),
                               device=_ctx_device(ctx)))


def ones(shape, dtype=float32, order="C", ctx=None):
    return ndarray(torch.ones(_shp(shape), dtype=_tdt(dtype or "float32"),
                              device=_ctx_device(ctx)))


def full(shape, fill_value, dtype=None, order="C", ctx=None):
    dev = _ctx_device(ctx)
    if isinstance(fill_value, NDArray):
        fill = fill_value._data.to(dev)
        return ndarray(_canon(torch.broadcast_to(
            fill, _shp(shape)).to(_tdt(dtype) or fill.dtype).clone()))
    return ndarray(_canon(torch.full(_shp(shape), fill_value,
                                     dtype=_tdt(dtype), device=dev)))


def empty(shape, dtype=float32, order="C", ctx=None):
    return zeros(shape, dtype, order, ctx)


def zeros_like(a, dtype=None):
    dt = _tdt(dtype)
    return _run1("zeros_like", lambda x: torch.zeros_like(x, dtype=dt), a)


def ones_like(a, dtype=None):
    dt = _tdt(dtype)
    return _run1("ones_like", lambda x: torch.ones_like(x, dtype=dt), a)


def full_like(a, fill_value, dtype=None):
    dt = _tdt(dtype)
    if isinstance(fill_value, (NDArray, onp.ndarray, list, tuple)):
        # an array fill value broadcasts to a's shape (jnp.full_like)
        return _run("full_like", lambda x, v: torch.broadcast_to(
            v.to(x.device), x.shape).to(dt or x.dtype).clone(),
            [a, fill_value])
    return _run1("full_like",
                 lambda x: torch.full_like(x, fill_value, dtype=dt), a)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    if stop is None:
        start, stop = 0, start
    return ndarray(_canon(torch.arange(start, stop, step, dtype=_tdt(dtype),
                                       device=_ctx_device(ctx))))


def _lin(start, stop, num, endpoint):
    """NumPy's linspace in float64: ``start + i * step``, the last value
    ``stop`` exactly when ``endpoint``."""
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else float("nan")
    i = torch.arange(num, dtype=torch.float64)
    out = start + i * step if div > 0 else start + i * (stop - start)
    if endpoint and num > 1:
        out[-1] = stop
    return out, step


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    out, step = _lin(float(start), float(stop), int(num), endpoint)
    dt = _tdt(dtype) or torch.float32
    t = out.to(dt) if dt.is_floating_point else torch.floor(out).to(dt)
    r = ndarray(t.to(_ctx_device(ctx)))
    return (r, float(step)) if retstep else r


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    out, _ = _lin(float(start), float(stop), int(num), endpoint)
    dt = _tdt(dtype) or torch.float32
    return ndarray((float(base) ** out).to(dt).to(_ctx_device(ctx)))


def _eye(n, m, k, dt, dev):
    m = n if m is None else m
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i == k).to(dt)


def eye(N, M=None, k=0, dtype=float32, ctx=None):
    return ndarray(_eye(N, M, k, _tdt(dtype or "float32"),
                        _ctx_device(ctx)))


def identity(n, dtype=float32, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def meshgrid(*xi, indexing="xy"):
    dev = _device_of(xi)
    ts = [_coerce_arr(x, dev)._data for x in xi]
    # each grid keeps its own input's dtype (torch's meshgrid wants one)
    axes = list(range(len(ts)))
    if indexing == "xy" and len(ts) > 1:
        axes[0], axes[1] = 1, 0
    shape = [0] * len(ts)
    for t, ax in zip(ts, axes):
        shape[ax] = t.numel()
    grids = []
    for t, ax in zip(ts, axes):
        view = [1] * len(ts)
        view[ax] = t.numel()
        grids.append(ndarray(_canon(t.reshape(view).expand(shape).clone())))
    return grids


def tril(m, k=0):
    return _run1("tril", lambda x: torch.tril(x, k), m)


def triu(m, k=0):
    return _run1("triu", lambda x: torch.triu(x, k), m)


# --------------------------------------------------------------------------- #
# unary ufuncs
# --------------------------------------------------------------------------- #

def _f(tfn):
    """A function of real values: integers and booleans in f32."""
    return lambda x: tfn(_real(x))


def _keep_int(tfn):
    """A rounding: integers and booleans pass unchanged."""
    return lambda x: x.clone() if not (x.is_floating_point() or
                                       x.is_complex()) else tfn(x)


def _keep_bool(tfn):
    """``abs``: booleans pass unchanged."""
    return lambda x: x.clone() if x.dtype == torch.bool else tfn(x)


def _cbrt(x):
    x = _real(x)
    return torch.sign(x) * torch.abs(x).to(torch.float64).pow(
        1.0 / 3.0).to(x.dtype)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real_part(x):
    return torch.real(x) if x.is_complex() else x.clone()


def _angle(x):
    return torch.angle(x) if x.is_complex() else torch.angle(_real(x))


def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    if not x.is_floating_point():
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


_UNARY = {
    "negative": torch.negative, "positive": lambda x: x.clone(),
    "abs": _keep_bool(torch.abs), "absolute": _keep_bool(torch.abs),
    "fabs": _keep_bool(torch.abs), "sign": torch.sign,
    "exp": _f(torch.exp), "expm1": _f(torch.expm1), "exp2": _f(torch.exp2),
    "log": _f(torch.log), "log2": _f(torch.log2), "log10": _f(torch.log10),
    "log1p": _f(torch.log1p),
    "sqrt": _f(torch.sqrt), "cbrt": _cbrt, "square": torch.square,
    "reciprocal": _f(torch.reciprocal),
    "sin": _f(torch.sin), "cos": _f(torch.cos), "tan": _f(torch.tan),
    "arcsin": _f(torch.asin), "arccos": _f(torch.acos),
    "arctan": _f(torch.atan), "sinh": _f(torch.sinh),
    "cosh": _f(torch.cosh), "tanh": _f(torch.tanh),
    "arcsinh": _f(torch.asinh), "arccosh": _f(torch.acosh),
    "arctanh": _f(torch.atanh),
    "degrees": _f(torch.rad2deg), "radians": _f(torch.deg2rad),
    "rint": _f(torch.round), "fix": _keep_int(torch.trunc),
    "floor": _keep_int(torch.floor), "ceil": _keep_int(torch.ceil),
    "trunc": _keep_int(torch.trunc), "round": _keep_int(torch.round),
    "around": _keep_int(torch.round),
    "logical_not": torch.logical_not, "invert": torch.bitwise_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "isposinf": torch.isposinf, "isneginf": torch.isneginf,
    "conj": lambda x: torch.conj_physical(x) if x.is_complex()
    else x.clone(),
    "real": _real_part, "imag": _imag, "angle": _angle,
    "sinc": _f(torch.sinc), "i0": _f(torch.special.i0),
    "nan_to_num": _nan_to_num,
}


def _fbin(tfn):
    """A binary function of real values (integers in f32)."""
    def run(a, b):
        a, b = _inexact(a, b)
        return tfn(a, b)
    return run


def _same(tfn):
    """A binary op whose torch function needs one dtype."""
    def run(a, b):
        dt = _result(a, b)
        return tfn(a.to(dt), b.to(dt))
    return run


def _add(a, b):
    return torch.logical_or(a, b) if a.dtype == b.dtype == torch.bool \
        else torch.add(a, b)


def _multiply(a, b):
    return torch.logical_and(a, b) if a.dtype == b.dtype == torch.bool \
        else torch.mul(a, b)


def _int_pair(a, b):
    """Integer operands promoted together and the divisor with 1 where it
    is 0 (``None`` for floating operands): XLA's integer division by zero
    gives values where torch's raises, and the functions below reproduce
    them."""
    dt = _result(a, b)
    if dt.is_floating_point or dt.is_complex:
        return None
    a, b = a.to(dt), b.to(dt)
    return a, b, torch.where(b == 0, torch.ones_like(b), b)


def _floor_divide(a, b):
    """``jnp.floor_divide``: on integers, ``x // 0`` is -1 for ``x == 0``
    and -2 otherwise (XLA's quotient -1, less one where the signs differ
    and the remainder ``x`` is not 0); unsigned, the type's largest
    value."""
    ints = _int_pair(a, b)
    if ints is None:
        return torch.floor_divide(a, b)
    a, b, safe = ints
    q = torch.floor_divide(a, safe)
    if a.dtype == torch.uint8:
        by_zero = torch.full_like(q, 255)
    else:
        by_zero = torch.where(a == 0, torch.full_like(q, -1),
                              torch.full_like(q, -2))
    return torch.where(b == 0, by_zero, q)


def _remainder(a, b):
    """``jnp.remainder``: an integer remainder by 0 is 0."""
    ints = _int_pair(a, b)
    return torch.remainder(a, b) if ints is None else \
        torch.remainder(ints[0], ints[2])


def _fmod(a, b):
    """``jnp.fmod``: an integer remainder by 0 is 0."""
    ints = _int_pair(a, b)
    return torch.fmod(a, b) if ints is None else torch.fmod(ints[0], ints[2])


def _float_power(a, b):
    a, b = _inexact(a, b)
    return torch.pow(a.to(torch.float64), b.to(torch.float64)).to(a.dtype)


_BINARY = {
    "add": _add, "subtract": torch.subtract, "multiply": _multiply,
    "divide": _fbin(torch.true_divide),
    "true_divide": _fbin(torch.true_divide),
    "floor_divide": _floor_divide, "mod": _remainder,
    "remainder": _remainder, "fmod": _fmod,
    "power": torch.pow, "float_power": _float_power,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "fmax": torch.fmax, "fmin": torch.fmin,
    "hypot": _fbin(torch.hypot), "arctan2": _fbin(torch.atan2),
    "logaddexp": _fbin(torch.logaddexp),
    "logaddexp2": _fbin(torch.logaddexp2),
    "copysign": _fbin(torch.copysign), "nextafter": _fbin(torch.nextafter),
    "equal": torch.eq, "not_equal": torch.ne,
    "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": _same(torch.bitwise_left_shift),
    "right_shift": _same(torch.bitwise_right_shift),
    "gcd": torch.gcd, "lcm": torch.lcm,
    "ldexp": lambda a, b: torch.ldexp(_real(a), b),
}

for _n, _f_ in _UNARY.items():
    globals()[_n] = _make_unary(_n, _f_)
for _n, _f_ in _BINARY.items():
    globals()[_n] = _make_binary(_n, _f_)


# --------------------------------------------------------------------------- #
# reductions
# --------------------------------------------------------------------------- #

def _int_acc(x):
    """``sum``/``prod``'s accumulator: small integers and booleans in
    int32 (unsigned ones in int32 too), others as they are."""
    if x.dtype == torch.bool or (not x.is_floating_point() and
                                 not x.is_complex()):
        return torch.int32 if x.dtype != torch.int64 else torch.int64
    return None


def _sum(x, axis, keepdims, dtype):
    dims = _dims(x, axis)
    acc = _tdt(dtype) or _int_acc(x)
    if not dims:
        return x.to(acc) if acc is not None else x.clone()
    return torch.sum(x, dim=dims, keepdim=keepdims, dtype=acc)


def _prod(x, axis, keepdims, dtype):
    acc = _tdt(dtype) or _int_acc(x)
    r = x.to(acc) if acc is not None else x
    for d in sorted(_dims(x, axis), reverse=True):
        r = torch.prod(r, dim=d, keepdim=keepdims)
    return r


def _mean(x, axis, keepdims, dtype):
    dims = _dims(x, axis)
    r = _real(x)
    out = torch.mean(r, dim=dims, keepdim=keepdims) if dims else r.clone()
    return out.to(_tdt(dtype)) if dtype else out


def _nanprod(x, axis, keepdims, dtype):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axis, keepdims, dtype)


def _nansum(x, axis, keepdims, dtype):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _sum(x, axis, keepdims, dtype)


def _nanmean(x, axis, keepdims, dtype):
    r = _real(x)
    out = torch.nanmean(r, dim=_dims(r, axis), keepdim=keepdims)
    return out.to(_tdt(dtype)) if dtype else out


def _axis_reduce(name, impl):
    def wrapper(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
        return _into(out, _run(name, lambda x: impl(
            x, _ax(axis), keepdims, dtype), [a]))
    wrapper.__name__ = name
    return wrapper


sum = _axis_reduce("sum", _sum)  # noqa: A001
prod = _axis_reduce("prod", _prod)
mean = _axis_reduce("mean", _mean)
nansum = _axis_reduce("nansum", _nansum)
nanprod = _axis_reduce("nanprod", _nanprod)
nanmean = _axis_reduce("nanmean", _nanmean)


def _amax(x, axis, keepdims):
    dims = _dims(x, axis)
    return torch.amax(x, dim=dims, keepdim=keepdims) if dims else x.clone()


def _amin(x, axis, keepdims):
    dims = _dims(x, axis)
    return torch.amin(x, dim=dims, keepdim=keepdims) if dims else x.clone()


def _nanmax(x, axis, keepdims):
    if not x.is_floating_point():
        return _amax(x, axis, keepdims)
    nan_ = torch.isnan(x)
    r = _amax(torch.where(nan_, torch.full_like(x, -math.inf), x), axis,
              keepdims)
    allnan = _amin(nan_, axis, keepdims) if nan_.dim() else nan_
    return torch.where(allnan, torch.full_like(r, math.nan), r)


def _nanmin(x, axis, keepdims):
    if not x.is_floating_point():
        return _amin(x, axis, keepdims)
    return -_nanmax(-x, axis, keepdims)


def _minmax(name, impl):
    def wrapper(a, axis=None, out=None, keepdims=False):
        return _into(out, _run(name, lambda x: impl(x, _ax(axis),
                                                    keepdims), [a]))
    wrapper.__name__ = name
    return wrapper


max = _minmax("max", _amax)  # noqa: A001
min = _minmax("min", _amin)  # noqa: A001
amax = max
amin = min
nanmax = _minmax("nanmax", _nanmax)
nanmin = _minmax("nanmin", _nanmin)
ptp = _minmax("ptp", lambda x, a, k: _amax(x, a, k) - _amin(x, a, k))


def _var(x, axis, ddof, keepdims):
    r = _real(x)
    return torch.var(r, dim=_dims(r, axis), correction=ddof,
                     keepdim=keepdims)


def std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _into(out, _run("std", lambda x: torch.sqrt(
        _var(x, _ax(axis), ddof, keepdims)), [a]))


def var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _into(out, _run("var", lambda x: _var(x, _ax(axis), ddof,
                                                  keepdims), [a]))


def _argext(tfn):
    def run(x, axis):
        if axis is None:
            return tfn(x.reshape(-1), 0)
        return tfn(x, axis)
    return run


def argmax(a, axis=None, out=None):
    return _into(out, _run("argmax", lambda x: _argext(torch.argmax)(
        x, axis), [a]))


def argmin(a, axis=None, out=None):
    return _into(out, _run("argmin", lambda x: _argext(torch.argmin)(
        x, axis), [a]))


def _cum(tfn, x, axis, dtype):
    if axis is None:
        x, axis = x.reshape(-1), 0
    dt = _tdt(dtype)
    if dt is None:
        dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return tfn(x, dim=axis, dtype=dt)


def cumsum(a, axis=None, dtype=None, out=None):
    return _into(out, _run("cumsum", lambda x: _cum(torch.cumsum, x, axis,
                                                    dtype), [a]))


def cumprod(a, axis=None, dtype=None):
    return _run("cumprod", lambda x: _cum(torch.cumprod, x, axis, dtype),
                [a])


def _quantile(x, q, axis, keepdims, nan=False):
    r = _real(x)
    qq = q.to(r.dtype) if isinstance(q, torch.Tensor) else q
    fn = torch.nanquantile if nan else torch.quantile
    dims = _dims(r, axis)
    if len(dims) > 1 or axis is None:
        keep = [d for d in range(r.dim()) if d not in dims]
        moved = r.permute(keep + list(dims)).reshape(
            [r.shape[d] for d in keep] + [-1])
        out = fn(moved, qq, dim=-1)
        if keepdims:
            shape = [1 if d in dims else r.shape[d] for d in range(r.dim())]
            out = out.reshape(out.shape[:out.dim() - len(keep)] +
                              tuple(shape))
        return out
    return fn(r, qq, dim=dims[0], keepdim=keepdims)


def median(a, axis=None, out=None, keepdims=False):
    return _into(out, _run("median", lambda x: _quantile(
        x, 0.5, _ax(axis), keepdims), [a]))


def quantile(a, q, axis=None, keepdims=False):
    return _run("quantile", lambda x, qq: _quantile(
        x, qq, _ax(axis), keepdims), [a, q])


def percentile(a, q, axis=None, keepdims=False):
    return _run("percentile", lambda x, qq: _quantile(
        x, _real(qq) / 100.0, _ax(axis), keepdims), [a, q])


def _average(x, w, axis):
    x, w = _inexact(x, w)
    if axis is not None and w.dim() == 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[axis] = -1
        w = w.reshape(shape)
    w = torch.broadcast_to(w, x.shape)
    dims = _dims(x, axis)
    return torch.sum(x * w, dim=dims) / torch.sum(w, dim=dims)


def average(a, axis=None, weights=None, returned=False):
    if weights is None:
        return mean(a, axis=axis)
    r = _run("average", lambda x, w: _average(x, w, _ax(axis)),
             [a, weights])
    if returned:
        sw = sum(asarray(weights), axis=axis)
        return r, sw
    return r


def _all(x, axis, keepdims):
    r = x.to(torch.bool)
    for d in sorted(_dims(x, axis), reverse=True):
        r = torch.all(r, dim=d, keepdim=keepdims)
    return r


def _any(x, axis, keepdims):
    r = x.to(torch.bool)
    for d in sorted(_dims(x, axis), reverse=True):
        r = torch.any(r, dim=d, keepdim=keepdims)
    return r


def all(a, axis=None, out=None, keepdims=False):  # noqa: A001
    return _into(out, _run("all", lambda x: _all(x, _ax(axis), keepdims),
                           [a]))


def any(a, axis=None, out=None, keepdims=False):  # noqa: A001
    return _into(out, _run("any", lambda x: _any(x, _ax(axis), keepdims),
                           [a]))


def count_nonzero(a, axis=None):
    return _run("count_nonzero", lambda x: torch.count_nonzero(
        x, dim=_dims(x, _ax(axis))), [a])


# --------------------------------------------------------------------------- #
# manipulation
# --------------------------------------------------------------------------- #

def reshape(a, newshape, order="C"):
    return _run("reshape", lambda x: torch.reshape(x, _shp(newshape)), [a])


def transpose(a, axes=None):
    def run(x):
        ax = tuple(axes) if axes is not None else \
            tuple(reversed(range(x.dim())))
        return x.permute(ax)
    return _run("transpose", run, [a])


def swapaxes(a, axis1, axis2):
    return _run("swapaxes", lambda x: torch.swapaxes(x, axis1, axis2), [a])


def moveaxis(a, source, destination):
    return _run("moveaxis", lambda x: torch.movedim(x, source, destination),
                [a])


def _rollaxis(x, axis, start):
    n = x.dim()
    axis %= n
    if start < 0:
        start += n
    if start > axis:
        start -= 1
    return torch.movedim(x, axis, start)


def rollaxis(a, axis, start=0):
    return _run("rollaxis", lambda x: _rollaxis(x, axis, start), [a])


def _expand(x, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = x.dim() + len(axes)
    axes = sorted(a % n for a in axes)
    for a in axes:
        x = x.unsqueeze(a)
    return x


def expand_dims(a, axis):
    return _run("expand_dims", lambda x: _expand(x, axis), [a])


def _squeeze(x, axis):
    if axis is None:
        return x.squeeze()
    return x.squeeze(_dims(x, axis))


def squeeze(a, axis=None):
    return _run("squeeze", lambda x: _squeeze(x, _ax(axis)), [a])


def ravel(a, order="C"):
    return reshape(a, (-1,))


def _atleast(x, n):
    if x.dim() >= n:
        return x
    if n == 1:
        return x.reshape(1)
    if n == 2:
        return x.reshape(1, -1) if x.dim() == 1 else x.reshape(1, 1)
    if x.dim() == 0:
        return x.reshape(1, 1, 1)
    if x.dim() == 1:
        return x.reshape(1, -1, 1)
    return x.unsqueeze(-1)


def atleast_1d(*arys):
    rs = [_run("atleast_1d", lambda x: _atleast(x, 1), [a]) for a in arys]
    return rs[0] if len(rs) == 1 else rs


def atleast_2d(*arys):
    rs = [_run("atleast_2d", lambda x: _atleast(x, 2), [a]) for a in arys]
    return rs[0] if len(rs) == 1 else rs


def atleast_3d(*arys):
    rs = [_run("atleast_3d", lambda x: _atleast(x, 3), [a]) for a in arys]
    return rs[0] if len(rs) == 1 else rs


def broadcast_to(a, shape):
    return _run("broadcast_to", lambda x: torch.broadcast_to(
        x, _shp(shape)).clone(), [a])


def broadcast_arrays(*args):
    dev = _device_of(args)
    ts = [_coerce_arr(a, dev)._data.to(dev) for a in args]
    return [ndarray(_canon(r.clone())) for r in torch.broadcast_tensors(*ts)]


def _promote_all(xs):
    dt = _result(*xs) if len(xs) > 1 else xs[0].dtype
    return [x.to(dt) for x in xs]


def _cat(xs, axis):
    xs = _promote_all(list(xs))
    if axis is None:
        return torch.cat([x.reshape(-1) for x in xs])
    return torch.cat(xs, dim=axis)


def concatenate(seq, axis=0, out=None):
    return _into(out, _run("concatenate", lambda *xs: _cat(xs, axis),
                           list(seq)))


def stack(arrays, axis=0, out=None):
    return _into(out, _run("stack", lambda *xs: torch.stack(
        _promote_all(list(xs)), dim=axis), list(arrays)))


def vstack(tup):
    return _run("vstack", lambda *xs: torch.vstack(_promote_all(list(xs))),
                list(tup))


def hstack(tup):
    return _run("hstack", lambda *xs: torch.hstack(_promote_all(list(xs))),
                list(tup))


def dstack(tup):
    return _run("dstack", lambda *xs: torch.dstack(_promote_all(list(xs))),
                list(tup))


def column_stack(tup):
    return _run("column_stack", lambda *xs: torch.column_stack(
        _promote_all(list(xs))), list(tup))


def _split(x, sec, axis, equal):
    if isinstance(sec, (int, onp.integer)):
        if equal and x.shape[axis] % int(sec):
            raise MXNetError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(x, int(sec), dim=axis))
    return tuple(torch.tensor_split(x, list(sec), dim=axis))


def split(ary, indices_or_sections, axis=0):
    sec = indices_or_sections
    if isinstance(sec, NDArray):
        sec = tuple(int(v) for v in sec.asnumpy())
    elif isinstance(sec, (list, tuple)):
        sec = tuple(int(v) for v in sec)
    r = _run("split", lambda x: _split(x, sec, axis, True), [ary])
    return r if isinstance(r, list) else [r]


def array_split(ary, indices_or_sections, axis=0):
    sec = indices_or_sections
    r = _run("array_split", lambda x: _split(x, sec, axis, False), [ary])
    return r if isinstance(r, list) else [r]


def hsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=1)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def tile(a, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return _run("tile", lambda x: torch.tile(x, reps), [a])


def _repeat(x, repeats, axis):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if not isinstance(repeats, int):
        repeats = torch.as_tensor(onp.asarray(repeats), device=x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat(a, repeats, axis=None):
    return _run("repeat", lambda x: _repeat(x, repeats, axis), [a])


def roll(a, shift, axis=None):
    return _run("roll", lambda x: torch.roll(x, shift, dims=axis), [a])


def flip(m, axis=None):
    return _run("flip", lambda x: torch.flip(x, _dims(x, axis)), [m])


def fliplr(m):
    return flip(m, 1)


def flipud(m):
    return flip(m, 0)


def rot90(m, k=1, axes=(0, 1)):
    return _run("rot90", lambda x: torch.rot90(x, k, list(axes)), [m])


def _pad_index(n, before, after, mode):
    """Source index of each padded position along one axis."""
    i = torch.arange(-before, n + after)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        period = 2 * (n - 1) if n > 1 else 1
        j = i % period
        return torch.where(j >= n, period - j, j)
    if mode == "symmetric":
        period = 2 * n
        j = i % period
        return torch.where(j >= n, period - 1 - j, j)
    raise MXNetError(f"mx.np.pad: mode {mode!r} is not supported")


def _pad(x, pad_width, mode, constant_values=0, **kw):
    pw = onp.broadcast_to(onp.asarray(pad_width, dtype=onp.int64),
                          (x.dim(), 2))
    if mode == "constant":
        cv = onp.broadcast_to(onp.asarray(constant_values, dtype=onp.float64),
                              (x.dim(), 2))
        out = x
        for d in range(x.dim()):
            b, a = int(pw[d, 0]), int(pw[d, 1])
            if b == 0 and a == 0:
                continue
            shape = list(out.shape)
            shape[d] = b
            lo = torch.full(shape, float(cv[d, 0]), dtype=x.dtype,
                            device=x.device)
            shape[d] = a
            hi = torch.full(shape, float(cv[d, 1]), dtype=x.dtype,
                            device=x.device)
            out = torch.cat([lo, out, hi], dim=d)
        return out
    out = x
    for d in range(x.dim()):
        idx = _pad_index(x.shape[d], int(pw[d, 0]), int(pw[d, 1]), mode)
        out = torch.index_select(out, d, idx.to(x.device))
    return out


def pad(array, pad_width, mode="constant", **kwargs):  # noqa: A002
    return _run("pad", lambda x: _pad(x, pad_width, mode, **kwargs),
                [array])


def _index_keep(n, obj):
    keep = onp.ones(n, dtype=bool)
    keep[obj] = False
    return onp.nonzero(keep)[0]


def delete(arr, obj, axis=None):
    if isinstance(obj, NDArray):
        obj = onp.asarray(obj.asnumpy()).astype(onp.int64)
    elif isinstance(obj, (list, tuple)):
        obj = onp.asarray(obj)

    def run(x):
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        keep = torch.as_tensor(_index_keep(x.shape[ax], obj),
                               device=x.device)
        return torch.index_select(x, ax, keep)
    return _run("delete", run, [arr])


def _insert(x, obj, v, axis):
    """NumPy's ``insert``: a scalar ``obj`` inserts ``v`` as one slice
    (every value of a 1-D ``v`` into a 1-D array), a sequence one slice
    at each index (indices of the original array)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    n = x.shape[axis]
    xm = torch.movedim(x, axis, 0)
    rest = tuple(xm.shape[1:])
    vals = v.to(x.dtype)
    if isinstance(obj, (int, onp.integer)):
        vals = vals.reshape(-1) if xm.dim() == 1 else \
            torch.broadcast_to(vals, rest).unsqueeze(0)
        pos = int(obj) + n if obj < 0 else int(obj)
        out = torch.cat([xm[:pos], vals, xm[pos:]], dim=0)
        return torch.movedim(out, 0, axis)
    idx = onp.asarray(obj).reshape(-1)
    k = idx.size
    src = onp.insert(onp.arange(n), idx, n + onp.arange(k))
    vals = torch.broadcast_to(vals.reshape((-1,) + (1,) * len(rest))
                              if vals.dim() <= 1 else vals, (k,) + rest)
    out = torch.cat([xm, vals], dim=0)[torch.as_tensor(src,
                                                       device=x.device)]
    return torch.movedim(out, 0, axis)


def insert(arr, obj, values, axis=None):
    return _run("insert", lambda x, v: _insert(x, obj, v, axis),
                [arr, values])


def append(arr, values, axis=None):
    return _run("append", lambda x, v: _cat([x, v], axis), [arr, values])


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    return _run("where", lambda c, a, b: torch.where(
        c.to(torch.bool), *_promote_all([a, b])), [condition, x, y])


def clip(a, a_min, a_max, out=None):
    return _into(out, _run("clip", lambda x: torch.clamp(x, a_min, a_max),
                           [a]))


def diag(v, k=0):
    return _run("diag", lambda x: torch.diag(x, k), [v])


def diagonal(a, offset=0, axis1=0, axis2=1):
    return _run("diagonal", lambda x: torch.diagonal(
        x, offset, axis1, axis2).clone(), [a])


def _trace(x, offset, axis1, axis2):
    d = torch.diagonal(x, offset, axis1, axis2)
    return torch.sum(d, dim=-1, dtype=_int_acc(x))


def trace(a, offset=0, axis1=0, axis2=1):
    return _run("trace", lambda x: _trace(x, offset, axis1, axis2), [a])


def _default_device():
    return _device_of(())


def _pair(t):
    return ndarray(t[0].to(torch.int32)), ndarray(t[1].to(torch.int32))


def tril_indices(n, k=0, m=None):
    return _pair(torch.tril_indices(n, n if m is None else m, k,
                                    device=_default_device()))


def indices(dimensions, dtype=int32):
    dev = _default_device()
    grids = torch.meshgrid(*[torch.arange(d, device=dev)
                             for d in dimensions], indexing="ij")
    return ndarray(torch.stack(grids).to(_tdt(dtype)))


def unravel_index(indices, shape):  # noqa: A002
    arr = _coerce_arr(indices)
    rs = torch.unravel_index(arr._data.to(torch.int64), _shp(shape))
    return tuple(ndarray(r.to(torch.int32)) for r in rs)


def ravel_multi_index(multi_index, dims, mode="raise"):
    dev = _device_of(multi_index)
    ts = [_coerce_arr(a, dev)._data.to(torch.int64) for a in multi_index]
    dims = _shp(dims)
    out = torch.zeros_like(ts[0])
    for t, d in zip(ts, dims):
        if mode == "clip":
            t = t.clamp(0, d - 1)
        elif mode == "wrap":
            t = t % d
        out = out * d + t
    return ndarray(out.to(torch.int32))


def _take(x, i, axis, mode):
    if i.is_floating_point():
        i = i.to(torch.int64)
    i = i.to(torch.int64)
    if axis is None:
        x, axis = x.reshape(-1), 0
    n = x.shape[axis]
    i = i % n if mode == "wrap" else i.clamp(0, n - 1)
    out = torch.index_select(x, axis, i.reshape(-1))
    return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])


def take(a, indices, axis=None, mode="clip"):  # noqa: A002
    return _run("take", lambda x, i: _take(x, i, axis, mode), [a, indices])


def take_along_axis(arr, indices, axis):  # noqa: A002
    return _run("take_along_axis", lambda x, i: torch.take_along_dim(
        x, i.to(torch.int64), dim=axis), [arr, indices])


def searchsorted(a, v, side="left"):
    return _run("searchsorted", lambda x, y: torch.searchsorted(
        *_promote_all([x, y]), right=side == "right"), [a, v])


def sort(a, axis=-1, kind=None, order=None):
    def run(x):
        if axis is None:
            return torch.sort(x.reshape(-1)).values
        return torch.sort(x, dim=axis, stable=True).values
    return _run("sort", run, [a])


def argsort(a, axis=-1, kind=None, order=None):
    def run(x):
        if axis is None:
            return torch.argsort(x.reshape(-1), stable=True)
        return torch.argsort(x, dim=axis, stable=True)
    return _run("argsort", run, [a])


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """Unique values (and index, inverse, counts), read on the host: the
    result's length depends on the data."""
    arr = _coerce_arr(ar)
    dev = arr._data.device
    rs = onp.unique(_host(arr), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(rs, tuple):
        return tuple(_dev_array(r, dev) for r in rs)
    return _dev_array(rs, dev)


def nonzero(a):
    """Indices of the non-zero elements, one array an axis (read on the
    host: their count depends on the data)."""
    arr = _coerce_arr(a)
    dev = arr._data.device
    return tuple(_dev_array(r, dev) for r in onp.nonzero(_host(arr)))


def flatnonzero(a):
    """Flat indices of the non-zero elements (read on the host)."""
    arr = _coerce_arr(a)
    return _dev_array(onp.flatnonzero(_host(arr)), arr._data.device)


def argwhere(a):
    """``(count, ndim)`` indices of the non-zero elements (read on the
    host)."""
    arr = _coerce_arr(a)
    return _dev_array(onp.argwhere(_host(arr)), arr._data.device)


def extract(condition, arr):
    """The elements where ``condition`` holds (read on the host)."""
    c = _coerce_arr(condition)
    a = _coerce_arr(arr)
    r = onp.extract(_host(c), _host(a))
    out = _dev_array(r, a._data.device)
    return out if a._data.dtype != torch.bfloat16 else \
        ndarray(out._data.to(torch.bfloat16))


def copy(a):
    return _run("copy", torch.clone, [a])


# --------------------------------------------------------------------------- #
# linear algebra (top-level)
# --------------------------------------------------------------------------- #

def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or (a.dim() <= 2 and b.dim() <= 2):
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([-1], [-2]))


def dot(a, b, out=None):
    return _into(out, _run("dot", _mm(_dot), [a, b]))


def matmul(a, b, out=None):
    return _into(out, _run("matmul", _mm(torch.matmul), [a, b]))


def inner(a, b):
    return _run("inner", _mm(lambda x, y: x * y if x.dim() == 0 or
                             y.dim() == 0 else torch.inner(x, y)), [a, b])


def outer(a, b):
    return _run("outer", _mm(lambda x, y: torch.outer(
        x.reshape(-1), y.reshape(-1))), [a, b])


def tensordot(a, b, axes=2):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [list(x) if isinstance(x, (list, tuple)) else [x] for x in ax]
    return _run("tensordot", _mm(lambda x, y: torch.tensordot(
        x, y, dims=ax)), [a, b])


def einsum(subscripts, *operands, out=None, optimize=False):
    def run(*xs):
        xs = _promote_all(list(xs))
        if xs[0].is_cuda and not (xs[0].is_floating_point() or
                                  xs[0].is_complex()):
            dt = xs[0].dtype
            return torch.einsum(subscripts,
                                *[x.to(torch.float64) for x in xs]).to(dt)
        return torch.einsum(subscripts, *xs)
    return _into(out, _run("einsum", run, list(operands)))


def kron(a, b):
    return _run("kron", lambda x, y: torch.kron(*_promote_all([x, y])),
                [a, b])


def cross(a, b, axis=-1):
    return _run("cross", lambda x, y: torch.linalg.cross(
        *_promote_all([x, y]), dim=axis), [a, b])


def vdot(a, b):
    return _run("vdot", _mm(lambda x, y: torch.dot(
        torch.conj_physical(x.reshape(-1)) if x.is_complex()
        else x.reshape(-1), y.reshape(-1))), [a, b])


def _interp(x, xp, fp, left, right):
    x, xp, fp = _inexact(x, xp, fp)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    t = (x - x0) / (x1 - x0)
    out = y0 + t * (y1 - y0)
    out = torch.where(x == x1, y1, out)
    lo = fp[0] if left is None else torch.tensor(left, dtype=fp.dtype,
                                                 device=fp.device)
    hi = fp[-1] if right is None else torch.tensor(right, dtype=fp.dtype,
                                                   device=fp.device)
    out = torch.where(x < xp[0], lo, out)
    return torch.where(x > xp[-1], hi, out)


def interp(x, xp, fp, left=None, right=None):
    return _run("interp", lambda a, b, c: _interp(a, b, c, left, right),
                [x, xp, fp])


def diff(a, n=1, axis=-1):
    return _run("diff", lambda x: torch.diff(x, n, dim=axis), [a])


def ediff1d(ary):
    return _run("ediff1d", lambda x: torch.diff(x.reshape(-1)), [ary])


def _gradient1(x, h, axis):
    n = x.shape[axis]
    sl = lambda a, b: x.narrow(axis, a, b - a)  # noqa: E731
    mid = (sl(2, n) - sl(0, n - 2)) / (2.0 * h)
    first = (sl(1, 2) - sl(0, 1)) / h
    last = (sl(n - 1, n) - sl(n - 2, n - 1)) / h
    return torch.cat([first, mid, last], dim=axis)


def gradient(f, *varargs, axis=None):
    axes = tuple(range(_coerce_arr(f).ndim)) if axis is None else \
        ((axis,) if isinstance(axis, int) else tuple(axis))
    hs = list(varargs) if varargs else [1.0] * len(axes)
    if len(hs) == 1 and len(axes) > 1:
        hs = hs * len(axes)
    outs = [_run("gradient", lambda x, ax=ax, h=h: _gradient1(
        _real(x), float(h), ax), [f]) for ax, h in zip(axes, hs)]
    return outs[0] if len(outs) == 1 else outs


def _correlate_full(a, v):
    """``sum_k a[n + k] * v[k]`` over every overlap (NumPy's 'full')."""
    a, v = _inexact(a, v)
    n, m = a.shape[0], v.shape[0]
    x = torch.nn.functional.pad(a.reshape(1, 1, n), (m - 1, m - 1))
    return torch.nn.functional.conv1d(x, v.reshape(1, 1, m)).reshape(-1)


def _mode_slice(full_, n, m, mode):
    if mode == "full":
        return full_
    if mode == "same":
        size = _imax(n, m)
        start = (full_.shape[0] - size) // 2
        return full_[start:start + size]
    size = _imax(n, m) - _imin(n, m) + 1
    start = _imin(n, m) - 1
    return full_[start:start + size]


def _imax(a, b):
    return a if a >= b else b


def _imin(a, b):
    return a if a <= b else b


def _convolve(a, v, mode):
    n, m = a.shape[0], v.shape[0]
    if m > n:
        a, v = v, a
    return _mode_slice(_correlate_full(a, torch.flip(v, [0])), n, m, mode)


def _correlate(a, v, mode):
    n, m = a.shape[0], v.shape[0]
    if m > n:
        return torch.flip(_mode_slice(_correlate_full(v, a), n, m, mode),
                          [0])
    return _mode_slice(_correlate_full(a, v), n, m, mode)


def convolve(a, v, mode="full"):
    return _run("convolve", lambda x, y: _convolve(x, y, mode), [a, v])


def correlate(a, v, mode="valid"):
    return _run("correlate", lambda x, y: _correlate(x, y, mode), [a, v])


def _histogram(x, bins, rng, w):
    x = _real(x).reshape(-1)
    if rng is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(rng[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(rng[1]), dtype=x.dtype, device=x.device)
    same = hi == lo
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    # jnp.linspace's formula, start * (1 - t) + stop * t, each step
    # rounded in x's dtype, and the end point appended
    t = torch.arange(bins, dtype=x.dtype, device=x.device) / torch.full(
        (), bins, dtype=x.dtype, device=x.device)
    edges = torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])
    idx = torch.searchsorted(edges, x.contiguous(), right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins - 1), idx)
    inside = (idx >= 0) & (idx < bins)
    weights = torch.ones_like(x) if w is None else _real(w).reshape(-1)
    counts = torch.zeros(bins, dtype=weights.dtype, device=x.device)
    counts.index_add_(0, idx.clamp(0, bins - 1),
                      torch.where(inside, weights, torch.zeros_like(
                          weights)))
    return counts, edges


def histogram(a, bins=10, range=None, weights=None):  # noqa: A002
    arrays = [a] + ([] if weights is None else [weights])
    h, edges = _run("histogram", lambda x, *w: _histogram(
        x, int(bins), range, w[0] if w else None), arrays)
    return h, edges


def bincount(x, weights=None, minlength=0):
    arrays = [x] + ([] if weights is None else [weights])
    return _run("bincount", lambda t, *w: torch.bincount(
        t.to(torch.int64), weights=_real(w[0]) if w else None,
        minlength=minlength), arrays)


def _digitize(x, bins, right):
    x, bins = _promote_all([x, bins])
    if bins.shape[0] > 1 and bool(bins[0] > bins[-1]):
        r = torch.searchsorted(torch.flip(bins, [0]), x.contiguous(),
                               right=not right)
        return bins.shape[0] - r
    return torch.searchsorted(bins, x.contiguous(), right=not right)


def digitize(x, bins, right=False):
    return _run("digitize", lambda a, b: _digitize(a, b, right), [x, bins])


def _isclose(x, y, rtol, atol, equal_nan):
    x, y = _inexact(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _run("isclose", lambda x, y: _isclose(x, y, rtol, atol,
                                                 equal_nan), [a, b])


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return bool(isclose(a, b, rtol, atol, equal_nan).asnumpy().all())


def array_equal(a1, a2):
    x = _coerce_arr(a1)
    y = _coerce_arr(a2, x._data.device)
    if x.shape != y.shape:
        return False
    return bool(torch.equal(*_promote_all([x._data, y._data.to(
        x._data.device)])))


def _np_dtype(dt):
    if dt == torch.bfloat16:
        return torch.bfloat16
    return onp.dtype(str(dt).replace("torch.", ""))


def result_type(*args):
    """The dtype NumPy's promotion (64-bit types as 32-bit, Python
    numbers weak) gives ``args``."""
    ts = []
    for a in args:
        if isinstance(a, NDArray):
            ts.append(torch.empty((1,), dtype=a._data.dtype))
        elif isinstance(a, (bool, int, float, complex)):
            ts.append(torch.tensor(a))
        elif isinstance(a, torch.dtype):
            ts.append(torch.empty((1,), dtype=a))
        else:
            ts.append(torch.empty((1,), dtype=_tdt(onp.asarray(a).dtype
                                                   if not isinstance(
                                                       a, (type, onp.dtype,
                                                           str))
                                                   else a)))
    dt = ts[0].dtype
    acc = ts[0]
    for t in ts[1:]:
        dt = torch.result_type(acc, t)
        acc = torch.empty((1,), dtype=dt) if acc.dim() or t.dim() else \
            torch.tensor(0, dtype=dt)
    return _np_dtype(_CANON.get(dt, dt))


def can_cast(from_, to):
    return onp.can_cast(from_, to)


def shape(a):
    return _coerce_arr(a).shape


def ndim(a):
    return _coerce_arr(a).ndim


def size(a, axis=None):
    arr = _coerce_arr(a)
    return arr.size if axis is None else arr.shape[axis]


def expm1x(x):
    return expm1(x)  # noqa: F821


def deg2rad(x):
    return _run1("deg2rad", _f(torch.deg2rad), x)


def rad2deg(x):
    return _run1("rad2deg", _f(torch.rad2deg), x)


def signbit(x):
    return _run1("signbit", lambda a: torch.signbit(a) if not a.dtype ==
                 torch.bool else torch.zeros_like(a), x)


def empty_like(prototype, dtype=None, order="C"):
    return zeros_like(prototype, dtype)


def diagflat(v, k=0):
    return _run1("diagflat", lambda x: torch.diagflat(x, k), v)


def diag_indices(n, ndim=2):
    r = torch.arange(n, dtype=torch.int32, device=_default_device())
    return tuple(ndarray(r.clone()) for _ in range(ndim))


def triu_indices(n, k=0, m=None):
    return _pair(torch.triu_indices(n, n if m is None else m, k,
                                    device=_default_device()))


def tri(N, M=None, k=0, dtype=float32):
    m = N if M is None else M
    dev = _default_device()
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return ndarray((j - i <= k).to(_tdt(dtype)))


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=2)


def row_stack(tup):
    return _run("row_stack", lambda *xs: torch.vstack(
        _promote_all(list(xs))), list(tup))


def _nanarg(tfn, fill):
    def run(x, axis):
        if x.is_floating_point():
            x = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
        return _argext(tfn)(x, axis)
    return run


def nanargmax(a, axis=None):
    return _run("nanargmax", lambda x: _nanarg(torch.argmax, -math.inf)(
        x, axis), [a])


def nanargmin(a, axis=None):
    return _run("nanargmin", lambda x: _nanarg(torch.argmin, math.inf)(
        x, axis), [a])


def _nanfill(x, v):
    return torch.where(torch.isnan(x), torch.full_like(x, v), x) \
        if x.is_floating_point() else x


def nancumsum(a, axis=None, dtype=None):
    return _run("nancumsum", lambda x: _cum(torch.cumsum, _nanfill(x, 0.0),
                                            axis, dtype), [a])


def nancumprod(a, axis=None, dtype=None):
    return _run("nancumprod", lambda x: _cum(
        torch.cumprod, _nanfill(x, 1.0), axis, dtype), [a])


def _nanvar(x, axis, ddof, keepdims):
    x = _real(x)
    dims = _dims(x, axis)
    ok = ~torch.isnan(x)
    n = torch.sum(ok, dim=dims, keepdim=True).to(x.dtype)
    m = torch.nansum(x, dim=dims, keepdim=True) / n
    dev = torch.where(ok, x - m, torch.zeros_like(x))
    out = torch.sum(dev * dev, dim=dims, keepdim=True) / (n - ddof)
    return out if keepdims else out.squeeze(dims)


def nanstd(a, axis=None, ddof=0, keepdims=False):
    return _run("nanstd", lambda x: torch.sqrt(_nanvar(x, axis, ddof,
                                                       keepdims)), [a])


def nanvar(a, axis=None, ddof=0, keepdims=False):
    return _run("nanvar", lambda x: _nanvar(x, axis, ddof, keepdims), [a])


def nanpercentile(a, q, axis=None, keepdims=False):
    return _run("nanpercentile", lambda x: _quantile(
        x, torch.as_tensor(onp.asarray(q, dtype=onp.float64) / 100.0,
                           device=x.device), _ax(axis), keepdims, nan=True),
        [a])


def _corrcoef(x, y, rowvar):
    x = _real(x)
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if not rowvar:
        x = x.T
    if y is not None:
        y = _real(y)
        if y.dim() == 1:
            y = y.reshape(1, -1)
        if not rowvar:
            y = y.T
        x = torch.cat([x, y.to(x.dtype)], dim=0)
    c = torch.corrcoef(x)
    return c.reshape(()) if c.numel() == 1 else c


def corrcoef(x, y=None, rowvar=True):
    if y is None:
        return _run("corrcoef", lambda a: _corrcoef(a, None, rowvar), [x])
    return _run("corrcoef", lambda a, b: _corrcoef(a, b, rowvar), [x, y])


def trapz(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return _run("trapz", lambda yy: torch.trapezoid(
            _real(yy), dx=dx, dim=axis), [y])
    return _run("trapz", lambda yy, xx: torch.trapezoid(
        *_inexact(yy, xx), dim=axis), [y, x])


def put(a, ind, v, mode="clip"):
    """Set ``a.flat[ind] = v``: returns the new array and rebinds ``a``'s
    handle to it (the reference's surface)."""
    arr = _coerce_arr(a)
    dev = arr._data.device
    idx = _coerce_arr(ind, dev)._data.to(dev).to(torch.int64).reshape(-1)
    vals = _coerce_arr(v, dev)._data.to(device=dev, dtype=arr._data.dtype)
    flat = arr._data.detach().reshape(-1).clone()
    n = flat.shape[0]
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    vals = torch.broadcast_to(vals.reshape(-1), idx.shape) \
        if vals.dim() <= 1 else vals.reshape(-1)
    flat[idx] = vals
    new = flat.reshape(arr._data.shape)
    if isinstance(a, NDArray):
        a._rebind(new)
        return a
    return ndarray(new)


def _resize(x, new_shape):
    shp = _shp(new_shape)
    total = 1
    for s in shp:
        total *= s
    flat = x.reshape(-1)
    reps = -(-total // _imax(flat.shape[0], 1))
    return flat.repeat(reps)[:total].reshape(shp)


def resize(a, new_shape):
    return _run("resize", lambda x: _resize(x, new_shape), [a])


def bitwise_not(a):
    return _run("bitwise_not", torch.bitwise_not, [a])


invert = bitwise_not


def _polyval(p, x):
    p, x = _inexact(p, x)
    out = torch.zeros_like(x)
    for i in range(p.shape[0]):
        out = out * x + p[i]
    return out


def polyval(p, x):
    return _run("polyval", _polyval, [p, x])


def _window(fn, M, dtype):
    w = fn(M, periodic=False, dtype=torch.float64) if M > 1 else \
        torch.ones(M, dtype=torch.float64)
    return ndarray(w.to(_tdt(dtype or "float32")).to(_default_device()))


def blackman(M, dtype=None):
    return _window(torch.blackman_window, M, dtype)


def hamming(M, dtype=None):
    return _window(torch.hamming_window, M, dtype)


def hanning(M, dtype=None):
    return _window(torch.hann_window, M, dtype)


def diag_indices_from(arr):
    a = _coerce_arr(arr)
    r = torch.arange(a.shape[0], dtype=torch.int32, device=a._data.device)
    return tuple(ndarray(r.clone()) for _ in range(a.ndim))


def share_memory(a, b):
    return False


def may_share_memory(a, b, max_work=None):
    return False


def shares_memory(a, b, max_work=None):
    return False


# everything public defined in this module (functions, constants, dtypes)
__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_")
           and _n not in ("torch", "onp", "math", "NDArray", "Op", "invoke",
                          "MXNetError", "numeric_types", "annotations")]
