"""``mx.np``'s breadth: NumPy 2.0's names, structured functions, set
operations and dtype helpers.

Port of ``mxnet_tpu/numpy/extensions.py``, every name of its tables:

- the NumPy-2.0 aliases (``acos``, ``atan2``, ``concat``,
  ``permute_dims``, ``pow``, ``bitwise_invert``, ...);
- structured functions (``cov``, ``vander``, ``select``, ``choose``,
  ``put_along_axis`` and ``fill_diagonal`` with copy semantics,
  ``apply_along_axis``, ``unwrap``, ``trapezoid``, ``geomspace``,
  ``lexsort``, ``partition``/``argpartition`` as JAX arranges them,
  ``divmod``/``modf``/``frexp``, the polynomial helpers, index helpers);
- set operations (``isin``, ``intersect1d``, ``union1d``, ...,
  ``unique_*``), whose result's shape depends on the data: they run
  NumPy on the host and return arrays on the operand's device, as the
  reference does (not inside a CUDA-graph capture);
- dtype and introspection helpers (``finfo``, ``iinfo``,
  ``issubdtype``, ``promote_types`` with 64-bit types as 32-bit,
  ``broadcast_shapes``, ``isscalar``, ``iterable``, ...).

``apply_along_axis``/``apply_over_axes`` call the user's function on
torch tensors (the reference's on JAX arrays).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..ndarray.ndarray import NDArray
from .multiarray import (_CANON, _canon, _coerce_arr, _device_of,
                         _floor_divide, _host, _inexact, _make_binary,
                         _make_unary, _np_dtype, _promote_all, _real,
                         _remainder, _run, _run1, _tdt, ndarray)

__all__: list = []  # populated below


def _np_of(x):
    """Host NumPy values of any array-ish input (the set operations)."""
    a = _coerce_arr(x)
    return _host(a) if isinstance(a, NDArray) else onp.asarray(a)


def _dev(x, device=None):
    from .multiarray import _host_tensor

    return ndarray(_host_tensor(x, device if device is not None
                                else _device_of(())))


def _export(name, fn):
    fn.__name__ = name
    globals()[name] = fn
    __all__.append(name)
    return fn


# --------------------------------------------------------------------------- #
# NumPy-2.0 alias names over existing ufuncs
# --------------------------------------------------------------------------- #

def _popcount(x):
    """The set bits of ``|x|`` (NumPy's and ``jnp.bitwise_count``'s
    rule: -5 counts the bits of 5)."""
    bits = torch.zeros_like(x, dtype=torch.uint8)
    v = torch.abs(x).to(torch.int64) & ((1 << (8 * x.element_size())) - 1)
    for _ in range(8 * x.element_size()):
        bits = bits + (v & 1).to(torch.uint8)
        v = v >> 1
    return bits


def _spacing(x):
    x = _real(x)
    toward = torch.where(x < 0, torch.full_like(x, -math.inf),
                         torch.full_like(x, math.inf))
    return torch.nextafter(x, toward) - x


def _heaviside(a, b):
    a, b = _inexact(a, b)
    return torch.heaviside(a, b)


_UNARY_ALIASES = {
    "acos": lambda x: torch.acos(_real(x)),
    "acosh": lambda x: torch.acosh(_real(x)),
    "asin": lambda x: torch.asin(_real(x)),
    "asinh": lambda x: torch.asinh(_real(x)),
    "atan": lambda x: torch.atan(_real(x)),
    "atanh": lambda x: torch.atanh(_real(x)),
    "bitwise_invert": torch.bitwise_not, "bitwise_count": _popcount,
    "conjugate": lambda x: torch.conj_physical(x) if x.is_complex()
    else x.clone(),
    "spacing": _spacing,
}
_BINARY_ALIASES = {
    "atan2": lambda a, b: torch.atan2(*_inexact(a, b)),
    "pow": torch.pow,
    "bitwise_left_shift": lambda a, b: torch.bitwise_left_shift(
        *_promote_all([a, b])),
    "bitwise_right_shift": lambda a, b: torch.bitwise_right_shift(
        *_promote_all([a, b])),
    "heaviside": _heaviside,
}
for _n, _f in _UNARY_ALIASES.items():
    _export(_n, _make_unary(_n, _f))
for _n, _f in _BINARY_ALIASES.items():
    _export(_n, _make_binary(_n, _f))


# --------------------------------------------------------------------------- #
# structured functions
# --------------------------------------------------------------------------- #

def _structured(name, tfn, n_arr=1):
    def wrapper(*args, **kwargs):
        arrays, rest = list(args[:n_arr]), args[n_arr:]
        return _run(name, lambda *arrs: tfn(*arrs, *rest, **kwargs), arrays)
    return _export(name, wrapper)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None):
    x = _real(m)
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    corr = (0 if bias else 1) if ddof is None else ddof
    c = torch.cov(x, correction=corr)
    return c.reshape(()) if c.numel() == 1 else c


def _vander(x, N=None, increasing=False):
    return torch.vander(x, N=N, increasing=increasing)


def _trapezoid(y, x=None, dx=1.0, axis=-1):
    return torch.trapezoid(_real(y), dx=dx, dim=axis)


def _unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = _real(p)
    dd = torch.diff(p, dim=axis)
    half = period / 2
    discont = half if discont is None else max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(torch.abs(dd) < discont, torch.zeros_like(dd),
                       ddmod - dd)
    head = p.narrow(axis, 0, 1)
    return torch.cat([head, p.narrow(axis, 1, p.shape[axis] - 1) +
                      torch.cumsum(corr, dim=axis)], dim=axis)


def _partition(a, kth, axis=-1):
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    kth = kth % n
    bottom = -torch.topk(-x, kth + 1, dim=-1).values
    top = torch.topk(x, n - kth - 1, dim=-1).values
    return torch.movedim(torch.cat([bottom, top], dim=-1), -1, axis)


def _argpartition(a, kth, axis=-1):
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    kth = kth % n
    bottom = torch.topk(-x, kth + 1, dim=-1).indices
    top = torch.topk(x, n - kth - 1, dim=-1).indices
    return torch.movedim(torch.cat([bottom, top], dim=-1), -1, axis)


def _histogram_bin_edges(a, bins=10, range=None, weights=None):  # noqa: A002
    x = _real(a).reshape(-1)
    if range is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(range[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(range[1]), dtype=x.dtype, device=x.device)
    same = hi == lo
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    steps = torch.arange(bins + 1, dtype=x.dtype, device=x.device) / bins
    return lo + (hi - lo) * steps


def _poly(z):
    z = _real(z).reshape(-1)
    c = torch.ones(1, dtype=z.dtype, device=z.device)
    for i in range(z.shape[0]):
        c = torch.cat([c, torch.zeros_like(c[:1])]) - torch.cat(
            [torch.zeros_like(c[:1]), c * z[i]])
    return c


def _roots(p):
    p = _real(p).reshape(-1)
    nz = torch.nonzero(p != 0).reshape(-1)
    p = p[int(nz[0]):int(nz[-1]) + 1] if nz.numel() else p[:0]
    n = p.shape[0] - 1
    if n < 1:
        return torch.zeros(0, dtype=torch.complex64, device=p.device)
    comp = torch.zeros((n, n), dtype=torch.float64, device=p.device)
    comp[0, :] = -p[1:].to(torch.float64) / p[0].to(torch.float64)
    if n > 1:
        comp[1:, :-1] = torch.eye(n - 1, dtype=torch.float64,
                                  device=p.device)
    return torch.linalg.eigvals(comp).to(torch.complex64)


def _padded(a, b):
    n = max(a.shape[0], b.shape[0])
    za = torch.nn.functional.pad(a, (n - a.shape[0], 0))
    zb = torch.nn.functional.pad(b, (n - b.shape[0], 0))
    return za, zb


def _polyadd(a, b):
    a, b = _promote_all([a, b])
    za, zb = _padded(a, b)
    return za + zb


def _polysub(a, b):
    a, b = _promote_all([a, b])
    za, zb = _padded(a, b)
    return za - zb


def _polymul(a, b):
    a, b = _inexact(a, b)
    n, m = a.shape[0], b.shape[0]
    x = torch.nn.functional.pad(a.reshape(1, 1, n), (m - 1, m - 1))
    return torch.nn.functional.conv1d(
        x, torch.flip(b, [0]).reshape(1, 1, m)).reshape(-1)


def _polyder(p, m=1):
    p = p.clone()
    for _ in range(m):
        n = p.shape[0] - 1
        if n < 1:
            return torch.zeros(1, dtype=p.dtype, device=p.device)
        p = p[:-1] * torch.arange(n, 0, -1, device=p.device).to(p.dtype)
    return p


def _polyint(p, m=1, k=None):
    p = _real(p)
    for i in range(m):
        n = p.shape[0]
        c = 0.0 if k is None else float(onp.atleast_1d(k)[i])
        p = torch.cat([p / torch.arange(n, 0, -1, device=p.device).to(
            p.dtype), torch.full((1,), c, dtype=p.dtype, device=p.device)])
    return p


def _vecdot(a, b, axis=-1):
    a, b = _promote_all([a, b])
    if a.is_complex():
        a = torch.conj_physical(a)
    return torch.sum(a * b, dim=axis)


def _sort_complex(a):
    a = a.to(torch.complex64) if not a.is_complex() else a
    order = torch.argsort(torch.imag(a), dim=-1, stable=True)
    a = torch.take_along_dim(a, order, dim=-1)
    order = torch.argsort(torch.real(a), dim=-1, stable=True)
    return torch.take_along_dim(a, order, dim=-1)


def _trim_zeros(a, trim="fb"):
    nz = torch.nonzero(a != 0).reshape(-1)
    if nz.numel() == 0:
        return a[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else a.shape[0]
    return a[lo:hi]


_structured("cov", _cov)
_structured("vander", _vander)
_structured("trapezoid", _trapezoid)
_structured("unwrap", _unwrap)
_structured("partition", _partition)
_structured("argpartition", _argpartition)
_structured("matrix_transpose", lambda x: torch.swapaxes(x, -1, -2))
_structured("permute_dims", lambda x, axes: x.permute(tuple(axes)))
_structured("histogram_bin_edges", _histogram_bin_edges)
_structured("poly", _poly)
_structured("roots", _roots)
_structured("polyadd", _polyadd, n_arr=2)
_structured("polysub", _polysub, n_arr=2)
_structured("polymul", _polymul, n_arr=2)
_structured("polyder", _polyder)
_structured("polyint", _polyint)
_structured("vecdot", _vecdot, n_arr=2)
_structured("sort_complex", _sort_complex)
_structured("trim_zeros", _trim_zeros)


def concat(arrays, axis=0):
    arrays = [_coerce_arr(a) for a in arrays]
    return _run("concat", lambda *arrs: torch.cat(
        _promote_all(list(arrs)), dim=axis) if axis is not None else
        torch.cat([x.reshape(-1) for x in _promote_all(list(arrs))]),
        list(arrays))


_export("concat", concat)


def select(condlist, choicelist, default=0):
    conds = [_np_of(c).astype(bool) for c in condlist]

    def run(*arrs):
        arrs = _promote_all(list(arrs))
        out = torch.full_like(arrs[0], default)
        for c, a in zip(reversed(conds), reversed(arrs)):
            out = torch.where(torch.as_tensor(c, device=a.device), a, out)
        return out
    return _run("select", run, list(choicelist))


_export("select", select)


def choose(a, choices, mode="raise"):
    def run(idx, *arrs):
        arrs = _promote_all(list(arrs))
        n = len(arrs)
        i = idx.to(torch.int64)
        i = i % n if mode == "wrap" else i.clamp(0, n - 1)
        stacked = torch.stack(torch.broadcast_tensors(*arrs,
                                                      i.to(arrs[0].dtype))
                              [:-1])
        i = torch.broadcast_to(i, stacked.shape[1:])
        return torch.gather(stacked, 0, i.unsqueeze(0)).squeeze(0)
    return _run("choose", run, [a] + list(choices))


_export("choose", choose)


def compress(condition, a, axis=None):
    """Elements (or slices) where ``condition`` holds, read on the host."""
    arr = _coerce_arr(a)
    cond = _np_of(condition).astype(bool)
    out = _dev(onp.compress(cond, _np_of(arr), axis=axis),
               arr._data.device)
    return out if arr._data.dtype != torch.bfloat16 else \
        ndarray(out._data.to(torch.bfloat16))


_export("compress", compress)


def put_along_axis(arr, indices, values, axis):
    """Copy semantics: returns the updated array."""
    def impl(a, idx, vals):
        idx = idx.to(torch.int64)
        vals = torch.broadcast_to(vals.to(a.dtype), idx.shape)
        return torch.scatter(a, axis, idx, vals)
    return _run("put_along_axis", impl, [arr, indices, values])


_export("put_along_axis", put_along_axis)


def _diagonal_values(val, n, like):
    """``val`` for ``n`` diagonal places: a number, or an array's values
    repeated in order (NumPy's ``fill_diagonal``)."""
    v = val._data if isinstance(val, NDArray) else val
    v = torch.as_tensor(v, device=like.device).to(like.dtype).reshape(-1)
    if v.numel() <= 1:
        return v.reshape(())
    return v.repeat(-(-n // v.numel()))[:n]


def _fill_diagonal(x, val, wrap):
    out = x.clone()
    if x.dim() == 2:
        n, m = x.shape
        step = m + 1
        end = n * m if wrap else max(0, min(n, m)) * m
        flat = out.reshape(-1)
        idx = torch.arange(0, end, step, device=x.device)
        flat[idx] = _diagonal_values(val, idx.numel(), x)
        return flat.reshape(x.shape)
    n = x.shape[0]
    r = torch.arange(n, device=x.device)
    out[(r,) * x.dim()] = _diagonal_values(val, n, x)
    return out


def fill_diagonal(a, val, wrap=False):
    """Copy semantics: returns the filled array."""
    return _run1("fill_diagonal", lambda x: _fill_diagonal(x, val, wrap), a)


_export("fill_diagonal", fill_diagonal)


def _apply_along(func1d, axis, x, args, kwargs):
    moved = torch.movedim(x, axis, -1)
    lead = moved.shape[:-1]
    rows = moved.reshape(-1, moved.shape[-1])
    outs = torch.stack([torch.as_tensor(func1d(r, *args, **kwargs))
                        for r in rows])
    out = outs.reshape(lead + outs.shape[1:])
    if outs.dim() == 1:
        return out
    return torch.movedim(out, -1, axis % x.dim())


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    return _run1("apply_along_axis", lambda x: _apply_along(
        func1d, axis, x, args, kwargs), arr)


_export("apply_along_axis", apply_along_axis)


def _apply_over(func, x, axes):
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    for ax in axes:
        r = func(x, ax)
        x = r if r.dim() == x.dim() else r.unsqueeze(ax % x.dim())
    return x


def apply_over_axes(func, a, axes):
    return _run1("apply_over_axes", lambda x: _apply_over(func, x, axes), a)


_export("apply_over_axes", apply_over_axes)


def _lexsort(keys, axis):
    order = None
    for k in keys:
        if order is None:
            order = torch.argsort(k, dim=axis, stable=True)
        else:
            o = torch.argsort(torch.take_along_dim(k, order, dim=axis),
                              dim=axis, stable=True)
            order = torch.take_along_dim(order, o, dim=axis)
    return order


def lexsort(keys, axis=-1):
    keys = [_coerce_arr(k) for k in keys]
    return _run("lexsort", lambda *arrs: _lexsort(arrs, axis), list(keys))


_export("lexsort", lexsort)


def divmod(x1, x2):
    q = _run("floor_divide", _floor_divide, [x1, x2])
    r = _run("remainder", _remainder, [x1, x2])
    return q, r


_export("divmod", divmod)


def modf(x):
    frac = _run1("modf_frac", lambda a: _real(a) - torch.trunc(_real(a)), x)
    whole = _run1("modf_whole", lambda a: torch.trunc(_real(a)), x)
    return frac, whole


_export("modf", modf)


def frexp(x):
    m = _run1("frexp_m", lambda a: torch.frexp(_real(a))[0], x)
    e = _run1("frexp_e", lambda a: torch.frexp(_real(a))[1], x)
    return m, e


_export("frexp", frexp)


def histogram2d(x, y, bins=10, range=None, weights=None):  # noqa: A002
    dev = _device_of([x, y])
    h, ex, ey = onp.histogram2d(_np_of(x), _np_of(y), bins=bins,
                                range=range,
                                weights=None if weights is None
                                else _np_of(weights))
    return _dev(h, dev), _dev(ex, dev), _dev(ey, dev)


_export("histogram2d", histogram2d)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0):
    r = onp.geomspace(start, stop, num, endpoint=endpoint)
    dt = _tdt(dtype) or torch.float32
    return ndarray(torch.from_numpy(r).to(dt).to(_device_of(())))


_export("geomspace", geomspace)


def _depth(a):
    return 1 + _depth(a[0]) if isinstance(a, list) and a else 0


def _leaves(a):
    return [y for x in a for y in _leaves(x)] if isinstance(a, list) \
        else [a]


def block(arrays):
    dev = _device_of(_leaves(arrays))
    depth = _depth(arrays)

    def tensors(a):
        if isinstance(a, list):
            return [tensors(x) for x in a]
        return _coerce_arr(a, dev)._data.to(dev)

    def build(a, level):
        if not isinstance(a, list):
            return a
        parts = [build(x, level + 1) for x in a]
        nd = depth
        for p in parts:
            nd = max(nd, p.dim())
        parts = [p.reshape((1,) * (nd - p.dim()) + tuple(p.shape))
                 for p in parts]
        return torch.cat(_promote_all(parts), dim=-(depth - level))

    return ndarray(_canon(build(tensors(arrays), 0)))


_export("block", block)


def ix_(*args):
    dev = _device_of(args)
    return tuple(_dev(g, dev) for g in onp.ix_(*[_np_of(a) for a in args]))


_export("ix_", ix_)


def tril_indices_from(arr, k=0):
    dev = _device_of([arr])
    r, c = onp.tril_indices(_np_of(arr).shape[-2], k,
                            _np_of(arr).shape[-1])
    return _dev(r, dev), _dev(c, dev)


def triu_indices_from(arr, k=0):
    dev = _device_of([arr])
    r, c = onp.triu_indices(_np_of(arr).shape[-2], k,
                            _np_of(arr).shape[-1])
    return _dev(r, dev), _dev(c, dev)


def mask_indices(n, mask_func, k=0):
    if mask_func == "tril":
        mask_func = onp.tril
    elif mask_func == "triu":
        mask_func = onp.triu
    r, c = onp.mask_indices(n, lambda m, kk: onp.asarray(
        mask_func(m, kk)), k)
    return _dev(r), _dev(c)


_export("tril_indices_from", tril_indices_from)
_export("triu_indices_from", triu_indices_from)
_export("mask_indices", mask_indices)


# --------------------------------------------------------------------------- #
# set operations: data-dependent result shapes, NumPy on the host
# --------------------------------------------------------------------------- #

def _setop(name, nfn, n_arr=2):
    def wrapper(*args, **kwargs):
        dev = _device_of(args[:n_arr])
        host = [_np_of(a) for a in args[:n_arr]]
        out = nfn(*host, *args[n_arr:], **kwargs)
        if isinstance(out, tuple):
            return tuple(_dev(o, dev) for o in out)
        return _dev(out, dev)
    return _export(name, wrapper)


_setop("isin", onp.isin)
_setop("in1d", onp.isin)  # modern alias of the deprecated in1d
_setop("intersect1d", onp.intersect1d)
_setop("union1d", onp.union1d)
_setop("setdiff1d", onp.setdiff1d)
_setop("setxor1d", onp.setxor1d)
_setop("unique_values", lambda a: onp.unique(a), n_arr=1)
_setop("unique_counts", lambda a: onp.unique(a, return_counts=True),
       n_arr=1)
_setop("unique_inverse", lambda a: onp.unique(a, return_inverse=True),
       n_arr=1)
_setop("unique_all", lambda a: onp.unique(
    a, return_index=True, return_inverse=True, return_counts=True),
    n_arr=1)


# --------------------------------------------------------------------------- #
# dtype / introspection helpers
# --------------------------------------------------------------------------- #

def _finfo(dt):
    return torch.finfo(dt) if isinstance(dt, torch.dtype) else \
        onp.finfo(dt)


def _iinfo(dt):
    return torch.iinfo(dt) if isinstance(dt, torch.dtype) else \
        onp.iinfo(dt)


def _promote_types(a, b):
    dt = torch.promote_types(_tdt(a), _tdt(b))
    return _np_dtype(_CANON.get(dt, dt))


def _passthrough(name, fn):
    return _export(name, fn)


_passthrough("finfo", _finfo)
_passthrough("iinfo", _iinfo)
_passthrough("issubdtype", onp.issubdtype)
_passthrough("promote_types", _promote_types)
_passthrough("broadcast_shapes", onp.broadcast_shapes)
_passthrough("isdtype", getattr(onp, "isdtype", None) or (
    lambda dt, kind: onp.issubdtype(dt, kind)))
_passthrough("isscalar", onp.isscalar)
_passthrough("iterable", onp.iterable)
_passthrough("isrealobj", lambda x: not _coerce_arr(x)._data.is_complex()
             if isinstance(_coerce_arr(x), NDArray)
             else onp.isrealobj(x))
_passthrough("iscomplexobj", lambda x: _coerce_arr(x)._data.is_complex()
             if isinstance(_coerce_arr(x), NDArray)
             else onp.iscomplexobj(x))


def isreal(x):
    return _run1("isreal", lambda a: torch.imag(a) == 0 if a.is_complex()
                 else torch.ones_like(a, dtype=torch.bool), x)


def iscomplex(x):
    return _run1("iscomplex", lambda a: torch.imag(a) != 0
                 if a.is_complex()
                 else torch.zeros_like(a, dtype=torch.bool), x)


_export("isreal", isreal)
_export("iscomplex", iscomplex)


def astype(x, dtype, copy=True):
    dt = _tdt(dtype)
    return _run1("astype", lambda a: a.to(dt), x)


def array_equiv(a1, a2):
    return bool(onp.array_equiv(_np_of(a1), _np_of(a2)))


_export("astype", astype)
_export("array_equiv", array_equiv)
