"""``mx.test_utils``: helpers for tests of models and ops.

Port of ``mxnet_tpu/test_utils.py`` (reference
``python/mxnet/test_utils.py``): ``assert_almost_equal`` with a
tolerance by dtype, ``same``, ``rand_ndarray``/``rand_shape_nd``,
``check_numeric_gradient`` (central differences against autograd),
``check_consistency`` (one function across dtypes),
``check_symbolic_forward``/``check_symbolic_backward`` (a Symbol bound
through the port's ``Executor``), ``with_seed`` and ``environment``.
Arrays are made on the current context, as the reference's are.
"""
from __future__ import annotations

import functools
import os
import random as pyrandom

import numpy as np
import torch

from .base import MXNetError  # noqa: F401 (the reference's namespace)
from .context import cpu, current_context  # noqa: F401
from .ndarray.ndarray import NDArray, array

# (rtol, atol) by dtype name; bfloat16 by its name (numpy has none)
_DTYPE_TOL = {
    "float16": (1e-2, 1e-2),
    "float32": (1e-4, 1e-5),
    "float64": (1e-6, 1e-8),
    "bfloat16": (4e-2, 4e-2),
}


def _dtype_name(a):
    dt = getattr(a, "dtype", np.float32)
    if dt == torch.bfloat16:
        return "bfloat16"
    return np.dtype(dt).name


def default_rtol_atol(*arrays):
    rtol, atol = 1e-5, 1e-8
    for a in arrays:
        tol = _DTYPE_TOL.get(_dtype_name(a))
        if tol is not None:
            rtol, atol = max(rtol, tol[0]), max(atol, tol[1])
    return rtol, atol


def _np(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    if rtol is None or atol is None:
        r, t = default_rtol_atol(a, b)
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else t
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} vs {names[1]}")


def same(a, b):
    return np.array_equal(_np(a), _np(b))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None):
    data = np.random.uniform(-1, 1, size=shape).astype(dtype)
    nd = array(data, ctx=ctx)
    if stype != "default":
        return nd.tostype(stype)
    return nd


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Central differences against autograd; ``fn`` maps NDArrays to a
    scalar NDArray."""
    from . import autograd

    nds = [array(np.asarray(x, np.float32)) if not isinstance(x, NDArray)
           else x for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = fn(*nds)
    out.backward()

    for i, x in enumerate(nds):
        base = np.ascontiguousarray(x.asnumpy().astype(np.float64))
        num = np.zeros(base.shape, np.float64)
        flat = base.reshape(-1)
        gflat = num.reshape(-1)

        def val(v):
            args = [array(v.reshape(x.shape).astype(np.float32),
                          ctx=x.context) if k == i else y.detach()
                    for k, y in enumerate(nds)]
            with autograd.pause():
                return float(fn(*args).asnumpy().reshape(-1)[0])

        for j in range(flat.size):
            pp, pm = flat.copy(), flat.copy()
            pp[j] += eps
            pm[j] -= eps
            gflat[j] = (val(pp) - val(pm)) / (2 * eps)
        assert_almost_equal(num, x.grad.asnumpy(), rtol=rtol, atol=atol,
                            names=(f"numeric_grad[{i}]", f"autograd[{i}]"))


def check_consistency(fn, inputs, dtypes=("float32",), rtol=None, atol=None):
    """``fn`` under each dtype, held against the first."""
    ref = None
    for dt in dtypes:
        args = [array(_np(x).astype(np.float32), dtype=dt) for x in inputs]
        out = _np(fn(*args)).astype(np.float64)
        if ref is None:
            ref = out
        else:
            r, t = _DTYPE_TOL.get(np.dtype(dt).name if dt != "bfloat16"
                                  else dt, (1e-5, 1e-8))
            assert_almost_equal(out, ref, rtol=rtol or r, atol=atol or t)


def with_seed(seed=None):
    """A decorator seeding numpy, ``random`` and ``mx.random`` for a test
    and printing the seed when it fails."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            from . import random as mxrandom
            s = seed if seed is not None else np.random.randint(0, 2**31)
            np.random.seed(s)
            pyrandom.seed(s)
            mxrandom.seed(s)
            try:
                return f(*args, **kwargs)
            except Exception:
                print(f"Test failed with seed {s} (set with_seed({s}) to "
                      f"reproduce)")
                raise
        return wrapper

    return deco


class environment:
    """``with environment(name, value):`` or ``environment({...})``:
    environment variables set for the block (None unsets) and restored
    after."""

    def __init__(self, *args):
        self._vals = {args[0]: args[1]} if len(args) == 2 else dict(args[0])

    def __enter__(self):
        self._old = {k: os.environ.get(k) for k in self._vals}
        for k, v in self._vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *a):
        for k, v in self._old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bound_args(sym, args, ctx):
    arg_names = sym.list_arguments()
    if isinstance(args, (list, tuple)):
        args = dict(zip(arg_names, args))
    return {k: v if isinstance(v, NDArray) else array(v, ctx=ctx)
            for k, v in args.items()}


def check_symbolic_forward(sym, args, expected, rtol=None, atol=None,
                           ctx=None):
    """Bind ``sym`` to ``args`` (a list in ``list_arguments()`` order or
    a dict) and hold its outputs against ``expected``."""
    ex = sym.bind(ctx=ctx, args=_bound_args(sym, args, ctx),
                  grad_req="null")
    outputs = ex.forward(is_train=False)
    assert len(outputs) == len(expected), \
        f"{len(outputs)} outputs != {len(expected)} expected"
    for o, e in zip(outputs, expected):
        assert_almost_equal(o, e, rtol, atol)
    return outputs


def check_symbolic_backward(sym, args, out_grads, expected_grads, rtol=None,
                            atol=None, grad_req="write", ctx=None):
    """Bind, forward in training mode, backward from ``out_grads`` and
    hold the arguments' gradients against ``expected_grads``."""
    arg_names = sym.list_arguments()
    if isinstance(expected_grads, (list, tuple)):
        expected_grads = dict(zip(arg_names, expected_grads))
    ex = sym.bind(ctx=ctx, args=_bound_args(sym, args, ctx),
                  grad_req=grad_req)
    ex.forward(is_train=True)
    heads = out_grads if isinstance(out_grads, (list, tuple)) \
        else [out_grads]
    ex.backward([g if isinstance(g, NDArray) else array(g, ctx=ctx)
                 for g in heads])
    grads = ex.grad_dict
    for name, e in expected_grads.items():
        if e is None:
            continue
        assert name in grads, f"no gradient computed for {name}"
        assert_almost_equal(grads[name], e, rtol, atol,
                            names=(f"grad({name})", "expected"))
    return grads
