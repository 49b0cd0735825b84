"""``mx.np`` of the port against the JAX package's, name by name.

Every call of ``tests/_torch_np_cases.py`` runs in both packages on the
same seeded NumPy inputs (the port on the CPU): shapes and dtypes equal,
integer and boolean values equal, float32 values within 1e-6 of the
reference's largest magnitude (``np.linalg`` 1e-5, factorisations by
reconstruction), and ``mx.np.random``'s draws by their support and
moments.  Also: an op on an ``mx.np.ndarray`` returns one (through
``invoke``, ``NDArray`` methods and a Gluon layer), autograd records
``mx.np`` functions, and every public name of the reference's
``numpy``, ``numpy.linalg`` and ``numpy.random`` resolves in the port.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_np_cases import (call, cases, compare, flatten, moments_ok,
                             random_cases)
from _torch_parity import LazyReference

rmx = LazyReference()

TOL = 1e-6              # float32, of the largest magnitude
LINALG_TOL = 1e-5
NPX_TOL = 1e-5          # convolutions and norms sum in another order

CASES = [c for c in cases() if not c[1].startswith("npx.")]


def _ref_host(out):
    from mxnet_tpu.ndarray.ndarray import NDArray as RArray

    if isinstance(out, RArray):
        a = onp.asarray(out._data)
        return (a.astype(onp.float32) if a.dtype.name == "bfloat16" else a,
                str(out.dtype), tuple(out.shape))
    return None


def port_host(out):
    if isinstance(out, pmx.nd.NDArray):
        t = out._data.detach()
        a = t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.cpu().numpy()
        return a, str(out.dtype).replace("torch.", ""), tuple(out.shape)
    return None


def run_ref(case):
    import jax.numpy as jnp
    return flatten(call(rmx, case, lambda v: rmx.np.array(v),
                        lambda n: getattr(jnp, n)), _ref_host)


def run_port(case, ctx=None):
    ctx = ctx or pmx.cpu()
    with ctx:
        return flatten(call(pmx, case, lambda v: pmx.np.array(v, ctx=ctx),
                            lambda n: getattr(torch, n)), port_host)


def _tol(case):
    if ".linalg." in case[1]:
        return LINALG_TOL
    return NPX_TOL if case[1].startswith("npx.") else TOL


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_np_surface_matches_reference(case):
    ref = run_ref(case)
    got = run_port(case)
    ok, err, msg = compare(case, ref, got, _tol(case))
    assert ok, f"{case[0]}: {msg}"


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


# names of the reference modules that are JAX itself, not its surface
JAX_MODULES = {"jax", "jnp"}


@pytest.mark.parametrize("which", ["numpy", "numpy.linalg",
                                   "numpy.random", "numpy_extension",
                                   "util", "runtime", "profiler_xla",
                                   "contrib.quantization"])
def test_every_reference_name_resolves(which):
    import importlib

    ref = importlib.import_module(f"mxnet_tpu.{which}")
    port_name = {"profiler_xla": "profiler_trace"}.get(which, which)
    port = importlib.import_module(f"mxnet_tpu_torch.{port_name}")
    names = getattr(ref, "__all__", None) or _public(ref)
    # ``annotations`` is the ``__future__`` feature, not a name of the API
    missing = sorted(n for n in (set(names) | _public(ref)) - {"annotations"}
                     if not hasattr(port, n) and n not in JAX_MODULES and
                     not _is_module_import(ref, n))
    assert not missing, missing


def _is_module_import(mod, name):
    import types
    return isinstance(getattr(mod, name, None), types.ModuleType) and \
        name not in ("linalg", "random", "multiarray", "extensions",
                     "quantization")


def test_dtype_promotion_rules():
    with pmx.cpu():
        np = pmx.np
        x = np.array(onp.arange(6, dtype=onp.float64).reshape(2, 3))
        assert x.dtype == onp.float32
        i = np.array(onp.arange(6, dtype=onp.int64))
        assert i.dtype == onp.int32
        assert pmx.np.multiply(i, 2.5).dtype == onp.float32
        assert np.sum(i).dtype == onp.int32
        assert np.mean(i).dtype == onp.float32
        assert np.cumsum(np.array(onp.ones(3, onp.int8))).dtype == onp.int8
        assert (x == x).dtype == onp.bool_
        assert np.argmax(x).dtype == onp.int32
        assert np.array(onp.ones(3, onp.float16)).__add__(2.0).dtype == \
            onp.float16


def test_class_follows_the_data_through_ops_and_layers():
    with pmx.cpu():
        a = pmx.np.array(onp.ones((2, 3), onp.float32))
        nd = pmx.nd.array(onp.ones((2, 3), onp.float32))
        assert type(a + 1) is pmx.np.ndarray
        assert type(pmx.nd.relu(a)) is pmx.np.ndarray
        assert type(a.as_nd_ndarray()) is pmx.nd.NDArray
        assert type(nd.as_np_ndarray()) is pmx.np.ndarray
        assert type(pmx.nd.relu(nd)) is pmx.nd.NDArray
        assert type(a.copy()) is pmx.np.ndarray
        assert type(a.as_in_context(pmx.cpu())) is pmx.np.ndarray
        assert type(a.T) is pmx.np.ndarray
        dense = pmx.gluon.nn.Dense(4, in_units=3)
        dense.initialize(ctx=pmx.cpu())
        out = dense(a)
        assert type(out) is pmx.np.ndarray
        assert out.shape == (2, 4)
        assert type(pmx.nd.relu(nd.tostype("csr"))) is pmx.nd.NDArray


def test_views_share_tensor_and_gradient():
    with pmx.cpu():
        x = pmx.nd.array(onp.arange(3, dtype=onp.float32))
        x.attach_grad()
        v = x.as_np_ndarray()
        with pmx.autograd.record():
            y = pmx.np.sum(v * v)
        y.backward()
        onp.testing.assert_array_equal(v.grad.asnumpy(), [0.0, 2.0, 4.0])
        onp.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 2.0, 4.0])
        assert v._data is x._data


def test_autograd_through_np_functions_matches_reference():
    data = onp.linspace(-1, 1, 12, dtype=onp.float32).reshape(3, 4)

    def grads(mx, make):
        x = make(data)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.sum(mx.np.tanh(x) * mx.np.exp(x) + mx.np.square(
                mx.np.linalg.norm(x, axis=1))[:, None] +
                mx.np.mean(x, axis=0))
        y.backward()
        return x.grad.asnumpy()

    ref = grads(rmx, rmx.np.array)
    with pmx.cpu():
        got = grads(pmx, lambda v: pmx.np.array(v))
    onp.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_data_dependent_functions_refuse_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pmx.cpu():
        x = pmx.np.array(onp.asarray([0, 1, 2], onp.int32))
        with pytest.raises(pmx.MXNetError, match="capture"):
            pmx.np.nonzero(x)
        with pytest.raises(pmx.MXNetError, match="capture"):
            pmx.np.unique(x)


def test_entry_points_need_the_card_without_a_cpu_scope():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for fn in (lambda: pmx.np.zeros((2,)), lambda: pmx.np.array([1.0]),
               lambda: pmx.np.arange(3),
               lambda: pmx.np.random.uniform(size=2),
               lambda: pmx.util.default_array([1.0])):
        with pytest.raises(pmx.MXNetError):
            fn()


# --------------------------------------------------------------------- #
# mx.np.random: support and moments (JAX's threefry bits are not
# reproduced; the draws are checked as tests/test_torch_samplers.py's)
# --------------------------------------------------------------------- #

N = 20000
RANDOM = random_cases(N)


@pytest.mark.parametrize("row", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_draws_by_support_and_moments(row):
    name, draw, mean, var, lo, hi, dtype = row
    pmx.np.random.seed(11)
    with pmx.cpu():
        out = draw(pmx.np.random)
    rmx.np.random.seed(11)
    ref = draw(rmx.np.random)
    assert type(out) is pmx.np.ndarray
    assert out.shape == tuple(ref.shape) == (N,)
    assert str(out.dtype) == str(ref.dtype) == dtype
    ok, msg = moments_ok(out.asnumpy(), mean, var, lo, hi)
    assert ok, msg


def test_random_structured_draws():
    with pmx.cpu():
        r = pmx.np.random
        r.seed(3)
        mv = r.multivariate_normal(pmx.np.array([1.0, -1.0]),
                                   pmx.np.array([[2.0, 0.5], [0.5, 1.0]]),
                                   size=(N,)).asnumpy()
        assert mv.shape == (N, 2) and mv.dtype == onp.float32
        onp.testing.assert_allclose(onp.cov(mv.T), [[2.0, 0.5], [0.5, 1.0]],
                                    atol=0.08)
        mn = r.multinomial(10, pmx.np.array([0.2, 0.3, 0.5]), size=(N,))
        assert mn.dtype == onp.float32 and mn.shape == (N, 3)
        assert (mn.asnumpy().sum(1) == 10).all()
        onp.testing.assert_allclose(mn.asnumpy().mean(0), [2, 3, 5],
                                    atol=0.1)
        c = r.choice(5, size=(N,)).asnumpy()
        assert c.dtype == onp.int32 and set(onp.unique(c)) == set(range(5))
        cp = r.choice(pmx.np.array([1.0, 2.0, 4.0]), size=(N,),
                      p=pmx.np.array([0.5, 0.25, 0.25])).asnumpy()
        assert abs((cp == 1.0).mean() - 0.5) < 0.02
        nr = r.choice(10, size=(10,), replace=False).asnumpy()
        assert sorted(nr) == list(range(10))
        p = r.permutation(7).asnumpy()
        assert sorted(p) == list(range(7)) and p.dtype == onp.int32
        x = pmx.np.array(onp.arange(8, dtype=onp.float32))
        assert r.shuffle(x) is None
        assert sorted(x.asnumpy()) == list(range(8))
        assert r.normal().shape == ()


def test_integer_draws_repeat_from_a_seed():
    with pmx.cpu():
        r = pmx.np.random
        outs = []
        for _ in range(2):
            r.seed(5)
            outs.append([r.randint(0, 100, size=(50,)).asnumpy(),
                         r.choice(30, size=(10,)).asnumpy(),
                         r.permutation(20).asnumpy()])
        for a, b in zip(*outs):
            onp.testing.assert_array_equal(a, b)


# npx names the case table leaves to tests/test_torch_npx.py (control
# flow, the switches, I/O, draws) or that are not functions of arrays
NPX_ELSEWHERE = {"cond", "foreach", "while_loop", "set_np", "reset_np",
                 "is_np_array", "is_np_shape", "np_array", "np_shape",
                 "use_np", "seed", "multinomial", "shuffle", "load", "save",
                 "waitall", "rnn", "multibox_detection", "cpu", "gpu",
                 "num_gpus", "current_context", "invoke"}


@pytest.mark.parametrize("path", ["np", "np.linalg", "npx"])
def test_case_table_covers_every_function(path):
    import inspect

    mod = pmx
    for part in path.split("."):
        mod = getattr(mod, part)
    covered = {c[1] for c in cases()}
    calls = [n for n in dir(mod) if not n.startswith("_") and
             callable(getattr(mod, n)) and
             not inspect.isclass(getattr(mod, n)) and
             not inspect.ismodule(getattr(mod, n))]
    missing = [n for n in calls if f"{path}.{n}" not in covered and
               not (path == "npx" and n in NPX_ELSEWHERE)]
    assert not missing, missing
