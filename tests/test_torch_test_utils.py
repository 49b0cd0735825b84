"""The port's ``mx.test_utils`` against ``mxnet_tpu``'s: every name of
the reference's module is exercised, on the CPU.

- ``default_rtol_atol`` gives the reference's tolerances for f16, f32
  and f64 (bf16 by its name, which numpy lacks);
  ``assert_almost_equal`` passes within them and fails past them;
  ``same``; ``rand_ndarray`` (shape, range, dtype, a sparse storage) and
  ``rand_shape_nd``.
- ``check_numeric_gradient`` on a function with a known gradient, and
  its failure on a wrong one; ``check_consistency`` over f32 and f64.
- ``with_seed`` (the same draws for the same seed, in numpy, ``random``
  and ``mx.random``; the seed printed on a failure) and ``environment``
  (set, unset and restored).
- ``check_symbolic_forward``/``check_symbolic_backward`` over the port's
  ``Executor`` on ``tests/test_symbol.py::_mlp``'s graph, against the
  numpy answer and the reference's, with arguments as a list and a dict.
"""
import os
import random

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference
from mxnet_tpu_torch import test_utils as tu

rmx = LazyReference()     # the JAX package, imported at first use

CPU = mx.cpu()


def test_the_reference_names_are_all_here():
    import mxnet_tpu.test_utils as rtu

    names = [n for n in vars(rtu) if not n.startswith("__")
             and not isinstance(getattr(rtu, n), type(os))]
    assert [n for n in names if not hasattr(tu, n)] == []


def test_tolerances_by_dtype():
    import mxnet_tpu.test_utils as rtu

    for dt in ("float16", "float32", "float64"):
        a = onp.zeros(1, dt)
        assert tu.default_rtol_atol(a) == rtu.default_rtol_atol(a)
    with CPU:
        b = mx.nd.zeros((2,), dtype="bfloat16")
    assert tu.default_rtol_atol(b) == (4e-2, 4e-2)
    assert tu.default_rtol_atol(onp.zeros(1, onp.int32)) == (1e-5, 1e-8)


def test_assert_almost_equal_and_same():
    with CPU:
        a = mx.nd.array([1.0, 2.0])
    tu.assert_almost_equal(a, [1.0, 2.0 + 1e-6])
    tu.assert_almost_equal(a, [1.1, 2.0], rtol=0.2, atol=0.0)
    with pytest.raises(AssertionError, match="x vs y"):
        tu.assert_almost_equal(a, [1.0, 2.1], names=("x", "y"))
    assert tu.same(a, onp.array([1.0, 2.0], onp.float32))
    assert not tu.same(a, [1.0, 2.5])


def test_random_arrays_and_shapes():
    onp.random.seed(4)
    with CPU:
        a = tu.rand_ndarray((3, 4))
        h = tu.rand_ndarray((2, 2), dtype="float64")
        s = tu.rand_ndarray((4, 3), stype="row_sparse")
    assert a.shape == (3, 4) and a.context == CPU
    assert -1 <= a.asnumpy().min() and a.asnumpy().max() <= 1
    assert h.dtype == onp.float32       # 64-bit arrays are 32-bit, as in
    assert s.stype == "row_sparse"      # the reference
    shape = tu.rand_shape_nd(3, dim=5)
    assert len(shape) == 3 and all(1 <= d <= 5 for d in shape)


def test_check_numeric_gradient():
    with CPU:
        tu.check_numeric_gradient(lambda x, y: (x * x * y).sum(),
                                  [onp.array([1.0, -2.0]),
                                   onp.array([0.5, 3.0])])
        with pytest.raises(AssertionError, match="numeric_grad"):
            tu.check_numeric_gradient(
                lambda x: mx.nd.BlockGrad(x * x).sum() + x.sum(),
                [onp.array([1.0, 2.0])])


def test_check_consistency():
    with CPU:
        tu.check_consistency(lambda x: x * 3.0 + 1.0,
                             [onp.array([1.0, 2.0])],
                             dtypes=("float32", "float64"))
        tu.check_consistency(lambda x: mx.nd.exp(x), [onp.array([0.5])],
                             dtypes=("float32", "bfloat16"))


def test_with_seed_reproduces_draws(capsys):
    draws = []

    @tu.with_seed(7)
    def draw():
        with CPU:
            x = mx.random.uniform(shape=(3,)).asnumpy()
        draws.append((onp.random.rand(), random.random(), x.tolist()))

    draw()
    draw()
    assert draws[0] == draws[1]

    @tu.with_seed(11)
    def broken():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        broken()
    assert "with_seed(11)" in capsys.readouterr().out


def test_environment_sets_and_restores(monkeypatch):
    monkeypatch.setenv("MXT_A", "old")
    monkeypatch.delenv("MXT_B", raising=False)
    with tu.environment({"MXT_A": "new", "MXT_B": 3}):
        assert os.environ["MXT_A"] == "new" and os.environ["MXT_B"] == "3"
        with tu.environment("MXT_A", None):
            assert "MXT_A" not in os.environ
        assert os.environ["MXT_A"] == "new"
    assert os.environ["MXT_A"] == "old" and "MXT_B" not in os.environ


def _mlp(pkg):
    s = pkg.sym if pkg is mx else pkg.symbol
    fc = s.FullyConnected(s.var("data"), s.var("w1"), s.var("b1"),
                          num_hidden=4, name="fc1")
    return s.Activation(fc, act_type="relu", name="relu1")


def test_check_symbolic_forward_and_backward():
    import mxnet_tpu.test_utils as rtu

    rs = onp.random.RandomState(6)
    x = rs.rand(2, 8).astype(onp.float32)
    w = rs.rand(4, 8).astype(onp.float32)
    b = rs.rand(4).astype(onp.float32)
    og = rs.rand(2, 4).astype(onp.float32)
    y = onp.maximum(x @ w.T + b, 0)
    active = (y > 0).astype(onp.float32) * og
    grads = {"data": active @ w, "w1": active.T @ x, "b1": active.sum(0)}
    outs = tu.check_symbolic_forward(_mlp(mx), [x, w, b], [y], ctx=CPU)
    assert outs[0].context == CPU
    got = tu.check_symbolic_backward(_mlp(mx), {"data": x, "w1": w,
                                                "b1": b}, [og], grads,
                                     ctx=CPU)
    assert sorted(got) == ["b1", "data", "w1"]
    rgot = rtu.check_symbolic_backward(_mlp(rmx), [x, w, b], og, grads)
    for k in grads:
        tu.assert_almost_equal(got[k], rgot[k].asnumpy())
    with pytest.raises(AssertionError):
        tu.check_symbolic_forward(_mlp(mx), [x, w, b], [y + 1.0], ctx=CPU)
    with pytest.raises(AssertionError, match="grad"):
        tu.check_symbolic_backward(_mlp(mx), [x, w, b], og,
                                   {"w1": grads["w1"] * 2}, ctx=CPU)
    with pytest.raises(AssertionError, match="expected"):
        tu.check_symbolic_forward(_mlp(mx), [x, w, b], [y, y], ctx=CPU)


def test_arrays_default_to_the_current_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        tu.rand_ndarray((2,))
    with CPU:
        assert tu.cpu() == CPU and tu.current_context() == CPU
