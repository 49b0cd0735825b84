"""``mx.npx`` of the port against the JAX package's: the nn ops of
``tests/_torch_np_cases.npx_cases`` name by name (values within 1e-5 of
the reference's largest magnitude, dtypes and shapes equal), control
flow (``foreach``, ``while_loop``, ``cond``), ``index_update``/
``index_add``, and the ``set_np`` switches."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_np_cases import compare, inputs, npx_cases
from _torch_parity import LazyReference
from test_torch_numpy import NPX_TOL, run_port, run_ref

rmx = LazyReference()

CASES = npx_cases(inputs())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_npx_op_matches_reference(case):
    ref = run_ref(case)
    got = run_port(case)
    ok, err, msg = compare(case, ref, got, NPX_TOL)
    assert ok, f"{case[0]}: {msg}"


def _both(fn):
    ref = fn(rmx, rmx.np.array)
    with pmx.cpu():
        got = fn(pmx, pmx.np.array)
    return ref, got


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    return out.asnumpy()


def test_foreach_scans_the_leading_axis():
    data = onp.arange(12, dtype=onp.float32).reshape(4, 3)

    def run(mx, arr):
        def body(x, states):
            s = states[0] + x
            return s * 2, [s]
        outs, states = mx.npx.foreach(body, arr(data),
                                      [arr(onp.zeros(3, onp.float32))])
        return outs, states

    ref, got = _both(run)
    assert type(got[0]) is pmx.np.ndarray
    onp.testing.assert_allclose(_np(got[0]), _np(ref[0]))
    onp.testing.assert_allclose(_np(got[1]), _np(ref[1]))


def test_while_loop_stops_at_its_predicate_and_the_cap():
    def run(mx, arr, cap):
        return mx.npx.while_loop(
            lambda vs: vs[0] < 10, lambda vs: [vs[0] + 3, vs[1] * 2],
            [arr(onp.asarray(1.0, onp.float32)),
             arr(onp.asarray([1.0, 2.0], onp.float32))],
            max_iterations=cap)

    for cap in (None, 2):
        ref, got = _both(lambda mx, arr: run(mx, arr, cap))
        assert type(got[0]) is pmx.np.ndarray
        for a, b in zip(got, ref):
            onp.testing.assert_allclose(a.asnumpy(), b.asnumpy())


def test_while_loop_refuses_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pmx.cpu():
        x = pmx.np.array([1.0])
        with pytest.raises(pmx.MXNetError, match="host"):
            pmx.npx.while_loop(lambda vs: vs[0] < 3,
                               lambda vs: [vs[0] + 1], [x])


def test_cond_takes_one_branch():
    for p in (True, False):
        def run(mx, arr):
            return mx.npx.cond(arr(onp.asarray(p)),
                               lambda vs: [vs[0] * 2, vs[1] + 1],
                               lambda vs: [vs[0] - 1, vs[1] * 3],
                               [arr(onp.asarray([1.0, 2.0], onp.float32)),
                                arr(onp.asarray([3.0], onp.float32))])
        ref, got = _both(run)
        for a, b in zip(got, ref):
            onp.testing.assert_allclose(a.asnumpy(), b.asnumpy())


def test_cond_under_a_capture_selects_on_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pmx.cpu():
        out = pmx.npx.cond(pmx.np.array(onp.asarray(False)),
                           lambda vs: vs[0] * 2, lambda vs: vs[0] - 1,
                           [pmx.np.array([1.0, 2.0])])
    onp.testing.assert_allclose(out.asnumpy(), [0.0, 1.0])


def test_index_update_and_index_add_are_functional():
    data = onp.zeros((3, 4), onp.float32)

    def run(mx, arr):
        x = arr(data)
        idx = (arr(onp.asarray([0, 2, 2])), arr(onp.asarray([1, 3, 3])))
        v = arr(onp.asarray([1.0, 2.0, 5.0], onp.float32))
        return mx.npx.index_update(x, idx, v), mx.npx.index_add(x, idx, v), x

    ref, got = _both(run)
    add_ref, add_got = ref[1].asnumpy(), got[1].asnumpy()
    onp.testing.assert_allclose(add_got, add_ref)
    assert add_got[2, 3] == 7.0
    # a repeated index's update keeps one of the values, as in JAX
    upd = got[0].asnumpy()
    assert upd[0, 1] == 1.0 and upd[2, 3] in (2.0, 5.0)
    onp.testing.assert_array_equal(got[2].asnumpy(), data)


def test_set_np_switches_default_array():
    with pmx.cpu():
        try:
            pmx.npx.set_np()
            assert pmx.npx.is_np_array() and pmx.util.is_np_shape()
            a = pmx.util.default_array([1.0, 2.0], ctx=pmx.cpu())
            assert type(a) is pmx.np.ndarray
            pmx.npx.reset_np()
            assert not pmx.npx.is_np_array()
            b = pmx.util.default_array([1.0, 2.0], ctx=pmx.cpu())
            assert type(b) is pmx.nd.NDArray
            with pmx.util.np_array(True):
                assert pmx.util.is_np_array()
            assert not pmx.util.is_np_array()

            @pmx.util.use_np
            def inner():
                return pmx.util.is_np_array()
            assert inner() and not pmx.util.is_np_array()
        finally:
            pmx.npx.reset_np()


def test_npx_nn_ops_record_and_reach_the_registry():
    with pmx.cpu():
        x = pmx.np.array(onp.linspace(-1, 1, 12, dtype=onp.float32)
                         .reshape(3, 4))
        w = pmx.np.array(onp.ones((2, 4), onp.float32))
        x.attach_grad()
        with pmx.autograd.record():
            y = pmx.np.sum(pmx.npx.fully_connected(x, w, num_hidden=2,
                                                   no_bias=True))
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), 2 * onp.ones((3, 4)))
        assert type(y) is pmx.np.ndarray


def test_multibox_detection_runs_the_port_op():
    rs = onp.random.RandomState(0)
    cls = rs.rand(1, 3, 8).astype(onp.float32)
    cls /= cls.sum(1, keepdims=True)
    loc = (rs.randn(1, 32) * 0.1).astype(onp.float32)
    anchors = onp.sort(rs.rand(1, 8, 4).astype(onp.float32), axis=-1)
    with pmx.cpu():
        out = pmx.npx.multibox_detection(pmx.np.array(cls),
                                         pmx.np.array(loc),
                                         pmx.np.array(anchors))
        ref = pmx.nd.MultiBoxDetection(pmx.nd.array(cls), pmx.nd.array(loc),
                                       pmx.nd.array(anchors))
    assert type(out) is pmx.np.ndarray
    onp.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())
