"""The autograd cases of ``tests/test_autograd.py`` run on both packages:
``mxnet_tpu`` (the reference's tape of ``jax.vjp`` closures) and
``mxnet_tpu_torch`` (``torch.autograd`` underneath, arrays on the host).
Each case holds both to the same expected values; float32 on the CPU,
within 1e-6 relative (1e-5 where a transcendental is involved)."""
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx


def close(a, b, rtol=1e-6, atol=1e-7):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    onp.testing.assert_allclose(a, onp.asarray(b, onp.float32), rtol=rtol,
                                atol=atol)


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """(package, its MXNetError); the port's arrays live on the host."""
    if request.param == "reference":
        yield rmx, rmx.MXNetError
        return
    with mx.cpu():
        yield mx, mx.MXNetError


def test_record_flags(pkg):
    m, _ = pkg
    ag = m.autograd
    assert not ag.is_recording()
    with ag.record():
        assert ag.is_recording()
        assert ag.is_training()
        with ag.pause():
            assert not ag.is_recording()
        with ag.predict_mode():
            assert ag.is_recording()
            assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training()
    assert not ag.is_recording()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True
    assert ag.set_training(True) is False
    assert ag.set_training(False) is True


def test_basic_backward(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x + 2 * x
    y.backward()                    # head gradient of ones, shape (3,)
    close(x.grad, 2 * x.asnumpy() + 2)


def test_head_gradient(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * 3
    y.backward(m.nd.array([2.0, 4.0]))
    close(x.grad, [6.0, 12.0])


def test_grad_req_add(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with m.autograd.record():
            y = x * 2
        y.backward()
    close(x.grad, [4.0, 4.0])


def test_grad_req_write_overwrites(pkg):
    m, _ = pkg
    x = m.nd.array([1.0])
    x.attach_grad()
    g = x.grad                      # the handle persists across backwards
    with m.autograd.record():
        y = x * 2
    y.backward()
    with m.autograd.record():
        y = x * 5
    y.backward()
    close(x.grad, [5.0])
    close(g, [5.0])


def test_grad_req_null(pkg):
    m, _ = pkg
    x = m.nd.array([1.0])
    x.attach_grad(grad_req="null")
    w = m.nd.array([2.0])
    w.attach_grad()
    with m.autograd.record():
        y = x * w
    y.backward()
    close(w.grad, [1.0])
    close(x.grad, [0.0])


def test_multi_path_accumulation(pkg):
    m, _ = pkg
    x = m.nd.array([2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x + x * 3           # dy/dx = 2x + 3 = 7
    y.backward()
    close(x.grad, [7.0])


def test_detach(pkg):
    m, _ = pkg
    x = m.nd.array([2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
        z = y.detach() * x          # z = const(4) * x
    z.backward()
    close(x.grad, [4.0])


def test_autograd_grad_api(pkg):
    m, _ = pkg
    x = m.nd.array([3.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
    (gx,) = m.autograd.grad(y, [x])
    close(gx, [6.0])
    close(x.grad, [0.0])            # .grad untouched


def test_grad_wrt_intermediate(pkg):
    m, _ = pkg
    x = m.nd.array([2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
        z = y * y                   # dz/dy = 2y = 8
    (gy,) = m.autograd.grad(z, [y])
    close(gy, [8.0])


def test_grad_create_graph_raises(pkg):
    m, err = pkg
    x = m.nd.array([3.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
    with pytest.raises(err):
        m.autograd.grad(y, [x], create_graph=True)
    with pytest.raises(err):
        m.autograd.get_symbol(y)


def test_backward_twice_raises_without_retain(pkg):
    m, err = pkg
    x = m.nd.array([1.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x * x
    y.backward()
    with pytest.raises(err):
        y.backward()


def test_freed_array_enters_later_ops_as_constant(pkg):
    m, _ = pkg
    x = m.nd.array([3.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
    y.backward()
    with m.autograd.record():
        z = y * x                   # y's graph is gone: d/dx = y = 9
    z.backward()
    close(x.grad, [9.0])


def test_freed_intermediate_enters_later_ops_as_constant(pkg):
    m, err = pkg
    x = m.nd.array([3.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * x
        w = y * x
    w.backward()                    # frees w's graph, y's node with it
    with m.autograd.record():
        z = y * x                   # y enters as the constant 9
    z.backward()
    close(x.grad, [9.0])
    with pytest.raises(err):
        y.backward()


def test_retain_graph(pkg):
    m, _ = pkg
    x = m.nd.array([2.0])
    x.attach_grad(grad_req="add")
    with m.autograd.record():
        y = x * x
    y.backward(retain_graph=True)
    y.backward()
    close(x.grad, [8.0])


def test_training_flag(pkg):
    m, _ = pkg
    with m.autograd.record(train_mode=True):
        assert m.autograd.is_training()
    with m.autograd.record(train_mode=False):
        assert not m.autograd.is_training()


def test_mark_variables(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    g = m.nd.zeros((2,))
    m.autograd.mark_variables(x, g)
    with m.autograd.record():
        y = (x * 4).sum()
    y.backward()
    close(x.grad, [4.0, 4.0])


def test_mark_variables_add(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    g = m.nd.array([1.0, 1.0])
    m.autograd.mark_variables([x], [g], grad_reqs="add")
    with m.autograd.record():
        y = (x * x).sum()
    y.backward()
    close(x.grad, [3.0, 5.0])


def test_custom_function(pkg):
    m, _ = pkg

    class MySigmoid(m.autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + m.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    f = MySigmoid()
    x = m.nd.array([0.0, 1.0, -1.0])
    x.attach_grad()
    with m.autograd.record():
        y = f(x)
    y.backward()
    s = 1 / (1 + onp.exp(-x.asnumpy()))
    close(y, s, rtol=1e-5)
    close(x.grad, s * (1 - s), rtol=1e-5, atol=1e-6)


def test_custom_function_two_inputs(pkg):
    m, _ = pkg

    class Scaled(m.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b

        def backward(self, dy):
            a, b = self.saved_tensors
            return dy * b, dy * a * 10      # a deliberately wrong rule

    a, b = m.nd.array([2.0, 3.0]), m.nd.array([5.0, 7.0])
    a.attach_grad()
    b.attach_grad()
    with m.autograd.record():
        y = Scaled()(a, b)
    y.backward(m.nd.array([1.0, 2.0]))
    close(a.grad, [5.0, 14.0])
    close(b.grad, [20.0, 60.0])      # the user's rule, not the true one


def test_inplace_rebind_grad(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * 2
        y += 1                      # rebind; grad still flows through mul
        z = y.sum()
    z.backward()
    close(x.grad, [2.0, 2.0])


def test_update_outside_record_keeps_variable(pkg):
    """``w -= lr * w.grad`` outside ``record()`` rebinds ``w``; it stays a
    variable, and the next backward writes the new gradient."""
    m, _ = pkg
    w = m.nd.array([1.0, -2.0])
    w.attach_grad()
    for _ in range(3):
        with m.autograd.record():
            loss = (w * w).sum()
        loss.backward()
        w -= 0.25 * w.grad
    close(w, [0.125, -0.25])
    close(w.grad, [0.5, -1.0])


def test_ops_outside_record_stay_off_the_tape(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 3.0])
    x.attach_grad()
    y = x * 2                       # not recorded: a constant below
    with m.autograd.record():
        z = (y * x).sum()
        with m.autograd.pause():
            c = x * 100             # paused: a constant too
        w = (c * x).sum()
    z.backward()
    close(x.grad, y.asnumpy())
    w.backward()
    close(x.grad, c.asnumpy())


def test_setitem_inside_record_raises(pkg):
    m, err = pkg
    x = m.nd.array([1.0, 2.0])
    x.attach_grad()
    with m.autograd.record():
        y = x * 2
        with pytest.raises(err):
            y[0] = 5.0


def test_multi_output_op_grad(pkg):
    m, _ = pkg
    x = m.nd.array(onp.arange(6, dtype="float32").reshape(2, 3))
    x.attach_grad()
    with m.autograd.record():
        parts = m.nd.split(x, num_outputs=3, axis=1)
        z = (parts[0] * 1 + parts[2] * 3).sum()
    z.backward()
    close(x.grad, [[1, 0, 3], [1, 0, 3]])


def test_backward_of_several_heads(pkg):
    m, _ = pkg
    x = m.nd.array([1.0, 2.0])
    x.attach_grad()
    with m.autograd.record():
        a = x * 3
        b = x * x
    m.autograd.backward([a, b], [m.nd.array([1.0, 1.0]),
                                 m.nd.array([2.0, 0.5])])
    close(x.grad, [3 + 4.0, 3 + 2.0])


def test_port_builds_on_torch_autograd():
    """The port's graph is torch's: a recorded output carries a
    ``grad_fn``, a variable is a leaf that requires a gradient, and an op
    outside ``record()`` builds no graph even from a variable."""
    with mx.cpu():
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        assert x.astorch().is_leaf and x.astorch().requires_grad
        with mx.autograd.record():
            y = x * x
        assert y.astorch().grad_fn is not None
        assert (x * x).astorch().grad_fn is None
        y.backward()
        assert x.astorch().grad is None     # handed to x.grad by the hook
        close(x.grad, [2.0, 4.0])
