"""``mx.operator`` custom ops: the ``CustomOp`` cases of
``tests/test_quantization_onnx_custom.py`` (``TestCustomOp``) on both
packages, and the port's allocation of ``out_data``/``in_grad`` on the
inputs' device and dtype.  Float32 on the CPU, tolerances as in the
reference test (1e-6 forward, 1e-5 gradients)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import need_cuda


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """(package, its MXNetError); the port's arrays live on the host.  The
    JAX package is imported here, not at the top: the ``cuda`` test below
    runs where there is no JAX."""
    if request.param == "reference":
        import mxnet_tpu as rmx
        yield rmx, rmx.MXNetError
        return
    with mx.cpu():
        yield mx, mx.MXNetError


def _register_sigmoid(m, name):
    @m.operator.register(name)
    class P(m.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class O(m.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0],
                                1.0 / (1.0 + (-x).exp()))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    y = out_data[0]
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * y * (1 - y))
            return O()
    return P


def _register_double(m, name):
    @m.operator.register(name)
    class P(m.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class O(m.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2)
            return O()
    return P


def test_forward_backward(pkg):
    m, _ = pkg
    _register_sigmoid(m, "tt_sigmoid")
    x = m.nd.array(onp.array([0.0, 1.0, -1.0], onp.float32))
    x.attach_grad()
    with m.autograd.record():
        y = m.nd.Custom(x, op_type="tt_sigmoid")
    y.backward(m.nd.ones(3))
    sig = 1 / (1 + onp.exp(-x.asnumpy()))
    onp.testing.assert_allclose(y.asnumpy(), sig, rtol=1e-6)
    onp.testing.assert_allclose(x.grad.asnumpy(), sig * (1 - sig),
                                rtol=1e-5)


def test_unregistered_raises(pkg):
    m, err = pkg
    with pytest.raises(err):
        m.nd.Custom(m.nd.ones(2), op_type="tt_nope")


def test_grad_req_add(pkg):
    m, _ = pkg
    _register_double(m, "tt_double")
    x = m.nd.ones(3)
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with m.autograd.record():
            y = m.nd.Custom(x, op_type="tt_double")
        y.backward(m.nd.ones(3))
    onp.testing.assert_allclose(x.grad.asnumpy(), onp.full(3, 4.0))


def test_outside_record_no_tape(pkg):
    m, _ = pkg
    _register_double(m, "tt_double2")
    x = m.nd.array([1.0, 2.0])
    x.attach_grad()
    y = m.nd.Custom(x, op_type="tt_double2")
    onp.testing.assert_allclose(y.asnumpy(), [2.0, 4.0])
    with m.autograd.record():
        z = (y * x).sum()           # y is a constant
    z.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0])


def test_assign_honours_req(pkg):
    m, _ = pkg
    op = m.operator.CustomOp()
    dst = m.nd.array([1.0, 2.0])
    op.assign(dst, "null", m.nd.array([5.0, 5.0]))
    onp.testing.assert_allclose(dst.asnumpy(), [1.0, 2.0])
    op.assign(dst, "add", m.nd.array([5.0, 5.0]))
    onp.testing.assert_allclose(dst.asnumpy(), [6.0, 7.0])
    op.assign(dst, "write", m.nd.array([0.5, 0.5]))
    onp.testing.assert_allclose(dst.asnumpy(), [0.5, 0.5])


def test_get_all_registered(pkg):
    m, _ = pkg
    prop = _register_double(m, "tt_listed")
    assert m.operator.get_all_registered()["tt_listed"] is prop


def test_register_needs_a_prop(pkg):
    m, err = pkg
    with pytest.raises(err):
        m.operator.register("tt_bad")(object)


def test_backward_frees_the_custom_ops_buffers():
    """A non-retaining backward releases what the custom op kept for its
    backward (here its input, an intermediate) while the head lives on,
    as the reference drops its tape node's closure, and dropping the
    output then frees ``out_data``; both by reference counting alone,
    with the cyclic collector off.  With ``retain_graph=True`` a second
    backward still runs."""
    import gc
    import weakref

    _register_double(mx, "tt_double_free")
    gc.collect()
    gc.disable()
    try:
        with mx.cpu():
            x = mx.nd.array([1.0, 2.0])
            x.attach_grad(grad_req="add")
            for retain in (True, False):
                with mx.autograd.record():
                    h = x * 3
                    y = mx.nd.Custom(h, op_type="tt_double_free")
                    loss = y.sum()
                alive = weakref.ref(h.astorch())
                out = weakref.ref(y.astorch())
                del h, y
                loss.backward(retain_graph=retain)
                assert (alive() is not None) == retain
                if retain:
                    loss.backward()
                else:
                    assert out() is None
            with pytest.raises(mx.MXNetError):
                loss.backward()
    finally:
        gc.enable()
    onp.testing.assert_allclose(x.grad.asnumpy(), [18.0, 18.0])


# --------------------------------------------------------------------------- #
# the port's allocation: on the inputs' device, in their dtypes
# --------------------------------------------------------------------------- #

class _Seen:
    arrays = {}


@mx.operator.register("tt_probe")
class _ProbeProp(mx.operator.CustomOpProp):
    def list_arguments(self):
        return ["a", "b"]

    def list_auxiliary_states(self):
        return ["state"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], [in_shape[0]]

    def create_operator(self, ctx, in_shapes, in_dtypes):
        _Seen.arrays["ctx"] = ctx

        class O(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                _Seen.arrays.update(out=out_data[0], aux=aux[0])
                self.assign(out_data[0], req[0], in_data[0] * 3)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                _Seen.arrays.update(in_grad=list(in_grad))
                self.assign(in_grad[0], req[0], out_grad[0] * 3)
        return O()


def _probe(device, dtypes):
    a = mx.nd.from_torch(torch.ones(2, 3, dtype=dtypes[0], device=device))
    b = mx.nd.from_torch(torch.ones(2, 3, dtype=dtypes[1], device=device))
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(a, b, op_type="tt_probe")
    y.backward()
    return a, y


def test_allocation_ignores_the_default_context(monkeypatch):
    """``out_data``, ``aux`` and ``in_grad`` never ask for the default
    context (here: one that raises), and take each input's dtype."""
    def no_default(cls):
        raise AssertionError("Custom allocated on the default context")

    monkeypatch.setattr(mx.context.Context, "default_ctx",
                        classmethod(no_default))
    a, y = _probe("cpu", (torch.bfloat16, torch.float64))
    seen = _Seen.arrays
    assert seen["ctx"] == mx.cpu()
    assert seen["out"].astorch().dtype == torch.bfloat16
    assert seen["aux"].astorch().dtype == torch.bfloat16
    assert [g.astorch().dtype for g in seen["in_grad"]] == \
        [torch.bfloat16, torch.float64]
    assert y.astorch().dtype == torch.bfloat16
    onp.testing.assert_allclose(a.grad.asnumpy(), onp.full((2, 3), 3.0))


@pytest.mark.cuda
def test_allocation_on_the_card_under_a_cpu_scope():
    need_cuda()
    with mx.cpu():
        a, y = _probe("cuda", (torch.float32, torch.float32))
    seen = _Seen.arrays
    assert seen["ctx"] == mx.gpu(0)
    for arr in [seen["out"], seen["aux"], *seen["in_grad"], y, a.grad]:
        assert arr.astorch().is_cuda
    onp.testing.assert_allclose(a.grad.asnumpy(), onp.full((2, 3), 3.0))
