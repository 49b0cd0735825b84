"""The fifth slice as a whole at a small size: an MLP block whose GELU is
the ``rtc_gelu`` custom op, trained three SGD steps through ``mx.nd``,
``autograd.record()``, ``backward()`` and in-place ``NDArray`` updates.

Reference: ``mxnet_tpu`` with an ``rtc_gelu`` ``CustomOp`` whose forward
and backward launch ``mxnet_tpu.rtc.PallasModule`` GELU kernels (interpret
mode on the CPU).  Port: ``mxnet_tpu_torch`` with ``_torch_rtc_sources``'s
``RtcGelu`` on a CPU context, which takes the plain GELU (on the card the
same op launches the NVRTC kernels; ``chip_smoke.py`` drives that at
GPT-2-small width).  The weights are carried from the reference to the
port with ``nd.save``/``nd.load`` and back after training.

Tolerances (f32 on the CPU; the packages sum in other orders): losses
within 1e-5, weights within 5e-5.
"""
import jax.numpy as jnp
import numpy as onp
import pytest

import _torch_rtc_sources as S
import mxnet_tpu as rmx
import mxnet_tpu_torch as mx

ROWS, UNITS, HIDDEN, STEPS, LR = 16, 8, 32, 3, 0.5


def _gelu_fwd_kernel(x_ref, o_ref):
    x = x_ref[...].astype(jnp.float32)
    y = 0.5 * x * (1.0 + jnp.tanh(S.GELU_K0 * (x + S.GELU_K1 * x * x * x)))
    o_ref[...] = y.astype(o_ref.dtype)


def _gelu_bwd_kernel(x_ref, dy_ref, o_ref):
    x = x_ref[...].astype(jnp.float32)
    x2 = x * x
    t = jnp.tanh(S.GELU_K0 * (x + S.GELU_K1 * x2 * x))
    g = 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * S.GELU_K0 * (
        1.0 + 3.0 * S.GELU_K1 * x2)
    o_ref[...] = (dy_ref[...].astype(jnp.float32) * g).astype(o_ref.dtype)


class _RefGelu:
    """The reference's rtc_gelu: each pass launches one Pallas kernel."""

    def __init__(self):
        mod = rmx.rtc.PallasModule({"gelu_fwd": _gelu_fwd_kernel,
                                    "gelu_bwd": _gelu_bwd_kernel})
        self.fwd = mod.get_kernel("gelu_fwd", S.SIGNATURES["gelu_fwd"])
        self.bwd = mod.get_kernel("gelu_bwd", S.SIGNATURES["gelu_bwd"])
        self.launches = 0
        owner = self

        class GeluOp(rmx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                owner.launches += 1
                self.assign(out_data[0], req[0], owner.fwd([in_data[0]]))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                owner.launches += 1
                self.assign(in_grad[0], req[0],
                            owner.bwd([in_data[0], out_grad[0]]))

        @rmx.operator.register("rtc_gelu_ref")
        class GeluProp(rmx.operator.CustomOpProp):
            def create_operator(self, ctx, in_shapes, in_dtypes):
                return GeluOp()


def _train(m, params, op_type):
    """Three SGD steps of the MLP block; returns the losses."""
    w1, b1, w2, b2, x, t = (params[k] for k in
                            ("w1", "b1", "w2", "b2", "x", "t"))
    for p in (w1, b1, w2, b2):
        p.attach_grad()
    losses = []
    for _ in range(STEPS):
        with m.autograd.record():
            h = m.nd.dot(x, w1) + b1
            a = m.nd.Custom(h, op_type=op_type)
            y = m.nd.dot(a, w2) + b2
            loss = m.nd.mean(m.nd.square(y - t))
        loss.backward()
        for p in (w1, b1, w2, b2):
            p -= LR * p.grad
        losses.append(float(loss.asnumpy()[0]))
    return losses


@pytest.fixture(scope="module")
def port_gelu():
    return S.RtcGelu(mx, op_type="rtc_gelu_port").register()


def test_imperative_mlp_matches_reference(tmp_path, port_gelu):
    rs = onp.random.RandomState(0)
    init = {"w1": rs.normal(0, 0.5, (UNITS, HIDDEN)),
            "b1": rs.normal(0, 0.1, (HIDDEN,)),
            "w2": rs.normal(0, 0.5, (HIDDEN, UNITS)),
            "b2": onp.zeros(UNITS),
            "x": rs.normal(0, 1.0, (ROWS, UNITS)),
            "t": rs.normal(0, 1.0, (ROWS, UNITS))}
    init = {k: v.astype(onp.float32) for k, v in init.items()}
    ref = {k: rmx.nd.array(v) for k, v in init.items()}
    path = str(tmp_path / "mlp.params")
    rmx.nd.save(path, ref)
    port = mx.nd.load(path, ctx=mx.cpu())    # carried across, on the host
    assert all(port[k].context == mx.cpu() for k in port)

    ref_gelu = _RefGelu()
    ref_losses = _train(rmx, ref, "rtc_gelu_ref")
    with mx.cpu():
        port_losses = _train(mx, port, "rtc_gelu_port")
    assert ref_gelu.launches == 2 * STEPS
    assert port_gelu.launches() == 0         # the CPU branch: plain GELU
    onp.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5,
                                atol=1e-5)
    assert port_losses[-1] < port_losses[0]
    back = str(tmp_path / "trained.params")
    mx.nd.save(back, port)
    for k, v in rmx.nd.load(back).items():
        onp.testing.assert_allclose(v.asnumpy(), ref[k].asnumpy(),
                                    rtol=5e-5, atol=5e-5)


def test_plain_gelu_matches_the_reference_kernels():
    """The plain versions of ``gelu_fwd``/``gelu_bwd`` against the
    reference's Pallas kernels (interpret mode), f32 within 1e-5: XLA's
    tanh and torch's differ by ulps, which ``1 - t * t`` magnifies."""
    import torch

    rs = onp.random.RandomState(1)
    x = rs.normal(0, 2.0, (8, 128)).astype(onp.float32)
    dy = rs.normal(0, 1.0, (8, 128)).astype(onp.float32)
    mod = rmx.rtc.PallasModule({"f": _gelu_fwd_kernel,
                                "b": _gelu_bwd_kernel})
    ry = mod.get_kernel("f")([rmx.nd.array(x)]).asnumpy()
    rdx = mod.get_kernel("b")([rmx.nd.array(x), rmx.nd.array(dy)]).asnumpy()
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    onp.testing.assert_allclose(S.gelu_fwd_plain(tx).numpy(), ry,
                                rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(S.gelu_bwd_plain(tx, tdy).numpy(), rdx,
                                rtol=1e-5, atol=1e-5)
    # and the reference framework's own GELU (tanh approximation)
    onp.testing.assert_allclose(
        S.gelu_fwd_plain(tx).numpy(),
        rmx.nd.Activation(rmx.nd.array(x), act_type="gelu").asnumpy(),
        rtol=1e-5, atol=1e-6)
