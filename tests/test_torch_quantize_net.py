"""``contrib.quantization.quantize_net`` of the port against the JAX
package's, on the same MLP and small CNN with the same weights and
calibration batches: equal calibrated ranges, equal int8 weights, equal
int32 accumulators, and outputs that agree to f32 rounding; entropy
mode, ``exclude_layers`` and ``num_calib_batches``."""
import numpy as onp
import pytest

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference

rmx = LazyReference()


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"),
            mx.gluon.nn.Dense(4, in_units=16))
    return net


def _cnn(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3,
                               activation="relu"),
            mx.gluon.nn.Conv2D(6, 1, in_channels=4),
            mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(5, in_units=6 * 8 * 8))
    return net


def _pair(build):
    """The same net in both packages, the port's carrying the reference's
    initial weights."""
    rnet = build(rmx)
    rnet.initialize(rmx.init.Xavier(magnitude=2.0))
    with pmx.cpu():
        pnet = build(pmx)
        pnet.initialize(pmx.init.Xavier(), ctx=pmx.cpu())
    for rp, pp in zip(rnet.collect_params().values(),
                      pnet.collect_params().values()):
        pp.set_data(pmx.nd.array(rp.data().asnumpy(), ctx=pmx.cpu()))
    return rnet, pnet


def _batches(shape, n, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(onp.float32) for _ in range(n)]


def _quantize(rnet, pnet, batches, **kw):
    rmx_q = rmx.contrib.quantization.quantize_net(
        rnet, calib_data=[rmx.nd.array(b) for b in batches], **kw)
    with pmx.cpu():
        pmx_q = pmx.contrib.quantization.quantize_net(
            pnet, calib_data=[pmx.nd.array(b) for b in batches], **kw)
    return rmx_q, pmx_q


def _layers(net, cls):
    return [b for b in net._children.values() if isinstance(b, cls)]


@pytest.mark.parametrize("build,shape", [(_mlp, (6, 8)),
                                         (_cnn, (2, 3, 8, 8))],
                         ids=["mlp", "cnn"])
def test_quantize_net_matches_reference(build, shape):
    rnet, pnet = _pair(build)
    batches = _batches(shape, 3)
    rq, pq = _quantize(rnet, pnet, batches)
    rQ = rmx.contrib.quantization
    pQ = pmx.contrib.quantization
    r_layers = _layers(rq, (rQ.QuantizedDense, rQ.QuantizedConv2D))
    p_layers = _layers(pq, (pQ.QuantizedDense, pQ.QuantizedConv2D))
    assert len(p_layers) == len(r_layers) == len(
        [b for b in pq._children.values()
         if not isinstance(b, pmx.gluon.nn.Flatten)])
    for r, p in zip(r_layers, p_layers):
        assert type(p).__name__ == type(r).__name__
        assert p._x_amax == pytest.approx(r._x_amax, rel=1e-6)
        onp.testing.assert_array_equal(p._qweight.asnumpy(),
                                       r._qweight.asnumpy())
    x = _batches(shape, 1, seed=9)[0]
    ref = rq(rmx.nd.array(x)).asnumpy()
    with pmx.cpu():
        got = pq(pmx.nd.array(x)).asnumpy()
    assert got.dtype == onp.float32
    scale = float(onp.abs(ref).max())
    assert float(onp.abs(got - ref).max()) <= 1e-5 * scale


def test_int32_accumulators_equal_the_reference():
    rnet, pnet = _pair(_cnn)
    batches = _batches((2, 3, 8, 8), 2)
    rq, pq = _quantize(rnet, pnet, batches)
    r0 = _layers(rq, rmx.contrib.quantization.QuantizedConv2D)[0]
    p0 = _layers(pq, pmx.contrib.quantization.QuantizedConv2D)[0]
    x = _batches((2, 3, 8, 8), 1, seed=5)[0]
    F = rmx.nd
    qx, _, _ = F._contrib_quantize_v2(F.array(x),
                                      min_calib_range=-r0._x_amax,
                                      max_calib_range=r0._x_amax)
    ref = F.quantized_conv_int8(qx, r0._qweight, stride=r0._stride,
                                pad=r0._pad, dilate=r0._dilate,
                                num_group=r0._groups).asnumpy()
    seen = []
    hook = p0.register_forward_pre_hook(lambda b, args: seen.append(args[0]))
    with pmx.cpu():
        pq(pmx.nd.array(x))
        hook.detach()
        P = pmx.nd
        pqx, _, _ = P._contrib_quantize_v2(P.NDArray(seen[0]),
                                           min_calib_range=-p0._x_amax,
                                           max_calib_range=p0._x_amax)
        got = P.quantized_conv_int8(pqx, p0._qweight, stride=p0._stride,
                                    pad=p0._pad, dilate=p0._dilate,
                                    num_group=p0._groups).asnumpy()
    assert got.dtype == onp.int32 and ref.dtype == onp.int32
    onp.testing.assert_array_equal(got, ref)


def test_entropy_mode_and_options():
    rnet, pnet = _pair(_mlp)
    batches = _batches((6, 8), 5)
    rq, pq = _quantize(rnet, pnet, batches, calib_mode="entropy",
                       num_calib_batches=2)
    r0 = _layers(rq, rmx.contrib.quantization.QuantizedDense)[0]
    p0 = _layers(pq, pmx.contrib.quantization.QuantizedDense)[0]
    # the first layer sees the batches themselves: the same histogram
    assert p0._x_amax == pytest.approx(r0._x_amax, rel=1e-6)
    assert p0._x_amax <= float(onp.abs(onp.stack(batches[:2])).max())
    with pmx.cpu():
        _, pnet2 = _pair(_mlp)
        first = list(pnet2._children.values())[0]
        pq2 = pmx.contrib.quantization.quantize_net(
            pnet2, calib_data=[pmx.nd.array(b) for b in batches],
            exclude_layers=[first.name], num_calib_batches=2)
    kids = list(pq2._children.values())
    assert isinstance(kids[0], pmx.gluon.nn.Dense)
    assert isinstance(kids[1], pmx.contrib.quantization.QuantizedDense)
    with pytest.raises(pmx.MXNetError):
        pmx.contrib.quantization.quantize_net(pnet2, calib_data=None)
    with pytest.raises(pmx.MXNetError):
        pmx.contrib.quantization.LayerOutputCollector(mode="nope")


def test_hybridized_net_calibrates_imperatively():
    with pmx.cpu():
        net = _mlp(pmx)
        net.initialize(pmx.init.Xavier(), ctx=pmx.cpu())
        net.hybridize()
        x = pmx.nd.array(_batches((6, 8), 1)[0])
        before = net(x).asnumpy()
        pmx.contrib.quantization.quantize_net(net, calib_data=[x])
        assert net._active and net._cached_op is None
        after = net(x).asnumpy()
    assert float(onp.abs(after - before).max()) <= \
        0.05 * float(onp.abs(before).max())


@pytest.mark.parametrize("bins,power", [(601, 1), (2001, 2)])
def test_kl_threshold_equals_reference(bins, power):
    """The entropy collector's threshold search (prefix sums in place of
    the reference's loop over quantized bins) gives the reference's
    threshold exactly on integer-count histograms."""
    from mxnet_tpu.ops.quantization import optimal_threshold_kl as ref
    from mxnet_tpu_torch.ops.quantization import optimal_threshold_kl

    rs = onp.random.RandomState(bins)
    x = rs.standard_normal(20000)
    x = onp.abs(x) ** power * onp.sign(x)
    amax = float(onp.abs(x).max())
    hist, edges = onp.histogram(x, bins=bins,
                                range=(-amax - 1e-12, amax + 1e-12))
    hist = hist.astype(onp.float64)
    assert optimal_threshold_kl(hist, edges) == ref(hist, edges)
