"""The int8 quantization ops of the port (``ops/quantization.py``) against
the JAX package's, on the CPU, through ``mx.nd`` and ``mx.nd.contrib``.

Tolerances: every int result exact (the codes, the int32 products);
the ranges and dequantized values exact too, since both packages take
the same f32 steps (``127 / amax``, ``amax / 127``); the KL threshold
equal.  The int8 products are taken where ``K * 127**2`` passes 2**24,
so an f32 sum would round and only an exact int32 (here f64) one
agrees.
"""
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import quantization as rq
from mxnet_tpu_torch.ops import quantization as pq


def _both(fn_ref, fn_port, arrays, kwargs):
    ref = fn_ref(*[rmx.nd.array(a, dtype=a.dtype) for a in arrays], **kwargs)
    with mx.cpu():
        got = fn_port(*[mx.nd.array(a, dtype=a.dtype) for a in arrays],
                      **kwargs)
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r, g = r.asnumpy(), g.asnumpy()
        assert r.dtype == g.dtype and r.shape == g.shape, (r.dtype, g.dtype)
        onp.testing.assert_array_equal(g, r)
    return [g.asnumpy() for g in got]


@pytest.mark.parametrize("calib", [None, (-2.5, 1.75), (-0.3, 0.2)])
def test_quantize_dequantize(calib):
    x = onp.random.RandomState(0).standard_normal((6, 33)).astype(
        onp.float32)
    x[0, :4] = [0.5 / 127 * 1.7, -0.5 / 127 * 1.7, 0.0, -0.0]   # ties
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    q, lo, hi = _both(rmx.nd.contrib.quantize_v2, mx.nd.contrib.quantize_v2,
                      [x], kw)
    assert q.dtype == onp.int8 and abs(q).max() <= 127
    _both(rmx.nd.contrib.dequantize, mx.nd.contrib.dequantize,
          [q, lo, hi], {})


@pytest.mark.parametrize("calib", [None, (-40.0, 35.0)])
def test_requantize(calib):
    acc = onp.random.RandomState(1).randint(-2 ** 22, 2 ** 22,
                                            (5, 17)).astype(onp.int32)
    rng = onp.array([-3.1], onp.float32), onp.array([2.9], onp.float32)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    q, lo, hi = _both(rmx.nd.contrib.requantize, mx.nd.contrib.requantize,
                      [acc, *rng], kw)
    assert q.dtype == onp.int8


def _int8(seed, shape):
    return onp.random.RandomState(seed).randint(-127, 128, shape).astype(
        onp.int8)


@pytest.mark.parametrize("k,transpose", [(2048, False), (1536, True),
                                         (7, False)])
def test_quantized_matmul_int32_exact(k, transpose):
    """K = 2048: K * 127**2 = 3.3e7 > 2**24 (an f32 sum would round)."""
    a = _int8(2, (3, 5, k))
    b = _int8(3, (9, k) if transpose else (k, 9))
    a[0, 0] = 127
    b[...] = onp.where(onp.arange(b.size).reshape(b.shape) % 3 == 0, 127,
                       b)
    got = _both(rmx.nd.quantized_matmul_int8, mx.nd.quantized_matmul_int8,
                [a, b], dict(transpose_b=transpose))[0]
    assert got.dtype == onp.int32
    want = onp.tensordot(a.astype(onp.int64),
                         (b.T if transpose else b).astype(onp.int64), 1)
    onp.testing.assert_array_equal(got, want)
    if k == 2048:
        assert abs(want).max() > 2 ** 24


@pytest.mark.parametrize("kw", [
    dict(), dict(stride=(2, 1), pad=(1, 2)), dict(dilate=(2, 2), pad=(2, 2)),
    dict(num_group=2, pad=(1, 1))])
def test_quantized_conv_int32_exact(kw):
    """Ci * 3 * 3 = 1152: K * 127**2 = 1.9e7 > 2**24."""
    groups = kw.get("num_group", 1)
    x = _int8(4, (2, 128, 9, 8))
    w = _int8(5, (6, 128 // groups, 3, 3))
    x[...] = onp.where(x > 60, 127, x)
    w[...] = onp.where(w > 60, 127, w)
    got = _both(rmx.nd.quantized_conv_int8, mx.nd.quantized_conv_int8,
                [x, w], kw)[0]
    assert got.dtype == onp.int32


def test_optimal_threshold_kl_equals_reference():
    rs = onp.random.RandomState(6)
    data = onp.concatenate([rs.standard_normal(20000),
                            rs.standard_normal(300) * 6])
    hist, edges = onp.histogram(data, bins=2001, range=(-8, 8))
    assert pq.optimal_threshold_kl(hist, edges) == \
        rq.optimal_threshold_kl(hist, edges)
    assert pq.optimal_threshold_kl(onp.zeros(601), onp.linspace(-3, 3, 602)) \
        == rq.optimal_threshold_kl(onp.zeros(601), onp.linspace(-3, 3, 602))


def test_round_trip_through_a_quantized_layer():
    """quantize -> int8 matmul -> requantize -> dequantize of both packages
    bit for bit (the reference test's calibrated FC chain)."""
    rs = onp.random.RandomState(8)
    x = rs.standard_normal((4, 64)).astype(onp.float32)
    w = rs.standard_normal((64, 16)).astype(onp.float32)

    def chain(pkg):
        nd = pkg.nd
        qx, xl, xh = nd.contrib.quantize_v2(nd.array(x))
        qw, wl, wh = nd.contrib.quantize_v2(nd.array(w))
        acc = nd.quantized_matmul_int8(qx, qw)
        amax = nd.array(onp.array([float(xh.asnumpy()[0]) *
                                   float(wh.asnumpy()[0])], onp.float32))
        q, lo, hi = nd.contrib.requantize(acc, -amax, amax)
        return nd.contrib.dequantize(q, lo, hi).asnumpy()

    ref = chain(rmx)
    with mx.cpu():
        got = chain(mx)
    onp.testing.assert_array_equal(got, ref)
    onp.testing.assert_allclose(got, x @ w, rtol=0.1, atol=0.5)
