"""The parity faults F1–F9 (ROADMAP §3), each held against the JAX
package on the inputs that found it, and the reference's integer
``power`` to a negative exponent, held to the port's own answer.

Each case runs both packages on the same NumPy inputs (the port with
``ctx=mx.cpu()``); integer, boolean and dtype results must be equal, and
floats within 1e-5 where a factorisation sums in another order.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference

rmx = LazyReference()

CAST_IN = onp.array([1.7, -1.7, 3e10, onp.nan, -1.0, 256.0, 300.5],
                    onp.float32)
DIV_A = onp.array([7, -7, 5, 0], onp.int32)
DIV_B = onp.array([0, 2, 0, 0], onp.int32)
HIST_IN = onp.array([2, -3, -5, -5, -1, 0, 0, 1, 3, -1, -4, -1], onp.int32)
NONSYM = onp.array([[1, 2, 0, 3], [4, 1, 2, 0], [0, 5, 1, 1],
                    [2, 0, 3, 1]], onp.int32)
SPD = onp.array([[4, 1, 0, 0], [1, 3, 1, 0], [0, 1, 2, 1], [0, 0, 1, 5]],
                onp.float32)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return onp.asarray(x.asnumpy()) if hasattr(x, "asnumpy") else \
        onp.asarray(x)


def both(fn):
    """``fn(mx)`` in the reference, then in the port on the CPU."""
    ref = _host(fn(rmx))
    with pmx.cpu():
        got = _host(fn(pmx))
    return ref, got


def assert_same(ref, got):
    if isinstance(ref, list):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_same(r, g)
        return
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    onp.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
@pytest.mark.parametrize("how", ["np_astype", "nd_astype", "nd_cast"])
def test_f1_float_to_int_casts_saturate(dtype, how):
    """F1: truncate, NaN to 0, out of range to the nearest end (XLA's
    convert); torch's ``to`` wraps."""
    def run(mx):
        if how == "np_astype":
            return mx.np.array(CAST_IN).astype(dtype)
        x = mx.nd.array(CAST_IN)
        return x.astype(dtype) if how == "nd_astype" else \
            mx.nd.cast(x, dtype=dtype)
    ref, got = both(run)
    assert_same(ref, got)


def test_f1_int64_cast_saturates_at_its_own_range():
    """The reference has no int64 (JAX without 64-bit types); the port's
    ``mx.nd`` int64 cast follows the same rule at int64's ends."""
    x = onp.array([1.7, -1.7, 3e10, onp.nan, 1e19, -1e19, onp.inf],
                  onp.float32)
    with pmx.cpu():
        got = pmx.nd.cast(pmx.nd.array(x), dtype="int64").asnumpy()
    i = onp.iinfo(onp.int64)
    onp.testing.assert_array_equal(
        got, onp.array([1, -1, 30000001024, 0, i.max, i.min, i.max]))
    from mxnet_tpu_torch.ops.defs import convert
    t = torch.tensor([0.5, 2.0 ** 31, -2.0 ** 31 - 512.0, 127.9],
                     dtype=torch.float32)
    assert convert(t, torch.int32).tolist() == [0, 2 ** 31 - 1, -2 ** 31,
                                                127]
    assert convert(t.to(torch.float16)[3:], torch.int8).tolist() == [127]


@pytest.mark.parametrize("axis,idx", [(None, [-1, 0, 5, 20, -20]),
                                      (1, [-1, 3, 4, -5])])
def test_f2_take_clips_negative_indices(axis, idx):
    """F2: ``mode="clip"`` clips to [0, n-1] as NumPy's clip mode."""
    ref, got = both(lambda mx: mx.np.take(
        mx.np.arange(12.).reshape(3, 4),
        mx.np.array(onp.array(idx, onp.int32)), axis=axis))
    assert_same(ref, got)


@pytest.mark.parametrize("fn", ["floor_divide", "mod", "remainder", "fmod",
                                "divmod"])
def test_f3_integer_division_by_zero(fn):
    """F3: the reference's values (-2/-1 quotients, 0 remainders) where
    torch raises."""
    ref, got = both(lambda mx: getattr(mx.np, fn)(mx.np.array(DIV_A),
                                                  mx.np.array(DIV_B)))
    assert_same(ref, got)
    want = {"floor_divide": [-2, -4, -2, -1], "mod": [0, 1, 0, 0],
            "remainder": [0, 1, 0, 0], "fmod": [0, -1, 0, 0]}
    if fn in want:
        assert got.tolist() == want[fn]


def test_f4_bitwise_count_of_negatives():
    """F4: the bits of |x|, as NumPy and ``jnp.bitwise_count``."""
    ref, got = both(lambda mx: mx.np.bitwise_count(
        mx.np.array(onp.array([-5, -1, 0, 3, 7], onp.int32))))
    assert_same(ref, got)
    assert got.tolist() == [2, 1, 0, 2, 3]


def test_f5_histogram_edges_are_jnp_linspace():
    """F5: the port computes ``jnp.histogram``'s edge formula, rounded
    step by step: its edges equal the reference's un-jitted ones bit for
    bit, and its counts NumPy's.  The jitted reference moves the sixth
    edge to -0.99999994, which puts the three -1s a bin low (ROADMAP §3,
    faults of the reference)."""
    import jax

    with jax.disable_jit():
        ref = _host(rmx.np.histogram(rmx.np.array(HIST_IN), bins=10))
    with pmx.cpu():
        got = _host(pmx.np.histogram(pmx.np.array(HIST_IN), bins=10))
    assert_same(ref[1], got[1])
    counts, _ = onp.histogram(HIST_IN, bins=10)
    onp.testing.assert_array_equal(got[0], counts.astype(onp.float32))
    assert got[0].tolist() == [2, 1, 1, 0, 0, 3, 2, 1, 1, 1]
    jitted = _host(rmx.np.histogram(rmx.np.array(HIST_IN), bins=10))
    assert jitted[1][5] == onp.float32(-0.99999994)
    # float data, where start * (1 - t) + stop * t and start + (stop -
    # start) * t round apart, and a range of zero width
    x = (onp.random.RandomState(0).standard_normal(20) * 3).astype(
        onp.float32)
    for kw in (dict(bins=7), dict(bins=4, range=(1.0, 1.0))):
        with jax.disable_jit():
            ref = _host(rmx.np.histogram(rmx.np.array(x), **kw))
        with pmx.cpu():
            got = _host(pmx.np.histogram(pmx.np.array(x), **kw))
        assert_same(ref, got)


@pytest.mark.parametrize("case", ["broadcast_arrays", "polyval",
                                  "sum_uint32", "int32_plus_uint32",
                                  "np_add_uint32"])
def test_f6_result_dtypes(case):
    """F6: JAX's dtypes without 64-bit types, unsigned ones included."""
    u = onp.array([3, 4], onp.uint32)
    i = onp.array([1, -2], onp.int32)
    calls = {
        "broadcast_arrays": lambda mx: mx.np.broadcast_arrays(
            mx.np.array(onp.array([1., 2.], onp.float32)), 2),
        "polyval": lambda mx: mx.np.polyval(
            mx.np.array(onp.array([1, 2, 3], onp.int32)),
            mx.np.array(onp.array([2, 3], onp.int32))),
        "sum_uint32": lambda mx: mx.np.sum(mx.np.array(u)),
        "int32_plus_uint32": lambda mx: mx.np.array(i) + mx.np.array(u),
        "np_add_uint32": lambda mx: [mx.np.add(mx.np.array(i),
                                               mx.np.array(u)),
                                     mx.np.add(mx.np.array(u),
                                               mx.np.array(u))],
    }
    ref, got = both(calls[case])
    assert_same(ref, got)


@pytest.mark.parametrize("case", ["full_like", "fill_diagonal", "meshgrid"])
def test_f7_calls_that_raised(case):
    """F7: an array fill value, an array of diagonal values and grids of
    mixed dtypes return what the reference returns."""
    calls = {
        "full_like": lambda mx: mx.np.full_like(
            mx.np.zeros((2, 3)), mx.np.array(onp.array([1., 2., 3.],
                                                       onp.float32))),
        "fill_diagonal": lambda mx: mx.np.fill_diagonal(
            mx.np.zeros((3, 3)), mx.np.array(onp.array([9., 8., 7.],
                                                       onp.float32))),
        "meshgrid": lambda mx: mx.np.meshgrid(
            mx.np.array(onp.array([0.5, 1.5], onp.float32)),
            mx.np.array(onp.array([1, 2, 3], onp.int32))),
    }
    ref, got = both(calls[case])
    assert_same(ref, got)


def test_f8_block_follows_its_arrays_device():
    """F8: ``block`` of CPU arrays stays on the CPU outside any context
    scope (the default context is ``gpu(0)``: the parent placed the
    result there, or raised without CUDA)."""
    with pmx.cpu():
        a = pmx.np.array(onp.array([[1., 2.]], onp.float32))
        b = pmx.np.array(onp.array([[3.]], onp.float32))
    out = pmx.np.block([[a, b]])
    assert out._data.device.type == "cpu"
    assert out.asnumpy().tolist() == [[1., 2., 3.]]
    ref = _host(rmx.np.block([[rmx.np.array(onp.array([[1., 2.]],
                                                      onp.float32)),
                               rmx.np.array(onp.array([[3.]],
                                                      onp.float32))]]))
    assert_same(ref, onp.asarray(out.asnumpy()))


@pytest.mark.parametrize("case", ["lstsq_vector", "lstsq_matrix",
                                  "cholesky_not_pd", "eigh_nonsymmetric",
                                  "eigvalsh_nonsymmetric", "outer_2d"])
def test_f9_linalg_as_the_reference(case):
    """F9: ``lstsq``'s residuals always one a right-hand side,
    ``cholesky`` NaN on a matrix that is not positive definite,
    ``eigh``/``eigvalsh`` of the symmetrized input, ``outer`` of
    flattened operands; values within 1e-5."""
    b4 = onp.array([1., 2., 3., 4.], onp.float32)
    calls = {
        "lstsq_vector": lambda mx: list(mx.np.linalg.lstsq(
            mx.np.array(SPD), mx.np.array(b4), rcond=None))[:2],
        "lstsq_matrix": lambda mx: list(mx.np.linalg.lstsq(
            mx.np.array(SPD), mx.np.array(SPD), rcond=None))[:2],
        "cholesky_not_pd": lambda mx: mx.np.linalg.cholesky(
            mx.np.array(onp.array([[1., 2.], [2., 1.]], onp.float32))),
        "eigh_nonsymmetric": lambda mx: mx.np.linalg.eigh(
            mx.np.array(NONSYM))[0],
        "eigvalsh_nonsymmetric": lambda mx: mx.np.linalg.eigvalsh(
            mx.np.array(NONSYM)),
        "outer_2d": lambda mx: mx.np.linalg.outer(
            mx.np.array(onp.array([[1., 2.], [3., 4.]], onp.float32)),
            mx.np.array(onp.array([[1., 0.]], onp.float32))),
    }
    ref, got = both(calls[case])
    for r, g in zip(ref if isinstance(ref, list) else [ref],
                    got if isinstance(got, list) else [got]):
        assert r.dtype == g.dtype and r.shape == g.shape, (r.shape, g.shape)
        onp.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_power_of_int32_to_negative_exponent_is_the_ports_own():
    """The reference's ``3 ** -2`` in int32 is 703701817 (ROADMAP §3,
    faults of the reference); the port gives the truncated quotient, 0,
    and 1 and -1 for bases 1 and -1, as integer arithmetic does."""
    base = onp.array([3, 1, -1, 2, -2], onp.int32)
    exp = onp.array([-2, -2, -3, -1, -1], onp.int32)
    with pmx.cpu():
        got = pmx.np.power(pmx.np.array(base), pmx.np.array(exp))
    assert str(got.dtype) == "int32"
    assert got.asnumpy().tolist() == [0, 1, -1, 0, 0]
    ref = _host(rmx.np.power(rmx.np.array(base), rmx.np.array(exp)))
    assert ref.tolist()[0] == 703701817
