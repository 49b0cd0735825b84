"""``mx.nd.image`` of the port (``ops/image_ops.py``) against the JAX
package's, on the CPU, through each package's ``mx.nd.image`` names.

Tolerances: f32 outputs and input gradients within 1e-5 (relative and
absolute, ``jax.vjp`` through the reference's autograd with the same
head gradient); integer outputs exact, except where a resized value
lies within 1e-4 of an integer: there ``astype(uint8)`` truncates the
sum of a different summation order (the reference's XLA dot against the
port's einsum) to either side, so those pixels may differ by one.  The
random ops draw other numbers than the reference's threefry bits, so
they are held to their rules: each image itself or its flip, one factor
an image within [min, max], the reference's formula at the drawn factor,
the same key the same output.
"""
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(seed, shape, dtype):
    rs = onp.random.RandomState(seed)
    if dtype == "uint8":
        return rs.randint(0, 256, shape).astype(onp.uint8)
    return (rs.rand(*shape) * 255).astype(onp.float32)


def _run(pkg, short, arrays, kwargs, heads=None):
    nds = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    grad = heads is not None
    if grad:
        for x in nds:
            x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd.image, short)(*nds, **kwargs)
    if grad:
        out.backward(pkg.nd.array(heads))
    return out.asnumpy(), [x.grad.asnumpy() for x in nds] if grad else []


def _compare(short, arrays, kwargs, int_near=None):
    ref, _ = _run(rmx, short, arrays, kwargs)
    grad = arrays[0].dtype == onp.float32
    heads = onp.random.RandomState(1).standard_normal(ref.shape).astype(
        onp.float32) if grad else None
    ref, ref_g = _run(rmx, short, arrays, kwargs, heads)
    with mx.cpu():
        got, got_g = _run(mx, short, arrays, kwargs, heads)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == onp.uint8:
        diff = onp.abs(got.astype(int) - ref.astype(int))
        near = onp.zeros_like(diff, bool) if int_near is None else int_near
        assert (diff[~near] == 0).all() and (diff <= 1).all()
    else:
        onp.testing.assert_allclose(got, ref, **TOL)
    for p, r in zip(got_g, ref_g):
        onp.testing.assert_allclose(p, r, **TOL)
    return got


@pytest.mark.parametrize("layout", ["hwc", "nhwc"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_to_tensor(layout, dtype):
    shape = (7, 6, 3) if layout == "hwc" else (2, 7, 6, 3)
    got = _compare("to_tensor", [_images(0, shape, dtype)], {})
    assert got.dtype == onp.float32


@pytest.mark.parametrize("batch", [False, True])
def test_normalize(batch):
    x = onp.random.RandomState(2).rand(*((2, 3, 5, 4) if batch
                                        else (3, 5, 4))).astype(onp.float32)
    _compare("normalize", [x], dict(mean=(0.2, 0.3, 0.4),
                                    std=(0.5, 0.25, 0.1)))


def test_normalize_refuses_integers():
    x = onp.zeros((3, 4, 4), onp.uint8)
    with mx.cpu(), pytest.raises(TypeError, match="float input"):
        mx.nd.image.normalize(mx.nd.array(x, dtype="uint8"))


def _near_integer(arrays, kwargs):
    """Where the reference's f32 resize of the image lies within 1e-4 of
    an integer (there a cast to uint8 may land on either side)."""
    f = rmx.nd.image.resize(rmx.nd.array(arrays[0].astype(onp.float32)),
                            **kwargs).asnumpy()
    return onp.abs(f - onp.round(f)) < 1e-4


RESIZE = {
    "shrink": (17, 13, dict(size=(6, 5))),
    "grow": (5, 6, dict(size=(11, 9))),
    "shrink_one_side": (12, 10, dict(size=(10, 4))),
    "keep_ratio": (9, 14, dict(size=6, keep_ratio=True)),
    "square_int": (8, 8, dict(size=13)),
}


@pytest.mark.parametrize("interp", [0, 1])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("layout", ["hwc", "nhwc"])
@pytest.mark.parametrize("case", list(RESIZE))
def test_resize(case, layout, dtype, interp):
    """Shrink and grow, both ``interp`` values (the reference's
    antialiased triangle filter and half-pixel nearest), HWC and NHWC,
    uint8 (cast back by truncation) and f32 with gradients."""
    h, w, kw = RESIZE[case]
    shape = (h, w, 3) if layout == "hwc" else (2, h, w, 3)
    x = _images(h * w + interp, shape, dtype)
    kw = dict(kw, interp=interp)
    near = _near_integer([x], kw) if dtype == "uint8" else None
    _compare("resize", [x], kw, int_near=near)


@pytest.mark.parametrize("short,kw", [
    ("crop", dict(x=1, y=2, width=3, height=4)),
    ("flip_left_right", {}), ("flip_top_bottom", {})])
@pytest.mark.parametrize("layout", ["hwc", "nhwc"])
def test_geometry(short, kw, layout):
    shape = (6, 5, 3) if layout == "hwc" else (2, 6, 5, 3)
    for dtype in ("uint8", "float32"):
        _compare(short, [_images(3, shape, dtype)], kw)


@pytest.mark.parametrize("short,axis", [("random_flip_left_right", 2),
                                        ("random_flip_top_bottom", 1)])
def test_random_flips_draw_an_image_at_a_time(short, axis):
    x = _images(4, (32, 6, 5, 3), "uint8")
    with mx.cpu():
        mx.random.seed(3)
        out = getattr(mx.nd.image, short)(mx.nd.array(x, dtype="uint8"))
        mx.random.seed(3)
        again = getattr(mx.nd.image, short)(mx.nd.array(x, dtype="uint8"))
        one = getattr(mx.nd.image, short)(mx.nd.array(x[0], dtype="uint8"))
    out = out.asnumpy()
    flipped = onp.flip(x, axis)
    same = (out == x).all(axis=(1, 2, 3))
    flip = (out == flipped).all(axis=(1, 2, 3))
    assert (same | flip).all() and same.any() and flip.any()
    onp.testing.assert_array_equal(again.asnumpy(), out)
    one = one.asnumpy()
    assert (one == x[0]).all() or (one == flipped[0]).all()


def _factors(seed, n, lo, hi):
    """The factors a seeded call draws: one ``key_uniform`` of ``n``."""
    mx.random.seed(seed)
    return lo + (hi - lo) * mx.random.key_uniform(n).numpy()


@pytest.mark.parametrize("short", ["random_brightness", "random_contrast",
                                   "random_saturation"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_photometric_rules(short, dtype):
    x = _images(5, (8, 6, 5, 3), dtype)
    lo, hi = 0.6, 1.7
    with mx.cpu():
        mx.random.seed(11)
        out = getattr(mx.nd.image, short)(mx.nd.array(x, dtype=dtype),
                                          min_factor=lo, max_factor=hi)
        mx.random.seed(11)
        again = getattr(mx.nd.image, short)(mx.nd.array(x, dtype=dtype),
                                            min_factor=lo, max_factor=hi)
        f = _factors(11, 8, lo, hi).astype(onp.float32)
    out = out.asnumpy()
    assert out.dtype == onp.float32
    assert ((f >= lo) & (f <= hi)).all() and len(set(f.tolist())) == 8
    onp.testing.assert_array_equal(again.asnumpy(), out)
    xf = x.astype(onp.float32)
    fb = f.reshape(-1, 1, 1, 1)
    coef = onp.array([0.299, 0.587, 0.114], onp.float32)
    if short == "random_brightness":
        want = xf * fb
    elif short == "random_contrast":
        gray = (xf @ coef).mean(axis=(1, 2), keepdims=True)[..., None]
        want = gray * (1 - fb) + xf * fb
    else:
        want = (xf @ coef)[..., None] * (1 - fb) + xf * fb
    onp.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-3)


def test_random_single_image_draws_a_scalar():
    x = _images(6, (5, 4, 3), "float32")
    with mx.cpu():
        mx.random.seed(2)
        out = mx.nd.image.random_brightness(mx.nd.array(x)).asnumpy()
    f = _factors(2, 1, 0.5, 1.5)[0]
    onp.testing.assert_allclose(out, x * onp.float32(f), rtol=1e-6)
    assert out.dtype == onp.float32


def test_reference_random_ops_keep_their_shapes_and_types():
    """The reference's random ops on the same inputs give the same
    shapes and dtypes as the port's (their values are its own draws)."""
    x = _images(7, (4, 6, 5, 3), "uint8")
    for short in ("random_flip_left_right", "random_flip_top_bottom",
                  "random_brightness", "random_contrast",
                  "random_saturation"):
        ref = getattr(rmx.nd.image, short)(rmx.nd.array(x, dtype="uint8"))
        with mx.cpu():
            got = getattr(mx.nd.image, short)(mx.nd.array(x, dtype="uint8"))
        assert ref.shape == got.shape and \
            ref.asnumpy().dtype == got.asnumpy().dtype, short
