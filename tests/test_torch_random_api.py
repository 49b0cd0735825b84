"""``mx.random``'s user functions and ``mx.nd.random`` in the port
(``mxnet_tpu_torch/random.py``) against the reference's
(``mxnet_tpu/random.py``) on the CPU: the same output shapes and dtypes
for every function and parameter form, the ``ctx=``/``out=``/``dtype=``
rules, the ``mx.nd`` names, ``seed``/``current_seed``, and
``get_state``/``set_state`` resuming every stream (the key stream, the
device generators, the attention seeds) exactly where the snapshot was
taken.  The values are the port's own (JAX's threefry bits are not
reproduced), so they are held by distribution (``test_torch_samplers``)
and by determinism here.  ``exponential`` takes a scale: 4,096 draws of
``exponential(2.0)`` average within 6 standard errors of 2.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.base import MXNetError

rmx = LazyReference()     # the JAX package, imported at first use

P2 = onp.asarray([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8]], onp.float32)
LO, HI = onp.asarray([0.0, 1.0], onp.float32), onp.asarray([1.0, 3.0],
                                                          onp.float32)

# (id, function, positional args as numpy-or-scalar, kwargs)
CALLS = [
    ("uniform", "uniform", (), {}),
    ("uniform_shape", "uniform", (-1.0, 2.0), dict(shape=(2, 3))),
    ("uniform_f16", "uniform", (), dict(shape=(4,), dtype="float16")),
    ("uniform_nd", "uniform", (LO, HI), dict(shape=(3,))),
    ("normal", "normal", (1.0, 2.0), dict(shape=(5,))),
    ("normal_nd", "normal", (LO, HI), dict(shape=(2, 2))),
    ("randn", "randn", (2, 3), {}),
    ("randn_empty", "randn", (), {}),
    ("randint", "randint", (0, 5), dict(shape=(3,))),
    ("randint_i8", "randint", (-4, 4), dict(shape=(2, 2), dtype="int8")),
    ("gamma", "gamma", (2.0, 1.5), dict(shape=(4,))),
    ("gamma_nd", "gamma", (HI, HI), dict(shape=3)),
    ("exponential", "exponential", (2.0,), dict(shape=(4,))),
    ("exponential_nd", "exponential", (HI,), dict(shape=(3,))),
    ("poisson", "poisson", (3.0,), dict(shape=(2, 2))),
    ("poisson_nd", "poisson", (HI,), dict(shape=(3,))),
    ("bernoulli", "bernoulli", (0.3,), dict(shape=(6,))),
    ("multinomial_1", "multinomial", (P2,), {}),
    ("multinomial_4", "multinomial", (P2,), dict(shape=4)),
    ("multinomial_tuple", "multinomial", (P2,), dict(shape=(2, 3))),
    ("multinomial_row", "multinomial", (P2[0],), dict(shape=1)),
    ("multinomial_prob", "multinomial", (P2,), dict(get_prob=True)),
    ("multinomial_row_prob", "multinomial", (P2[0],), dict(get_prob=True)),
    ("shuffle", "shuffle", (onp.arange(12.0).reshape(6, 2),), {}),
]


def _call(pkg, fn, args, kw):
    args = [pkg.nd.array(a) if isinstance(a, onp.ndarray) else a
            for a in args]
    out = getattr(pkg.random, fn)(*args, **kw)
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("call", CALLS, ids=[c[0] for c in CALLS])
def test_user_function_shapes_and_dtypes(call):
    cid, fn, args, kw = call
    want = _call(rmx, fn, args, kw)
    with mx.cpu():
        got = _call(mx, fn, args, kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, g.dtype, w.shape, w.dtype)
        assert g.context == mx.cpu()


def test_nd_random_names():
    """``mx.nd.random`` is ``mx.random`` and the legacy ``mx.nd`` names
    are the reference's: ``random_*``, ``sample_multinomial`` and
    ``shuffle`` over the user functions, the others the ops' wrappers."""
    from mxnet_tpu_torch.ops.registry import OPS

    assert mx.nd.random is mxrandom
    for name in ("random_uniform", "random_normal", "random_randint",
                 "random_gamma", "random_exponential", "random_poisson",
                 "sample_multinomial", "shuffle", "random_negative_binomial",
                 "random_generalized_negative_binomial", "multinomial"):
        ref = getattr(rmx.nd, name)
        got = getattr(mx.nd, name)
        if getattr(ref, "_op", None) is not None:
            assert got is OPS[ref._op.name].wrapper, name
        else:
            assert got is getattr(mxrandom, ref.__name__), name
    for name in ("uniform", "normal", "randn", "randint", "gamma",
                 "exponential", "poisson", "bernoulli", "multinomial",
                 "shuffle", "seed", "current_seed", "get_state",
                 "set_state"):
        assert callable(getattr(mx.nd.random, name))


def test_ctx_out_and_dtype_rules():
    x = mx.nd.zeros((2, 3), ctx=mx.cpu())
    r = mx.random.uniform(shape=(2, 3), ctx=mx.cpu(), out=x)
    assert r is x and (x.asnumpy() < 1).all()
    n = mx.random.normal(shape=(4,), dtype="float16", ctx=mx.cpu())
    assert n.dtype == onp.float16 and n.context == mx.cpu()
    i = mx.random.randint(2, 9, shape=(50,), ctx=mx.cpu())
    assert i.dtype == onp.int32 and i.asnumpy().min() >= 2 and \
        i.asnumpy().max() < 9


def test_default_context_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.random.uniform(shape=(2,))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.random.normal(shape=(2,))


def test_seed_and_current_seed():
    mxrandom.seed(123, ctx="all")
    assert mxrandom.current_seed() == 123
    with mx.cpu():
        a = mx.random.uniform(shape=(8,)).asnumpy()
        mxrandom.seed(123)
        b = mx.random.uniform(shape=(8,)).asnumpy()
        mxrandom.seed(124)
        c = mx.random.uniform(shape=(8,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    assert not onp.array_equal(a, c)


def test_get_state_set_state_resume_every_stream():
    """After ``set_state(get_state())`` the key stream, the CPU device
    generator and the attention seed draw what they drew after the
    snapshot; a generator made after the snapshot restarts."""
    mxrandom.seed(31)
    with mx.cpu():
        mx.random.normal(shape=(3,))
        torch.rand(4, generator=mxrandom.generator("cpu"))
        state = mxrandom.get_state()
        first = [mx.random.normal(shape=(5,)).asnumpy(),
                 mx.random.randint(0, 1000, shape=(5,)).asnumpy(),
                 torch.rand(4, generator=mxrandom.generator("cpu")).numpy(),
                 mxrandom.attention_seed("cpu").numpy(),
                 mx.random.shuffle(mx.nd.arange(10)).asnumpy()]
        mxrandom.seed(99)
        mx.random.uniform(shape=(7,))
        mxrandom.set_state(state)
        again = [mx.random.normal(shape=(5,)).asnumpy(),
                 mx.random.randint(0, 1000, shape=(5,)).asnumpy(),
                 torch.rand(4, generator=mxrandom.generator("cpu")).numpy(),
                 mxrandom.attention_seed("cpu").numpy(),
                 mx.random.shuffle(mx.nd.arange(10)).asnumpy()]
    for a, b in zip(first, again):
        onp.testing.assert_array_equal(a, b)
    assert mxrandom.current_seed() == 31
    assert set(state) == {"seed", "root", "generators"}


def test_exponential_takes_a_scale():
    mxrandom.seed(5)
    with mx.cpu():
        x = mx.random.exponential(2.0, shape=(4096,)).asnumpy()
        y = mx.random.exponential(mx.nd.array(onp.asarray([0.5, 4.0],
                                                          onp.float32)),
                                  shape=(4096,)).asnumpy()
    assert abs(x.mean() - 2.0) < 6 * 2.0 / 64
    assert abs(y[0].mean() - 0.5) < 6 * 0.5 / 64
    assert abs(y[1].mean() - 4.0) < 6 * 4.0 / 64


def test_bernoulli_and_shuffle():
    mxrandom.seed(6)
    with mx.cpu():
        b = mx.random.bernoulli(0.25, shape=(4096,)).asnumpy()
        data = mx.nd.array(onp.arange(40.0).reshape(20, 2))
        s = mx.random.shuffle(data).asnumpy()
    assert set(onp.unique(b)) == {0.0, 1.0}
    assert abs(b.mean() - 0.25) < 6 * (0.25 * 0.75 / 4096) ** 0.5
    assert sorted(s[:, 0].tolist()) == list(range(0, 40, 2))
    onp.testing.assert_array_equal(s[:, 1], s[:, 0] + 1)
    assert not onp.array_equal(s, data.asnumpy())


def test_multinomial_get_prob():
    """``get_prob=True`` returns the log of each drawn entry's
    probability, for ``shape=1`` (as the reference) and for several
    draws a row, where the reference's ``pick`` raises (ROADMAP
    section 3)."""
    mxrandom.seed(8)
    with mx.cpu():
        for shape in (1, 5):
            s, logp = mx.random.multinomial(mx.nd.array(P2), shape=shape,
                                            get_prob=True)
            idx = s.asnumpy().reshape(2, -1)
            want = torch.log(torch.from_numpy(
                onp.take_along_axis(P2, idx, axis=1))).numpy()
            onp.testing.assert_array_equal(logp.asnumpy().reshape(2, -1),
                                           want)
    with pytest.raises(ValueError):
        rmx.random.multinomial(rmx.nd.array(P2), shape=5, get_prob=True)


def test_hybridized_draw_is_fresh_per_key():
    """A block that draws ``mx.nd.random.normal`` under a program's key:
    one key, the same numbers; another key, others (the CPU runs the
    forward directly, so the key is pushed here as the card's program
    pushes it)."""
    class Reparam(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, mu):
            return mu + F.random.normal(shape=mu.shape, ctx=mx.cpu())

    net = Reparam()
    mu = mx.nd.zeros((4, 8), ctx=mx.cpu())

    def run(key):
        with mxrandom.trace(torch.tensor([key], dtype=torch.int32)):
            return net(mu).asnumpy()

    a, b, c = run(3), run(3), run(4)
    onp.testing.assert_array_equal(a, b)
    assert not onp.array_equal(a, c)


@pytest.mark.cuda
def test_card_and_cpu_draw_the_same_bits():
    """One seed: uniform, randint, bernoulli and shuffle equal on the
    card and the CPU bit for bit; normal and exponential within 2 f32
    ulps."""
    need_cuda()
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mxrandom.seed(17)
        with ctx:
            res.append([
                mx.random.uniform(-2.0, 5.0, shape=(4096,)).asnumpy(),
                mx.random.randint(-9, 1 << 30, shape=(4096,)).asnumpy(),
                mx.random.bernoulli(0.3, shape=(4096,)).asnumpy(),
                mx.random.shuffle(mx.nd.arange(1000)).asnumpy(),
                mx.random.normal(1.0, 3.0, shape=(4096,)).asnumpy(),
                mx.random.exponential(2.0, shape=(4096,)).asnumpy()])
    for a, b in zip(res[0][:4], res[1][:4]):
        onp.testing.assert_array_equal(a, b)
    for a, b in zip(res[0][4:], res[1][4:]):
        assert (abs(a - b) <= 2 * onp.spacing(onp.abs(a))).all()
