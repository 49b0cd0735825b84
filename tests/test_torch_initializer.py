"""The port's initializers (``mxnet_tpu_torch/initializer.py``) against
the reference's rules: Xavier's bound ``sqrt(magnitude / fan)`` with
fans computed as ``mxnet_tpu.initializer.Xavier`` computes them for
OIHW, the moments of its draws, and the base class's name rules.  The
random streams differ from JAX's by design; the draws are compared by
their distribution (4096+ samples: the sample moments of U(-s, s) within
5% of s / sqrt(3)).  The deterministic initializers (``Bilinear``,
``LSTMBias``, ``Load``, ``Mixed``, ``MSRAPrelu``'s scale) are held to the
reference exactly; ``Orthogonal`` by its orthogonality (``W Wᵀ`` or
``Wᵀ W`` within 1e-5 of scale² I in f32) and the reference's shape
rules."""
import math

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import initializer as pinit
from mxnet_tpu_torch.base import MXNetError


def _ref_scale(shape, factor_type, magnitude):
    """The reference's Xavier scale, read off its uniform draw's bound."""
    import jax
    from mxnet_tpu.initializer import Xavier

    w = Xavier("uniform", factor_type, magnitude)._init_weight(
        "w", jax.random.PRNGKey(0), shape, "float32")
    return float(onp.abs(onp.asarray(w)).max())


@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (256, 64, 1, 1),
                                   (1000, 2048), (64, 3, 7, 7)], ids=str)
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_xavier_bound_and_moments(shape, factor_type):
    init = pinit.Xavier("uniform", factor_type, 3)
    s = init.scale("w", shape)
    hw = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan = {"in": shape[1] * hw, "out": shape[0] * hw,
           "avg": (shape[0] + shape[1]) * hw / 2}[factor_type]
    assert s == pytest.approx(math.sqrt(3 / fan))
    # the reference's draws reach its bound from below
    assert _ref_scale(shape, factor_type, 3) <= s
    assert _ref_scale(shape, factor_type, 3) > 0.99 * s
    g = torch.Generator().manual_seed(0)
    w = init.generate("conv0_weight", shape, torch.float32, "cpu", g)
    assert w.shape == shape and w.abs().max() <= s
    assert abs(w.mean().item()) < 0.05 * s
    assert w.std().item() == pytest.approx(s / math.sqrt(3), rel=0.05)


def test_xavier_gaussian_and_errors():
    g = torch.Generator().manual_seed(1)
    init = pinit.Xavier("gaussian", "avg", 2)
    w = init.generate("w", (128, 64, 3, 3), torch.float32, "cpu", g)
    assert w.std().item() == pytest.approx(init.scale("w", w.shape),
                                           rel=0.05)
    with pytest.raises(MXNetError):
        pinit.Xavier().generate("dense0_weight", (8,), torch.float32, "cpu",
                                g)
    with pytest.raises(MXNetError):
        pinit.create("nope")


@pytest.mark.parametrize("name,value", [
    ("stage1_batchnorm0_gamma", 1.0), ("stage1_batchnorm0_beta", 0.0),
    ("dense0_bias", 0.0), ("batchnorm3_running_mean", 0.0),
    ("batchnorm3_running_var", 1.0)])
def test_name_rules_match_reference(name, value):
    import jax
    from mxnet_tpu.initializer import Xavier

    ref = onp.asarray(Xavier().generate(name, jax.random.PRNGKey(0), (5,)))
    got = pinit.Xavier().generate(name, (5,), torch.float32, "cpu",
                                  torch.Generator())
    onp.testing.assert_array_equal(got.numpy(), ref)
    assert (got == value).all()


def test_initialize_module_seeded_with_overrides():
    from mxnet_tpu_torch.gluon import nn

    def build():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, in_channels=4, use_bias=True,
                          bias_initializer="ones", device="cpu"),
                nn.BatchNorm(in_channels=8, device="cpu"),
                nn.Dense(3, in_units=8, device="cpu"))
        return net

    a = build().initialize(pinit.Xavier(), seed=7)
    b = build().initialize(pinit.Xavier(), seed=7)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    def t(param):                              # a Gluon Parameter's tensor
        return param.data().astorch()

    assert (t(a[0].bias) == 1).all()           # the layer's own initializer
    assert (t(a[1].gamma) == 1).all() and (t(a[1].running_var) == 1).all()
    assert (t(a[1].beta) == 0).all() and (t(a[1].running_mean) == 0).all()
    assert (t(a[2].bias) == 0).all()
    bound = pinit.Xavier().scale("w", a[0].weight.shape)
    assert 0 < t(a[0].weight).abs().max() <= bound
    c = build().initialize(pinit.Xavier(), seed=8)
    assert not torch.equal(t(a[0].weight), t(c[0].weight))
    # the default initializer is the reference's Uniform(0.07)
    d = build().initialize()
    assert t(d[2].weight).abs().max() <= 0.07


# --------------------------------------------------------------------------- #
# Orthogonal, MSRAPrelu, Bilinear, LSTMBias, Load, Mixed
# --------------------------------------------------------------------------- #

def _ref_nd(shape, value=0.0):
    import mxnet_tpu as rmx

    return rmx.nd.array(onp.full(shape, value, onp.float32))


def _port_nd(shape, value=0.0):
    import mxnet_tpu_torch as mx

    return mx.nd.array(onp.full(shape, value, onp.float32), ctx=mx.cpu())


def _gram(w):
    """``W Wᵀ`` of the (out, rest) matrix when out <= rest, else ``Wᵀ
    W``: the product the reference's choice of U or Vᵀ makes scale² I."""
    m = onp.asarray(w, onp.float64).reshape(w.shape[0], -1)
    return m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(16, 64), (64, 16), (32, 32),
                                   (8, 4, 3, 3)], ids=str)
def test_orthogonal_is_orthogonal_as_the_reference(shape, rand_type):
    import jax
    from mxnet_tpu.initializer import Orthogonal as ROrth

    scale = 1.414
    ref = onp.asarray(ROrth(scale, rand_type)._init_weight(
        "w", jax.random.PRNGKey(0), shape, "float32"))
    g = torch.Generator().manual_seed(3)
    got = pinit.Orthogonal(scale, rand_type).generate(
        "conv0_weight", shape, torch.float32, "cpu", g).numpy()
    assert got.shape == ref.shape == shape and got.dtype == onp.float32
    k = min(shape[0], math.prod(shape[1:]))
    for w in (got, ref):
        onp.testing.assert_allclose(_gram(w), scale ** 2 * onp.eye(k),
                                    atol=1e-5)
    # seeded: the same generator state draws the same matrix
    again = pinit.Orthogonal(scale, rand_type).generate(
        "w", shape, torch.float32, "cpu", torch.Generator().manual_seed(3))
    assert onp.array_equal(again.numpy(), got)
    other = pinit.Orthogonal(scale, rand_type).generate(
        "w", shape, torch.float32, "cpu", torch.Generator().manual_seed(4))
    assert not onp.array_equal(other.numpy(), got)


def test_orthogonal_by_name_and_through_initialize():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    assert isinstance(pinit.create("orthogonal"), pinit.Orthogonal)
    with mx.cpu():
        net = nn.Dense(24, in_units=40)
    net.initialize(pinit.Orthogonal(scale=2.0), ctx=mx.cpu(), seed=0)
    w = net.weight.data().asnumpy()
    onp.testing.assert_allclose(_gram(w), 4.0 * onp.eye(24), atol=1e-5)
    assert (net.bias.data().asnumpy() == 0).all()      # the name rule


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("slope", [0.25, 0.0, 1.0])
def test_msraprelu_scale_is_the_reference(factor_type, slope):
    from mxnet_tpu.initializer import MSRAPrelu as RMSRA

    ref = RMSRA(factor_type, slope)
    got = pinit.MSRAPrelu(factor_type, slope)
    assert got.magnitude == ref.magnitude == 2.0 / (1 + slope ** 2)
    assert (got.rnd_type, got.factor_type) == (ref.rnd_type,
                                               ref.factor_type)
    assert got._kwargs == ref._kwargs
    shape = (64, 32, 3, 3)
    s = got.scale("w", shape)
    fan = {"in": 32 * 9, "out": 64 * 9, "avg": 48 * 9}[factor_type]
    assert s == math.sqrt(ref.magnitude / fan)
    w = got.generate("w", shape, torch.float32, "cpu",
                     torch.Generator().manual_seed(0))
    assert w.std().item() == pytest.approx(s, rel=0.05)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (3, 2, 5, 5),
                                   (2, 1, 3, 6), (4, 4, 8, 8)], ids=str)
def test_bilinear_equals_the_reference(shape):
    import jax
    from mxnet_tpu.initializer import Bilinear as RBil

    ref = onp.asarray(RBil()._init_weight("w", jax.random.PRNGKey(0),
                                          shape, "float32"))
    got = pinit.Bilinear().generate("up_weight", shape, torch.float32,
                                    "cpu", None).numpy()
    assert onp.array_equal(got, ref)


@pytest.mark.parametrize("forget_bias", [1.0, 0.0, 2.5])
def test_lstmbias_equals_the_reference(forget_bias):
    import jax
    from mxnet_tpu.initializer import LSTMBias as RLB

    ref = onp.asarray(RLB(forget_bias)._init_weight(
        "b", jax.random.PRNGKey(0), (24,), "float32"))
    got = pinit.LSTMBias(forget_bias)._init_weight(
        "b", (24,), torch.float32, "cpu", None).numpy()
    assert onp.array_equal(got, ref)
    # through a cell's own bias initializer, past the name rule
    import mxnet_tpu_torch as mx

    with mx.cpu():
        cell = mx.gluon.rnn.LSTMCell(6, input_size=3,
                                     i2h_bias_initializer=pinit.LSTMBias(
                                         forget_bias))
    cell.initialize(ctx=mx.cpu())
    assert onp.array_equal(cell.i2h_bias.data().asnumpy(), ref)


def test_load_equals_the_reference(tmp_path):
    from mxnet_tpu.initializer import Constant as RConst, InitDesc as RDesc
    from mxnet_tpu.initializer import Load as RLoad

    rs = onp.random.RandomState(0)
    w = rs.standard_normal((4, 3)).astype(onp.float32)
    b = rs.standard_normal((4,)).astype(onp.float32)
    arrays = {"arg:fc_weight": w, "aux:fc_bias": b}
    rl = RLoad(arrays, default_init=RConst(3.0))
    pl = pinit.Load(arrays, default_init=pinit.Constant(3.0))
    for name, shape in (("fc_weight", (4, 3)), ("fc_bias", (4,)),
                        ("other_weight", (2, 2))):
        r, p = _ref_nd(shape), _port_nd(shape)
        rl(RDesc(name), r)
        pl(pinit.InitDesc(name), p)
        assert onp.array_equal(p.asnumpy(), r.asnumpy()), name
    with pytest.raises(MXNetError, match="shape mismatch"):
        pl(pinit.InitDesc("fc_weight"), _port_nd((3, 4)))
    with pytest.raises(MXNetError, match="no init"):
        pinit.Load({})(pinit.InitDesc("x"), _port_nd((1,)))
    # a .params file, read through the port's nd.load
    import mxnet_tpu_torch as mx

    path = str(tmp_path / "w.params")
    mx.nd.save(path, {"fc_weight": mx.nd.array(w, ctx=mx.cpu())})
    p = _port_nd((4, 3))
    pinit.Load(path)(pinit.InitDesc("fc_weight"), p)
    assert onp.array_equal(p.asnumpy(), w)


def test_mixed_equals_the_reference():
    from mxnet_tpu.initializer import Constant as RConst, InitDesc as RDesc
    from mxnet_tpu.initializer import Mixed as RMixed, One as ROne

    rm = RMixed([".*bias", ".*"], [RConst(0.5), ROne()])
    pm = pinit.Mixed([".*bias", ".*"], [pinit.Constant(0.5), pinit.One()])
    for name in ("fc_bias", "fc_weight"):
        r, p = _ref_nd((3, 2)), _port_nd((3, 2))
        rm(RDesc(name), r)
        pm(pinit.InitDesc(name), p)
        assert onp.array_equal(p.asnumpy(), r.asnumpy()), name
    with pytest.raises(MXNetError, match="no pattern"):
        pinit.Mixed(["a"], [pinit.One()])(pinit.InitDesc("b"), _port_nd((1,)))
    with pytest.raises(MXNetError, match="length"):
        pinit.Mixed(["a", "b"], [pinit.One()])
    # as a block's initializer and as a parameter's own one
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    with mx.cpu():
        net = nn.Dense(3, in_units=2)
        own = nn.Dense(3, in_units=2, weight_initializer=pm)
    net.initialize(pm, ctx=mx.cpu())
    own.initialize(pinit.Zero(), ctx=mx.cpu())
    # the bias's own "zeros" wins over the block's Mixed, as in the
    # reference
    assert (net.bias.data().asnumpy() == 0.0).all()
    assert (net.weight.data().asnumpy() == 1.0).all()
    assert (own.weight.data().asnumpy() == 1.0).all()
