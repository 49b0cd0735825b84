"""The port's initializers (``mxnet_tpu_torch/initializer.py``) against
the reference's rules: Xavier's bound ``sqrt(magnitude / fan)`` with
fans computed as ``mxnet_tpu.initializer.Xavier`` computes them for
OIHW, the moments of its draws, and the base class's name rules.  The
random streams differ from JAX's by design; the draws are compared by
their distribution (4096+ samples: the sample moments of U(-s, s) within
5% of s / sqrt(3))."""
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
