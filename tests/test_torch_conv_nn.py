"""The vision ops of the PyTorch port (``ops.nn.convolution``,
``pooling``, ``batch_norm``) against the JAX package's ``Convolution``,
``Pooling`` and ``_BatchNormStats`` in float32 on the CPU, NCHW and NHWC:
outputs, and gradients against ``jax.vjp``.  Tolerance 1e-5 relative,
and 1e-5 of the largest magnitude absolute (the two sides sum the
windows and reductions in other orders)."""
import numpy as onp
import pytest
import torch

from _torch_parity import t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as pnn


def _close(got, ref, rtol=1e-5):
    ref = onp.asarray(ref)
    onp.testing.assert_allclose(got, ref, rtol=rtol,
                                atol=rtol * max(1.0, onp.abs(ref).max()))


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _nhwc(a):
    return onp.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _vjp_check(jfn, tfn, arrays, seed):
    """Outputs of ``jfn`` (jax) and ``tfn`` (torch) on ``arrays``, then the
    gradients of both under one random cotangent."""
    import jax
    import jax.numpy as jnp

    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    leaves = [t(a).requires_grad_() for a in arrays]
    out = tfn(*leaves)
    _close(out.detach().numpy(), ref)
    ct = _rand(seed, *ref.shape)
    rgrads = vjp(jnp.asarray(ct))
    out.backward(t(ct))
    for leaf, rg in zip(leaves, rgrads):
        _close(leaf.grad.numpy(), rg)


CONV_CASES = {
    "7x7_s2_p3": dict(ci=3, co=8, k=7, stride=2, pad=3, groups=1,
                      bias=False),
    "3x3_s1_p1": dict(ci=8, co=8, k=3, stride=1, pad=1, groups=1,
                      bias=False),
    "3x3_s2_p1": dict(ci=8, co=16, k=3, stride=2, pad=1, groups=1,
                      bias=False),
    "1x1_s2_bias": dict(ci=8, co=16, k=1, stride=2, pad=0, groups=1,
                        bias=True),
    "3x3_groups2": dict(ci=8, co=6, k=3, stride=1, pad=1, groups=2,
                        bias=True),
    "1x1_s1_bias": dict(ci=8, co=16, k=1, stride=1, pad=0, groups=1,
                        bias=True),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_convolution_matches_jax(monkeypatch, case, layout):
    """NHWC 1x1 stride 1 takes the fused route on both sides
    (``MXNET_FUSED_CONV_BWD=1``, Pallas in interpret mode)."""
    from mxnet_tpu.ops.nn import Convolution

    monkeypatch.setenv("MXNET_FUSED_CONV_BWD", "1")
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    c = CONV_CASES[case]
    x = _rand(1, 2, c["ci"], 12, 12)
    if layout == "NHWC":
        x = _nhwc(x)
    w = _rand(2, c["co"], c["ci"] // c["groups"], c["k"], c["k"]) * 0.2
    b = _rand(3, c["co"])
    kw = dict(kernel=(c["k"], c["k"]), stride=(c["stride"],) * 2,
              pad=(c["pad"],) * 2, num_filter=c["co"],
              num_group=c["groups"], no_bias=not c["bias"], layout=layout)
    arrays = [x, w, b] if c["bias"] else [x, w]

    def jfn(*a):
        return Convolution.__wrapped__(*a, **kw)

    def tfn(*a):
        return pnn.convolution(*a, **kw)

    _vjp_check(jfn, tfn, arrays, seed=4)


POOL_CASES = {
    "max_3_2_1": dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                      pad=(1, 1)),
    "global_avg": dict(kernel=(1, 1), pool_type="avg", global_pool=True),
    "global_max": dict(kernel=(1, 1), pool_type="max", global_pool=True),
    "avg_full": dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                     pad=(1, 1), pooling_convention="full"),
    "max_full": dict(kernel=(2, 2), pool_type="max", stride=(2, 2),
                     pad=(1, 1), pooling_convention="full"),
    "avg_no_pad_count": dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                             pad=(1, 1), count_include_pad=False),
    "sum_2_2": dict(kernel=(2, 2), pool_type="sum", stride=(2, 2)),
    "lp_3_1_1": dict(kernel=(3, 3), pool_type="lp", stride=(1, 1),
                     pad=(1, 1)),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_jax(case, layout):
    from mxnet_tpu.ops.nn import Pooling

    x = _rand(5, 2, 4, 9, 9)
    if layout == "NHWC":
        x = _nhwc(x)
    kw = dict(POOL_CASES[case], layout=layout)

    def jfn(a):
        return Pooling.__wrapped__(a, **kw)

    def tfn(a):
        return pnn.pooling(a, **kw)

    _vjp_check(jfn, tfn, [x], seed=6)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["train", "train_fix_gamma", "eval",
                                  "global_stats"])
def test_batch_norm_matches_jax(mode, layout):
    """Outputs, the new moving statistics, the batch statistics and the
    gradients of data, gamma and beta (the hand-written backward on both
    sides)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import _BatchNormStats

    axis = 1 if layout == "NCHW" else -1
    x = _rand(7, 4, 6, 5, 5) * 2.0 + 0.5
    if layout == "NHWC":
        x = _nhwc(x)
    gamma, beta = 1.0 + 0.1 * _rand(8, 6), 0.1 * _rand(9, 6)
    mm, mv = 0.2 * _rand(10, 6), 1.0 + 0.3 * onp.abs(_rand(11, 6))
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=mode == "train_fix_gamma",
              use_global_stats=mode == "global_stats", axis=axis,
              training=mode != "eval")

    def jfn(d, g, b):
        return _BatchNormStats.__wrapped__(d, g, b, jnp.asarray(mm),
                                           jnp.asarray(mv), **kw)

    ref = jfn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    got = pnn.batch_norm(t(x), t(gamma), t(beta), t(mm), t(mv), **kw)
    for g_, r_ in zip(got, ref):
        _close(g_.numpy(), r_)
    _vjp_check(lambda *a: jfn(*a)[0],
               lambda *a: pnn.batch_norm(*a, t(mm), t(mv), **kw)[0],
               [x, gamma, beta], seed=12)
    del jax


def test_batch_norm_bf16_dtype_flow():
    """bf16 data and statistics: the batch statistics are summed in f32
    and rounded once to bf16, and every output keeps bf16."""
    x = t(_rand(13, 8, 5, 5, 4) + 1.0).bfloat16()
    g, b = torch.ones(4).bfloat16(), torch.zeros(4).bfloat16()
    mm, mv = torch.zeros(4).bfloat16(), torch.ones(4).bfloat16()
    out, nmm, nmv, mean, var = pnn.batch_norm(x, g, b, mm, mv, axis=-1)
    assert all(a.dtype == torch.bfloat16 for a in (out, nmm, nmv, mean,
                                                    var))
    x32 = x.float()
    torch.testing.assert_close(mean, x32.mean((0, 1, 2)).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(nmm, mm * 0.9 + mean * 0.1, rtol=0, atol=0)


def test_convolution_refuses_other_ranks():
    """1-3 spatial dims are ported (``tests/test_torch_nn_ops.py``); a
    4-D window is refused."""
    with pytest.raises(MXNetError, match="1, 2 or 3 spatial dims"):
        pnn.convolution(torch.zeros(1, 2, 3, 3, 3, 3),
                        torch.zeros(2, 2, 1, 1, 1, 1), kernel=(1, 1, 1, 1))
    with pytest.raises(MXNetError, match="unknown pool_type"):
        pnn.pooling(torch.zeros(1, 2, 4, 4), kernel=(2, 2), pool_type="min")


def test_flatten():
    x = torch.arange(24.).reshape(2, 3, 2, 2)
    assert pnn.flatten(x).shape == (2, 12)
