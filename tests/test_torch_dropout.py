"""``mx.nd.Dropout`` and ``gluon.nn.Dropout`` of the PyTorch port against
the JAX package's, and ``Trainer.fused_step`` over a block with
``gluon.nn.Dropout``, on the CPU.

The two packages draw their masks from different generators (threefry
against torch's), so the masks are not compared element by element;
what the reference fixes is compared exactly:

- the identity in inference mode and at rate 0;
- every kept element scaled by exactly ``1 / (1 - p)`` in the input's
  dtype (f32 and bf16), every other element 0;
- the keep share of 100,000 elements within 5 standard deviations of
  the binomial's ``1 - p``;
- with ``axes``, the mask constant along the named axes (the reference's
  output has the same structure);
- one integer ``key``, one mask; another key, another mask;
- ``Trainer.fused_step`` over a net with ``gluon.nn.Dropout`` runs,
  draws a new mask at every call, and equals the phase-by-phase step
  (``MXNET_FUSED_STEP=0``) bit for bit from the same weights and the
  same ``random.seed``."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import autograd as pautograd
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch import random as prandom

CPU = pmx.cpu()


def _x(shape=(64, 50), dtype="float32", seed=0):
    return onp.random.RandomState(seed).uniform(0.5, 2.0, shape).astype(
        dtype)


def _port(a, dtype="float32"):
    return pmx.nd.array(a, dtype=dtype, ctx=CPU)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_identity_in_inference_and_at_rate_zero(p):
    import mxnet_tpu as mx

    x = _x()
    with CPU:
        outs = [pmx.nd.Dropout(_port(x), p=p).asnumpy(),
                pmx.nd.Dropout(_port(x), p=0.0, mode="always").asnumpy(),
                pgluon.nn.Dropout(p)(_port(x)).asnumpy()]
        with pautograd.record():
            outs.append(pgluon.nn.Dropout(0.0)(_port(x)).asnumpy())
    ref = mx.nd.Dropout(mx.nd.array(x), p=p).asnumpy()
    onp.testing.assert_array_equal(ref, x)
    for o in outs:
        onp.testing.assert_array_equal(o, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_elements_scaled_exactly(dtype, p):
    import mxnet_tpu as mx

    x32 = _x((200, 500))
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    with CPU:
        out = pmx.nd.Dropout(pmx.nd.NDArray(xt), p=p, mode="always")._data
    kept = out != 0
    assert out.dtype == xt.dtype
    assert torch.equal(out[kept], (xt / (1.0 - p))[kept])
    share = kept.double().mean().item()
    sigma = (p * (1 - p) / kept.numel()) ** 0.5
    assert abs(share - (1 - p)) < 5 * sigma
    # the reference: the same scale on what it keeps
    r = mx.nd.Dropout(mx.nd.array(x32), p=p, mode="always").asnumpy()
    rk = r != 0
    onp.testing.assert_allclose(r[rk], (x32 / onp.float32(1 - p))[rk],
                                rtol=1e-7)
    assert abs(rk.mean() - (1 - p)) < 5 * sigma


def test_axes_share_the_mask_like_the_reference():
    import mxnet_tpu as mx

    x = onp.ones((6, 40, 8), onp.float32)
    ref = mx.nd.Dropout(mx.nd.array(x), p=0.5, mode="always",
                        axes=(1,)).asnumpy()
    with CPU:
        got = pmx.nd.Dropout(_port(x), p=0.5, mode="always",
                             axes=(1,)).asnumpy()
        with pautograd.record():
            blk = pgluon.nn.Dropout(0.5, axes=(1,))(_port(x)).asnumpy()
    for a in (ref, got, blk):
        assert (a == a[:, :1, :]).all()        # constant along axis 1
        assert set(onp.unique(a)) == {0.0, 2.0}
        assert 0 < (a != 0).mean() < 1


def test_one_key_one_mask():
    x = _x()
    with CPU:
        a, b, c = (pmx.nd.Dropout(_port(x), k, p=0.5, mode="always")
                   .asnumpy() for k in (5, 5, 6))
        d = pmx.nd.Dropout(_port(x), key=5, p=0.5, mode="always").asnumpy()
    onp.testing.assert_array_equal(a, b)
    onp.testing.assert_array_equal(a, d)
    assert not onp.array_equal(a, c)


def test_unkeyed_draws_follow_random_seed():
    x = _x()
    with CPU:
        prandom.seed(3)
        a = pmx.nd.Dropout(_port(x), p=0.5, mode="always").asnumpy()
        b = pmx.nd.Dropout(_port(x), p=0.5, mode="always").asnumpy()
        prandom.seed(3)
        c = pmx.nd.Dropout(_port(x), p=0.5, mode="always").asnumpy()
    assert not onp.array_equal(a, b)
    onp.testing.assert_array_equal(a, c)


def test_block_repr_matches_reference():
    import mxnet_tpu as mx

    assert repr(pgluon.nn.Dropout(0.3, axes=(1,))) == \
        repr(mx.gluon.nn.Dropout(0.3, axes=(1,)))


# --------------------------------------------------------------------------- #
# the fused step over a block with Dropout
# --------------------------------------------------------------------------- #

def _net(tmp_path):
    nn = pgluon.nn
    with CPU:
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=12),
                nn.Dropout(0.3), nn.Dense(4, in_units=32))
    net.initialize(pmx.init.Xavier(), ctx=CPU, seed=2)
    f = str(tmp_path / "drop.params")
    if not (tmp_path / "drop.params").exists():
        net.save_parameters(f)
    else:
        net.load_parameters(f, ctx=CPU)
    return net


def _batch():
    rs = onp.random.RandomState(6)
    return (_port(rs.rand(16, 12).astype(onp.float32)),
            _port(rs.randint(0, 4, 16).astype(onp.float32)))


def _fused_run(tmp_path, steps, lr=0.1):
    net = _net(tmp_path)
    tr = pgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": lr, "momentum": 0.9})
    loss_l = pgluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _batch()

    def loss_fn(a, b):
        return loss_l(net(a), b)

    losses = [tr.fused_step(loss_fn, x, y).asnumpy() for _ in range(steps)]
    return losses, {k: p.data().asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}


def test_fused_step_draws_a_new_mask_each_call(tmp_path):
    from mxnet_tpu_torch.gluon import fused_step as fsm

    prandom.seed(1)
    fsm.reset_step_counters()
    losses, _ = _fused_run(tmp_path, 3, lr=0.0)
    assert fsm.step_counters["compiles"] == 1
    assert fsm.step_counters["legacy_steps"] == 0
    assert not onp.array_equal(losses[0], losses[1])
    assert not onp.array_equal(losses[1], losses[2])


def test_fused_step_equals_phase_by_phase(tmp_path, monkeypatch):
    prandom.seed(8)
    fused_losses, fused = _fused_run(tmp_path, 3)
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    prandom.seed(8)
    phase_losses, phase = _fused_run(tmp_path, 3)
    for a, b in zip(fused_losses, phase_losses):
        onp.testing.assert_array_equal(a, b)
    assert sorted(fused) == sorted(phase)
    for k in fused:
        onp.testing.assert_array_equal(fused[k], phase[k], err_msg=k)


@pytest.mark.cuda
def test_fused_step_and_hybridize_draw_fresh_masks_on_card():
    """On the card the fused step over the Dropout net is a graph replay
    from its second call, and each replay draws a new mask; the
    hybridized forward in training mode too."""
    from _torch_parity import need_cuda
    from mxnet_tpu_torch.gluon import fused_step as fsm

    need_cuda()
    nn = pgluon.nn
    with pmx.gpu(0):
        net = nn.HybridSequential()
        net.add(nn.Dense(64, activation="relu", in_units=12),
                nn.Dropout(0.3), nn.Dense(4, in_units=64))
    net.initialize(pmx.init.Xavier(), ctx=pmx.gpu(0), seed=2)
    tr = pgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.0})
    loss_l = pgluon.loss.SoftmaxCrossEntropyLoss()
    rs = onp.random.RandomState(6)
    x = pmx.nd.array(rs.rand(16, 12).astype(onp.float32), ctx=pmx.gpu(0))
    y = pmx.nd.array(rs.randint(0, 4, 16).astype(onp.float32),
                     ctx=pmx.gpu(0))

    def loss_fn(a, b):
        return loss_l(net(a), b)

    fsm.reset_step_counters()
    losses = [tr.fused_step(loss_fn, x, y).asnumpy() for _ in range(4)]
    (fs,) = tr._fused_steps.values()
    (prog,) = fs._programs.values()
    assert prog.graph is not None and prog.replays == 3
    assert fsm.step_counters["compiles"] == 1
    for a, b in zip(losses[1:], losses[2:]):
        assert not onp.array_equal(a, b)
    net.hybridize()
    with pautograd.train_mode():
        outs = [net(x).asnumpy() for _ in range(3)]
    assert all(p.graph is not None
               for p in net._cached_op._programs.values())
    assert not onp.array_equal(outs[1], outs[2])
