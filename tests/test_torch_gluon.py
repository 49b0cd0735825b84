"""The Gluon parameter layer of the PyTorch port (``gluon.Parameter``,
``ParameterDict``, ``Block``/``HybridBlock``, deferred initialization,
``collect_params``, ``save_parameters``/``load_parameters``, the NDArray
bridge of every block and loss, ``gluon.Trainer`` over Parameters), on
the CPU (``ctx=mx.cpu()``).

The cases of the reference's ``tests/test_gluon.py`` that need no
unported module come first, in the port's form; then the pins of the
port's design: one storage shared by ``Parameter.data()``, the module
and both trainers; ``grad_req`` write/add/null; NDArray calls following
``autograd.is_training()`` and tensor calls ``nn.Module.training``; and
the parts that are not ported raising ``MXNetError``.  Tolerances are
the reference test's: forward 1e-5 relative, gradients 1e-4.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()


def _nd(a):
    return mx.nd.array(onp.asarray(a, onp.float32), ctx=CPU)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _mlp(*layers):
    net = nn.HybridSequential()
    net.add(*layers)
    return net


# --------------------------------------------------------------------------- #
# the reference's cases
# --------------------------------------------------------------------------- #

def test_parameter_basic():
    p = gluon.Parameter("weight", shape=(4, 3))
    p.initialize(init=mx.init.Xavier(), ctx=CPU)
    assert p.data().shape == (4, 3)
    assert p.grad().shape == (4, 3)
    assert float(p.grad().asnumpy().sum()) == 0.0
    assert p.list_ctx() == [CPU]


def test_parameter_deferred():
    p = gluon.Parameter("weight", shape=(4, 0), allow_deferred_init=True)
    p.initialize(ctx=CPU)
    with pytest.raises(gluon.DeferredInitializationError):
        p.data()
    p.shape = (4, 7)
    p._finish_deferred_init()
    assert p.data().shape == (4, 7)
    assert p.data().context == CPU


def test_dense_forward_matches_numpy():
    with CPU:
        net = nn.Dense(5, in_units=3, use_bias=True)
    net.initialize(ctx=CPU)
    x = _nd(_rand(0, 2, 3))
    out = net(x)
    assert isinstance(out, mx.nd.NDArray)
    w = net.weight.data().asnumpy()
    b = net.bias.data().asnumpy()
    onp.testing.assert_allclose(out.asnumpy(), x.asnumpy() @ w.T + b,
                                rtol=1e-5)


def test_sequential_and_collect_params():
    net = _mlp(nn.Dense(8, activation="relu"), nn.Dense(2))
    net.initialize(ctx=CPU)
    assert net(_nd(_rand(1, 4, 3))).shape == (4, 2)
    params = net.collect_params()
    assert len(params) == 4
    assert len(net.collect_params(".*weight")) == 2
    # the reference's flat names and structural names
    first = net[0].prefix
    assert list(params)[0] == first + "weight"
    assert set(net._collect_params_with_prefix()) == {
        "0.weight", "0.bias", "1.weight", "1.bias"}


@pytest.mark.parametrize("what", ["outputs", "grads"])
def test_hybridize_matches_imperative(what):
    """``hybridize()`` keeps the forward imperative in this slice: the
    outputs and the gradients equal the unhybridized block's."""
    mx.random.seed(7)
    net = _mlp(nn.Dense(16, activation="tanh"), nn.Dense(4))
    net.initialize(init=mx.init.Xavier(), ctx=CPU)
    x = _nd(_rand(2, 5, 7))

    def run():
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        return (net(x).asnumpy() if what == "outputs" else
                net[0].weight.grad().asnumpy().copy())

    before = run()
    net.hybridize()
    assert net[0]._active and net._flags["static_alloc"] is False
    onp.testing.assert_allclose(run(), before, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hybridize", [False, True])
def test_batchnorm_moving_stats_update(hybridize):
    with CPU:
        net = nn.BatchNorm(in_channels=3)
    net.initialize(ctx=CPU)
    if hybridize:
        net.hybridize()
    x = _nd(_rand(3, 8, 3, 4, 4) * 5 + 2)
    with autograd.record():
        net(x)
    mm = net.running_mean.data().asnumpy()
    assert onp.abs(mm).sum() > 0                   # moved off zero
    before = mm.copy()
    net(x)                                          # predict mode: fixed
    onp.testing.assert_array_equal(net.running_mean.data().asnumpy(),
                                   before)


def test_conv2d_deferred_init():
    net = nn.Conv2D(8, 3, padding=1)
    net.initialize(ctx=CPU)
    assert net.weight.shape == (8, 0, 3, 3)
    out = net(_nd(_rand(4, 2, 5, 9, 9)))
    assert out.shape == (2, 8, 9, 9)
    assert net.weight.shape == (8, 5, 3, 3)
    assert dict(net.named_parameters())["weight"].shape == (8, 5, 3, 3)


def test_save_load_parameters(tmp_path):
    def build():
        with CPU:
            return _mlp(nn.Dense(8, in_units=3), nn.Dense(2, in_units=8))

    net = build().initialize(ctx=CPU)
    f = str(tmp_path / "x.params")
    net.save_parameters(f)
    net2 = build()
    net2.load_parameters(f, ctx=CPU)
    for a, b in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        onp.testing.assert_array_equal(a.data().asnumpy(),
                                       b.data().asnumpy())
    # a flat-name file (ParameterDict.save) loads by Parameter.name
    flat = str(tmp_path / "flat.params")
    net.collect_params().save(flat)
    net3 = _mlp(nn.Dense(8), nn.Dense(2))      # deferred: takes the shapes
    names = [p.name for p in net3.collect_params().values()]
    net3.collect_params().load(flat, ctx=CPU, restore_prefix="",
                               allow_missing=True, ignore_extra=True)
    assert all(net3.collect_params()[n]._data is None for n in names)
    net3.load_parameters(f, ctx=CPU)
    onp.testing.assert_array_equal(net3[1].weight.data().asnumpy(),
                                   net[1].weight.data().asnumpy())
    with pytest.raises(MXNetError, match="missing"):
        build().load_parameters(flat, ctx=CPU)


def test_losses():
    pred = _nd(_rand(5, 4, 5))
    label = _nd([0, 2, 1, 4])
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label)
    assert isinstance(loss, mx.nd.NDArray)
    p = pred.asnumpy()
    logp = p - p.max(-1, keepdims=True)
    logp = logp - onp.log(onp.exp(logp).sum(-1, keepdims=True))
    onp.testing.assert_allclose(loss.asnumpy(),
                                -logp[onp.arange(4), [0, 2, 1, 4]],
                                rtol=1e-4)
    l2 = gluon.loss.L2Loss()(pred, pred * 0 + 1.0)
    onp.testing.assert_allclose(l2.asnumpy(),
                                0.5 * ((p - 1.0) ** 2).mean(-1), rtol=1e-5)
    l1 = gluon.loss.L1Loss()(pred, pred * 0)
    onp.testing.assert_allclose(l1.asnumpy(), onp.abs(p).mean(-1),
                                rtol=1e-5)
    # and on tensors, as before
    t = gluon.loss.L1Loss()(torch.as_tensor(p), torch.zeros(4, 5))
    assert isinstance(t, torch.Tensor)


def _one_weight(seed_value=1.0):
    with CPU:
        net = nn.Dense(1, in_units=2, use_bias=False)
    return net.initialize(init=mx.init.Constant(seed_value), ctx=CPU)


def test_trainer_sgd_step():
    net = _one_weight()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = _nd(onp.ones((4, 2)))
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(batch_size=4)
    # dL/dw = [4, 4]; / batch_size = 1 each; w = 1 - 0.1
    onp.testing.assert_allclose(net.weight.data().asnumpy(),
                                onp.full((1, 2), 0.9, onp.float32),
                                rtol=1e-6)


def test_stale_gradient_raises_or_is_skipped():
    """A gradient no backward refreshed since the last step is stale, as
    in MXNet: ``step`` raises, or skips it with ``ignore_stale_grad``."""
    net = _one_weight()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = _nd(onp.ones((4, 2)))
    with autograd.record():
        net(x).sum().backward()
    trainer.step(4)
    with pytest.raises(MXNetError, match="has not been updated"):
        trainer.step(4)
    trainer.step(4, ignore_stale_grad=True)
    onp.testing.assert_allclose(net.weight.data().asnumpy(), [[0.9, 0.9]],
                                rtol=1e-6)


def test_trainer_full_loop_decreases_loss():
    mx.random.seed(42)
    rs = onp.random.RandomState(1)
    xa = rs.randn(64, 10).astype(onp.float32)
    x = _nd(xa)
    y = _nd(rs.randn(64, 1) * 0.01 + xa @ rs.randn(10, 1))
    with CPU:
        net = nn.Dense(1, in_units=10)
    net.initialize(init=mx.init.Normal(0.1), ctx=CPU)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.05})
    loss_fn = gluon.loss.L2Loss()
    losses = []
    for _ in range(60):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch_size=64)
        losses.append(float(loss.mean().asnumpy()))
    assert losses[-1] < losses[0] * 0.1


def test_grad_clipping_pattern():
    net = _one_weight()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0}, kvstore=None)
    x = _nd(onp.full((1, 2), 100.0))
    with autograd.record():
        net(x).sum().backward()
    grads = [p.grad() for p in net.collect_params().values()
             if p.grad_req != "null"]
    total = float(sum((g.norm() ** 2).asnumpy() for g in grads) ** 0.5)
    for g in grads:
        g *= min(1.0, 1.0 / total)
    trainer.update(batch_size=1)
    w = net.weight.data().asnumpy()
    assert onp.linalg.norm(onp.ones((1, 2)) - w) <= 1.0 + 1e-4
    assert gluon.utils.clip_global_norm([_nd([3.0, 4.0])], 1.0) == \
        pytest.approx(5.0)


def test_headline_loop():
    """The reference's headline loop, verbatim but for ``ctx``: deferred
    ``in_units``, ``mx.init.Xavier()``, ``collect_params()``,
    ``hybridize()``, NDArrays in and out, and falling losses."""
    mx.random.seed(0)
    rs = onp.random.RandomState(3)
    x = _nd(rs.rand(16, 20))
    y = _nd(rs.randint(0, 10, 16))
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam")
    losses = []
    for _ in range(10):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        trainer.step(16)
        losses.append(float(loss.mean().asnumpy()))
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0]
    assert [p.shape for p in net.collect_params().values()] == [
        (32, 20), (32,), (10, 32), (10,)]


# --------------------------------------------------------------------------- #
# the port's pins
# --------------------------------------------------------------------------- #

def test_one_storage_for_data_module_and_trainers():
    """``Parameter.data()``'s tensor is the module's ``nn.Parameter``
    before and after both trainers update it."""
    net = _one_weight(0.5)
    leaf = dict(net.named_parameters())["weight"]
    assert net.weight.data()._data is leaf
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = _nd(onp.ones((4, 2)))
    with autograd.record():
        net(x).sum().backward()
    trainer.step(4)
    assert net.weight.data()._data is dict(net.named_parameters())["weight"]
    onp.testing.assert_array_equal(net.weight.data().asnumpy(),
                                   leaf.detach().numpy())
    onp.testing.assert_allclose(leaf.detach().numpy(), [[0.4, 0.4]],
                                rtol=1e-6)
    spmd = parallel.SPMDTrainer(net, gluon.loss.L2Loss(), "sgd",
                                {"learning_rate": 0.1})
    spmd.step(torch.ones(4, 2), torch.zeros(4, 1))
    assert net.weight.data()._data is leaf
    onp.testing.assert_array_equal(net.weight.data().asnumpy(),
                                   leaf.detach().numpy())
    assert not torch.equal(leaf.detach(), torch.full((1, 2), 0.4))
    # a rebind outside record() writes into the same tensor
    w = net.weight.data()
    w -= 0.5
    assert w._data is leaf and net.weight.data() is w


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    """``write`` replaces the gradient, ``add`` accumulates it, ``null``
    keeps none and the tensor needs none."""
    net = _one_weight()
    net.weight.grad_req = req
    leaf = dict(net.named_parameters())["weight"]
    x = _nd(onp.ones((3, 2)))
    for _ in range(2):
        with autograd.record():
            net(x).sum().backward()
    assert leaf.grad is None                     # moved into grad()
    if req == "null":
        assert not leaf.requires_grad
        with pytest.raises(MXNetError, match="null"):
            net.weight.grad()
        return
    want = 3.0 * (2 if req == "add" else 1)
    onp.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                   [[want, want]])
    net.weight.zero_grad()
    assert float(net.weight.grad().asnumpy().sum()) == 0.0


def test_batchnorm_follows_autograd_with_ndarrays_and_train_with_tensors():
    """With NDArrays BatchNorm follows ``autograd.is_training()`` whatever
    ``.train()`` says; with tensors it follows ``nn.Module.training``."""
    with CPU:
        net = nn.BatchNorm(in_channels=3)
    net.initialize(ctx=CPU)
    xa = _rand(6, 8, 3, 4, 4) * 3 + 1
    mm = net.running_mean.data()

    def moved(fn):
        before = mm.asnumpy().copy()
        fn()
        return not onp.array_equal(mm.asnumpy(), before)

    net.train()
    assert not moved(lambda: net(_nd(xa)))               # predict mode
    net.eval()
    with autograd.record():
        assert moved(lambda: net(_nd(xa)))               # train mode
    with autograd.record(train_mode=False):
        assert not moved(lambda: net(_nd(xa)))
    with autograd.train_mode():
        assert moved(lambda: net(_nd(xa)))
    x = torch.as_tensor(xa)
    net.train()
    assert moved(lambda: net(x))
    net.eval()
    with autograd.record():                  # tensors ignore autograd
        assert not moved(lambda: net(x))
    # outside record() an NDArray call records no graph
    out = net(_nd(xa))
    assert out._data.grad_fn is None


def test_spmd_trainer_trains_a_gluon_net():
    """``SPMDTrainer`` takes a net built by this layer, deferred sizes
    included: it collects the parameters after the first forward."""
    mx.random.seed(1)
    net = _mlp(nn.Dense(16, activation="relu"), nn.BatchNorm(),
               nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    rs = onp.random.RandomState(4)
    x = torch.as_tensor(rs.rand(32, 8).astype(onp.float32))
    y = torch.as_tensor(rs.randint(0, 4, 32))
    tr = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.5})
    losses = [float(tr.step(x, y)) for _ in range(8)]
    assert losses[-1] < losses[0]
    trainable = [p for p in net.collect_params().values()
                 if p.grad_req != "null"]
    assert len(tr._params) == len(trainable) == 6
    assert {id(p) for p in tr._params} == \
        {id(p.data()._data) for p in trainable}


def test_gluon_block_names_follow_the_reference_scopes():
    net = nn.HybridSequential(prefix="model_")
    with net.name_scope():
        net.add(nn.Conv2D(3, 1), nn.Dense(4), nn.Dense(4))
    names = list(net.collect_params())
    assert names == ["model_conv2d0_weight", "model_conv2d0_bias",
                     "model_dense0_weight", "model_dense0_bias",
                     "model_dense1_weight", "model_dense1_bias"]
    seen = []
    h = net.register_forward_hook(lambda b, i, o: seen.append(o.shape))
    pre = net.register_forward_pre_hook(lambda b, i: seen.append("pre"))
    net.initialize(ctx=CPU)
    net.hybridize()
    net(_nd(_rand(0, 2, 3, 1, 1)))
    h.detach()
    pre.detach()
    net(_nd(_rand(0, 2, 3, 1, 1)))
    assert seen == ["pre", (2, 4)]


# --------------------------------------------------------------------------- #
# the hybridize features: the CUDA-graph cached op, and since the symbolic
# surface export, optimize_for and SymbolBlock (tests/test_torch_symbol.py
# holds them against the reference)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("what", ["export", "optimize_for", "SymbolBlock",
                                  "_CachedOp", "imports"])
def test_hybridize_features_not_ported_raise(what, tmp_path):
    """Each feature runs, and raises only where the reference does."""
    from mxnet_tpu_torch.gluon import block

    net = _one_weight()
    x = _nd(onp.ones((1, 2)))
    prefix = str(tmp_path / "m")
    if what == "_CachedOp":
        # ported since the fused train step: on the CPU the cached op is
        # the block's forward itself (a CUDA graph on the card)
        op = block._CachedOp(net)
        onp.testing.assert_array_equal(op([x]).asnumpy(),
                                       net(x).asnumpy())
        assert op.builds == 1
    elif what == "export":
        with pytest.raises(MXNetError, match="run the block"):
            net.export(prefix)
        net(x)
        sym = net.export(prefix)
        assert sym.list_arguments() == ["data", net.weight.name]
    elif what == "optimize_for":
        onp.testing.assert_array_equal(net.optimize_for(x).asnumpy(),
                                       [[2.0]])
        assert net._active
    elif what == "SymbolBlock":
        with pytest.raises(MXNetError, match="Symbol"):
            gluon.SymbolBlock(None, None)
    else:
        net(x)
        net.export(prefix)
        blk = gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                        prefix + "-0000.params", ctx=CPU)
        onp.testing.assert_array_equal(blk(x).asnumpy(), [[2.0]])


@pytest.mark.parametrize("what", ["initialize", "split_and_load"])
def test_several_contexts_raise(what):
    net = nn.Dense(2)
    with pytest.raises(MXNetError, match="one card"):
        if what == "initialize":
            net.initialize(ctx=[CPU, mx.cpu(1)])
        else:
            gluon.utils.split_and_load(_nd(onp.ones((4, 2))), [CPU, CPU])


def test_initialize_without_ctx_or_cuda_raises(monkeypatch):
    """``ctx=None`` is the current context, ``gpu(0)``: without CUDA that
    raises, with no quiet fallback to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = nn.Dense(2)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        net.initialize()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        nn.Dense(2, in_units=3)              # sizes known: made at once
    with pytest.raises(MXNetError, match="deferred"):
        nn.Dense(2, device="cpu")            # device= needs every size
    with pytest.raises(MXNetError, match="JAX package"):
        gluon.Parameter("w", shape=(2,)).set_sharding(None)


def test_utils():
    u = gluon.utils
    parts = u.split_data(_nd(onp.arange(10).reshape(5, 2)), 2,
                         even_split=False)
    assert [p.shape for p in parts] == [(3, 2), (2, 2)]
    with pytest.raises(MXNetError, match="evenly"):
        u.split_data(_nd(onp.ones((5, 2))), 2)
    assert u.shape_is_known((2, 3)) and not u.shape_is_known((2, 0))
    with pytest.raises(MXNetError, match="no network"):
        u.download("https://example.invalid/x.params", path="/nonexistent")
