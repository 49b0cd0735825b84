"""The port's fused train step (``Trainer.fused_step``,
``gluon/fused_step.py``), gradient accumulation (``update_interval``),
``autograd.trace_value_and_grad``, the learning-rate schedulers and
``_CachedOp``, on the CPU in float32.  On the CPU a fused step runs its
program eagerly; on the card the same program is a CUDA-graph replay
(the ``cuda``-marked cases, and ``chip_smoke.py`` phase 18).

Ported from the reference's ``tests/test_fused_step.py`` (its line in
brackets): N micro-batches through the fused step against one batch of
N*B phase by phase for SGD, Adam and AdamW [:112], with bf16 weights
and f32 masters [:127], with ``clip_gradient`` [:160];
``MXNET_FUSED_STEP=0`` [:170], also accumulating [:202]; BatchNorm's
running statistics against the phase-by-phase micro path [:217]; one
program run a call and one apply a window [:240]; a new signature makes
one more program [:305]; a new learning rate is an operand, not a new
program [:325]; ``Trainer.zero_grad`` [:365]; ``step`` with ``'add'``
accumulators [:386]; ``'write'`` gradients refused mid-window [:425];
``allreduce_grads``/``update`` refused mid-window [:441];
``update_interval`` validated [:467]; a loss function's extras [:477];
``fused_step`` and ``step`` sharing one window [:566].  The reference's
tolerances are kept.

SGLD taking the phase-by-phase step [:346]; ``save_states`` after
fused steps [:541] is in ``tests/test_torch_trainer_states.py``.  Not
ported, each waiting on a ROADMAP item: the registry-dispatch count
[:276] (the port has no op registry hook in the fused path to count),
the estimator [:498, :518] (``gluon/contrib``, §1 item 7), the
data-sharded step [:587] (one card; ``data_sharding=`` raises) and the
benchmark smoke runs [:633, :639] (``benchmark/`` is not ported).

Every case runs on the reference test's inputs: its seeded data and
its net's weights (``_build_net``, made by ``mxnet_tpu`` and carried by
``save_parameters``).  Held against ``mxnet_tpu``: the reference's Dense
net (no BatchNorm) trained by
both packages' ``Trainer.fused_step`` with SGD, Adam and AdamW at
``update_interval`` 1 and 4 for two windows: every parameter within
1e-5 of its array's largest magnitude.  The four schedulers' learning
rates at updates 0-200, with warmup, equal the reference's.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.fused_step import (fused_step_enabled,
                                              reset_step_counters,
                                              step_counters)
from mxnet_tpu_torch.gluon.parameter import generation
from mxnet_tpu_torch.optimizer.optimizer import (apply_counters,
                                                 reset_apply_counters)

CPU = mx.cpu()
PARITY_TOL = 1e-5       # of each array's largest magnitude


_REF_FILES: dict = {}


def _ref_weights(seed, units, depth, bn, tmp):
    """The reference test's ``_build_net`` weights (``mx.random.seed``,
    Xavier, in ``mxnet_tpu``) as a ``.params`` file, made once."""
    key = (seed, units, depth, bn)
    if key not in _REF_FILES:
        import mxnet_tpu as rmx
        from mxnet_tpu.gluon import nn as rnn

        rmx.random.seed(seed)
        net = rnn.HybridSequential()
        with net.name_scope():
            for _ in range(depth):
                net.add(rnn.Dense(units, activation="relu", in_units=units))
                if bn:
                    net.add(rnn.BatchNorm(in_channels=units))
            net.add(rnn.Dense(1, in_units=units))
        net.initialize(rmx.init.Xavier())
        f = str(tmp / f"ref_{seed}_{units}_{depth}_{int(bn)}.params")
        net.save_parameters(f)
        _REF_FILES[key] = f
    return _REF_FILES[key]


@pytest.fixture(autouse=True, scope="module")
def _ref_dir(tmp_path_factory):
    _REF_FILES["dir"] = tmp_path_factory.mktemp("fused_ref")
    yield
    _REF_FILES.clear()


def _build_net(seed=0, units=8, depth=3, bn=False, dtype=None):
    """The reference test's net, with the reference's weights (carried
    by ``save_parameters``), so every case runs on its inputs."""
    with CPU:
        net = nn.HybridSequential()
        with net.name_scope():
            for _ in range(depth):
                net.add(nn.Dense(units, activation="relu", in_units=units))
                if bn:
                    net.add(nn.BatchNorm(in_channels=units))
            net.add(nn.Dense(1, in_units=units))
    net.load_parameters(_ref_weights(seed, units, depth, bn,
                                     _REF_FILES["dir"]), ctx=CPU)
    if dtype is not None:
        net.cast(dtype)
    return net


def _data(n, units=8, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, units).astype(onp.float32),
            rng.randn(n, 1).astype(onp.float32))


def _nd(a, dtype=None):
    return mx.nd.array(a, ctx=CPU, dtype=dtype)


def _params_np(net):
    return [p.data().asnumpy().astype(onp.float32)
            for p in net.collect_params().values()]


def _run_fused(opt, opt_params, N, B, X, Y, windows=2, seed=0, bn=False,
               dtype=None, net=None):
    net = net if net is not None else _build_net(seed=seed, bn=bn,
                                                 dtype=dtype)
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                       kvstore=None, update_interval=N)

    def loss_fn(x, y):
        return loss_l(net(x), y)

    loss = None
    for _ in range(windows):
        for j in range(N):
            sl = slice(j * B, (j + 1) * B)
            loss = tr.fused_step(loss_fn, _nd(X[sl], dtype),
                                 _nd(Y[sl], dtype))
    return net, tr, loss


def _run_legacy_big_batch(opt, opt_params, NB, X, Y, windows=2, seed=0,
                          dtype=None):
    net = _build_net(seed=seed, dtype=dtype)
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                       kvstore=None)
    for _ in range(windows):
        with autograd.record():
            loss = loss_l(net(_nd(X, dtype)), _nd(Y, dtype))
        loss.backward()
        tr.step(NB)
    return net, tr, loss


# --------------------------------------------------------------------------- #
# N micro-batches (fused, accumulated) against one batch of N*B
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("N", [1, 4])
def test_accumulated_fused_matches_legacy_big_batch(opt, N):
    B = 4
    X, Y = _data(N * B)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    netf, _, _ = _run_fused(opt, kw, N, B, X, Y)
    netl, _, _ = _run_legacy_big_batch(opt, kw, N * B, X, Y)
    for i, (a, b) in enumerate(zip(_params_np(netf), _params_np(netl))):
        onp.testing.assert_allclose(
            a, b, rtol=2e-5, atol=1e-6,
            err_msg=f"{opt} N={N} param {i}: fused-accum != legacy-NB")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_accumulated_fused_multi_precision(opt):
    N, B = 2, 4
    X, Y = _data(N * B)
    kw = {"learning_rate": 0.05, "multi_precision": True}
    netf, trf, _ = _run_fused(opt, kw, N, B, X, Y, dtype="bfloat16")
    netl, trl, _ = _run_legacy_big_batch(opt, kw, N * B, X, Y,
                                         dtype="bfloat16")
    (fs,) = trf._fused_steps.values()
    for i in fs._train_idx:
        assert trf._params[i].data()._data.dtype == torch.bfloat16
        s = trf._states[i]
        assert isinstance(s, tuple) and s[0].dtype == torch.float32
    masters_f = [s[0] for s in trf._states if isinstance(s, tuple)]
    masters_l = [s[0] for s in trl._states if isinstance(s, tuple)]
    assert masters_f and len(masters_f) == len(masters_l)
    for i, (a, b) in enumerate(zip(masters_f, masters_l)):
        onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2,
                                    atol=1e-4, err_msg=f"{opt} master {i}")
    for i, (a, b) in enumerate(zip(_params_np(netf), _params_np(netl))):
        onp.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2,
                                    err_msg=f"{opt} bf16 weight {i}")


def test_fused_clip_gradient_parity():
    N, B = 2, 4
    X, Y = _data(N * B)
    kw = {"learning_rate": 0.05, "clip_gradient": 0.05}
    netf, _, _ = _run_fused("adam", kw, N, B, X, Y)
    netl, _, _ = _run_legacy_big_batch("adam", kw, N * B, X, Y)
    for a, b in zip(_params_np(netf), _params_np(netl)):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_env_hatch_restores_phase_by_phase(monkeypatch):
    B = 8
    X, Y = _data(B)
    kw = {"learning_rate": 0.05}
    netf, _, _ = _run_fused("adam", kw, 1, B, X, Y)
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    assert not fused_step_enabled()
    reset_step_counters()
    netl, _, _ = _run_fused("adam", kw, 1, B, X, Y)
    assert step_counters["legacy_steps"] == 2
    assert step_counters["dispatches"] == 0
    for a, b in zip(_params_np(netf), _params_np(netl)):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)
    net2 = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr2 = gluon.Trainer(net2.collect_params(), "adam", dict(kw),
                        kvstore=None)
    for _ in range(2):
        with autograd.record():
            loss = loss_l(net2(_nd(X)), _nd(Y))
        loss.backward()
        tr2.step(B)
    for a, b in zip(_params_np(netl), _params_np(net2)):
        onp.testing.assert_array_equal(a, b)


def test_env_hatch_accumulation_parity(monkeypatch):
    N, B = 3, 4
    X, Y = _data(N * B)
    kw = {"learning_rate": 0.05}
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    netf, _, _ = _run_fused("sgd", kw, N, B, X, Y)
    monkeypatch.delenv("MXNET_FUSED_STEP")
    netl, _, _ = _run_legacy_big_batch("sgd", kw, N * B, X, Y)
    for a, b in zip(_params_np(netf), _params_np(netl)):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_batchnorm_aux_updates_match_legacy_micro_path(monkeypatch):
    B = 8
    X, Y = _data(2 * B)
    kw = {"learning_rate": 0.05}
    netf, _, _ = _run_fused("sgd", kw, 2, B, X, Y, windows=1, bn=True)
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    netl, _, _ = _run_fused("sgd", kw, 2, B, X, Y, windows=1, bn=True)
    moved = False
    for (n, pf), pl in zip(netf.collect_params().items(),
                           netl.collect_params().values()):
        onp.testing.assert_allclose(pf.data().asnumpy(),
                                    pl.data().asnumpy(), rtol=2e-5,
                                    atol=1e-6, err_msg=n)
        moved |= "running_mean" in n and \
            bool(onp.abs(pf.data().asnumpy()).max() > 0)
    assert moved


@pytest.mark.parametrize("opt,dtype", [("sgd", None), ("adam", None),
                                       ("adamw", None), ("sgd", "bfloat16"),
                                       ("adam", "bfloat16"),
                                       ("adamw", "bfloat16")])
def test_fused_steps_stay_within_a_bf16_step_or_1e_6_of_phase_steps(
        opt, dtype):
    """Three fused steps against three phase-by-phase steps on one batch:
    f32 within 1e-6 of each array's largest magnitude; bf16 weights
    without masters within one bf16 step of it (both apply through
    ``fused_step_apply``, which promotes to f32 through its f32 lr/wd, as
    the reference's does)."""
    B = 8
    X, Y = _data(B)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    nets = [_build_net(dtype=dtype), _build_net(dtype=dtype)]
    loss_l = gluon.loss.L2Loss()
    trs = [gluon.Trainer(n.collect_params(), opt, dict(kw)) for n in nets]
    fn = lambda x, y: loss_l(nets[0](x), y)   # noqa: E731
    for _ in range(3):
        trs[0].fused_step(fn, _nd(X, dtype), _nd(Y, dtype))
        with autograd.record():
            loss = loss_l(nets[1](_nd(X, dtype)), _nd(Y, dtype))
        loss.backward()
        trs[1].step(B)
    for a, b in zip(_params_np(nets[0]), _params_np(nets[1])):
        top = float(onp.abs(b).max())
        tol = 2.0 ** (onp.floor(onp.log2(top)) - 7) if dtype else 1e-6 * top
        assert float(onp.abs(a - b).max()) <= tol


# --------------------------------------------------------------------------- #
# one program run a call, one apply a window
# --------------------------------------------------------------------------- #

def test_dispatch_count_one_executable_per_step_one_apply_per_interval():
    N, B = 4, 4
    X, Y = _data(N * B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.05}, kvstore=None,
                       update_interval=N)

    def loss_fn(x, y):
        return loss_l(net(x), y)

    for j in range(N):
        sl = slice(j * B, (j + 1) * B)
        tr.fused_step(loss_fn, _nd(X[sl]), _nd(Y[sl]))
    reset_step_counters()
    reset_apply_counters()
    windows = 2
    for _ in range(windows):
        for j in range(N):
            sl = slice(j * B, (j + 1) * B)
            tr.fused_step(loss_fn, _nd(X[sl]), _nd(Y[sl]))
    assert step_counters["dispatches"] == windows * N
    assert step_counters["apply_dispatches"] == windows
    assert step_counters["micro_dispatches"] == windows * (N - 1)
    assert step_counters["compiles"] == 0
    assert apply_counters["fused_calls"] == 0       # the apply is inside
    assert apply_counters["fallback_params"] == 0


def test_signature_change_retraces_once():
    B = 8
    X, Y = _data(2 * B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None)

    def loss_fn(x, y):
        return loss_l(net(x), y)

    reset_step_counters()
    tr.fused_step(loss_fn, _nd(X[:B]), _nd(Y[:B]))
    assert step_counters["compiles"] == 1
    tr.fused_step(loss_fn, _nd(X), _nd(Y))
    assert step_counters["compiles"] == 2
    tr.fused_step(loss_fn, _nd(X[:B]), _nd(Y[:B]))
    assert step_counters["compiles"] == 2


def test_lr_change_is_an_operand_not_a_retrace():
    B = 8
    X, Y = _data(B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1}, kvstore=None)

    def loss_fn(x, y):
        return loss_l(net(x), y)

    tr.fused_step(loss_fn, _nd(X), _nd(Y))
    reset_step_counters()
    before = _params_np(net)
    tr.set_learning_rate(0.0)
    tr.fused_step(loss_fn, _nd(X), _nd(Y))
    assert step_counters["compiles"] == 0
    for a, b in zip(before, _params_np(net)):
        onp.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_lr_schedule_is_an_operand_not_a_retrace():
    """A schedule changes lr every step through the same program, and
    the weights equal the phase-by-phase steps under the same schedule."""
    from mxnet_tpu_torch.optimizer import CosineScheduler

    B = 8
    X, Y = _data(B)
    nets = [_build_net(), _build_net()]
    loss_l = gluon.loss.L2Loss()
    trs = [gluon.Trainer(n.collect_params(), "sgd", {
        "momentum": 0.9, "lr_scheduler": CosineScheduler(
            6, base_lr=0.1, warmup_steps=2)}) for n in nets]
    reset_step_counters()
    fn = lambda x, y: loss_l(nets[0](x), y)   # noqa: E731
    for _ in range(6):
        trs[0].fused_step(fn, _nd(X), _nd(Y))
        with autograd.record():
            loss = loss_l(nets[1](_nd(X)), _nd(Y))
        loss.backward()
        trs[1].step(B)
    assert step_counters["compiles"] == 1
    for a, b in zip(_params_np(nets[0]), _params_np(nets[1])):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_sgld_falls_back():
    """SGLD draws its noise inside its rule: the whole step takes the
    phase-by-phase path [:346]."""
    B = 4
    X, Y = _data(B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgld",
                       {"learning_rate": 0.01}, kvstore=None)
    reset_step_counters()
    tr.fused_step(lambda x, y: loss_l(net(x), y), _nd(X), _nd(Y))
    assert step_counters["legacy_steps"] == 1
    assert step_counters["dispatches"] == 0


# --------------------------------------------------------------------------- #
# Trainer: zero_grad, accumulated step(), mid-window errors
# --------------------------------------------------------------------------- #

def _add_grads(net):
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.grad_req = "add"


def test_trainer_zero_grad_resets_add_accumulators():
    net = _build_net()
    _add_grads(net)
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None)
    X, Y = _data(4)
    for _ in range(2):
        with autograd.record():
            loss_l(net(_nd(X)), _nd(Y)).backward()
    g = [p for p in net.collect_params().values()
         if p.grad_req != "null"][0].grad().asnumpy()
    assert onp.abs(g).max() > 0
    tr.zero_grad()
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert onp.abs(p.grad().asnumpy()).max() == 0


def test_step_accumulated_add_rescales_by_effective_batch_once():
    N, B = 3, 4
    X, Y = _data(N * B)
    net = _build_net()
    _add_grads(net)
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None,
                       update_interval=N)
    before = _params_np(net)
    for j in range(N):
        sl = slice(j * B, (j + 1) * B)
        with autograd.record():
            loss_l(net(_nd(X[sl])), _nd(Y[sl])).backward()
        mid = _params_np(net)
        tr.step(B)
        if j < N - 1:
            for a, b in zip(mid, _params_np(net)):
                onp.testing.assert_array_equal(a, b)
    assert any(onp.abs(a - b).max() > 0
               for a, b in zip(before, _params_np(net)))
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert onp.abs(p.grad().asnumpy()).max() == 0
    netl, _, _ = _run_legacy_big_batch("sgd", {"learning_rate": 0.05},
                                       N * B, X, Y, windows=1)
    for a, b in zip(_params_np(net), _params_np(netl)):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def test_step_with_write_grads_mid_window_raises():
    X, Y = _data(4)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None,
                       update_interval=2)
    with autograd.record():
        loss_l(net(_nd(X)), _nd(Y)).backward()
    with pytest.raises(MXNetError, match="grad_req='add'"):
        tr.step(4)


def test_allreduce_and_update_raise_mid_window():
    N, B = 4, 4
    X, Y = _data(B)
    net = _build_net()
    _add_grads(net)
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None,
                       update_interval=N)
    with autograd.record():
        loss_l(net(_nd(X)), _nd(Y)).backward()
    tr.step(B)
    with pytest.raises(MXNetError, match="mid-accumulation window"):
        tr.allreduce_grads()
    with pytest.raises(MXNetError, match="mid-accumulation window"):
        tr.update(B)
    for _ in range(N - 1):
        with autograd.record():
            loss_l(net(_nd(X)), _nd(Y)).backward()
        tr.step(B)
    tr.allreduce_grads()


def test_update_interval_validation():
    net = _build_net()
    with pytest.raises(MXNetError, match="update_interval"):
        gluon.Trainer(net.collect_params(), "sgd", {}, update_interval=0)


def test_loss_fn_extras_ride_through():
    B = 8
    X, Y = _data(B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.0}, kvstore=None)

    def loss_fn(x, y):
        pred = net(x)
        return loss_l(pred, y), pred

    expect = net(_nd(X)).asnumpy()
    loss, pred = tr.fused_step(loss_fn, _nd(X), _nd(Y))
    assert loss.shape == (B,)
    onp.testing.assert_allclose(pred.asnumpy(), expect, rtol=1e-5,
                                atol=1e-6)


def test_mixed_fused_and_imperative_steps_share_window():
    N, B = 2, 4
    X, Y = _data(B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore=None,
                       update_interval=N)

    def loss_fn(x, y):
        return loss_l(net(x), y)

    tr.fused_step(loss_fn, _nd(X), _nd(Y))
    assert tr._window_pos == 1
    with pytest.raises(MXNetError, match="mid-accumulation window"):
        tr.allreduce_grads()
    tr.fused_step(loss_fn, _nd(X), _nd(Y))
    assert tr._window_pos == 0


def test_fused_and_phase_steps_share_optimizer_states():
    """The phase-by-phase path writes into the state tensors the fused
    program reads (a captured graph keeps their storage): a fused, a
    phase-by-phase and a fused step equal three phase-by-phase ones."""
    B = 8
    X, Y = _data(B)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    nets = [_build_net(), _build_net()]
    loss_l = gluon.loss.L2Loss()
    trs = [gluon.Trainer(n.collect_params(), "adam", dict(kw))
           for n in nets]
    fn = lambda x, y: loss_l(nets[0](x), y)   # noqa: E731

    def phase(i):
        with autograd.record():
            loss = loss_l(nets[i](_nd(X)), _nd(Y))
        loss.backward()
        trs[i].step(B)

    trs[0].fused_step(fn, _nd(X), _nd(Y))
    states = [trs[0]._states[i] for i in range(len(trs[0]._states))]
    phase(0)
    assert all(a is b for a, b in zip(states, trs[0]._states))
    trs[0].fused_step(fn, _nd(X), _nd(Y))
    for _ in range(3):
        phase(1)
    for a, b in zip(_params_np(nets[0]), _params_np(nets[1])):
        onp.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# the port's own surface: no grad() buffers, refusals, trace_value_and_grad
# --------------------------------------------------------------------------- #

def test_fused_steps_allocate_no_grad_buffers():
    B = 8
    X, Y = _data(B)
    net = _build_net()
    loss_l = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    params = list(net.collect_params().values())
    assert all(p._data._grad is None for p in params)
    for _ in range(3):
        tr.fused_step(lambda x, y: loss_l(net(x), y), _nd(X), _nd(Y))
    assert all(p._data._grad is None and p._data._data.grad is None
               for p in params)
    with autograd.record():
        loss_l(net(_nd(X)), _nd(Y)).backward()
    assert all(p._data._grad is not None for p in params)


def test_fused_step_refusals():
    net = _build_net()
    tr = gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(MXNetError, match="one card"):
        tr.fused_step(lambda x: x, _nd(onp.ones((2, 8))),
                      data_sharding=object())
    with CPU:
        mod = torch.nn.Linear(2, 2)
    with pytest.raises(MXNetError, match="Gluon"):
        gluon.Trainer(mod, "sgd").fused_step(lambda x: x, torch.ones(1))


def test_trace_value_and_grad_leaves_grad_buffers_alone():
    """The gradients are those of ``backward`` on a twin net, and no
    ``grad()`` buffer nor ``.grad`` is written."""
    B = 8
    X, Y = _data(B)
    nets = [_build_net(), _build_net()]
    loss_l = gluon.loss.L2Loss()
    params = [list(n.collect_params().values()) for n in nets]
    pure = autograd.trace_value_and_grad(
        lambda x, y: (loss_l(nets[0](x), y), nets[0](x)), params[0])
    outs, grads, frozen = pure([p.data()._data for p in params[0]], [],
                               _nd(X)._data, _nd(Y)._data)
    assert pure.out_struct["is_seq"] and len(outs) == 2 and frozen == []
    assert all(p._data._grad is None and p._data._data.grad is None
               for p in params[0])
    with autograd.record():
        loss = loss_l(nets[1](_nd(X)), _nd(Y))
    loss.backward()
    onp.testing.assert_allclose(outs[0].numpy(), loss.asnumpy(), rtol=1e-6)
    for g, p in zip(grads, params[1]):
        onp.testing.assert_allclose(g.numpy(), p.grad().asnumpy(),
                                    rtol=1e-6, atol=1e-7)


def test_launch_counts_read_every_kernel_wrapper():
    from mxnet_tpu_torch.gluon.block import _launch_counts

    assert set(_launch_counts()) == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "q8_matvec",
        "decode_fused", "conv1x1_bwd", "box_nms", "rtc"}


# --------------------------------------------------------------------------- #
# _CachedOp
# --------------------------------------------------------------------------- #

def test_cached_op_keys_generation_clones_and_record(tmp_path):
    X, _ = _data(8)
    net = _build_net()
    net.hybridize()
    x = _nd(X)
    y1 = net(x)
    op = net._cached_op
    assert op is not None and op.builds == 1
    y2 = net(x)
    assert op.builds == 1 and y1._data is not y2._data
    onp.testing.assert_array_equal(y1.asnumpy(), y2.asnumpy())
    net(_nd(X[:4]))                         # a new input shape
    assert op.builds == 2
    with autograd.train_mode():             # a new training flag
        net(x)
    assert op.builds == 3
    # the storage generation: load_parameters and cast drop the programs
    f = str(tmp_path / "n.params")
    net.save_parameters(f)
    g0 = generation()
    net.load_parameters(f, ctx=CPU)
    assert generation() > g0
    net(x)
    assert op.builds == 4
    g1 = generation()
    net.cast("float64")
    assert generation() > g1
    out = net(_nd(X, "float64"))
    assert op.builds == 5 and out.dtype == onp.float64
    # under record() the forward runs imperatively, into torch's graph
    with autograd.record():
        out = net(_nd(X, "float64"))
    assert out._data.grad_fn is not None and op.builds == 5


def test_hybridized_forward_equals_imperative():
    X, _ = _data(8)
    net = _build_net(bn=True)
    want = net(_nd(X)).asnumpy()
    net.hybridize()
    for _ in range(3):
        onp.testing.assert_array_equal(net(_nd(X)).asnumpy(), want)
    net.hybridize(False)
    assert net._cached_op is None


# --------------------------------------------------------------------------- #
# against mxnet_tpu
# --------------------------------------------------------------------------- #

def _ref_net(seed=0, units=8, depth=3):
    import mxnet_tpu as rmx
    from mxnet_tpu.gluon import nn as rnn

    rmx.random.seed(seed)
    net = rnn.HybridSequential()
    with net.name_scope():
        for _ in range(depth):
            net.add(rnn.Dense(units, activation="relu", in_units=units))
        net.add(rnn.Dense(1, in_units=units))
    net.initialize(rmx.init.Xavier())
    return net


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("N", [1, 4])
def test_fused_step_matches_reference(opt, N, tmp_path):
    import mxnet_tpu as rmx

    B = 4
    X, Y = _data(N * B, seed=3)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    ref = _ref_net()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    rtr = rmx.gluon.Trainer(ref.collect_params(), opt, dict(kw),
                            kvstore=None, update_interval=N)
    rloss = rmx.gluon.loss.L2Loss()

    def rfn(x, y):
        return rloss(ref(x), y)

    for _ in range(2):
        for j in range(N):
            sl = slice(j * B, (j + 1) * B)
            rtr.fused_step(rfn, rmx.nd.array(X[sl]), rmx.nd.array(Y[sl]))
    net = _build_net(seed=9)
    net.load_parameters(f, ctx=CPU)
    _run_fused(opt, kw, N, B, X, Y, net=net)
    got = net._collect_params_with_prefix()
    for k, p in ref._collect_params_with_prefix().items():
        want = p.data().asnumpy()
        err = float(onp.abs(got[k].data().asnumpy() - want).max())
        assert err <= PARITY_TOL * float(onp.abs(want).max()), (k, err)


def _bf16_run(pkg, net, opt, kw, fused, X, Y):
    """Three bf16 steps of ``net`` (cast after the weights were loaded)
    through ``pkg``'s ``Trainer``: ``fused_step``, or record, backward and
    ``step``; the parameters by structural name, in f32."""
    tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw),
                           kvstore=None)
    loss_l = pkg.gluon.loss.L2Loss()

    def fn(x, y):
        return loss_l(net(x), y)

    ctx = {"ctx": CPU} if pkg is mx else {}
    for _ in range(3):
        x = pkg.nd.array(X, dtype="bfloat16", **ctx)
        y = pkg.nd.array(Y, dtype="bfloat16", **ctx)
        if fused:
            tr.fused_step(fn, x, y)
        else:
            with pkg.autograd.record():
                loss = fn(x, y)
            loss.backward()
            tr.step(X.shape[0])
    return {k: onp.asarray(p.data().asnumpy(), dtype=onp.float32)
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phase"])
@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_bf16_steps_match_reference(opt, fused, tmp_path):
    """bf16 weights without masters, three steps, both packages: the
    port's ``fused_step`` against the reference's, and its phase-by-phase
    ``Trainer.step`` against the reference's, within two bf16 steps of
    each array's largest magnitude (the tolerance of
    ``fused_step_apply`` against the reference's: XLA's CPU fusion keeps
    some bf16 intermediates in f32).  Fused against phase by phase, each
    package equals itself (held in bf16 for the port above)."""
    import mxnet_tpu as rmx

    X, Y = _data(8, seed=3)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    ref = _ref_net()
    f = str(tmp_path / "ref.params")
    ref.save_parameters(f)
    ref.cast("bfloat16")
    want = _bf16_run(rmx, ref, opt, kw, fused, X, Y)
    net = _build_net(seed=9)
    net.load_parameters(f, ctx=CPU)
    net.cast("bfloat16")
    got = _bf16_run(mx, net, opt, kw, fused, X, Y)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        step = 2.0 ** (onp.floor(onp.log2(onp.abs(w).max())) - 7)
        assert float(onp.abs(got[k] - w).max()) <= 2 * step, k


def _schedulers(pkg):
    ls = pkg.optimizer.lr_scheduler
    return {
        "factor": ls.FactorScheduler(step=10, factor=0.9, base_lr=0.1,
                                     warmup_steps=5, warmup_begin_lr=0.01),
        "multifactor": ls.MultiFactorScheduler(
            step=[20, 50, 120], factor=0.5, base_lr=0.2, warmup_steps=10,
            warmup_begin_lr=0.05, warmup_mode="constant"),
        "poly": ls.PolyScheduler(200, base_lr=0.1, pwr=2, final_lr=1e-3,
                                 warmup_steps=20),
        "cosine": ls.CosineScheduler(180, base_lr=0.1, final_lr=1e-3,
                                     warmup_steps=15, warmup_begin_lr=0.0),
    }


@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly",
                                  "cosine"])
def test_lr_schedulers_match_reference(kind):
    import mxnet_tpu as rmx

    got, ref = _schedulers(mx)[kind], _schedulers(rmx)[kind]
    assert [got(n) for n in range(201)] == [ref(n) for n in range(201)]


def test_lr_scheduler_refuses_bad_arguments():
    ls = mx.lr_scheduler
    with pytest.raises(MXNetError):
        ls.LRScheduler(warmup_mode="cubic")
    with pytest.raises(MXNetError):
        ls.FactorScheduler(step=0)
    with pytest.raises(MXNetError):
        ls.MultiFactorScheduler(step=[5, 3])


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _card_net(seed=0, units=8, depth=3):
    """``_build_net``'s net on the card with the port's own seeded Xavier
    weights (the card's machine has no JAX to make the reference's)."""
    ctx = mx.gpu(0)
    with ctx:
        net = nn.HybridSequential()
        with net.name_scope():
            for _ in range(depth):
                net.add(nn.Dense(units, activation="relu", in_units=units))
            net.add(nn.Dense(1, in_units=units))
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    return net


@pytest.mark.cuda
def test_fused_steps_replay_a_graph_and_equal_phase_steps_on_card():
    from _torch_parity import need_cuda

    need_cuda()
    B = 8
    X, Y = _data(B)
    nets = [_card_net(), _card_net()]
    loss_l = gluon.loss.L2Loss()
    trs = [gluon.Trainer(n.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
           for n in nets]
    x, y = (mx.nd.array(a, ctx=mx.gpu(0)) for a in (X, Y))
    fn = lambda a, b: loss_l(nets[0](a), b)   # noqa: E731
    reset_step_counters()
    for _ in range(3):      # eager, capture and replay, replay
        trs[0].fused_step(fn, x, y)
        with autograd.record():
            loss = loss_l(nets[1](x), y)
        loss.backward()
        trs[1].step(B)
    (fs,) = trs[0]._fused_steps.values()
    (prog,) = fs._programs.values()
    assert prog.graph is not None and prog.replays == 2
    assert step_counters["compiles"] == 1
    for a, b in zip(_params_np(nets[0]), _params_np(nets[1])):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_random_refuses_a_capture_on_card():
    from _torch_parity import need_cuda
    from mxnet_tpu_torch import random as mxrandom

    need_cuda()
    g = torch.cuda.CUDAGraph()
    raised = []
    x = torch.zeros(1, device="cuda")
    with torch.cuda.graph(g):
        x.add_(1)
        for fn in (mxrandom.attention_seed,
                   lambda: mxrandom.generator("cuda")):
            try:
                fn()
            except MXNetError:
                raised.append(fn)
    assert len(raised) == 2


@pytest.mark.cuda
def test_hybridized_forward_replays_on_card():
    from _torch_parity import need_cuda

    need_cuda()
    X, _ = _data(8)
    net = _card_net()
    x = mx.nd.array(X, ctx=mx.gpu(0))
    want = net(x).asnumpy()
    net.hybridize()
    outs = [net(x) for _ in range(3)]
    assert all(p.graph is not None
               for p in net._cached_op._programs.values())
    assert outs[1]._data.data_ptr() != outs[2]._data.data_ptr()
    for o in outs:
        onp.testing.assert_allclose(o.asnumpy(), want, rtol=1e-6,
                                    atol=1e-7)
