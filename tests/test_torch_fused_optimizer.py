"""The port's multi-tensor optimizer apply (``Optimizer.multi_update``,
``Optimizer.fused_step_apply``) on the CPU in float32.

Ported from the reference's ``tests/test_fused_optimizer.py`` (its line
in brackets): grouped apply against the per-parameter loop
(``MXNET_FUSED_OPTIMIZER=0``) for SGD, Adam and AdamW [:77], per-
parameter ``lr_mult``/``wd_mult`` [:86], ``clip_gradient`` [:104],
bf16 weights with f32 masters [:113], bf16 without [:135], one apply a
group, not a parameter [:193], groups by dtype [:207], the escape hatch
[:216], the analytic SGD update through ``Trainer.step`` [:225], the
optimizer pickling without its cache [:269], and a changed
hyperparameter taking effect [:284] (the port keeps no compiled
executable, so [:269] checks that the optimizer pickles and the copy
updates).  The reference's tolerances are
kept.  The grouped apply is ``fused_step_apply``, the fused step's own;
the escape hatch is the per-parameter loop bit for bit (held below).

``FUSABLE`` is every registered optimizer that the grouped apply serves
(all but SGLD) [:73].  SGLD's per-parameter path [:168] is held in
``tests/test_torch_optimizer_bf16.py``.  Not ported, waiting on the
sparse and kvstore items: the sparse-gradient fallback [:147], the
kvstore server push [:239].

Held against ``mxnet_tpu``: the fused train step's apply
(``fused_step_apply``, device operands) on the same weights, gradients
and states, three steps, within the reference's tolerance (f32), one
bf16 step of the array's largest magnitude (bf16 with f32 masters), or
two (bf16 without: both promote the update to f32, but XLA's CPU fusion
keeps some bf16 intermediates in f32, and three steps compound it).
"""
import pickle

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Parameter
from mxnet_tpu_torch.optimizer.optimizer import (_REGISTRY, apply_counters,
                                                 reset_apply_counters)

CPU = mx.cpu()
SHAPES = [(4, 5), (7,), (2, 3, 4)]
FUSABLE = sorted(k for k, v in _REGISTRY.items() if v._fusable)


def _mk(name, **extra):
    kw = {"learning_rate": 0.05, "wd": 0.01, "rescale_grad": 0.5}
    if name == "sgd":
        kw["momentum"] = 0.9
    kw.update(extra)
    return opt_mod.create(name, **kw)


def _mk_tensors(seed=0, shapes=SHAPES):
    rng = onp.random.RandomState(seed)
    wnp = [rng.randn(*s).astype(onp.float32) for s in shapes]
    gnp = [rng.randn(*s).astype(onp.float32) for s in shapes]
    return wnp, gnp


def _run_steps(opt, wnp, gnp, steps=3, mp=False, dtype=torch.float32):
    ws = [torch.tensor(w).to(dtype) for w in wnp]
    gs = [torch.tensor(g).to(dtype) for g in gnp]
    idxs = list(range(len(ws)))
    mk = opt.create_state_multi_precision if mp else opt.create_state
    ss = [mk(i, w) for i, w in zip(idxs, ws)]
    for _ in range(steps):
        ss = opt.multi_update(idxs, ws, gs, ss)
    return ws, ss


def _assert_close(ws_f, ws_l, name, rtol=2e-5, atol=1e-5):
    for i, (a, b) in enumerate(zip(ws_f, ws_l)):
        onp.testing.assert_allclose(
            a.float().numpy(), b.float().numpy(), rtol=rtol, atol=atol,
            err_msg=f"{name} param {i}: fused != legacy")


@pytest.mark.parametrize("name", FUSABLE)
def test_fused_matches_legacy_all_optimizers(name, monkeypatch):
    wnp, gnp = _mk_tensors()
    ws_f, _ = _run_steps(_mk(name), wnp, gnp)
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    ws_l, _ = _run_steps(_mk(name), wnp, gnp)
    _assert_close(ws_f, ws_l, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("name", FUSABLE)
def test_escape_hatch_equals_per_parameter_loop_bit_for_bit(
        name, mp, dtype, monkeypatch):
    """``MXNET_FUSED_OPTIMIZER=0``: ``multi_update`` is the per-parameter
    ``update_multi_precision`` loop, weights and states bit for bit, and
    the states are updated in the tensors it was given."""
    dt = getattr(torch, dtype)
    wnp, gnp = _mk_tensors(seed=11)
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    runs = []
    for grouped in (True, False):
        opt = _mk(name, multi_precision=mp, clip_gradient=0.3)
        opt.set_lr_mult({0: 0.5})
        ws = [torch.tensor(w).to(dt) for w in wnp]
        gs = [torch.tensor(g).to(dt) for g in gnp]
        ss = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(ws)]
        given = _tensors(ss)
        for _ in range(3):
            if grouped:
                ss = opt.multi_update(list(range(len(ws))), ws, gs, ss)
                assert all(x is y for x, y in zip(_tensors(ss), given))
            else:
                ss = [opt.update_multi_precision(i, w, g, s)
                      for i, (w, g, s) in enumerate(zip(ws, gs, ss))]
        runs.append(ws + _tensors(ss))
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _tensors(states):
    """The tensors of a list of states, in order."""
    out = []
    for s in states:
        if isinstance(s, tuple):
            out += _tensors(s)
        elif s is not None:
            out.append(s)
    return out


@pytest.mark.parametrize("name", FUSABLE)
def test_fused_lr_wd_mult_asymmetry(name, monkeypatch):
    def build():
        o = _mk(name)
        o.set_lr_mult({0: 0.5, 2: 2.0})
        o.set_wd_mult({1: 0.0, 2: 3.0})
        return o
    wnp, gnp = _mk_tensors(seed=1)
    reset_apply_counters()
    ws_f, _ = _run_steps(build(), wnp, gnp)
    assert apply_counters["fused_calls"] == 3   # one a step, not a param
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    ws_l, _ = _run_steps(build(), wnp, gnp)
    _assert_close(ws_f, ws_l, name)


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_fused_clip_gradient(name, monkeypatch):
    wnp, gnp = _mk_tensors(seed=2)
    ws_f, _ = _run_steps(_mk(name, clip_gradient=0.1), wnp, gnp)
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    ws_l, _ = _run_steps(_mk(name, clip_gradient=0.1), wnp, gnp)
    _assert_close(ws_f, ws_l, name)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_fused_multi_precision_master(name, monkeypatch):
    wnp, gnp = _mk_tensors(seed=3)
    ws_f, ss_f = _run_steps(_mk(name, multi_precision=True), wnp, gnp,
                            mp=True, dtype=torch.bfloat16)
    for w, s in zip(ws_f, ss_f):
        assert w.dtype == torch.bfloat16
        assert isinstance(s, tuple) and s[0].dtype == torch.float32
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    ws_l, ss_l = _run_steps(_mk(name, multi_precision=True), wnp, gnp,
                            mp=True, dtype=torch.bfloat16)
    for i, (sf, sl) in enumerate(zip(ss_f, ss_l)):
        onp.testing.assert_allclose(sf[0].numpy(), sl[0].numpy(),
                                    rtol=2e-5, atol=1e-6,
                                    err_msg=f"{name} master {i}")
    _assert_close(ws_f, ws_l, name, rtol=1e-2, atol=1e-2)


def test_fused_bf16_non_mp_close(monkeypatch):
    wnp, gnp = _mk_tensors(seed=4)
    ws_f, _ = _run_steps(_mk("sgd"), wnp, gnp, dtype=torch.bfloat16)
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    ws_l, _ = _run_steps(_mk("sgd"), wnp, gnp, dtype=torch.bfloat16)
    _assert_close(ws_f, ws_l, "sgd-bf16", rtol=2e-2, atol=2e-2)


def _many_param_trainer(n, optimizer="sgd", opt_params=None, dtypes=None):
    rng = onp.random.RandomState(7)
    params = []
    for i in range(n):
        dt = dtypes[i % len(dtypes)] if dtypes else "float32"
        p = Parameter(f"w{i}", shape=(3, 4), dtype=dt)
        p.initialize(init=mx.init.Uniform(), ctx=CPU)
        p.grad()._rebind(torch.tensor(rng.randn(3, 4)).to(
            p.data()._data.dtype))
        params.append(p)
    trainer = gluon.Trainer(params, optimizer,
                            opt_params or {"learning_rate": 0.01},
                            kvstore=None)
    return params, trainer


def test_dispatch_count_one_call_per_group_not_per_param():
    params, trainer = _many_param_trainer(60)
    reset_apply_counters()
    trainer.step(1)
    assert apply_counters["fused_calls"] == 1
    assert apply_counters["fused_params"] == 60
    assert apply_counters["fallback_params"] == 0
    for p in params:            # a fresh gradient for the next step
        p.grad()._rebind(p.grad()._data.clone())
    trainer.step(1)
    assert apply_counters["fused_calls"] == 2


def test_dispatch_count_groups_by_dtype():
    params, trainer = _many_param_trainer(
        50, dtypes=["float32", "bfloat16"])
    reset_apply_counters()
    trainer.step(1)
    assert apply_counters["fused_calls"] == 2   # one a dtype group
    assert apply_counters["fused_params"] == 50


def test_env_escape_hatch_disables_fusion(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", "0")
    params, trainer = _many_param_trainer(50)
    reset_apply_counters()
    trainer.step(1)
    assert apply_counters["fused_calls"] == 0
    assert apply_counters["fallback_params"] == 50


def test_trainer_fused_step_value():
    params, trainer = _many_param_trainer(
        8, opt_params={"learning_rate": 0.1})
    before = [p.data().asnumpy() for p in params]
    grads = [p.grad().asnumpy() for p in params]
    trainer.step(1)
    for p, b, g in zip(params, before, grads):
        onp.testing.assert_allclose(p.data()._data.detach().numpy(),
                                    b - 0.1 * g, rtol=1e-6, atol=1e-7)


def test_optimizer_pickles_without_executable_cache():
    """The port's grouped apply keeps no compiled executable (its ops run
    as they are called), so an optimizer that applied pickles, and the
    copy keeps its update counts and still updates."""
    opt = _mk("adam")
    wnp, gnp = _mk_tensors(seed=9)
    _run_steps(opt, wnp, gnp, steps=1)
    opt2 = pickle.loads(pickle.dumps(opt))
    assert opt2._index_update_count == opt._index_update_count
    ws, _ = _run_steps(opt2, wnp, gnp, steps=1)
    assert not any(torch.equal(w, torch.tensor(a)) for w, a in zip(ws, wnp))


def test_hyperparam_mutation_retraces():
    opt = _mk("sgd")
    wnp, gnp = _mk_tensors(seed=10, shapes=[(4, 5)])
    _run_steps(opt, wnp, gnp, steps=1)
    key = opt._hyper_key()
    opt.momentum = 0.0
    assert opt._hyper_key() != key
    w2 = [torch.tensor(wnp[0])]
    opt.multi_update([0], w2, [torch.tensor(gnp[0])], [None])
    expected = wnp[0] - 0.05 * (0.5 * gnp[0] + 0.01 * wnp[0])
    onp.testing.assert_allclose(w2[0].numpy(), expected, rtol=2e-5,
                                atol=1e-6)


def test_lr_scheduler_drives_learning_rate_and_refuses_set():
    sched = opt_mod.FactorScheduler(step=1, factor=0.5, base_lr=1.0)
    opt = opt_mod.create("sgd", learning_rate=0.4, lr_scheduler=sched)
    assert sched.base_lr == 0.4     # learning_rate seeds the schedule
    assert opt.learning_rate == 0.4
    opt.num_update = 2
    assert opt.learning_rate == pytest.approx(0.1)
    with pytest.raises(MXNetError, match="lr_scheduler"):
        opt.set_learning_rate(0.3)


# --------------------------------------------------------------------------- #
# the fused step's apply against the reference's
# --------------------------------------------------------------------------- #

def _ref_apply(name, kw, wnp, gnp, mp_flags, dtype, steps=3):
    import jax.numpy as jnp
    from mxnet_tpu import optimizer as ref_opt
    from mxnet_tpu.ndarray.ndarray import NDArray as RefND

    opt = ref_opt.create(name, **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ws = [jnp.asarray(w).astype(jdt) for w in wnp]
    gs = [jnp.asarray(g).astype(jdt) for g in gnp]
    ss = [opt.create_state_multi_precision(i, RefND(w)) if mp else
          opt.create_state(i, RefND(w))
          for i, (w, mp) in enumerate(zip(ws, mp_flags))]
    n = len(ws)
    for t in range(1, steps + 1):
        lrs = jnp.asarray([0.05 * (1 + 0.5 * i) for i in range(n)],
                          jnp.float32)
        wds = jnp.asarray([0.01] * n, jnp.float32)
        ts = jnp.asarray([t] * n, jnp.int32)
        ws, ss = opt.fused_step_apply(ws, gs, ss, mp_flags, lrs, wds, ts,
                                      jnp.float32(0.5))
    return [onp.asarray(w.astype(jnp.float32)) for w in ws]


def _port_apply(name, kw, wnp, gnp, mp_flags, dtype, steps=3):
    opt = opt_mod.create(name, **kw)
    dt = getattr(torch, dtype)
    ws = [torch.tensor(w).to(dt) for w in wnp]
    gs = [torch.tensor(g).to(dt) for g in gnp]
    ss = [opt.create_state_multi_precision(i, w) if mp else
          opt.create_state(i, w)
          for i, (w, mp) in enumerate(zip(ws, mp_flags))]
    n = len(ws)
    for t in range(1, steps + 1):
        lrs = torch.tensor([0.05 * (1 + 0.5 * i) for i in range(n)])
        wds = torch.tensor([0.01] * n)
        ts = torch.tensor([float(t)] * n)
        opt.fused_step_apply(ws, gs, ss, mp_flags, lrs, wds, ts,
                             torch.tensor(0.5))
    return [w.float().numpy() for w in ws]


@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", False),
                                      ("bfloat16", True)])
@pytest.mark.parametrize("name", FUSABLE)
def test_fused_step_apply_matches_reference(name, dtype, mp):
    kw = {"clip_gradient": 0.4, "multi_precision": mp}
    if name == "sgd":
        kw["momentum"] = 0.9
    wnp, gnp = _mk_tensors(seed=12)
    flags = [mp] * len(wnp)
    got = _port_apply(name, kw, wnp, gnp, flags, dtype)
    ref = _ref_apply(name, kw, wnp, gnp, flags, dtype)
    for i, (a, b) in enumerate(zip(got, ref)):
        if dtype == "float32":
            tol = dict(rtol=2e-5, atol=1e-5)
        else:       # bf16 steps of the array's largest magnitude
            tol = dict(rtol=0, atol=_bf16_step(b) * (1 if mp else 2))
        onp.testing.assert_allclose(a, b, err_msg=f"{name} {i}", **tol)


def _bf16_step(a):
    return 2.0 ** (onp.floor(onp.log2(onp.abs(a).max())) - 7)
