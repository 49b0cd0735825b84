"""The training side's telemetry of the port against the JAX package's,
on the CPU: the trainer's memory ledger (``train.params``,
``train.opt_states``, ``train.grad_accum``) and ``release_accounting``;
the fused step's ``fused_step_seconds``/``fused_step_dispatches_total``/
``fused_step_window_pos`` and its compile watch; the ``hybridize()``
program's compile watch (``compiles_total{site="gluon.cached_op"}``)."""
import gc

import numpy as onp
import pytest

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference

rmx = LazyReference()

X = onp.linspace(-1, 1, 8 * 4, dtype=onp.float32).reshape(8, 4)
Y = onp.arange(8, dtype=onp.float32) % 3


def _net(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, in_units=4, activation="relu"),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net


def _tele(mx):
    t = mx.telemetry
    return {"micro": t.histogram("fused_step_seconds", phase="micro").count,
            "apply": t.histogram("fused_step_seconds", phase="apply").count,
            "d_micro": t.counter("fused_step_dispatches_total",
                                 phase="micro").value,
            "d_apply": t.counter("fused_step_dispatches_total",
                                 phase="apply").value,
            "d_legacy": t.counter("fused_step_dispatches_total",
                                  phase="legacy").value,
            "fs_compiles": t.counter("compiles_total",
                                     site="gluon.fused_step").value,
            "co_compiles": t.counter("compiles_total",
                                     site="gluon.cached_op").value}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _run(mx, legacy_env):
    ctx = mx.cpu()
    with ctx:
        net = _net(mx)
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.01}, update_interval=2)

        def loss_fn(x, y):
            return loss(net(x), y)

        x, y = mx.nd.array(X), mx.nd.array(Y)
        before = _tele(mx)
        for _ in range(4):
            tr.fused_step(loss_fn, x, y)
        after = _tele(mx)
        acc = mx.telemetry.memory.ACCOUNTANT
        label = tr._mem_label
        mem = {s: acc.bytes(s, key=label) for s in ("train.params",
                                                     "train.opt_states")}
        mem["train.grad_accum"] = acc.bytes("train.grad_accum")
        legacy_env.setenv("MXNET_FUSED_STEP", "0")
        tr.fused_step(loss_fn, x, y)
        tr.fused_step(loss_fn, x, y)
        legacy_env.delenv("MXNET_FUSED_STEP")
        legacy = _delta(after, _tele(mx))
        window = mx.telemetry.gauge("fused_step_window_pos").value
        return tr, net, _delta(before, after), legacy, mem, window


def _param_bytes(net):
    return sum(p.data().asnumpy().nbytes
               for p in net.collect_params().values())


def test_fused_step_instruments_match_reference(monkeypatch):
    r_tr, r_net, r_d, r_leg, r_mem, _ = _run(rmx, monkeypatch)
    p_tr, p_net, p_d, p_leg, p_mem, p_win = _run(pmx, monkeypatch)
    assert p_d["micro"] == p_d["apply"] == p_d["d_micro"] == \
        p_d["d_apply"] == 2
    assert p_d["d_legacy"] == 0 and p_leg["d_legacy"] == 2
    # one compile a program (micro and apply); the reference's jit counts
    # a retrace of one of them as well
    assert p_d["fs_compiles"] == 2 and r_d["fs_compiles"] >= 2
    for k in ("micro", "apply", "d_micro", "d_apply", "d_legacy"):
        assert p_d[k] == r_d[k], k
        assert p_leg[k] == r_leg[k], k
    assert p_win == 0


def test_ledger_entries_equal_reference_and_release(monkeypatch):
    r_tr, r_net, _, _, r_mem, _ = _run(rmx, monkeypatch)
    p_tr, p_net, _, _, p_mem, _ = _run(pmx, monkeypatch)
    nb = _param_bytes(p_net)
    assert p_mem["train.params"] == nb == _param_bytes(r_net)
    # Adam: mean and variance, f32, per parameter
    assert p_mem["train.opt_states"] == 2 * nb == r_mem["train.opt_states"]
    assert p_mem["train.params"] == r_mem["train.params"]
    acc = pmx.telemetry.memory.ACCOUNTANT
    ring = [k for (s, k) in acc._entries if s == "train.grad_accum" and
            k.startswith(p_tr._mem_label + ":")]
    assert len(ring) == 1 and acc.bytes("train.grad_accum",
                                        key=ring[0]) == nb
    p_tr.release_accounting()
    for s in ("train.params", "train.opt_states"):
        assert acc.bytes(s, key=p_tr._mem_label) == 0
    assert acc.bytes("train.grad_accum", key=ring[0]) == 0


def test_collected_trainer_drops_its_entries(monkeypatch):
    tr, net, _, _, _, _ = _run(pmx, monkeypatch)
    label = tr._mem_label
    acc = pmx.telemetry.memory.ACCOUNTANT
    assert acc.bytes("train.params", key=label) > 0
    del tr
    gc.collect()
    assert acc.bytes("train.params", key=label) == 0
    assert acc.bytes("train.opt_states", key=label) == 0


def test_phase_by_phase_step_accounts_too():
    with pmx.cpu():
        net = _net(pmx)
        tr = pmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        loss = pmx.gluon.loss.L2Loss()
        with pmx.autograd.record():
            out = loss(net(pmx.nd.array(X)), pmx.nd.zeros((8, 3)))
        out.backward()
        tr.step(8)
    acc = pmx.telemetry.memory.ACCOUNTANT
    nb = _param_bytes(net)
    assert acc.bytes("train.params", key=tr._mem_label) == nb
    assert acc.bytes("train.opt_states", key=tr._mem_label) == nb
    assert tr._mem_accounted
    tr.release_accounting()
    assert acc.bytes("train.params", key=tr._mem_label) == 0


def _cached_op_compiles(mx):
    with mx.cpu():
        net = _net(mx)
        net.hybridize()
        c = mx.telemetry.counter("compiles_total", site="gluon.cached_op")
        before = c.value
        x = mx.nd.array(X)
        net(x)
        net(x)
        first = c.value - before
        net(mx.nd.array(X[:4]))
        return first, c.value - before


def test_hybridize_compile_watch_matches_reference():
    assert _cached_op_compiles(pmx) == _cached_op_compiles(rmx) == (1, 2)
    ev = [e for e in pmx.telemetry.events("compile")
          if e["site"] == "gluon.cached_op"]
    assert ev and ev[-1]["kernel_nodes"] is None and \
        ev[-1]["training"] is False


def test_cached_op_programs_carry_the_compile_watch():
    with pmx.cpu():
        net = _net(pmx)
        net.hybridize()
        x = pmx.nd.array(X)
        want = net(x).asnumpy()
        with pmx.autograd.train_mode():
            net(x)
        progs = list(net._cached_op._programs.values())
        assert len(progs) == 2 and not any(p.on_card for p in progs)
        assert [p.watch.site for p in progs] == ["gluon.cached_op"] * 2
        assert sorted(p.watch.fields["training"] for p in progs) == \
            [False, True]
        # the watched program is the forward itself, on each call's arrays
        onp.testing.assert_array_equal(net(x).asnumpy(), want)
        assert [p.watch.events for p in progs] == [1, 1]


def test_telemetry_off_leaves_programs_unwatched(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    with pmx.cpu():
        net = _net(pmx)
        net.hybridize()
        c = pmx.telemetry.counter("compiles_total", site="gluon.cached_op")
        before = c.value
        net(pmx.nd.array(X))
        assert c.value == before
