"""The port's optimizers on half-precision weights without master copies,
against the JAX package's, on the CPU.

The reference types a rule's Python constants as JAX does (weak types: a
number that meets a bf16 array is rounded to bf16 first, so SGD's
momentum 0.9 is 0.8984375 and Adam's beta2 0.999 is 1.0 on a bf16
state), and its traced f32 ``lr``/``wd`` promote what they meet to f32;
inside its jitted ``multi_update`` XLA computes a bf16 operation read by
an f32 one in f32 and rounds the rest.  The port follows that typing on
every path (``optimizer._Half``).  Held here:

- the Gluon path end to end (``gluon.Trainer.step`` and
  ``fused_step``), three steps on an exact-gradient probe (a bias-free
  Dense layer fed the identity, whose loss, its output times the label
  summed, makes each step's gradient the label exactly in both
  packages), SGD (``chip_smoke.py`` phase 16's), Adam and AdamW: every
  weight and state element 0 bf16 steps from the reference's
  ``gluon.Trainer``;
- each rule through ``multi_update`` (the grouped apply) and through
  the per-parameter ``update_multi_precision`` (the reference's eager
  path, every operation rounded), three steps from seeded arrays with
  rescale 1/3, with and without a clip: SGD, Adam and AdamW 0 bf16
  steps apart; the twelve other rules within 2 bf16 steps of each
  array's largest magnitude (most are 0 apart; the rest is f32 summation
  order in a norm or a centered RMSProp difference, and the reference's
  per-parameter Nadam, which turns its weight to f32 with its f32
  schedule state);
- the SPMD path (``parallel.SPMDTrainer``, where ``wd`` is a Python
  number) on the probe for every deterministic rule, within 2 bf16 steps;
- SGLD: with the noise stubbed to zeros, its update equal to the
  reference's with its noise stubbed the same way, bit for bit (f32 and
  bf16); its noise's mean and standard deviation over 10^5 elements
  within 5 sigma of 0 and ``sqrt(lr)``; the grouped apply and the fused
  step take the per-parameter path;
- DCASGD's previous-weight state holding the weight from before the
  update, bit for bit, on the grouped, fused-step and per-parameter
  paths, with and without masters.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import optimizer as popt
from mxnet_tpu_torch.optimizer import optimizer as popt_mod

PROBE_B, PROBE_UNITS = 16, 8
GLUON_OPTS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 0.01, "wd": 0.01},
    "adamw": {"learning_rate": 0.01, "wd": 0.01},
}
EXACT = ("sgd", "adam", "adamw")
RULES = {
    "sgd": {"learning_rate": 0.05, "momentum": 0.9},
    "adam": {"learning_rate": 0.01},
    "adamw": {"learning_rate": 0.01},
    "nag": {"learning_rate": 0.05, "momentum": 0.9},
    "signum": {"learning_rate": 0.01, "wd_lh": 0.01},
    "dcasgd": {"learning_rate": 0.05, "momentum": 0.9},
    "rmsprop": {"learning_rate": 0.01},
    "rmsprop_centered": {"learning_rate": 0.01, "centered": True,
                         "clip_weights": 3.0},
    "adagrad": {"learning_rate": 0.05},
    "adadelta": {"learning_rate": 1.0},
    "nadam": {"learning_rate": 0.01},
    "ftml": {"learning_rate": 0.01},
    "ftrl": {"learning_rate": 0.1},
    "lamb": {"learning_rate": 0.01},
    "lars": {"learning_rate": 0.1},
}
STEPS_APART = 2


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 steps of two bf16-valued arrays."""
    def line(x):
        bits = (onp.asarray(x, onp.float32).view(onp.uint32) >> 16) \
            .astype(onp.int64)
        return onp.where(bits & 0x8000, 0x8000 - bits, bits)

    return onp.abs(line(a) - line(b))


def _bf16_step(a):
    """One bf16 step at the array's largest magnitude."""
    m = float(onp.abs(onp.asarray(a, onp.float32)).max())
    return 2.0 ** (onp.floor(onp.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    if isinstance(state, torch.Tensor):
        return [state.detach().float().numpy()]
    return [onp.asarray(state, onp.float32)]


def _assert_same(want, have, what):
    assert len(want) == len(have), what
    for k, (a, b) in enumerate(zip(want, have)):
        a, b = onp.asarray(a, onp.float32), onp.asarray(b, onp.float32)
        ulps = _bf16_ulps(a, b)
        assert ulps.max() == 0, \
            f"{what} array {k}: {int((ulps > 0).sum())} of {ulps.size} " \
            f"elements differ, up to {int(ulps.max())} bf16 steps"


def _assert_close(want, have, what, steps=STEPS_APART):
    assert len(want) == len(have), what
    for k, (a, b) in enumerate(zip(want, have)):
        a, b = onp.asarray(a, onp.float32), onp.asarray(b, onp.float32)
        tol = steps * _bf16_step(a)
        err = float(onp.abs(a - b).max())
        assert err <= tol, f"{what} array {k}: {err} > {tol}"


# --------------------------------------------------------------------------- #
# the Gluon path end to end, on the exact-gradient probe
# --------------------------------------------------------------------------- #

def _probe_inputs():
    rs = onp.random.RandomState(11)
    w0 = (rs.standard_normal((PROBE_UNITS, PROBE_B))
          * 2.0 ** rs.randint(-6, 3, (PROBE_UNITS, 1))).astype(onp.float32)
    labels = rs.standard_normal((3, PROBE_B, PROBE_UNITS)).astype(onp.float32)
    return w0, labels, onp.eye(PROBE_B, dtype=onp.float32)


def _gluon_reference(name, opt):
    import mxnet_tpu as mx
    from mxnet_tpu import autograd, gluon

    w0, labels, x = _probe_inputs()
    net = gluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B)
    net.initialize()
    net.weight.set_data(mx.nd.array(w0))
    net.cast("bfloat16")
    tr = gluon.Trainer(net.collect_params(), name, dict(opt))
    xb = mx.nd.array(x).astype("bfloat16")
    for g in labels:
        with autograd.record():
            loss = (net(xb) * mx.nd.array(g).astype("bfloat16")).sum(axis=1)
        loss.backward()
        tr.step(PROBE_B)
    return [net.weight.data().asnumpy()] + _flat(tr._states[0])


def _gluon_port(name, opt, fused):
    import mxnet_tpu_torch as pmx
    from mxnet_tpu_torch import autograd, gluon

    w0, labels, x = _probe_inputs()
    with pmx.cpu():
        net = gluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B)
    net.initialize(ctx=pmx.cpu())
    net.weight.set_data(pmx.nd.array(w0, ctx=pmx.cpu()))
    net.cast("bfloat16")
    tr = gluon.Trainer(net.collect_params(), name, dict(opt))
    xb = pmx.nd.array(x, ctx=pmx.cpu()).astype("bfloat16")

    def loss_fn(a, g):
        return (net(a) * g).sum(axis=1)

    for g in labels:
        gb = pmx.nd.array(g, ctx=pmx.cpu()).astype("bfloat16")
        if fused:
            tr.fused_step(loss_fn, xb, gb)
        else:
            with autograd.record():
                loss = loss_fn(xb, gb)
            loss.backward()
            tr.step(PROBE_B)
    return [net.weight.data().asnumpy()] + _flat(tr._states[0])


@pytest.mark.parametrize("fused", [False, True], ids=["step", "fused_step"])
@pytest.mark.parametrize("name", list(GLUON_OPTS))
def test_gluon_path_bf16_matches_reference_ulp_for_ulp(name, fused):
    _assert_same(_gluon_reference(name, GLUON_OPTS[name]),
                 _gluon_port(name, GLUON_OPTS[name], fused),
                 f"{name} {'fused_step' if fused else 'step'}")


# --------------------------------------------------------------------------- #
# every rule, grouped and per parameter
# --------------------------------------------------------------------------- #

SHAPES = [(64, 33), (257,)]


def _rule_arrays(steps=3):
    rs = onp.random.RandomState(3)

    def arr(s):
        return (rs.standard_normal(s) *
                2.0 ** rs.randint(-6, 3, s)).astype(onp.float32)
    return [arr(s) for s in SHAPES], \
        [[arr(s) for s in SHAPES] for _ in range(steps)]


def _run_rule(key, grouped, clip):
    import mxnet_tpu as mx
    from mxnet_tpu import optimizer as jopt

    name = key.split("_")[0]
    kw = dict(RULES[key], wd=0.01, rescale_grad=1 / 3)
    if clip:
        kw["clip_gradient"] = 0.3
    w0, grads = _rule_arrays()
    jo, po = jopt.create(name, **kw), popt.create(name, **kw)
    jw = [mx.nd.array(w, dtype="bfloat16") for w in w0]
    pw = [torch.tensor(w).bfloat16() for w in w0]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ps = [po.create_state_multi_precision(i, w) for i, w in enumerate(pw)]
    idx = list(range(len(SHAPES)))
    for gs in grads:
        jg = [mx.nd.array(g, dtype="bfloat16") for g in gs]
        pg = [torch.tensor(g).bfloat16() for g in gs]
        if grouped:
            js = jo.multi_update(idx, jw, jg, js)
            ps = po.multi_update(idx, pw, pg, ps)
        else:
            js = [jo.update_multi_precision(i, jw[i], jg[i], js[i])
                  for i in idx]
            ps = [po.update_multi_precision(i, pw[i], pg[i], ps[i])
                  for i in idx]
    want = [a for i in idx for a in
            [jw[i].asnumpy().astype(onp.float32)] + _flat(js[i])]
    have = [a for i in idx for a in [pw[i].float().numpy()] + _flat(ps[i])]
    return want, have


@pytest.mark.parametrize("clip", [False, True], ids=["", "clip"])
@pytest.mark.parametrize("grouped", [True, False],
                         ids=["multi_update", "per_parameter"])
@pytest.mark.parametrize("key", list(RULES))
def test_rule_bf16_matches_reference(key, grouped, clip):
    want, have = _run_rule(key, grouped, clip)
    what = f"{key} {'multi_update' if grouped else 'per parameter'}" \
        f"{' clip' if clip else ''}"
    if key in EXACT:
        _assert_same(want, have, what)
    else:
        _assert_close(want, have, what)


# --------------------------------------------------------------------------- #
# the SPMD path
# --------------------------------------------------------------------------- #

def _spmd_probe(pkg_name, name, opt):
    w0, labels, x = _probe_inputs()
    if pkg_name == "jax":
        import jax
        import mxnet_tpu as mx
        from mxnet_tpu import gluon, parallel

        net = gluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B)
        net.initialize()
        net.weight.set_data(mx.nd.array(w0))
        net.cast("bfloat16")
        tr = parallel.SPMDTrainer(
            net, lambda out, label: (out * label).sum(axis=1), name,
            dict(opt), mesh=parallel.make_mesh({"dp": 1},
                                               devices=jax.devices()[:1]))
        for g in labels:
            tr.step(mx.nd.array(x).astype("bfloat16"),
                    mx.nd.array(g).astype("bfloat16"))
        return [net.weight.data().asnumpy()] + _flat(
            jax.tree.map(onp.asarray, tr._opt_states[0]))
    import mxnet_tpu_torch as pmx
    from mxnet_tpu_torch import gluon, parallel

    port = gluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B,
                          device="cpu")
    port.initialize()
    port.weight.set_data(pmx.nd.array(w0, ctx=pmx.cpu()))
    port.cast("bfloat16")
    tr = parallel.SPMDTrainer(
        port, lambda out, label: (out * label).sum(dim=1), name, dict(opt))
    for g in labels:
        tr.step(torch.as_tensor(x).bfloat16(), torch.as_tensor(g).bfloat16())
    return [port.weight.data().asnumpy()] + _flat(tr._states[0])


@pytest.mark.parametrize("key", list(RULES))
def test_spmd_path_bf16_matches_reference(key):
    name = key.split("_")[0]
    opt = dict(RULES[key], wd=0.01)
    _assert_close(_spmd_probe("jax", name, opt),
                  _spmd_probe("port", name, opt), f"{key} SPMD")


# --------------------------------------------------------------------------- #
# SGLD
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgld_deterministic_part_equals_reference(dtype, monkeypatch):
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu import optimizer as jopt

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dt: jnp.zeros(shape, dt))
    monkeypatch.setattr(popt_mod, "_normal", lambda like: torch.zeros(
        like.shape, dtype=like.dtype, device=like.device))
    kw = dict(learning_rate=0.05, wd=0.01, rescale_grad=1 / 3)
    w0, grads = _rule_arrays()
    jo, po = jopt.create("sgld", **kw), popt.create("sgld", **kw)
    jw = [mx.nd.array(w, dtype=dtype) for w in w0]
    pw = [torch.tensor(w).to(getattr(torch, dtype)) for w in w0]
    for gs in grads:
        for i, g in enumerate(gs):
            jo.update(i, jw[i], mx.nd.array(g, dtype=dtype), None)
            po.update(i, pw[i], torch.tensor(g).to(pw[i].dtype), None)
    for a, b in zip(jw, pw):
        onp.testing.assert_array_equal(a.asnumpy().astype(onp.float32),
                                       b.float().numpy())


def test_sgld_noise_statistics():
    """w = 0, g = 0: one update is the noise alone, N(0, lr)."""
    from mxnet_tpu_torch import random as prandom

    prandom.seed(3)
    lr, n = 0.04, 100_000
    o = popt.create("sgld", learning_rate=lr)
    w = torch.zeros(n)
    o.update(0, w, torch.zeros(n), None)
    std = lr ** 0.5
    assert abs(float(w.mean())) <= 5 * std / n ** 0.5
    assert abs(float(w.std()) - std) <= 5 * std / (2 * n) ** 0.5
    w2 = torch.zeros(n)
    o.update(0, w2, torch.zeros(n), None)
    assert not torch.equal(w, w2)           # fresh noise every update


def test_sgld_takes_the_per_parameter_path():
    import mxnet_tpu_torch as pmx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.fused_step import (reset_step_counters,
                                                  step_counters)

    with pmx.cpu():
        net = gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=pmx.cpu())
    tr = gluon.Trainer(net.collect_params(), "sgld", {"learning_rate": 0.1})
    x = pmx.nd.array(onp.ones((2, 3), onp.float32), ctx=pmx.cpu())
    popt_mod.reset_apply_counters()
    reset_step_counters()
    tr.fused_step(lambda a: net(a).sum(axis=1), x)
    assert step_counters["legacy_steps"] == 1
    assert popt_mod.apply_counters == {"fused_calls": 0, "fused_params": 0,
                                       "fallback_params": 2}


# --------------------------------------------------------------------------- #
# DCASGD's previous weight
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", False),
                                      ("bfloat16", True)])
@pytest.mark.parametrize("path", ["multi_update", "per_parameter",
                                  "fused_step"])
def test_dcasgd_keeps_the_pre_update_weight(path, dtype, mp, momentum):
    import mxnet_tpu_torch as pmx
    from mxnet_tpu_torch import gluon

    with pmx.cpu():
        net = gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=pmx.cpu())
    net.cast(dtype)
    tr = gluon.Trainer(net.collect_params(), "dcasgd",
                       {"learning_rate": 0.1, "momentum": momentum,
                        "multi_precision": mp})
    x = pmx.nd.array(onp.arange(6, dtype=onp.float32).reshape(2, 3),
                     ctx=pmx.cpu()).astype(dtype)

    def loss_fn(a):
        return (net(a) * net(a)).sum(axis=1)

    for step in range(2):
        before = [p.data()._data.clone() for p in tr._params]
        masters = [s[0].clone() if mp and s is not None else None
                   for s in tr._states]
        if path == "fused_step":
            tr.fused_step(loss_fn, x)
        else:
            with pmx.autograd.record():
                loss = loss_fn(x)
            loss.backward()
            if path == "per_parameter":
                with pytest.MonkeyPatch.context() as m:
                    m.setenv("MXNET_FUSED_OPTIMIZER", "0")
                    tr.step(2)
            else:
                tr.step(2)
        for i, p in enumerate(tr._params):
            state = tr._states[i]
            prev = state[1][1] if mp else state[1]
            want = masters[i] if mp and step else \
                before[i].float() if mp else before[i]
            assert not torch.equal(p.data()._data, before[i])
            assert torch.equal(prev, want), (path, step, i)
