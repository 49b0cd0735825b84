"""The thirteenth slice on the CPU: the new optimizers on the port's
trainers against the JAX package's, and ``Trainer.save_states``/
``load_states`` across the two packages.

- a 2-layer, 64-unit GPT through ``parallel.SPMDTrainer`` with LAMB,
  three f32 steps: losses within 1e-5 relative, every weight within 1e-5
  of its array's largest magnitude of the reference's (the arrays that
  start at zero, biases and LayerNorm's beta, within 1e-5 of the net's
  largest weight: where their gradient is summation noise LAMB's
  normalized step moves them by its full size either way);
- the narrow bottleneck ResNet of ``tests/test_torch_gluon_parity.py``
  (its weights carried by ``save_parameters``) through ``gluon.Trainer``
  with LARS, two steps at lr 0.01 with ``eta`` 1 (the default 0.001 would
  move the weights by less than the tolerance): every parameter and
  running statistic within 1e-5 of its array's largest magnitude (the
  biases that feed a BatchNorm, whose gradient is summation noise,
  within 1e-5 of the net's largest magnitude), and the weights moved;
- states files: written by the reference and read by the port, and
  written by the port and read by the reference, for f32 Adam, bf16
  Adam with f32 masters, bf16 SGD without masters (bf16 arrays in the
  file), Nadam (its 0-d f32 schedule state), DCASGD without momentum
  (``None`` in its state), a frozen parameter whose state was never
  created and bf16 LARS with f32 masters (phase 19.2's): every array and update count equal bit for bit, dtypes
  kept, and the next step of both trainers within the parity tolerance;
  a port run resumed from its files equal to the uninterrupted run bit
  for bit (phase by phase and through ``fused_step``);
- the port reading a reference bf16 file in a process where ``import
  ml_dtypes`` fails;
- ``save_states``/``load_states`` refused mid-window, and a load
  refusing another structure, shape or dtype;
- a load into a trainer whose fused step is built continuing from the
  loaded state with no new program (on the card: no new capture);
- the reference's ``test_trainer_save_load_states``
  (``tests/test_gluon.py:191``) and ``test_save_load_states_after_fused_
  steps`` (``tests/test_fused_step.py:541``);
- ``chip_smoke.reference_gluon_sgd``, the plain loop phases 16 and 18.2
  are held against on the card, equal to the reference's
  ``gluon.Trainer`` on bf16 SGD without masters, ulp for ulp.
"""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch.base import MXNetError

CPU = pmx.cpu()
TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


def _close(got, ref, what, scale=None):
    got, ref = onp.asarray(got, onp.float32), onp.asarray(ref, onp.float32)
    assert got.shape == ref.shape, what
    if scale is None:
        scale = max(float(onp.abs(ref).max()), 1e-6)
    err = float(onp.abs(got - ref).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


# --------------------------------------------------------------------------- #
# the slice's optimizers on the trainers
# --------------------------------------------------------------------------- #

def test_gpt_spmd_lamb_matches_reference():
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel
    from _torch_parity import jax_gpt, port_gpt
    from mxnet_tpu_torch import parallel as pparallel
    from mxnet_tpu_torch.models import arrays_from_port

    net = jax_gpt(init=0.02, num_layers=2, units=64, hidden_size=256)
    model = port_gpt(net)
    rs = onp.random.RandomState(5)
    data = rs.randint(0, 97, (2, 32)).astype(onp.int32)
    label = rs.randint(0, 97, (2, 32)).astype(onp.int32)
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = parallel.SPMDTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", dict(opt),
        mesh=parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    ptr = pparallel.SPMDTrainer(model, pgluon.loss.SoftmaxCrossEntropyLoss(),
                                "lamb", dict(opt))
    start = {k: onp.array(a) for k, a in
             arrays_from_port(model, prefix=net.prefix).items()}
    ref = [float(jtr.step(mx.nd.array(data, dtype="int32"),
                          mx.nd.array(label, dtype="int32")).asnumpy())
           for _ in range(3)]
    got = [float(ptr.step(torch.as_tensor(data), torch.as_tensor(label)))
           for _ in range(3)]
    onp.testing.assert_allclose(got, ref, rtol=TOL)
    want = {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in net.collect_params().items()}
    have = arrays_from_port(model, prefix=net.prefix)
    assert sorted(have) == sorted(want)
    net_scale = max(float(onp.abs(r).max()) for r in want.values())
    for k, r in want.items():
        # arrays that start at zero move by LAMB's full step where their
        # gradient is summation noise: held to the net's magnitude
        from_zero = k.endswith(("bias", "beta"))
        _close(have[k], r, k, net_scale if from_zero else None)
    assert any(not onp.array_equal(have[k], start[k]) for k in have)


def test_resnet_gluon_lars_matches_reference(tmp_path):
    import test_torch_gluon_parity as gp
    import mxnet_tpu as mx

    mx.random.seed(0)
    ref_net = gp._build(mx, "resnet")
    ref_net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                      magnitude=3))
    ref_net.hybridize()
    ref_net(mx.nd.array(gp._batch("resnet")[0]))
    f = str(tmp_path / "resnet.params")
    ref_net.save_parameters(f)
    port_net = gp._port("resnet", {"file": f})
    start = gp._by_structure(port_net)
    opt = {"learning_rate": 0.01, "eta": 1.0, "wd": 1e-4}
    runs = []
    for pkg, net in ((mx, ref_net), (pmx, port_net)):
        ctx = dict(ctx=CPU) if pkg is pmx else {}
        x, y = (pkg.nd.array(a, **ctx) for a in gp._batch("resnet"))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = pkg.gluon.Trainer(net.collect_params(), "lars", dict(opt))
        for _ in range(2):
            with pkg.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(x.shape[0])
        runs.append(gp._by_structure(net))
    want, have = runs
    assert sorted(want) == sorted(have)
    net_scale = max(float(onp.abs(a).max()) for a in want.values())
    for k in want:
        _close(have[k], want[k], k, net_scale if gp._NOISE.search(k)
               else None)
    moved = [k for k in want if k.endswith("weight") and
             float(onp.abs(have[k] - start[k]).max()) >
             100 * TOL * float(onp.abs(want[k]).max())]
    assert len(moved) >= 10, moved


# --------------------------------------------------------------------------- #
# states files across the packages
# --------------------------------------------------------------------------- #

# name, optimizer parameters, dtype, frozen first layer
CASES = {
    "f32_adam": ("adam", {"learning_rate": 0.01}, "float32", False),
    "bf16_masters_adam": ("adam", {"learning_rate": 0.01,
                                   "multi_precision": True},
                          "bfloat16", False),
    "bf16_sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                         "wd": 1e-4}, "bfloat16", False),
    "nadam": ("nadam", {"learning_rate": 0.01}, "float32", False),
    "dcasgd": ("dcasgd", {"learning_rate": 0.1}, "float32", False),
    "not_created": ("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                    "float32", True),
    "bf16_masters_lars": ("lars", {"learning_rate": 1.0, "wd": 1e-4,
                                   "multi_precision": True},
                          "bfloat16", False),
}


def _mlp(pkg, dtype, frozen, f=None):
    nn = pkg.gluon.nn
    ctx = CPU if pkg is pmx else None
    if pkg is pmx:
        with CPU:
            net = nn.HybridSequential()
            net.add(nn.Dense(6, activation="relu", in_units=4),
                    nn.Dense(3, in_units=6))
    else:
        net = nn.HybridSequential()
        net.add(nn.Dense(6, activation="relu", in_units=4),
                nn.Dense(3, in_units=6))
    if f is None:
        pkg.random.seed(1)
        net.initialize(pkg.init.Xavier(), **({"ctx": ctx} if ctx else {}))
    else:
        net.load_parameters(f, **({"ctx": ctx} if ctx else {}))
    net.cast(dtype)
    if frozen:
        for p in net[0].collect_params().values():
            p.grad_req = "null"
    return net


def _mlp_batch(pkg, dtype, k):
    rs = onp.random.RandomState(20 + k)
    x = rs.standard_normal((5, 4)).astype(onp.float32)
    y = rs.standard_normal((5, 3)).astype(onp.float32)
    ctx = dict(ctx=CPU) if pkg is pmx else {}
    return tuple(pkg.nd.array(a, **ctx).astype(dtype) for a in (x, y))


def _mlp_step(pkg, net, trainer, dtype, k, fused=False):
    x, y = _mlp_batch(pkg, dtype, k)
    loss_l = pkg.gluon.loss.L2Loss()
    if fused:
        return trainer.fused_step(_LOSS_FNS.setdefault(
            id(net), lambda a, b: loss_l(net(a), b)), x, y)
    with pkg.autograd.record():
        loss = loss_l(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


_LOSS_FNS: dict = {}


def _file_arrays(state):
    """A state's arrays in order, as numpy (bf16 as its raw bits, with
    the dtype's name), ``None`` kept."""
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _file_arrays(s)]
    if state is None:
        return [None]
    if isinstance(state, torch.Tensor):
        if state.dtype == torch.bfloat16:
            return [("bfloat16", state.view(torch.int16).numpy().copy())]
        return [(str(state.dtype).split(".")[1], state.numpy().copy())]
    a = onp.asarray(state)
    if a.dtype.name == "bfloat16":
        return [("bfloat16", a.view(onp.int16).copy())]
    return [(a.dtype.name, a.copy())]


def _assert_states_equal(a_states, b_states):
    assert len(a_states) == len(b_states)
    for a, b in zip(a_states, b_states):
        fa, fb = _file_arrays(a), _file_arrays(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            if x is None or y is None:
                assert x is None and y is None
                continue
            assert x[0] == y[0], (x[0], y[0])
            onp.testing.assert_array_equal(x[1], y[1])


def _params(net):
    return {k: p.data().asnumpy().astype(onp.float32)
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_file_loads_in_the_port(case, tmp_path):
    import mxnet_tpu as mx

    name, opt, dtype, frozen = CASES[case]
    net = _mlp(mx, dtype, frozen)
    tr = mx.gluon.Trainer(net.collect_params(), name, dict(opt))
    for k in range(2):
        _mlp_step(mx, net, tr, dtype, k)
    fp, fs = str(tmp_path / "r.params"), str(tmp_path / "r.states")
    net.save_parameters(fp)
    tr.save_states(fs)
    port = _mlp(pmx, dtype, frozen, fp)
    ptr = pgluon.Trainer(port.collect_params(), name, dict(opt))
    ptr.load_states(fs)
    assert ptr.optimizer.num_update == tr._optimizer.num_update == 2
    assert ptr.optimizer._index_update_count == \
        tr._optimizer._index_update_count
    assert ptr._states_created == tr._states_created
    _assert_states_equal(tr._states, ptr._states)
    for k in (2, 3):
        _mlp_step(mx, net, tr, dtype, k)
        _mlp_step(pmx, port, ptr, dtype, k)
    want, have = _params(net), _params(port)
    for k in want:
        if dtype == "bfloat16":     # 2 bf16 steps of the array
            step = 2.0 ** (onp.floor(onp.log2(onp.abs(want[k]).max())) - 7)
            assert onp.abs(have[k] - want[k]).max() <= 2 * step, k
        else:
            _close(have[k], want[k], k)


@pytest.mark.parametrize("case", list(CASES))
def test_port_file_loads_in_the_reference(case, tmp_path):
    import mxnet_tpu as mx

    name, opt, dtype, frozen = CASES[case]
    port = _mlp(pmx, dtype, frozen)
    ptr = pgluon.Trainer(port.collect_params(), name, dict(opt))
    for k in range(2):
        _mlp_step(pmx, port, ptr, dtype, k)
    fp, fs = str(tmp_path / "p.params"), str(tmp_path / "p.states")
    port.save_parameters(fp)
    ptr.save_states(fs)
    net = _mlp(mx, dtype, frozen, fp)
    tr = mx.gluon.Trainer(net.collect_params(), name, dict(opt))
    tr.load_states(fs)
    assert tr._optimizer.num_update == 2
    assert tr._optimizer._index_update_count == \
        ptr.optimizer._index_update_count
    assert tr._states_created == ptr._states_created
    _assert_states_equal(ptr._states, tr._states)
    _mlp_step(mx, net, tr, dtype, 2)     # the reference runs on from it
    assert tr._optimizer.num_update == 3


@pytest.mark.parametrize("fused", [False, True], ids=["step", "fused_step"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_resume_equals_uninterrupted_run(case, fused, tmp_path):
    name, opt, dtype, frozen = CASES[case]
    net = _mlp(pmx, dtype, frozen)
    tr = pgluon.Trainer(net.collect_params(), name, dict(opt))
    for k in range(4):
        if k == 2:
            fp, fs = str(tmp_path / "p.params"), str(tmp_path / "p.states")
            net.save_parameters(fp)
            tr.save_states(fs)
        _mlp_step(pmx, net, tr, dtype, k, fused)
    twin = _mlp(pmx, dtype, frozen, fp)
    ttr = pgluon.Trainer(twin.collect_params(), name, dict(opt))
    ttr.load_states(fs)
    for k in (2, 3):
        _mlp_step(pmx, twin, ttr, dtype, k, fused)
    for k, a in _params(net).items():
        onp.testing.assert_array_equal(_params(twin)[k], a, err_msg=k)
    _assert_states_equal(tr._states, ttr._states)


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # import ml_dtypes fails
sys.path.insert(0, sys.argv[1])
import numpy as onp, torch
import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import gluon
try:
    import ml_dtypes
    raise SystemExit("ml_dtypes imported")
except ImportError:
    pass
with pmx.cpu():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(6, activation="relu", in_units=4),
            gluon.nn.Dense(3, in_units=6))
net.load_parameters(sys.argv[2], ctx=pmx.cpu())
net.cast("bfloat16")
tr = gluon.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": 0.1, "momentum": 0.9})
tr.load_states(sys.argv[3])
out = [s.view(torch.int16).numpy() for s in tr._states]
assert all(s.dtype == torch.bfloat16 for s in tr._states)
onp.savez(sys.argv[4], *out)
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
"""


def test_port_reads_bf16_states_without_ml_dtypes(tmp_path):
    import mxnet_tpu as mx

    net = _mlp(mx, "bfloat16", False)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    for k in range(2):
        _mlp_step(mx, net, tr, "bfloat16", k)
    fp, fs = str(tmp_path / "r.params"), str(tmp_path / "r.states")
    net.save_parameters(fp)
    tr.save_states(fs)
    out = str(tmp_path / "states.npz")
    script = tmp_path / "load.py"
    script.write_text(_NO_ML_DTYPES)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), os.path.dirname(HERE),
                        fp, fs, out], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = onp.load(out)
    for i, s in enumerate(tr._states):
        onp.testing.assert_array_equal(
            got[f"arr_{i}"], onp.asarray(s).view(onp.int16))


def test_states_refused_mid_window(tmp_path):
    net = _mlp(pmx, "float32", False)
    tr = pgluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 0.01}, update_interval=2)
    f = str(tmp_path / "t.states")
    _mlp_step(pmx, net, tr, "float32", 0, fused=True)     # micro 1 of 2
    with pytest.raises(MXNetError, match="mid-accumulation window"):
        tr.save_states(f)
    with pytest.raises(MXNetError, match="mid-accumulation window"):
        tr.load_states(f)
    _mlp_step(pmx, net, tr, "float32", 1, fused=True)     # the boundary
    tr.save_states(f)
    tr.load_states(f)


def test_load_refuses_another_state(tmp_path):
    net = _mlp(pmx, "float32", False)
    tr = pgluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.1})
    _mlp_step(pmx, net, tr, "float32", 0)
    f = str(tmp_path / "adam.states")
    tr.save_states(f)
    sgd = pgluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    with pytest.raises(MXNetError, match="structure"):
        sgd.load_states(f)
    half = _mlp(pmx, "bfloat16", False)
    htr = pgluon.Trainer(half.collect_params(), "adam",
                         {"learning_rate": 0.1})
    with pytest.raises(MXNetError, match="bfloat16"):
        htr.load_states(f)


@pytest.mark.parametrize("N", [1, 2])
def test_load_into_a_built_fused_step_needs_no_new_program(N, tmp_path):
    from mxnet_tpu_torch.gluon.fused_step import (reset_step_counters,
                                                  step_counters)

    net = _mlp(pmx, "float32", False)
    tr = pgluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 0.01}, update_interval=N)
    reset_step_counters()
    for k in range(2 * N):
        _mlp_step(pmx, net, tr, "float32", k, fused=True)
    f = str(tmp_path / "t.states")
    tr.save_states(f)
    saved = [p.data()._data.clone() for p in tr._params]
    built = step_counters["compiles"]
    run = []
    for _ in range(2):
        for k in range(2 * N, 4 * N):
            _mlp_step(pmx, net, tr, "float32", k, fused=True)
        run.append(_params(net))
        tr.load_states(f)
        with torch.no_grad():           # the step's weights, in place
            for p, w in zip(tr._params, saved):
                p.data()._data.copy_(w)
    assert step_counters["compiles"] == built
    for k, a in run[0].items():
        onp.testing.assert_array_equal(run[1][k], a, err_msg=k)


def test_trainer_save_load_states(tmp_path):
    """The reference's ``tests/test_gluon.py:191``."""
    with CPU:
        net = pgluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    trainer = pgluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.1})
    x = pmx.nd.array(onp.ones((2, 2), onp.float32), ctx=CPU)
    with pmx.autograd.record():
        net(x).sum().backward()
    trainer.step(1)
    f = str(tmp_path / "t.states")
    trainer.save_states(f)
    trainer.load_states(f)
    assert trainer._optimizer.num_update == 1


def test_save_load_states_after_fused_steps(tmp_path):
    """The reference's ``tests/test_fused_step.py:541``."""
    net = _mlp(pmx, "float32", False)
    tr = pgluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 0.05})
    for _ in range(3):
        _mlp_step(pmx, net, tr, "float32", 0, fused=True)
    assert tr._optimizer.num_update == 3
    f = str(tmp_path / "t.states")
    tr.save_states(f)
    tr.load_states(f)
    assert tr._optimizer.num_update == 3
    # the fused and phase-by-phase paths share the one state list
    _mlp_step(pmx, net, tr, "float32", 0)
    assert tr._optimizer.num_update == 4


# --------------------------------------------------------------------------- #
# chip_smoke.py's plain loop for phases 16 and 18.2
# --------------------------------------------------------------------------- #

def test_smoke_reference_gluon_sgd_matches_the_reference_trainer():
    """``chip_smoke.reference_gluon_sgd`` at phase 16's SGD (lr 0.1,
    momentum 0.9, wd 1e-4) against the reference's ``gluon.Trainer`` on
    the exact-gradient probe of ``tests/test_torch_optimizer_bf16.py``,
    batch 16, three steps: weight and momentum 0 bf16 steps apart."""
    import chip_smoke
    import test_torch_optimizer_bf16 as tb

    opt = dict(chip_smoke.RESNET_OPT)
    w0, labels, _ = tb._probe_inputs()
    p = torch.as_tensor(w0).bfloat16()
    m = torch.zeros_like(p)
    for label in labels:
        g = torch.as_tensor(label).bfloat16().t()
        chip_smoke.reference_gluon_sgd(
            p, g, m, opt["learning_rate"], opt["momentum"], opt["wd"],
            1.0 / tb.PROBE_B)
    tb._assert_same(tb._gluon_reference("sgd", opt),
                    [p.float().numpy(), m.float().numpy()],
                    "reference_gluon_sgd")
