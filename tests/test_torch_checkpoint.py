"""``mx.checkpoint`` of the port (``mxnet_tpu_torch/checkpoint.py``)
against the JAX package's, on the CPU.

- the format both ways: a reference checkpoint of f32 parameters and
  Adam states restores into the port (the RNG subtree with a warning),
  and the reference's restore of a port checkpoint applies its f32
  parameters and states (then raises in its ``random.set_state``: the
  RNG subtree does not cross); arrays equal bit for bit, the next step
  of both within 1e-6;
- bf16: the reference's ``<V2`` bf16 leaves restore into the port bit
  for bit (the reference's own restore of them raises ``TypeError``);
  the port writes raw uint16 bits that numpy reads;
- truncation, a bad CRC and a missing manifest reported
  (``checkpoint_corrupt``) and skipped; an interrupted save's temp
  directory swept, this process's own kept; an explicit bad step raises;
- async save: the snapshot is taken before ``save()`` returns, a failed
  background write surfaces, ``close`` refuses to abandon a live writer;
- the mid-window refusal on the non-fused path;
- bit-exact resume: a 2-layer MLP killed inside its second save by
  ``checkpoint.save:kill:2`` in a subprocess and resumed equals the
  uninterrupted run bit for bit; a fused step restored mid-window, in
  place into the same trainer (its ring tensors kept) or into a fresh
  one (the ring adopted), equals the run from the save point bit for
  bit; the loss scaler's and ``mx.random``'s states round-trip.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError

rmx = LazyReference()
HERE = os.path.dirname(os.path.abspath(__file__))


def _net_and_trainer(pkg, dtype="float32", seed=0):
    pkg.random.seed(seed)
    ctx = pkg.cpu() if pkg is pmx else None
    with (ctx if ctx is not None else _null()):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=5,
                                   dtype=dtype),
                pkg.gluon.nn.Dense(3, in_units=8, dtype=dtype))
        net.initialize(pkg.init.Xavier())
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    return net, trainer


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _data(seed=1):
    rs = onp.random.RandomState(seed)
    return (rs.rand(4, 5).astype(onp.float32),
            rs.rand(4, 3).astype(onp.float32))


def _train(pkg, net, trainer, steps, seed=1):
    x, y = _data(seed)
    ctx = pkg.cpu() if pkg is pmx else None
    with (ctx if ctx is not None else _null()):
        x, y = pkg.nd.array(x), pkg.nd.array(y)
    loss_fn = pkg.gluon.loss.L2Loss()
    for _ in range(steps):
        with pkg.autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        trainer.step(x.shape[0])


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _states(trainer):
    out = []
    for s, made in zip(trainer._states, trainer._states_created):
        if not made:
            continue
        flat = s if isinstance(s, (tuple, list)) else [s]
        out.append([onp.asarray(x.float().numpy() if isinstance(
            x, torch.Tensor) else x, onp.float32) for x in flat])
    return out


def _ref_states(trainer):
    out = []
    for s, made in zip(trainer._states, trainer._states_created):
        if not made:
            continue
        flat = s if isinstance(s, (tuple, list)) else [s]
        out.append([onp.asarray(x, onp.float32) for x in flat])
    return out


# --------------------------------------------------------------------- #
# the format across packages
# --------------------------------------------------------------------- #

def test_reference_checkpoint_restores_into_the_port(tmp_path):
    rnet, rtr = _net_and_trainer(rmx)
    _train(rmx, rnet, rtr, 3)
    rmx.checkpoint.save(str(tmp_path), 3, rnet, rtr)
    pnet, ptr = _net_and_trainer(pmx, seed=7)
    with pytest.warns(RuntimeWarning, match="RNG"):
        assert pmx.checkpoint.restore(str(tmp_path), pnet, ptr) == 3
    for k, v in _params(rnet).items():
        onp.testing.assert_array_equal(_params(pnet)[k], v, err_msg=k)
    for a, b in zip(_states(ptr), _ref_states(rtr)):
        for x, y in zip(a, b):
            onp.testing.assert_array_equal(x, y)
    assert ptr._optimizer.num_update == rtr._optimizer.num_update
    _train(rmx, rnet, rtr, 1, seed=2)
    _train(pmx, pnet, ptr, 1, seed=2)
    for k, v in _params(rnet).items():
        onp.testing.assert_allclose(_params(pnet)[k], v, rtol=1e-6,
                                    atol=1e-6, err_msg=k)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    pnet, ptr = _net_and_trainer(pmx)
    _train(pmx, pnet, ptr, 3)
    pmx.checkpoint.save(str(tmp_path), 3, pnet, ptr)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "MANIFEST.json").read_text())
    assert manifest["library"] == "mxnet_tpu_torch"
    assert manifest["format"] == rmx.checkpoint.FORMAT_VERSION
    rnet, rtr = _net_and_trainer(rmx, seed=7)
    # the reference applies the parameters and the trainer, then its
    # random.set_state meets the port's {seed, root, generators}
    with pytest.raises(KeyError):
        rmx.checkpoint.restore(str(tmp_path), rnet, rtr)
    for k, v in _params(pnet).items():
        onp.testing.assert_array_equal(_params(rnet)[k], v, err_msg=k)
    for a, b in zip(_ref_states(rtr), _states(ptr)):
        for x, y in zip(a, b):
            onp.testing.assert_array_equal(x, y)
    assert rtr._optimizer.num_update == ptr._optimizer.num_update
    _train(rmx, rnet, rtr, 1, seed=2)
    _train(pmx, pnet, ptr, 1, seed=2)
    for k, v in _params(pnet).items():
        onp.testing.assert_allclose(_params(rnet)[k], v, rtol=1e-6,
                                    atol=1e-6, err_msg=k)


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    """The reference writes a bf16 leaf as ``<V2`` and its own restore
    raises; the port reads the manifest's dtype and restores the bits."""
    d = rmx.gluon.nn.Dense(4, in_units=3, dtype="bfloat16")
    d.initialize()
    rmx.checkpoint.save(str(tmp_path), 1, d)
    manifest = json.loads((tmp_path / "step_00000001" /
                           "MANIFEST.json").read_text())
    assert {a["dtype"] for a in manifest["arrays"]} >= {"bfloat16"}
    d2 = rmx.gluon.nn.Dense(4, in_units=3, dtype="bfloat16")
    d2.initialize()
    with pytest.raises(TypeError):
        rmx.checkpoint.restore(str(tmp_path), d2)
    with pmx.cpu():
        p = gluon.nn.Dense(4, in_units=3, dtype="bfloat16")
        p.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert pmx.checkpoint.restore(str(tmp_path), p) == 1
    for k, rp in d._collect_params_with_prefix().items():
        got = p._collect_params_with_prefix()[k].data()._data
        assert got.dtype == torch.bfloat16
        want = onp.asarray(rp.data()._data).view(onp.uint16)
        onp.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(onp.uint16), want)


def test_port_bf16_leaves_are_raw_bits_numpy_reads(tmp_path):
    with pmx.cpu():
        p = gluon.nn.Dense(4, in_units=3, dtype="bfloat16")
        p.initialize()
    pmx.checkpoint.save(str(tmp_path), 2, p)
    step = tmp_path / "step_00000002"
    manifest = json.loads((step / "MANIFEST.json").read_text())
    w = p.weight.data()._data
    names = dict((k, v) for (_, k), v in
                 manifest["tree"]["@dict"])["params"]["@dict"]
    idx = dict((k, v["@arr"]) for (_, k), v in names)["weight"]
    meta = manifest["arrays"][idx]
    assert meta["dtype"] == "bfloat16"
    bits = onp.load(step / meta["file"])
    assert bits.dtype == onp.uint16
    onp.testing.assert_array_equal(
        bits, w.view(torch.int16).numpy().view(onp.uint16))
    with pmx.cpu():
        q = gluon.nn.Dense(4, in_units=3, dtype="bfloat16")
        q.initialize(pmx.init.Zero())
    pmx.checkpoint.restore(str(tmp_path), q)
    assert torch.equal(q.weight.data()._data, w)


# --------------------------------------------------------------------- #
# integrity
# --------------------------------------------------------------------- #

def _saved_dir(tmp_path, steps=(1, 2)):
    net, tr = _net_and_trainer(pmx)
    for s in steps:
        _train(pmx, net, tr, 1)
        pmx.checkpoint.save(str(tmp_path), s, net, tr)
    return net, tr


def _fresh_restore(tmp_path, **kw):
    net, tr = _net_and_trainer(pmx, seed=3)
    return pmx.checkpoint.restore(str(tmp_path), net, tr, **kw)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "manifest"])
def test_damaged_newest_step_is_reported_and_skipped(tmp_path, damage):
    _saved_dir(tmp_path)
    newest = tmp_path / "step_00000002"
    if damage == "manifest":
        (newest / "MANIFEST.json").unlink()
    else:
        f = newest / "arr_00000.npy"
        data = bytearray(f.read_bytes())
        if damage == "truncate":
            data = data[:-7]
        else:
            data[-1] ^= 0x40
        f.write_bytes(bytes(data))
    ok, why = pmx.checkpoint.verify_step(str(tmp_path), 2)
    assert not ok and why
    pmx.telemetry.clear_events()
    assert _fresh_restore(tmp_path) == 1
    ev = pmx.telemetry.events(kind="checkpoint_corrupt")
    assert [e["step"] for e in ev] == [2]
    with pytest.raises(MXNetError, match="failed verification"):
        _fresh_restore(tmp_path, step=2)
    assert pmx.checkpoint.latest_step(str(tmp_path)) == 1


def test_interrupted_save_is_swept_own_kept(tmp_path):
    _saved_dir(tmp_path, steps=(1,))
    own = tmp_path / f".tmp-step_00000009-{os.getpid()}-abcd1234"
    own.mkdir()
    dead = tmp_path / ".tmp-step_00000009-99999999-abcd1234"
    dead.mkdir()
    pmx.telemetry.clear_events()
    assert _fresh_restore(tmp_path) == 1
    assert own.exists() and not dead.exists()
    ev = pmx.telemetry.events(kind="checkpoint_corrupt")
    assert len(ev) == 1 and "interrupted save" in ev[0]["why"]
    assert _fresh_restore(tmp_path, step=None) == 1
    empty = tmp_path / "empty"
    assert pmx.checkpoint.restore(str(empty), *_net_and_trainer(pmx)) \
        is None


def test_retention_and_events(tmp_path):
    net, tr = _net_and_trainer(pmx)
    _train(pmx, net, tr, 1)
    mgr = pmx.checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2,
                                           async_save=False)
    pmx.telemetry.clear_events()
    for s in (1, 2, 3):
        mgr.save(s, net, tr)
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    ev = pmx.telemetry.events(kind="checkpoint_saved")
    assert [e["step"] for e in ev] == [1, 2, 3]
    assert ev[0]["bytes"] > 0 and ev[0]["write_s"] > 0


# --------------------------------------------------------------------- #
# async save
# --------------------------------------------------------------------- #

def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    net, tr = _net_and_trainer(pmx)
    _train(pmx, net, tr, 2)
    at_save = _params(net)
    mgr = pmx.checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, net, tr)
    _train(pmx, net, tr, 3)          # updates the weights in place
    mgr.wait_until_finished()
    mgr.close()
    assert not onp.array_equal(at_save["0.weight"], _params(net)["0.weight"])
    assert _fresh_restore(tmp_path) == 2
    net2, tr2 = _net_and_trainer(pmx, seed=5)
    pmx.checkpoint.restore(str(tmp_path), net2, tr2)
    for k, v in _params(net2).items():
        onp.testing.assert_array_equal(v, at_save[k])


def test_background_write_error_surfaces(tmp_path, monkeypatch):
    net, tr = _net_and_trainer(pmx)
    mgr = pmx.checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(
        mgr, "_write_step",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk gone")))
    mgr.save(1, net, tr)
    with pytest.raises(MXNetError, match="background save failed"):
        mgr.wait_until_finished()
    mgr.close()


def test_close_refuses_to_abandon_a_live_writer(tmp_path, monkeypatch):
    import time

    net, tr = _net_and_trainer(pmx)
    mgr = pmx.checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(mgr, "_write_step", lambda *a, **k: time.sleep(2))
    mgr.save(1, net, tr)
    with pytest.raises(MXNetError, match="still writing"):
        mgr.close(timeout=0.2)


# --------------------------------------------------------------------- #
# windows and resume
# --------------------------------------------------------------------- #

def test_mid_window_save_without_a_ring_refuses(tmp_path):
    net, _ = _net_and_trainer(pmx)
    for p in net.collect_params().values():
        p.grad_req = "add"
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-2}, update_interval=2)
    _train(pmx, net, tr, 1)
    assert tr._window_pos == 1
    with pytest.raises(MXNetError, match="mid-accumulation-window"):
        pmx.checkpoint.save(str(tmp_path), 1, net, tr)


def _fused_rig(seed=0, units=6):
    """A 2-layer MLP trained by ``fused_step`` with update_interval 2 and
    a random draw each step (so the RNG state matters)."""
    pmx.random.seed(seed)
    with pmx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(units, use_bias=False, in_units=units),
                gluon.nn.Dense(2, use_bias=False, in_units=units))
        net.initialize(pmx.init.Xavier())
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-2}, update_interval=2)
    loss_l = gluon.loss.L2Loss()

    def loss_fn(bx, by):
        return loss_l(net(bx), by)

    def step(x, y):
        with pmx.cpu():
            noise = pmx.random.normal(shape=x.shape) * 0.01
        return tr.fused_step(loss_fn, x + noise, y)

    return net, tr, step


def _batches(n, seed=3):
    rs = onp.random.RandomState(seed)
    with pmx.cpu():
        return [(pmx.nd.array(rs.rand(4, 6).astype(onp.float32)),
                 pmx.nd.array(rs.rand(4, 2).astype(onp.float32)))
                for _ in range(n)]


def _state_arrays(tr):
    return [t.clone() for s, made in zip(tr._states, tr._states_created)
            if made for t in (s if isinstance(s, (tuple, list)) else [s])]


@pytest.mark.parametrize("into", ["same_trainer", "fresh_trainer"])
def test_mid_window_fused_restore_is_bit_exact(tmp_path, into):
    batches = _batches(7)
    net, tr, step = _fused_rig()
    for x, y in batches[:3]:
        step(x, y)
    assert tr._window_pos == 1
    pmx.checkpoint.save(str(tmp_path), 3, net, tr)
    for x, y in batches[3:]:
        step(x, y)
    want, want_states = _params(net), _state_arrays(tr)
    if into == "same_trainer":
        fs = next(iter(tr._fused_steps.values()))
        ring = [a.data_ptr() for a in fs._accum]
        net2, tr2, step2 = net, tr, step
    else:
        net2, tr2, step2 = _fused_rig(seed=5)
    assert pmx.checkpoint.restore(str(tmp_path), net2, tr2) == 3
    assert tr2._window_pos == 1
    if into == "same_trainer":
        assert [a.data_ptr() for a in fs._accum] == ring
    for x, y in batches[3:]:
        step2(x, y)
    for k, v in _params(net2).items():
        onp.testing.assert_array_equal(v, want[k], err_msg=k)
    for a, b in zip(_state_arrays(tr2), want_states):
        assert torch.equal(a, b)
    assert tr2._pending_accum == []


def test_loss_scaler_and_rng_round_trip(tmp_path):
    net, tr = _net_and_trainer(pmx)
    pmx.amp.init("float16")
    try:
        pmx.amp.init_trainer(tr)
    finally:
        pmx.amp._uninit()
    tr._amp_loss_scaler.loss_scale = 1024.0
    tr._amp_loss_scaler._unskipped = 17
    pmx.random.seed(42)
    pmx.checkpoint.save(str(tmp_path), 1, net, tr)
    with pmx.cpu():
        after = pmx.random.uniform(shape=(5,)).asnumpy()
    tr._amp_loss_scaler.loss_scale = 2.0
    tr._amp_loss_scaler._unskipped = 0
    pmx.checkpoint.restore(str(tmp_path), net, tr)
    assert tr._amp_loss_scaler.loss_scale == 1024.0
    assert tr._amp_loss_scaler._unskipped == 17
    with pmx.cpu():
        again = pmx.random.uniform(shape=(5,)).asnumpy()
    onp.testing.assert_array_equal(after, again)


_KILL_AND_RESUME = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import numpy as onp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

ckdir, out, steps = sys.argv[2], sys.argv[3], 8
mx.random.seed(0)
with mx.cpu():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=6),
            gluon.nn.Dense(2, in_units=16))
    net.initialize(mx.init.Xavier())
tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
loss_fn = gluon.loss.L2Loss()
mgr = None if ckdir == "-" else mx.checkpoint.CheckpointManager(
    ckdir, max_to_keep=2, async_save=True)
start = 0
if mgr is not None:
    got = mgr.restore(net, tr)
    start = 0 if got is None else got
losses = []
for s in range(start + 1, steps + 1):
    rs = onp.random.RandomState(s)
    with mx.cpu():
        x = mx.nd.array(rs.rand(8, 6).astype(onp.float32))
        y = mx.nd.array(rs.rand(8, 2).astype(onp.float32))
        x = x + mx.random.normal(shape=x.shape) * 0.01
    with autograd.record():
        L = loss_fn(net(x), y)
    L.backward()
    tr.step(8)
    losses.append(float(L.mean().asscalar()))
    if mgr is not None and s % 3 == 0:
        mgr.save(s, net, tr)
if mgr is not None:
    mgr.wait_until_finished()
    mgr.close()
onp.savez(out, losses=onp.array(losses), start=start,
          **{k: p.data().asnumpy()
             for k, p in net._collect_params_with_prefix().items()})
"""


def test_kill_and_resume_equals_uninterrupted(tmp_path):
    """The child dies (SIGKILL) inside its second save (step 6); the next
    child sweeps that save, resumes from step 3 and runs to step 8."""
    script = tmp_path / "run.py"
    script.write_text(_KILL_AND_RESUME)
    ck = tmp_path / "ck"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("MXNET_FAULT_INJECT", None)
    root = os.path.dirname(HERE)

    def run(ckdir, out, **extra):
        return subprocess.run(
            [sys.executable, str(script), root, ckdir, str(out)],
            capture_output=True, text=True, timeout=240,
            env=dict(env, **extra))

    r = run("-", tmp_path / "plain.npz")
    assert r.returncode == 0, r.stderr[-3000:]
    r = run(str(ck), tmp_path / "killed.npz",
            MXNET_FAULT_INJECT="checkpoint.save:kill:2")
    assert r.returncode == -9, (r.returncode, r.stderr[-3000:])
    left = sorted(os.listdir(ck))
    assert "step_00000003" in left and "step_00000006" not in left
    assert any(n.startswith(".tmp-step_00000006") for n in left)
    r = run(str(ck), tmp_path / "resumed.npz")
    assert r.returncode == 0, r.stderr[-3000:]
    plain, resumed = onp.load(tmp_path / "plain.npz"), \
        onp.load(tmp_path / "resumed.npz")
    assert int(resumed["start"]) == 3
    assert not any(n.startswith(".tmp-") for n in os.listdir(ck))
    onp.testing.assert_array_equal(resumed["losses"], plain["losses"][3:])
    for k in plain.files:
        if k not in ("losses", "start"):
            onp.testing.assert_array_equal(resumed[k], plain[k], err_msg=k)


@pytest.mark.cuda
def test_async_snapshot_and_in_place_restore_on_the_card(tmp_path):
    """On the card: the pinned snapshot is complete when ``save()``
    returns (training on after it does not reach the checkpoint), and a
    restore writes into the live tensors (their addresses kept)."""
    from _torch_parity import need_cuda

    need_cuda()
    pmx.random.seed(0)
    with pmx.gpu(0):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, in_units=32), gluon.nn.Dense(8,
                                                              in_units=64))
        net.initialize(pmx.init.Xavier())
        x = pmx.nd.array(onp.random.RandomState(0).rand(16, 32))
        y = pmx.nd.array(onp.random.RandomState(1).rand(16, 8))
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    loss_fn = gluon.loss.L2Loss()

    def step():
        with autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        tr.step(16)

    step()
    at_save = _params(net)
    mgr = pmx.checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, net, tr)
    for _ in range(3):
        step()
    mgr.wait_until_finished()
    ptrs = [p.data()._data.data_ptr() for p in net.collect_params().values()]
    assert mgr.restore(net, tr) == 1
    mgr.close()
    assert ptrs == [p.data()._data.data_ptr()
                    for p in net.collect_params().values()]
    for k, v in _params(net).items():
        onp.testing.assert_array_equal(v, at_save[k])
