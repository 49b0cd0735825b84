"""``mx.kv`` of the port against the JAX package's store, and
``gluon.Trainer``'s kvstore paths.

The same NumPy inputs go through both packages' stores (the port on the
CPU): pushed sums, pulls, updaters, the optimizer run in the store,
row-sparse pulls and the 2-bit/1-bit compressed values and residuals
must be exact (float32 sums in one order); a Trainer with
``update_on_kvstore`` matches the reference's weights within 1e-6
(``tests/test_gluon.py``'s tolerance) and its own local update bit for
bit.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch.base import MXNetError
from _torch_parity import LazyReference, need_cuda

rmx = LazyReference()
KNOWN = ("local", "device", "nccl", "tpu", "dist_sync", "dist_async",
         "dist_device_sync", "dist")


def _vals(seed, n, shape=(3, 4)):
    rs = onp.random.RandomState(seed)
    return [rs.standard_normal(shape).astype(onp.float32) for _ in range(n)]


def _host(a):
    return onp.asarray(a.asnumpy())


def _both(script):
    """``script(mx, arr)`` in the reference and in the port on the CPU;
    ``arr`` makes an array of a NumPy value in that package."""
    ref = script(rmx, lambda v: rmx.nd.array(v))
    with pmx.cpu():
        got = script(pmx, lambda v: pmx.nd.array(v))
    return ref, got


def _exact(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        onp.testing.assert_array_equal(g, r)


@pytest.mark.filterwarnings("ignore:kvstore 'dist_async'")
@pytest.mark.parametrize("name", KNOWN)
def test_create_accepts_every_reference_type(name):
    kv = pmx.kv.create(name)
    ref = rmx.kv.create(name)
    assert (kv.type, kv.rank, kv.num_workers) == (ref.type, ref.rank,
                                                  ref.num_workers)
    assert kv.is_capable == ref.is_capable
    assert pmx.kv is pmx.kvstore and isinstance(kv, pmx.kv.KVStore)


@pytest.mark.parametrize("how", ["push_pull", "push_list", "pushpull",
                                 "pushpull_keys", "broadcast"])
def test_push_pull_sums_are_exact(how):
    v = _vals(0, 4)

    def script(mx, arr):
        kv = mx.kv.create("local")
        kv.init(3, arr(v[0]))
        kv.init("w", arr(v[1]))
        out = [mx.nd.zeros((3, 4)) for _ in range(2)]
        if how == "push_pull":
            kv.push(3, arr(v[2]))
            kv.push(3, arr(v[3]))
            kv.pull(3, out=out[0])
        elif how == "push_list":
            kv.push(3, [arr(v[2]), arr(v[3]), arr(v[1])])
            kv.push([3, "w"], [arr(v[0]), [arr(v[2]), arr(v[3])]])
            kv.pull([3, "w"], out=out)
        elif how == "pushpull":
            kv.pushpull(3, [arr(v[2]), arr(v[3])], out=out[0])
            kv.pushpull("w", arr(v[2]))
            kv.pull("w", out=out[1])
        elif how == "pushpull_keys":
            kv.pushpull([3, "w"], [[arr(v[2]), arr(v[3])], arr(v[0])],
                        out=out)
        else:
            kv.broadcast(7, arr(v[3]), out=out)
        return [_host(o) for o in out]

    _exact(*_both(script))


def test_updater_runs_at_push():
    v = _vals(1, 3)

    def script(mx, arr):
        kv = mx.kv.create("device")
        seen = []

        def upd(key, recv, stored):
            seen.append(key)
            stored += recv * 2
        kv.set_updater(upd)
        kv.init(0, arr(v[0]))
        kv.push(0, [arr(v[1]), arr(v[2])])
        kv.pushpull(0, arr(v[2]))
        out = mx.nd.zeros((3, 4))
        kv.pull(0, out=out)
        return seen, _host(out)

    (rs, ro), (gs, go) = _both(script)
    assert rs == gs == ["0", "0"]
    onp.testing.assert_array_equal(go, ro)


@pytest.mark.parametrize("opt", [("sgd", dict(learning_rate=0.1,
                                              momentum=0.9, wd=1e-3)),
                                 ("adam", dict(learning_rate=0.01))])
def test_optimizer_on_the_store(opt):
    """The optimizer runs inside the store at push time (one wave for a
    key list), as on the reference's parameter server."""
    v = _vals(2, 8)

    def script(mx, arr):
        kv = mx.kv.create("dist_sync")
        kv.init([0, 1], [arr(v[0]), arr(v[1])])
        kv.set_optimizer(mx.optimizer.create(opt[0], **opt[1]))
        for s in range(3):
            kv.push([0, 1], [[arr(v[2 + s]), arr(v[3 + s])], arr(v[4 + s])])
        kv.push(0, arr(v[7]))
        out = [mx.nd.zeros((3, 4)) for _ in range(2)]
        kv.pull([0, 1], out=out)
        return [_host(o) for o in out]

    ref, got = _both(script)
    for r, g in zip(ref, got):
        onp.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


def test_row_sparse_pull():
    v = _vals(3, 1, (6, 2))

    def script(mx, arr):
        kv = mx.kv.create("local")
        kv.init("emb", arr(v[0]))
        out = mx.nd.zeros((6, 2))
        kv.row_sparse_pull("emb", out=out,
                           row_ids=arr(onp.array([4, 0, 4], onp.float32)))
        whole = mx.nd.zeros((6, 2))
        kv.row_sparse_pull("emb", out=whole)
        return [_host(out), _host(whole)]

    ref, got = _both(script)
    _exact(ref, got)
    assert (got[0][[1, 2, 3, 5]] == 0).all()


@pytest.mark.parametrize("params", [dict(type="2bit", threshold=0.5),
                                    dict(type="1bit", threshold=0.25)])
def test_compression_values_and_residuals_are_exact(params):
    v = [0.6 * a for a in _vals(4, 5)]

    def script(mx, arr):
        kv = mx.kv.create("dist_sync")
        kv.set_gradient_compression(params)
        kv.init(0, arr(onp.zeros((3, 4), onp.float32)))
        outs = []
        for s in range(4):
            out = mx.nd.zeros((3, 4))
            kv.pushpull(0, [arr(v[s]), arr(v[s + 1])], out=out)
            outs.append(_host(out))
        res = kv._compression._residual["0"]
        outs.append(onp.asarray(res) if not isinstance(res, torch.Tensor)
                    else res.numpy())
        return outs

    ref, got = _both(script)
    _exact(ref, got)
    t = params["threshold"]
    levels = {-t, 0.0, t} if params["type"] == "2bit" else {-t, t}
    assert set(onp.unique(onp.concatenate(got[:4]).ravel())) <= levels


@pytest.mark.cuda
def test_compression_on_the_card_equals_the_cpu():
    need_cuda()
    v = _vals(5, 3)
    outs = []
    for ctx in (pmx.cpu(), pmx.gpu(0)):
        with ctx:
            kv = pmx.kv.create("device")
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
            kv.init(0, pmx.nd.zeros((3, 4)))
            out = pmx.nd.zeros((3, 4))
            for a in v:
                kv.pushpull(0, pmx.nd.array(a), out=out)
            outs.append((_host(out), kv._compression._residual["0"].cpu()))
    onp.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_optimizer_states_round_trip(tmp_path):
    v = _vals(6, 4)
    with pmx.cpu():
        kv = pmx.kv.create("dist_sync")
        kv.init([0, 1], [pmx.nd.array(v[0]), pmx.nd.array(v[1])])
        kv.set_optimizer(pmx.optimizer.create("adam", learning_rate=0.01))
        kv.push([0, 1], [pmx.nd.array(v[2]), pmx.nd.array(v[3])])
        f = str(tmp_path / "kv.states")
        kv.save_optimizer_states(f, dump_optimizer=True)
        saved = {k: tuple(t.clone() for t in s)
                 for k, s in kv._opt_states.items()}
        kv.push([0, 1], [pmx.nd.array(v[3]), pmx.nd.array(v[2])])
        held = kv._opt_states["0"][0]
        kv.load_optimizer_states(f)
        assert kv._opt_states["0"][0] is held      # written in place
        for k, s in saved.items():
            for a, b in zip(s, kv._opt_states[k]):
                assert torch.equal(a, b)
        assert kv._optimizer._index_update_count == {"0": 1, "1": 1}
        fresh = pmx.kv.create("local")
        fresh.init([0, 1], [pmx.nd.array(v[0]), pmx.nd.array(v[1])])
        fresh.load_optimizer_states(f)
        assert fresh._optimizer.learning_rate == 0.01
        assert torch.equal(fresh._opt_states["1"][1], saved["1"][1])


def test_fault_sites(monkeypatch):
    with pmx.cpu():
        kv = pmx.kv.create("local")
        kv.init(0, pmx.nd.zeros(2))
        for site, call in (("kvstore.push",
                            lambda: kv.push(0, pmx.nd.ones(2))),
                           ("kvstore.pull", lambda: kv.pull(
                               0, out=pmx.nd.zeros(2))),
                           ("kvstore.pushpull", lambda: kv.pushpull(
                               0, pmx.nd.ones(2)))):
            monkeypatch.setenv("MXNET_FAULT_INJECT", f"{site}:raise:1")
            with pytest.raises(Exception, match=site):
                call()
            monkeypatch.delenv("MXNET_FAULT_INJECT")
            call()


# ------------------------------------------------------------------------ #
# gluon.Trainer
# ------------------------------------------------------------------------ #

def test_trainer_dist_sync_updates_in_the_store():
    """``tests/test_gluon.py::test_update_on_kvstore_dist_semantics`` in
    both packages."""
    def script(mx, arr):
        net = mx.gluon.nn.Dense(1, in_units=2, use_bias=False)
        net.initialize(init=mx.init.Constant(1.0), ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="dist_sync")
        x = arr(onp.ones((4, 2), onp.float32))
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(batch_size=4)
        assert tr._update_on_kvstore and tr._kvstore is not None
        return _host(net.weight.data())

    ref, got = _both(script)
    onp.testing.assert_allclose(got, onp.full((1, 2), 0.9, onp.float32),
                                rtol=1e-6)
    onp.testing.assert_allclose(got, ref, rtol=1e-6)


def _mlp_run(mx, arr, kvstore, update_on_kvstore, steps=3, fused=False,
             compression=None, opt=("sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-4})):
    rs = onp.random.RandomState(7)
    w0 = rs.standard_normal((16, 8)).astype(onp.float32) * 0.3
    w1 = rs.standard_normal((4, 16)).astype(onp.float32) * 0.3
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    params = list(net.collect_params().values())
    for p, val in zip(params, (w0, onp.zeros(16, onp.float32), w1,
                               onp.zeros(4, onp.float32))):
        p.set_data(arr(val))
    kv = kvstore(mx) if callable(kvstore) else kvstore
    tr = mx.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                          kvstore=kv, update_on_kvstore=update_on_kvstore,
                          compression_params=compression)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(steps):
        x = arr(rs.standard_normal((6, 8)).astype(onp.float32))
        y = arr(rs.randint(0, 4, 6).astype(onp.float32))
        if fused:
            tr.fused_step(lambda a, b: loss_fn(net(a), b), x, y)
        else:
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(6)
    return [_host(p.data()) for p in params], tr


@pytest.mark.parametrize("opt", [("sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9, "wd": 1e-4}),
                                 ("adam", {"learning_rate": 0.01})])
def test_trainer_update_on_kvstore_matches_reference_and_local(opt):
    """A ``KVStore`` object with ``update_on_kvstore=True``: the
    reference's weights within 1e-6, the port's own local update bit for
    bit."""
    ref, _ = _mlp_run(rmx, lambda v: rmx.nd.array(v),
                      lambda mx: mx.kv.create("device"), True, opt=opt)
    with pmx.cpu():
        arr = lambda v: pmx.nd.array(v)  # noqa: E731
        got, tr = _mlp_run(pmx, arr, lambda mx: mx.kv.create("device"),
                           True, opt=opt)
        local, ltr = _mlp_run(pmx, arr, "device", False, opt=opt)
    assert tr._update_on_kvstore and ltr._kvstore is None
    for r, g, l in zip(ref, got, local):
        onp.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
        onp.testing.assert_array_equal(g, l)


@pytest.mark.parametrize("case", ["dist_sync_pushpull", "kv_object_local",
                                  "fused_step", "compression"])
def test_trainer_store_paths(case):
    """A ``dist`` store without ``update_on_kvstore`` sums each gradient
    through ``pushpull`` (bit for bit the local update on one process); a
    fused step with a store runs the phase-by-phase step; compressed
    gradients are the reference's."""
    from mxnet_tpu_torch.gluon.fused_step import step_counters

    with pmx.cpu():
        arr = lambda v: pmx.nd.array(v)  # noqa: E731
        local, _ = _mlp_run(pmx, arr, "device", False)
        if case == "dist_sync_pushpull":
            got, tr = _mlp_run(pmx, arr, "dist_sync", False)
            assert tr._kvstore is not None and not tr._update_on_kvstore
        elif case == "kv_object_local":
            got, tr = _mlp_run(pmx, arr, lambda mx: mx.kv.create("local"),
                               None)
            assert tr._kvstore is not None and not tr._update_on_kvstore
        elif case == "fused_step":
            before = step_counters["legacy_steps"]
            got, tr = _mlp_run(pmx, arr, "dist_sync", None, fused=True)
            assert step_counters["legacy_steps"] - before == 3
        else:
            comp = {"type": "2bit", "threshold": 0.05}
            got, tr = _mlp_run(pmx, arr, "dist_sync", True,
                               compression=comp)
            ref, _ = _mlp_run(rmx, lambda v: rmx.nd.array(v), "dist_sync",
                              True, compression=comp)
            for r, g in zip(ref, got):
                onp.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
            assert tr._kvstore._compression is not None
            return
    for g, l in zip(got, local):
        onp.testing.assert_array_equal(g, l)


def test_trainer_states_through_the_store(tmp_path):
    with pmx.cpu():
        arr = lambda v: pmx.nd.array(v)  # noqa: E731
        _, tr = _mlp_run(pmx, arr, "dist_sync", None, steps=2,
                         opt=("adam", {"learning_rate": 0.01}))
        f = str(tmp_path / "t.states")
        tr.save_states(f)
        kv = tr._kvstore
        saved = {k: tuple(t.clone() for t in s)
                 for k, s in kv._opt_states.items()}
        count = dict(tr._optimizer._index_update_count)
        for s in kv._opt_states.values():
            for t in s:
                t.add_(1.0)
        tr.load_states(f)
        for k, s in saved.items():
            for a, b in zip(s, kv._opt_states[k]):
                assert torch.equal(a, b)
        assert tr._optimizer._index_update_count == count
        assert kv._optimizer is tr._optimizer


def test_trainer_errors_and_reference_error_paths():
    """``allreduce_grads``/``update`` under ``update_on_kvstore``, a
    kvstore over tensors, and ``tests/test_error_paths.py``'s kvstore
    cases."""
    with pmx.cpu():
        _, tr = _mlp_run(pmx, lambda v: pmx.nd.array(v), "dist_sync", None,
                         steps=1)
        with pytest.raises(MXNetError, match="update_on_kvstore"):
            tr.allreduce_grads()
        with pytest.raises(MXNetError, match="update_on_kvstore"):
            tr.update(6)
        lin = torch.nn.Linear(2, 2)
        with pytest.raises(MXNetError, match="kvstore"):
            pmx.gluon.Trainer(lin, "sgd", kvstore="local",
                              update_on_kvstore=True)
        with pytest.raises(MXNetError):
            pmx.kv.create("bogus")
        kv = pmx.kv.create("local")
        with pytest.raises(MXNetError):
            kv.push(42, pmx.nd.ones(2))
        with pytest.raises(MXNetError):
            kv.pull(42, out=pmx.nd.ones(2))
    with pytest.raises(Exception):
        rmx.kv.create("bogus")


def test_create_kvstore_helper(monkeypatch):
    from mxnet_tpu.model import _create_kvstore as ref_create
    from mxnet_tpu_torch.model import _create_kvstore

    for spec, n in ((None, 1), ("local", 1), ("device", 2),
                    ("dist_sync", 1)):
        kv, on = _create_kvstore(spec, n, {})
        rkv, ron = ref_create(spec, n, {})
        assert (kv is None, on) == (rkv is None, ron)
        if kv is not None:
            assert kv.type == rkv.type
    obj = pmx.kv.create("nccl")
    assert _create_kvstore(obj, 1, {}) == (obj, True)
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", "0")
    assert _create_kvstore("dist_sync", 1, {})[1] is False
    with pytest.raises(MXNetError):
        _create_kvstore(3, 1, {})
