"""``mxnet_tpu_torch.gluon.contrib.estimator`` against
``mxnet_tpu.gluon.contrib.estimator``, f32 on the CPU: a small MLP
(6 -> 8 -> 3, weights carried by ``models.load_mxnet_tpu_arrays``)
fitted by each package's ``Estimator`` on the same seeded batches.

- ``fit``/``evaluate``: every epoch's training metrics (``Accuracy``,
  ``Loss``) and validation metrics within 1e-5 (relative and absolute),
  and the weights after the fit within 1e-5.
- The handlers' call order (by ``priority``), stopping by epochs and by
  batches, early stopping, ``CheckpointHandler``'s files, all equal to
  the reference's.
- ``AtomicCheckpointHandler``: a run stopped after batch 4 and resumed by
  a new estimator (``resume=True``, the data from
  ``DataLoader.iter_from(4)``) equals the uninterrupted run bit for bit
  over batches 5-8: weights, each batch's metric sums and the cursor;
  with ``fused_step=True`` over a hybridized net, and phase by phase.
- A checkpoint the reference's estimator wrote resumes into the port's:
  parameters and optimizer states equal to the reference's at the save,
  the cursor, the ``RuntimeWarning`` for the RNG subtree, and the next
  batches' weights within 1e-5 of the reference's.
"""
import os
import warnings

import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)
OPT = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})


def _data(seed=0, n=32):
    rs = onp.random.RandomState(seed)
    x = rs.standard_normal((n, 6)).astype(onp.float32)
    y = rs.randint(0, 3, n).astype(onp.float32)
    return x, y


def _loader(pkg, seed=0, n=32, batch=4):
    x, y = _data(seed, n)
    ds = pkg.gluon.data.ArrayDataset(x, y)
    return pkg.gluon.data.DataLoader(ds, batch_size=batch, shuffle=False)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
                pkg.gluon.nn.Dense(3, in_units=8))
    return net


_START = {}


def _start_arrays():
    """The reference MLP's initial weights (Xavier, seed 0), once."""
    if not _START:
        rmx.random.seed(0)
        net = _mlp(rmx)
        net.initialize(rmx.init.Xavier())
        _START.update({k: p.data().asnumpy()
                       for k, p in net.collect_params().items()})
    return dict(_START)


def _estimator(pkg, metrics=None, fused=False, **kw):
    if pkg is rmx:
        rmx.random.seed(0)
        net = _mlp(rmx)
        net.initialize(rmx.init.Load(_start_arrays()))
        ctx = rmx.cpu()
    else:
        with mx.cpu():
            net = _mlp(mx)
        load_mxnet_tpu_arrays(net, _start_arrays())
        ctx = mx.cpu()
    if fused:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), OPT[0], dict(OPT[1]))
    if metrics is None:
        metrics = [pkg.metric.Accuracy(), pkg.metric.Loss()]
    return pkg.gluon.contrib.estimator.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), metrics=metrics,
        trainer=trainer, context=ctx, fused_step=fused, **kw)


def _recorder(pkg, log, outs=None):
    """An epoch-end handler that records the training metrics; a
    batch-end one that records each batch's metric sums (in ``log``) and
    its loss and predictions, what the metrics read (in ``outs``)."""
    eh = pkg.gluon.contrib.estimator
    outs = [] if outs is None else outs

    class Epochs(eh.EpochEnd):
        def epoch_end(self, est, *a, **k):
            log.append(("epoch", [m.get() for m in est.train_metrics]))

    class Batches(eh.BatchEnd):
        priority = 5          # after the MetricHandler (0)

        def batch_end(self, est, *a, **k):
            log.append(("batch", [(float(m.sum_metric), m.num_inst)
                                  for m in est.train_metrics]))
            outs.append((k["loss"].asnumpy(), k["pred"].asnumpy()))

    return [Epochs(), Batches()]


def _weights(net):
    """``{reference name: array}`` of a port net (``models.convert``)."""
    return arrays_from_port(net, prefix=net.prefix)


def _ctx(pkg):
    return mx.cpu() if pkg is mx else rmx.cpu()


def test_fit_and_evaluate_equal_the_reference():
    logs = {}
    nets = {}
    for pkg in (rmx, mx):
        log = logs.setdefault(pkg.__name__, [])
        est = _estimator(pkg)
        with _ctx(pkg):
            val = _loader(pkg, seed=1, n=12)
            est.fit(_loader(pkg), val_data=val, epochs=3,
                    event_handlers=_recorder(pkg, log))
            log.append(("eval", est.evaluate(val)))
        nets[pkg.__name__] = est.net
    ref, got = logs["mxnet_tpu"], logs["mxnet_tpu_torch"]
    assert len(got) == len(ref) == 3 * 8 + 3 + 1
    for (rk, rv), (gk, gv) in zip(ref, got):
        assert rk == gk
        for r, g in zip(rv, gv):
            assert r[0] == g[0] if rk != "batch" else r[1] == g[1]
            onp.testing.assert_allclose(g[1] if rk != "batch" else g[0],
                                        r[1] if rk != "batch" else r[0],
                                        **TOL)
    r_arr = {k: p.data().asnumpy() for k, p in
             nets["mxnet_tpu"].collect_params().items()}
    got = _weights(nets["mxnet_tpu_torch"])
    for k in r_arr:
        onp.testing.assert_allclose(got[k], r_arr[k], **TOL)


def test_fused_fit_equals_the_phase_by_phase_fit():
    arrays = []
    for fused in (False, True):
        log = []
        est = _estimator(mx, fused=fused)
        with mx.cpu():
            est.fit(_loader(mx), epochs=2, event_handlers=_recorder(mx, log))
        arrays.append((log, _weights(est.net)))
    (la, wa), (lb, wb) = arrays
    assert la == lb
    for k in wa:
        assert onp.array_equal(wa[k], wb[k]), k


def _order_handlers(pkg, calls):
    eh = pkg.gluon.contrib.estimator

    def make(name, prio):
        attrs = {"batch_end": lambda self, est, *a, **k: calls.append(name),
                 "epoch_end": lambda self, est, *a, **k: calls.append(
                     "e" + name)}
        if prio is not None:
            attrs["priority"] = prio
        return type(name, (eh.BatchEnd, eh.EpochEnd), attrs)()

    return [make("late", 50), make("plain", None), make("early", -50),
            make("last", 5000)]


def test_handler_order_and_stopping_equal_the_reference():
    seqs = {}
    for pkg in (rmx, mx):
        calls = seqs.setdefault(pkg.__name__, [])
        est = _estimator(pkg)
        with _ctx(pkg):
            est.fit(_loader(pkg), epochs=1,
                    event_handlers=_order_handlers(pkg, calls))
            calls.append("|")
            stop = pkg.gluon.contrib.estimator.StoppingHandler(None, 5)
            seen = []
            h = _recorder(pkg, seen)
            est.fit(_loader(pkg), batches=5, event_handlers=[stop] + h)
            calls.append(sum(1 for k, _ in seen if k == "batch"))
            calls.append(stop.current_batch)
    assert seqs["mxnet_tpu_torch"] == seqs["mxnet_tpu"]
    got = seqs["mxnet_tpu_torch"]
    assert got[:4] == ["early", "plain", "late", "last"]
    assert got[-2:] == [5, 5]


def test_early_stopping_equals_the_reference():
    stopped = {}
    for pkg in (rmx, mx):
        est = _estimator(pkg)
        est.trainer.set_learning_rate(0.0)       # nothing improves
        es = pkg.gluon.contrib.estimator.EarlyStoppingHandler(
            monitor=est.train_metrics[0], patience=2)
        with _ctx(pkg):
            est.fit(_loader(pkg), epochs=20, event_handlers=[es])
        stopped[pkg.__name__] = (es.current_epoch, es.stopped_epoch,
                                 es.mode, es.wait)
    assert stopped["mxnet_tpu_torch"] == stopped["mxnet_tpu"]
    assert stopped["mxnet_tpu_torch"][0] == 3


def test_checkpoint_handler_equals_the_reference(tmp_path):
    files = {}
    for pkg in (rmx, mx):
        d = str(tmp_path / pkg.__name__)
        est = _estimator(pkg)
        ck = pkg.gluon.contrib.estimator.CheckpointHandler(
            d, model_prefix="m", monitor=est.train_metrics[1],
            save_best=True, batch_period=3, max_checkpoints=2)
        with _ctx(pkg):
            est.fit(_loader(pkg), epochs=2, event_handlers=[ck])
        files[pkg.__name__] = sorted(os.listdir(d))
        if pkg is mx:
            with mx.cpu():
                back = _mlp(mx)
            back.load_parameters(os.path.join(d, "m-epoch2.params"),
                                 ctx=mx.cpu())
            want = _weights(est.net)
            for k, v in _weights(back).items():
                assert onp.array_equal(v, want[k])
    assert files["mxnet_tpu_torch"] == files["mxnet_tpu"]
    assert "m-best.params" in files["mxnet_tpu_torch"]


def _np(x):
    import torch

    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class _From:
    """One epoch of ``loader`` from batch ``done`` on (the cursor a
    resumed run starts at)."""

    def __init__(self, loader, done):
        self.loader, self.done = loader, done

    def __iter__(self):
        return self.loader.iter_from(self.done)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phased"])
def test_atomic_resume_equals_the_uninterrupted_run(tmp_path, fused):
    eh = mx.gluon.contrib.estimator

    def run(directory, data, batches=None, resume=False):
        outs = []
        est = _estimator(mx, fused=fused)
        h = eh.AtomicCheckpointHandler(directory, every_n_batches=2,
                                       every_n_epochs=None, resume=resume)
        with mx.cpu():
            est.fit(data, epochs=None if batches else 1, batches=batches,
                    event_handlers=[h] + _recorder(mx, [], outs))
        return est, h, outs

    with mx.cpu():
        loader = _loader(mx)
    full, hf, full_log = run(str(tmp_path / "a"), loader)
    d = str(tmp_path / "b")
    _, hb, _ = run(d, loader, batches=4)
    assert hb.current_batch == 4 and mx.checkpoint.latest_step(d) == 4
    resumed, hr, res_log = run(d, _From(loader, 4), resume=True)
    assert hr.resumed_step == 4
    assert (hr.current_batch, hr.current_epoch) == \
        (hf.current_batch, hf.current_epoch) == (8, 1)
    # what the metrics read at each batch: the loss and the predictions
    assert len(res_log) == 4 and len(full_log) == 8
    for (la, pa), (lb, pb) in zip(res_log, full_log[4:]):
        assert onp.array_equal(la, lb) and onp.array_equal(pa, pb)
    # and so the metrics of batches 5-8
    for m in (mx.metric.Accuracy(), mx.metric.Loss()):
        vals = []
        for log in (res_log, full_log[4:]):
            m.reset()
            for i, (loss, pred) in enumerate(log):
                if m.name == "loss":
                    m.update(0, loss)
                else:
                    m.update(_data()[1][16 + 4 * i:20 + 4 * i], pred)
            vals.append(m.get())
        assert vals[0] == vals[1]
    assert resumed.train_metrics[1].num_inst == 16
    want = _weights(full.net)
    for k, v in _weights(resumed.net).items():
        assert onp.array_equal(v, want[k]), k
    assert mx.checkpoint.latest_step(d) == 8


def test_a_reference_checkpoint_resumes_into_the_port(tmp_path):
    d = str(tmp_path / "ref")
    rest = _estimator(rmx)
    rh = rmx.gluon.contrib.estimator.AtomicCheckpointHandler(
        d, every_n_batches=4, every_n_epochs=None, async_save=False)
    with rmx.cpu():
        rest.fit(_loader(rmx), batches=4, event_handlers=[rh])
    at_save = {k: p.data().asnumpy() for k, p in
               rest.net.collect_params().items()}
    r_states = [_np(s) for s in rest.trainer._states if s is not None]
    with rmx.cpu():
        rest.fit(_From(_loader(rmx), 4), epochs=1, event_handlers=[])
    after = {k: p.data().asnumpy() for k, p in
             rest.net.collect_params().items()}

    est = _estimator(mx)
    h = mx.gluon.contrib.estimator.AtomicCheckpointHandler(
        d, every_n_batches=None, every_n_epochs=None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        h.train_begin(est)
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    assert h.resumed_step == 4 and (h.current_batch, h.current_epoch) == \
        (4, 0)
    got = _weights(est.net)
    for k, v in at_save.items():
        assert onp.array_equal(got[k], v), k
    p_states = [_np(s) for s in est.trainer._states if s is not None]
    assert len(p_states) == len(r_states) == 4      # the momenta
    for p, r in zip(p_states, r_states):
        assert onp.array_equal(p, r)
    h.train_end(est)
    with mx.cpu():
        est.fit(_From(_loader(mx), 4), epochs=1, event_handlers=[])
    got = _weights(est.net)
    for k in after:
        onp.testing.assert_allclose(got[k], after[k], **TOL)


@pytest.mark.cuda
def test_fused_estimator_on_card_equals_cpu():
    """The fused fit on the card against the CPU's (the card's machine
    has no JAX: the weights are the port's own, seeded)."""
    need_cuda()

    def fit(ctx, arrays=None):
        with ctx:
            net = _mlp(mx)
            if arrays is None:
                net.initialize(mx.init.Xavier(), ctx=ctx, seed=0)
            else:
                load_mxnet_tpu_arrays(net, arrays)
            start = _weights(net)
            net.hybridize()
            trainer = mx.gluon.Trainer(net.collect_params(), OPT[0],
                                       dict(OPT[1]))
            est = mx.gluon.contrib.estimator.Estimator(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                metrics=[mx.metric.Accuracy(), mx.metric.Loss()],
                trainer=trainer, context=ctx, fused_step=True)
            est.fit(_loader(mx), epochs=1)
        return start, _weights(net), [m.get() for m in est.train_metrics]

    start, want, want_m = fit(mx.cpu())
    _, got, got_m = fit(mx.gpu(0), start)
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert got_m[0] == want_m[0]
    onp.testing.assert_allclose(got_m[1][1], want_m[1][1], rtol=1e-4)
