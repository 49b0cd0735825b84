"""The port's Module API (``mxnet_tpu_torch.module``, ``model``,
``callback``) against ``mxnet_tpu``'s, in f32 on the CPU.

- ``Module.fit`` over ``tests/test_module.py::toy_iter``'s data (200 x
  20, 5 classes, batches of 25, in order) from the same numpy weights
  (``arg_params``; neither package draws them): the parameters after
  each epoch within 1e-5 of the reference Module's (of each array's
  largest magnitude), SGD with momentum, ``rescale_grad`` 1/batch by
  default; ``score`` and ``predict`` equal.
- ``SoftmaxOutput``'s gradient: ``p - onehot`` and the reference's.
- ``BucketingModule`` (``tests/test_module.py::TestBucketing``'s
  ``sym_gen``): the buckets share their arrays, and the parameters after
  steps in both buckets are within 1e-5 of the reference's.
- ``save_checkpoint``/``Module.load`` across packages, both directions:
  the graph node for node and the weights bit for bit.
- The callbacks: ``Speedometer``'s and ``log_train_metric``'s log lines
  (the reference's, speeds aside), ``do_checkpoint``'s files,
  ``ProgressBar`` and ``LogValidationMetricsCallback``.
- The surface: shapes deduced at ``bind``, fixed parameters, the
  errors, ``model``'s helpers.
"""
import json
import logging
import re

import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference
from mxnet_tpu_torch.base import MXNetError

rmx = LazyReference()     # the JAX package, imported at first use

CPU = mx.cpu()
TOL = 1e-5


def _close(a, b, tol=TOL):
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    scale = max(onp.abs(b).max(), 1e-30)
    assert onp.abs(a - b).max() <= tol * scale, onp.abs(a - b).max() / scale


def _mlp_sym(pkg, num_classes=5):
    s = pkg.sym if pkg is mx else pkg.symbol
    h = s.FullyConnected(s.var("data"), s.var("fc1_weight"),
                         s.var("fc1_bias"), num_hidden=32, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, s.var("fc2_weight"), s.var("fc2_bias"),
                         num_hidden=num_classes, name="fc2")
    return s.SoftmaxOutput(h, s.var("softmax_label"), name="softmax")


def _toy():
    rng = onp.random.RandomState(0)
    X = rng.rand(200, 20).astype(onp.float32)
    w = rng.rand(20, 5).astype(onp.float32)
    y = (X @ w).argmax(axis=1).astype(onp.float32)
    init = {"fc1_weight": rng.randn(32, 20).astype(onp.float32) * 0.3,
            "fc1_bias": onp.zeros(32, onp.float32),
            "fc2_weight": rng.randn(5, 32).astype(onp.float32) * 0.3,
            "fc2_bias": onp.zeros(5, onp.float32)}
    return X, y, init


def _module(pkg, **kw):
    return (pkg.mod if pkg is mx else pkg.module).Module(
        _mlp_sym(pkg), context=pkg.cpu(), **kw)


def _iter(pkg, X, y):
    with CPU:
        return pkg.io.NDArrayIter(X, y, batch_size=25, shuffle=False)


def _fit(pkg, epochs, **kw):
    X, y, init = _toy()
    mod, it = _module(pkg), _iter(pkg, X, y)
    seen = []
    extra = kw.pop("epoch_end_callback", [])
    with CPU:
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.5), ("momentum", 0.9)),
                arg_params={k: pkg.nd.array(v) for k, v in init.items()},
                epoch_end_callback=[lambda e, s, a, x: seen.append(
                    {k: v.asnumpy() for k, v in a.items()})] +
                (extra if isinstance(extra, list) else [extra]), **kw)
    return mod, it, seen


def test_fit_matches_the_reference_after_each_epoch():
    rmod, rit, rseen = _fit(rmx, 3)
    pmod, pit, pseen = _fit(mx, 3)
    assert len(pseen) == len(rseen) == 3
    for r, p in zip(rseen, pseen):
        assert sorted(p) == sorted(r)
        for k in r:
            _close(p[k], r[k])
    assert pmod._optimizer.rescale_grad == rmod._optimizer.rescale_grad \
        == 1.0 / 25
    with CPU:
        pacc = pmod.score(pit, "acc")[0][1]
        pred = pmod.predict(pit)
    assert pacc == rmod.score(rit, "acc")[0][1] and pacc > 0.6
    _close(pred.asnumpy(), rmod.predict(rit).asnumpy())
    assert pred.shape == (200, 5)


def test_softmax_output_gradient():
    rs = onp.random.RandomState(3)
    x = rs.rand(3, 4).astype(onp.float32)
    y = onp.array([1, 3, 0], onp.float32)
    grads = []
    for pkg in (rmx, mx):
        with CPU:
            xd, yd = pkg.nd.array(x), pkg.nd.array(y)
        xd.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.SoftmaxOutput(xd, yd)
        out.backward()
        grads.append(xd.grad.asnumpy())
    p = onp.exp(x) / onp.exp(x).sum(1, keepdims=True)
    _close(grads[1], p - onp.eye(4, dtype=onp.float32)[[1, 3, 0]])
    _close(grads[1], grads[0])


def _bucket_sym(pkg):
    s = pkg.sym if pkg is mx else pkg.symbol

    def sym_gen(seq_len):
        f = s.FullyConnected(s.var("data"), s.var("fc_weight"),
                             s.var("fc_bias"), num_hidden=4, flatten=False,
                             name="fc")
        f = s.transpose(f, axes=(0, 2, 1))
        return (s.SoftmaxOutput(f, s.var("softmax_label"),
                                multi_output=True),
                ("data",), ("softmax_label",))
    return sym_gen


def test_bucketing_shares_weights_and_matches_the_reference():
    init = {"fc_weight": onp.random.RandomState(1).randn(4, 5)
            .astype(onp.float32) * 0.3, "fc_bias": onp.zeros(4, onp.float32)}
    res = []
    for pkg in (rmx, mx):
        mod = (pkg.mod if pkg is mx else pkg.module)
        with CPU:
            bm = mod.BucketingModule(_bucket_sym(pkg), default_bucket_key=10,
                                     context=pkg.cpu())
            bm.bind([("data", (8, 10, 5))], [("softmax_label", (8, 10))])
            bm.init_params(arg_params={k: pkg.nd.array(v)
                                       for k, v in init.items()})
            bm.init_optimizer(optimizer="sgd",
                              optimizer_params=(("learning_rate", 0.1),))
            rng = onp.random.RandomState(0)
            for key in (10, 6, 10, 6):
                b = pkg.io.DataBatch(
                    data=[pkg.nd.array(rng.rand(8, key, 5)
                                       .astype(onp.float32))],
                    label=[pkg.nd.array(rng.randint(0, 4, (8, key))
                                        .astype(onp.float32))],
                    bucket_key=key, provide_data=[("data", (8, key, 5))],
                    provide_label=[("softmax_label", (8, key))])
                bm.forward(b, is_train=True)
                bm.backward()
                bm.update()
        assert sorted(bm._buckets) == [6, 10]
        assert (bm._buckets[6]._exec.arg_dict["fc_weight"]
                is bm._buckets[10]._exec.arg_dict["fc_weight"])
        assert bm._buckets[6]._optimizer is bm._buckets[10]._optimizer
        res.append({k: v.asnumpy() for k, v in bm.get_params()[0].items()})
    for k in res[0]:
        _close(res[1][k], res[0][k])


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_across_packages(tmp_path, direction):
    src, dst = (rmx, mx) if direction == "reference_to_port" else (mx, rmx)
    mod, it, _ = _fit(src, 1)
    prefix = str(tmp_path / "ck")
    mod.save_checkpoint(prefix, 1)
    loaded = (dst.mod if dst is mx else dst.module).Module.load(
        prefix, 1, context=dst.cpu())
    X, y, _ = _toy()
    it2 = _iter(dst, X, y)
    with CPU:
        loaded.bind(it2.provide_data, it2.provide_label, for_training=False)
        loaded.init_params()
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    got = {k: v.asnumpy() for k, v in loaded.get_params()[0].items()}
    assert sorted(got) == sorted(want)
    assert all(onp.array_equal(got[k], want[k]) for k in want)
    assert json.loads(loaded.symbol.tojson())["nodes"] == \
        json.loads(mod.symbol.tojson())["nodes"]


# --------------------------------------------------------------------------- #
# callbacks
# --------------------------------------------------------------------------- #

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    handler = _Lines()
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.INFO)
    root.addHandler(handler)
    yield handler.lines
    root.removeHandler(handler)
    root.setLevel(level)


def _speedless(lines):
    return [re.sub(r"Speed: [0-9.]+", "Speed: S", ln) for ln in lines
            if "Batch" in ln or "Iter" in ln]


def test_batch_callbacks_log_the_reference_lines(log_lines, tmp_path):
    out = []
    for pkg in (rmx, mx):
        del log_lines[:]
        cb = pkg.callback
        _fit(pkg, 2, batch_end_callback=[cb.Speedometer(25, 3),
                                         cb.log_train_metric(4)])
        out.append(_speedless(log_lines))
    assert out[1] == out[0]
    assert sum("Speed" in ln for ln in out[1]) == 2 * 2
    assert sum(ln.startswith("Iter[") for ln in out[1]) == 2 * 2


def test_epoch_callbacks_write_checkpoints(tmp_path, log_lines):
    prefix = str(tmp_path / "every")
    mod, it, seen = _fit(mx, 2, epoch_end_callback=mx.callback.do_checkpoint(
        prefix, period=1))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["every-0001.params", "every-0002.params", "every-symbol.json"]
    arg, aux = mx.model.load_params(prefix, 2, ctx=CPU)
    assert aux == {} and all(onp.array_equal(
        arg[k].asnumpy(), v.asnumpy()) for k, v in mod.get_params()[0]
        .items())
    assert mx.callback.module_checkpoint is mx.callback.do_checkpoint
    # the reference reads the port's checkpoint
    rsym, rarg, raux = rmx.model.load_checkpoint(prefix, 2)
    assert rsym.list_arguments() == mod.symbol.list_arguments()
    assert all(onp.array_equal(rarg[k].asnumpy(), arg[k].asnumpy())
               for k in arg)


def test_progress_bar_and_validation_callbacks(log_lines):
    lines = []
    for pkg in (rmx, mx):
        del log_lines[:]
        param = pkg.model.BatchEndParam(epoch=1, nbatch=5, eval_metric=None,
                                        locals=None)
        pkg.callback.ProgressBar(10, length=20)(param)
        metric = pkg.metric.create("acc")
        with CPU:
            metric.update([pkg.nd.array([1.0, 0.0])],
                          [pkg.nd.array([[0.1, 0.9], [0.8, 0.2]])])
        pkg.callback.LogValidationMetricsCallback()(
            param._replace(eval_metric=metric))
        pkg.callback.LogValidationMetricsCallback()(param)
        lines.append(list(log_lines))
    assert lines[1] == lines[0] and len(lines[1]) == 2
    assert lines[1][1] == "Epoch[1] Validation-accuracy=1.000000"


# --------------------------------------------------------------------------- #
# the surface
# --------------------------------------------------------------------------- #

def test_bind_infers_shapes_and_fixed_params_stay():
    X, y, init = _toy()
    mod = _module(mx, fixed_param_names=["fc1_weight"])
    it = _iter(mx, X, y)
    mod.bind(it.provide_data, it.provide_label)
    assert mod._exec.arg_dict["fc1_weight"].shape == (32, 20)
    assert mod._exec.arg_dict["fc2_weight"].shape == (5, 32)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    before = mod._exec.arg_dict["fc1_weight"].asnumpy().copy()
    with CPU:
        batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    onp.testing.assert_array_equal(
        mod._exec.arg_dict["fc1_weight"].asnumpy(), before)
    assert mod.output_shapes == [("softmax_output", (25, 5))]
    assert mod.data_names == ["data"] and mod.output_names == \
        ["softmax_output"]


def test_module_errors_and_set_params():
    mod = _module(mx)
    X, y, init = _toy()
    it = _iter(mx, X, y)
    with pytest.raises(MXNetError, match="bound"):
        mod.score(it, "acc")
    with pytest.raises(MXNetError, match="bind first"):
        mod.init_params()
    with pytest.raises(MXNetError, match="num_epoch"):
        mod.fit(it)
    mod.bind(it.provide_data, it.provide_label)
    with pytest.raises(MXNetError, match="missing"):
        mod.init_params(arg_params={"fc1_weight": init["fc1_weight"]})
    mod.set_params({k: mx.nd.array(v, ctx=CPU) for k, v in init.items()})
    got = mod.get_params()
    assert got[1] == {} and all(onp.array_equal(got[0][k].asnumpy(), v)
                                for k, v in init.items())
    with pytest.raises(MXNetError, match="init_optimizer"):
        mod.update()
    with pytest.raises(MXNetError, match="default_bucket_key"):
        mx.mod.BucketingModule(lambda k: None)


def test_model_helpers(tmp_path):
    a = mx.nd.array(onp.arange(4, dtype=onp.float32), ctx=CPU)
    path = str(tmp_path / "plain.params")
    mx.nd.save(path, {"w": a, "arg:x": a, "aux:y": a})
    arg, aux = mx.model.load_params_file(path, ctx=CPU)
    assert sorted(arg) == ["w", "x"] and sorted(aux) == ["y"]
    rarg, raux = rmx.model.load_params_file(path)
    assert sorted(rarg) == sorted(arg) and sorted(raux) == sorted(aux)
    mx.nd.save(path, [a])
    with pytest.raises(MXNetError, match="unnamed"):
        mx.model.load_params_file(path, ctx=CPU)
    assert mx.model.BatchEndParam._fields == rmx.model.BatchEndParam._fields
    mx.model.save_checkpoint(str(tmp_path / "nosym"), 3, None, {"w": a}, {})
    sym, arg, aux = mx.model.load_checkpoint(str(tmp_path / "nosym"), 3,
                                             ctx=CPU)
    assert sym is None and list(arg) == ["w"]
