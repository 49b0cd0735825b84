"""``mxnet_tpu_torch.metric`` (``mx.metric``) against ``mxnet_tpu.metric``:
every metric fed the same seeded batches (float32 arrays of each
package) over three updates, then ``get()`` compared.  Both sum in numpy
after reading the arrays to the host, so the values are equal; the
tolerance is 1e-12 relative in float64 (exact in practice).  Also
``create`` (names, aliases, lists, callables), ``register``,
``CompositeEvalMetric``, ``CustomMetric``/``np``, ``reset``,
``get_name_value``, ``update_dict`` and the host-read count."""
import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-12, atol=0)


def _batches(kind, seed, n=3):
    rs = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            pred = rs.rand(8, 5).astype(onp.float32)
            label = rs.randint(0, 5, 8).astype(onp.float32)
        elif kind == "binary2":
            pred = rs.rand(10, 2).astype(onp.float32)
            label = rs.randint(0, 2, 10).astype(onp.float32)
        elif kind == "binary1":
            pred = rs.rand(10).astype(onp.float32)
            label = rs.randint(0, 2, 10).astype(onp.float32)
        elif kind == "prob":
            logits = rs.standard_normal((4, 3, 6))
            p = onp.exp(logits) / onp.exp(logits).sum(-1, keepdims=True)
            pred = p.astype(onp.float32)
            label = rs.randint(0, 6, (4, 3)).astype(onp.float32)
        elif kind == "regress":
            pred = rs.standard_normal((6, 3)).astype(onp.float32)
            label = rs.standard_normal((6, 3)).astype(onp.float32)
        else:                       # a per-sample loss
            pred = rs.rand(7).astype(onp.float32)
            label = onp.zeros(7, onp.float32)
        out.append((label, pred))
    return out


CASES = [
    ("Accuracy", {}, "class"),
    ("Accuracy", {"axis": 1}, "binary2"),
    ("TopKAccuracy", {"top_k": 3}, "class"),
    ("F1", {}, "binary2"),
    ("F1", {"average": "micro"}, "binary1"),
    ("MCC", {}, "binary2"),
    ("MCC", {}, "binary1"),
    ("Perplexity", {}, "prob"),
    ("Perplexity", {"ignore_label": 2}, "prob"),
    ("MAE", {}, "regress"),
    ("MSE", {}, "regress"),
    ("RMSE", {}, "regress"),
    ("CrossEntropy", {}, "prob"),
    ("NegativeLogLikelihood", {"eps": 1e-8}, "prob"),
    ("PearsonCorrelation", {}, "regress"),
    ("Loss", {}, "loss"),
]


def _run(pkg, name, kwargs, batches, ctx=None):
    m = getattr(pkg.metric, name)(**kwargs)
    for label, pred in batches:
        if ctx is not None:
            m.update([pkg.nd.array(label, ctx=ctx)],
                     [pkg.nd.array(pred, ctx=ctx)])
        else:
            m.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
    return m


@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_metric_equals_the_reference(name, kwargs, kind):
    batches = _batches(kind, len(name) + len(kind))
    ref = _run(rmx, name, kwargs, batches)
    port = _run(mx, name, kwargs, batches, ctx=mx.cpu())
    rn, rv = ref.get()
    pn, pv = port.get()
    assert pn == rn
    onp.testing.assert_allclose(float(pv), float(rv), **TOL)
    assert port.num_inst == ref.num_inst
    assert port.get_name_value() == [(pn, pv)]
    port.reset()
    assert onp.isnan(port.get()[1]) and port.num_inst == 0


def test_composite_create_and_register():
    batches = _batches("class", 5)

    def both(make):
        r, p = make(rmx), make(mx)
        for label, pred in batches:
            r.update([rmx.nd.array(label)], [rmx.nd.array(pred)])
            p.update([mx.nd.array(label, ctx=mx.cpu())],
                     [mx.nd.array(pred, ctx=mx.cpu())])
        return r.get(), p.get()

    for spec in (["acc", "ce"], ("accuracy", "top_k_accuracy"),
                 ["nll_loss"]):
        (rn, rv), (pn, pv) = both(lambda pkg: pkg.metric.create(list(spec)))
        assert pn == rn
        onp.testing.assert_allclose(pv, rv, **TOL)
    (rn, rv), (pn, pv) = both(lambda pkg: pkg.metric.CompositeEvalMetric(
        [pkg.metric.Accuracy(), "ce"]))
    assert pn == rn == ["accuracy", "cross-entropy"]
    onp.testing.assert_allclose(pv, rv, **TOL)
    comp = mx.metric.create(["acc", "mae"])
    assert isinstance(comp.get_metric(1), mx.metric.MAE)
    assert mx.metric.create(mx.metric.Accuracy()).name == "accuracy"
    with pytest.raises(mx.base.MXNetError, match="unknown metric"):
        mx.metric.create("nope")

    @mx.metric.register
    class HalfAccuracy(mx.metric.Accuracy):
        def get(self):
            name, value = super().get()
            return name, value / 2

    assert isinstance(mx.metric.create("halfaccuracy"), HalfAccuracy)


def test_custom_and_np_equal_the_reference():
    batches = _batches("regress", 11)

    def feval(label, pred):
        return float(onp.abs(label - pred).max())

    def feval_pair(label, pred):
        return float((label * pred).sum()), label.size

    for make in (lambda pkg: pkg.metric.np(feval, name="maxerr"),
                 lambda pkg: pkg.metric.CustomMetric(feval_pair, "dot"),
                 lambda pkg: pkg.metric.create(feval)):
        r, p = make(rmx), make(mx)
        for label, pred in batches:
            r.update([rmx.nd.array(label)], [rmx.nd.array(pred)])
            p.update([mx.nd.array(label, ctx=mx.cpu())],
                     [mx.nd.array(pred, ctx=mx.cpu())])
        assert p.get()[0] == r.get()[0]
        onp.testing.assert_allclose(p.get()[1], r.get()[1], **TOL)


def test_update_dict_numpy_inputs_and_host_reads():
    label, pred = _batches("class", 3, 1)[0]
    m = mx.metric.Accuracy()
    r = rmx.metric.Accuracy()
    m.update_dict({"softmax_label": label}, {"softmax_output": pred})
    r.update_dict({"softmax_label": label}, {"softmax_output": pred})
    assert m.get() == r.get()
    before = mx.metric.host_reads()
    m.update([mx.nd.array(label, ctx=mx.cpu())],
             [mx.nd.array(pred, ctx=mx.cpu())])
    # one read a label and one a prediction; numpy inputs cost none
    assert mx.metric.host_reads() - before == 2
    loss = mx.metric.Loss()
    import torch

    loss.update(None, [torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)])
    assert loss.get() == ("loss", 2.0)
    assert "accuracy" in str(m)
