"""The losses of the PyTorch port against the JAX package:
``SoftmaxCrossEntropyLoss`` (sparse labels through the fused ``lse -
pred[label]``, sparse labels on log-probabilities, dense labels) on a
(B, L, V) input, and ``L2Loss``, with ``weight`` and ``sample_weight``;
values and gradients with respect to ``pred`` (MXNet's ``backward()``
on a per-sample loss: a head gradient of ones).  f32 at 1e-5; the bf16
input of the fused path to one bf16 rounding step in value and four in
gradient (where the two frameworks round at different places)."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, rand, t
from mxnet_tpu_torch.gluon import loss as ploss
from mxnet_tpu_torch.ops import nn as pnn

B, L, V = 3, 5, 11


def _jax_loss(loss, pred, label, sample_weight=None, dtype="float32"):
    import mxnet_tpu as mx

    p = mx.nd.array(pred, dtype=dtype)
    p.attach_grad()
    args = [mx.nd.array(label)]
    if sample_weight is not None:
        args.append(mx.nd.array(sample_weight))
    with mx.autograd.record():
        out = loss(p, *args)
    out.backward()
    return (out.asnumpy().astype(onp.float32),
            p.grad.asnumpy().astype(onp.float32))


def _port_loss(loss, pred, label, sample_weight=None, dtype=torch.float32):
    p = t(pred).to(dtype).requires_grad_()
    args = [t(label)]
    if sample_weight is not None:
        args.append(t(sample_weight))
    out = loss(p, *args)
    out.backward(torch.ones_like(out))
    return out.detach().float().numpy(), p.grad.float().numpy()


def _labels(kind):
    rs = onp.random.RandomState(1)
    if kind == "dense":
        lab = rs.random_sample((B, L, V)).astype(onp.float32)
        return lab / lab.sum(-1, keepdims=True)
    lab = rs.randint(0, V, (B, L))
    lab[0, 0] = V + 3                        # clipped, as the reference does
    return lab.astype(onp.int64)


CE_CASES = {
    "sparse": dict(labels="sparse"),
    "sparse_weighted": dict(labels="sparse", weight=0.7,
                            sample_weight=True),
    "sparse_from_logits": dict(labels="sparse", from_logits=True),
    "dense": dict(labels="dense"),
    "dense_axis1": dict(labels="dense", axis=1),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_softmax_ce_matches_jax(name):
    from mxnet_tpu import gluon

    c = CE_CASES[name]
    kw = dict(sparse_label=c["labels"] == "sparse",
              from_logits=c.get("from_logits", False),
              weight=c.get("weight"), axis=c.get("axis", -1))
    pred = rand(0, B, L, V, scale=3.0)
    label = _labels(c["labels"])
    if c.get("axis") == 1:                  # class axis 1: (B, V, L)
        pred, label = (onp.ascontiguousarray(a.transpose(0, 2, 1))
                       for a in (pred, label))
    if kw["from_logits"]:
        pred = pred - onp.log(onp.exp(pred).sum(-1, keepdims=True))
    sw = rand(2, B, L, 1) if c.get("sample_weight") else None
    ref = _jax_loss(gluon.loss.SoftmaxCrossEntropyLoss(**kw), pred, label,
                    sw)
    got = _port_loss(ploss.SoftmaxCrossEntropyLoss(**kw), pred, label, sw)
    assert got[0].shape == (B,)
    for a, b in zip(got, ref):
        onp.testing.assert_allclose(a, b, **KERNEL_TOL)


def test_softmax_ce_bf16_matches_jax():
    """bf16 logits: f32 inside the reductions, bf16 loss and gradient."""
    from mxnet_tpu import gluon

    pred = torch.tensor(rand(3, B, L, V, scale=3.0)).bfloat16().float()
    label = _labels("sparse")
    ref = _jax_loss(gluon.loss.SoftmaxCrossEntropyLoss(), pred.numpy(),
                    label, dtype="bfloat16")
    got = _port_loss(ploss.SoftmaxCrossEntropyLoss(), pred.numpy(), label,
                     dtype=torch.bfloat16)
    onp.testing.assert_allclose(got[0], ref[0], rtol=2 ** -8, atol=1e-6)
    # the reference adds the gradient's softmax and one-hot parts in
    # bf16 (two roundings), the port in f32 before one rounding
    onp.testing.assert_allclose(got[1], ref[1], rtol=2 ** -6, atol=1e-6)


def test_sparse_ce_chunks_rows(monkeypatch):
    """The fused loss's row chunks (bounding the f32 temporaries) give
    the unchunked values and gradients."""
    pred = t(rand(4, 7, 13, scale=2.0))
    label = torch.tensor(onp.random.RandomState(2).randint(0, 13, (7,)))
    outs = []
    for rows in (1024, 3):
        monkeypatch.setattr(pnn, "_CE_ROWS", rows)
        p = pred.clone().requires_grad_()
        out = pnn.sparse_softmax_ce(p, label)
        out.backward(torch.ones_like(out))
        outs.append((out.detach(), p.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_l2_loss_matches_jax(weighted):
    from mxnet_tpu import gluon

    pred, label = rand(5, B, L, 4), rand(6, B, L * 4)
    sw = rand(7, B, 1, 1) if weighted else None
    kw = dict(weight=2.0) if weighted else {}
    ref = _jax_loss(gluon.loss.L2Loss(**kw), pred, label, sw)
    got = _port_loss(ploss.L2Loss(**kw), pred, label, sw)
    for a, b in zip(got, ref):
        onp.testing.assert_allclose(a, b, **KERNEL_TOL)
