"""The training slice of the PyTorch port as a whole against the JAX
package, float32 on the CPU.

A tiny GPT (vocab 97, 2 layers, 32 units, 2 heads, context 640, dropout
0) carries the reference's weights into the port (``gpt_from_mxnet_tpu``)
and takes three AdamW steps on both sides, through
``parallel.SPMDTrainer`` (a one-device mesh in JAX) and through
``gluon.Trainer`` (record, backward, ``step(batch_size)``).  At T = 640
the port's attention runs its flash path (K1 forward, K2/K3 backward, by
their plain versions here) and the reference its blockwise ``"xla"``
path.  A BERT step with ``valid_length`` follows.  Losses agree to 1e-4
relative; weights, compared name by name through ``arrays_from_port``,
to 5e-5 absolute plus 1e-4 relative, half a percent of one step's move:
each AdamW step moves a weight by about ``lr`` (1e-2) whatever its
gradient's size, so where a gradient is near zero the two sides'
different summation orders show (the largest difference seen is 1.3e-5,
on an FFN weight)."""
import numpy as onp
import pytest
import torch

from _torch_parity import jax_gpt, port_gpt
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch import parallel as pparallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (BERTConfig, arrays_from_port,
                                    bert_from_mxnet_tpu)

LOSS_TOL = dict(rtol=1e-4, atol=0)
WEIGHT_TOL = dict(rtol=1e-4, atol=5e-5)
GPT_TINY = dict(vocab_size=97, max_length=640, num_layers=2, units=32,
                num_heads=2, hidden_size=64)
OPT = {"learning_rate": 1e-2, "wd": 0.01}
STEPS = 3


def _batch(T=640, vocab=97, B=1, seed=0):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, vocab, (B, T)).astype(onp.int32),
            rs.randint(0, vocab, (B, T)).astype(onp.int32))


def _one_device_mesh():
    import jax
    from mxnet_tpu import parallel

    return parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _ref_arrays(net):
    return {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in net.collect_params().items()}


def _assert_weights(net, model):
    ref = _ref_arrays(net)
    got = arrays_from_port(model, prefix=net.prefix)
    assert sorted(got) == sorted(ref)
    for name in ref:
        onp.testing.assert_allclose(got[name], ref[name], err_msg=name,
                                    **WEIGHT_TOL)


@pytest.fixture
def gpt_pair():
    net = jax_gpt(init=0.02, **GPT_TINY)
    return net, port_gpt(net)


def test_spmd_trainer_matches_jax(gpt_pair):
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel
    from mxnet_tpu_torch.ops import attention as pa

    net, model = gpt_pair
    data, label = _batch()
    jtr = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adamw", dict(OPT), mesh=_one_device_mesh())
    ptr = pparallel.SPMDTrainer(model, pgluon.loss.SoftmaxCrossEntropyLoss(),
                                "adamw", dict(OPT))
    ref = [jtr.step(mx.nd.array(data, dtype="int32"),
                    mx.nd.array(label, dtype="int32")).asnumpy().item()
           for _ in range(STEPS)]
    launches = (pa.flash_fwd.launches, pa.flash_bwd_dq.launches,
                pa.flash_bwd_dkv.launches)
    got = [float(ptr.step(torch.as_tensor(data), torch.as_tensor(label)))
           for _ in range(STEPS)]
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launches == (pa.flash_fwd.launches, pa.flash_bwd_dq.launches,
                        pa.flash_bwd_dkv.launches)
    onp.testing.assert_allclose(got, ref, **LOSS_TOL)
    assert got[-1] < got[0]
    assert ptr.optimizer.num_update == STEPS
    _assert_weights(net, model)


def test_spmd_run_steps_equals_steps(gpt_pair):
    """``run_steps`` over a leading steps axis is the same loop of
    ``step``: identical losses and weights."""
    net, model = gpt_pair
    twin = port_gpt(net)
    data, label = _batch(T=64, seed=3)
    steps = [onp.stack([data] * 2), onp.stack([label] * 2)]
    a = pparallel.SPMDTrainer(model, pgluon.loss.SoftmaxCrossEntropyLoss(),
                              "adamw", dict(OPT))
    b = pparallel.SPMDTrainer(twin, pgluon.loss.SoftmaxCrossEntropyLoss(),
                              "adamw", dict(OPT))
    losses = a.run_steps(*steps)
    assert losses.shape == (2,)
    ref = torch.stack([b.step(data, label) for _ in range(2)])
    torch.testing.assert_close(losses, ref, rtol=0, atol=0)
    for p, q in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_gluon_trainer_matches_jax(gpt_pair):
    import mxnet_tpu as mx
    from mxnet_tpu import autograd, gluon

    net, model = gpt_pair
    data, label = _batch(seed=1)
    jtr = gluon.Trainer(net.collect_params(), "adamw", dict(OPT))
    jloss = gluon.loss.SoftmaxCrossEntropyLoss()
    ptr = pgluon.Trainer(model, "adamw", dict(OPT))
    ploss = pgluon.loss.SoftmaxCrossEntropyLoss()
    ref, got = [], []
    for _ in range(STEPS):
        with autograd.record():
            L = jloss(net(mx.nd.array(data, dtype="int32")),
                      mx.nd.array(label, dtype="int32"))
        L.backward()
        jtr.step(data.shape[0])
        ref.append(L.asnumpy())
        L = ploss(model(torch.as_tensor(data)), torch.as_tensor(label))
        L.backward(torch.ones_like(L))
        ptr.step(data.shape[0])
        got.append(L.detach().numpy())
        assert all(p.grad is None for p in model.parameters())
    onp.testing.assert_allclose(onp.concatenate(got), onp.concatenate(ref),
                                **LOSS_TOL)
    _assert_weights(net, model)


def test_gluon_trainer_refuses_later_slice_features(gpt_pair):
    _, model = gpt_pair
    with pytest.raises(MXNetError, match="update_interval"):
        pgluon.Trainer(model, "sgd", update_interval=2)
    with pytest.raises(MXNetError, match="kvstore"):
        pgluon.Trainer(model, "sgd", kvstore="dist_sync")
    tr = pgluon.Trainer(model, "sgd")
    with pytest.raises(MXNetError, match="no gradient"):
        tr.step(1)
    with pytest.raises(MXNetError, match="more than one device"):
        pparallel.SPMDTrainer(model, pgluon.loss.L2Loss(), "sgd",
                              mesh={"dp": 2})


class _MLMOnly(torch.nn.Module):
    """The MLM logits of BERT on fixed token types and valid lengths
    (``bench.py``'s ``_MLMHeadOnly``, with a padding mask)."""

    def __init__(self, bert, types, valid_length):
        super().__init__()
        self.bert, self.types, self.vl = bert, types, valid_length

    def forward(self, tokens):
        return self.bert(tokens, self.types, self.vl)[-1]


def test_bert_step_matches_jax():
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel
    from mxnet_tpu.models import BERTConfig as JConfig
    from mxnet_tpu.models import BERTModel as JBERT

    kw = dict(vocab_size=101, max_length=32, num_layers=2, units=32,
              num_heads=4, hidden_size=64)
    mx.random.seed(0)
    bert = JBERT(JConfig(**kw))
    types = onp.zeros((2, 16), onp.int32)
    types[:, 8:] = 1
    vlen = onp.array([16, 10], onp.int32)

    class JMLM(gluon.Block):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, tokens):
            return self.bert(tokens, mx.nd.array(types, dtype="int32"),
                             mx.nd.array(vlen, dtype="int32"))[-1]

    jnet = JMLM()
    jnet.initialize(mx.init.Normal(0.02))
    model = bert_from_mxnet_tpu(BERTConfig(**kw), _ref_arrays(bert),
                                device="cpu")
    pnet = _MLMOnly(model, torch.as_tensor(types), torch.as_tensor(vlen))
    data, label = _batch(T=16, vocab=101, B=2, seed=4)
    jtr = parallel.SPMDTrainer(jnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                               "adamw", dict(OPT), mesh=_one_device_mesh())
    ptr = pparallel.SPMDTrainer(pnet, pgluon.loss.SoftmaxCrossEntropyLoss(),
                                "adamw", dict(OPT))
    ref = jtr.step(mx.nd.array(data, dtype="int32"),
                   mx.nd.array(label, dtype="int32")).asnumpy().item()
    got = float(ptr.step(data, label))
    onp.testing.assert_allclose(got, ref, **LOSS_TOL)
    _assert_weights(bert, model)
