"""The vision training slice of the PyTorch port against the JAX package,
float32 on the CPU.

Small bottleneck ResNets, v1 and v2 (``ResNetV1/V2(Bottleneck, [1, 1, 1,
1], [16, 32, 64, 128, 256], classes=10, thumbnail=True,
layout="NHWC")``), batch 2 at 32x32, carry the reference's weights and
running statistics into the port (``load_mxnet_tpu_arrays``; gammas,
betas, biases and running statistics are perturbed first, so that none
sits at its initial value).  Both packages run with
``MXNET_FUSED_CONV_BWD=1``, so every 1x1 stride-1 convolution's backward
goes through the fused pair: the Pallas kernel in interpret mode on the
JAX side, K6's plain version here.  At these sizes every P tiles in the
reference (2048, 512, 128, 32), so both route the same convolutions.

Tolerances (the two sides sum in other orders): logits 1e-4; running
statistics 1e-5; three SGD-momentum steps of ``parallel.SPMDTrainer``
and one ``gluon.Trainer`` step: losses 1e-4 relative, weights 5e-5
absolute plus 1e-4 relative.

The JAX side is computed once per module (``reference``), hybridized.
"""
import os

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch import parallel as pparallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays
from mxnet_tpu_torch.ops import conv_fused as pconv

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=0)
WEIGHT_TOL = dict(rtol=1e-4, atol=5e-5)
NET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
           classes=10, thumbnail=True)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
STEPS = 3
# 1x1 stride-1 convolutions a step: v1 every conv3, stage 1's conv1 and
# its downsample; v2 every conv1 and conv3 and stage 1's downsample
K6_PER_STEP = {1: 6, 2: 9}
ENV = {"MXNET_FUSED_CONV_BWD": "1", "MXNET_FLASH_INTERPRET": "1"}


def _batch(seed=0):
    rs = onp.random.RandomState(seed)
    return (rs.rand(2, 3, 32, 32).astype(onp.float32),
            rs.randint(0, 10, (2,)).astype(onp.float32))


def _perturb(arrays, seed):
    rs = onp.random.RandomState(seed)
    out = {}
    for k, a in arrays.items():
        if k.endswith(("gamma", "running_var")):
            a = 1.0 + 0.2 * rs.rand(*a.shape)
        elif k.endswith(("beta", "bias", "running_mean")):
            a = 0.1 * rs.standard_normal(a.shape)
        out[k] = a.astype(onp.float32)
    return out


class _Spy:
    """Counts the calls of a module function while it is installed."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.orig = getattr(module, name)

    def __enter__(self):
        def spy(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _jax_net(version):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.vision import resnet

    mx.random.seed(0)
    cls = (resnet.ResNetV1, resnet.ResNetV2)[version - 1]
    block = (resnet.BottleneckV1, resnet.BottleneckV2)[version - 1]
    net = cls(block, NET["layers"], NET["channels"], classes=NET["classes"],
              thumbnail=True, layout="NHWC")
    net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                  magnitude=3))
    net.hybridize()                        # one program, not op by op
    net(mx.nd.array(_batch()[0]))          # materialize deferred shapes
    arrays = _perturb({k: p.data().asnumpy() for k, p in
                       net.collect_params().items()}, version)
    _set(net, arrays)
    return net, arrays


def _set(net, arrays):
    import mxnet_tpu as mx

    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))


def _arrays(net):
    return {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in net.collect_params().items()}


def _reference(version):
    """Everything the tests compare, computed once on the JAX side."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import autograd, gluon, parallel
    from mxnet_tpu.ops import conv_fused as jconv

    net, arrays = _jax_net(version)
    x, y = _batch()
    r = dict(prefix=net.prefix, arrays=arrays)
    r["eval"] = net(mx.nd.array(x)).asnumpy()
    with autograd.record():
        r["train"] = net(mx.nd.array(x)).asnumpy()
    r["after_forward"] = _arrays(net)
    _set(net, arrays)
    mesh = parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    tr = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", dict(OPT), mesh=mesh)
    r["losses"] = [tr.step(mx.nd.array(x), mx.nd.array(y)).asnumpy().item()
                   for _ in range(STEPS)]
    r["after_steps"] = _arrays(net)
    _set(net, arrays)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        L = loss(net(mx.nd.array(x)), mx.nd.array(y))
    with _Spy(jconv, "_conv1x1_bwd_pair") as spy:
        L.backward()
    r["k6_calls"] = spy.calls              # traced once: one a convolution
    tr.step(2)
    r["gluon_loss"] = L.asnumpy()
    r["after_gluon"] = _arrays(net)
    return r


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        yield {v: _reference(v) for v in (1, 2)}


@pytest.fixture(autouse=True)
def _fused_on(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def _port(version, arrays, layout="NHWC"):
    cls = (pvision.ResNetV1, pvision.ResNetV2)[version - 1]
    block = (pvision.BottleneckV1, pvision.BottleneckV2)[version - 1]
    net = cls(block, NET["layers"], NET["channels"], classes=NET["classes"],
              thumbnail=True, layout=layout, device="cpu")
    return load_mxnet_tpu_arrays(net, arrays)


def _assert_arrays(model, ref, prefix, tol=WEIGHT_TOL):
    got = arrays_from_port(model, prefix=prefix)
    assert sorted(got) == sorted(ref)
    for name in ref:
        t = STAT_TOL if "running" in name else tol
        onp.testing.assert_allclose(got[name], ref[name], err_msg=name, **t)


@pytest.mark.parametrize("version", [1, 2])
def test_logits_and_running_stats(reference, version):
    r = reference[version]
    model = _port(version, r["arrays"])
    x = torch.as_tensor(_batch()[0])
    model.eval()
    with torch.no_grad():
        onp.testing.assert_allclose(model(x).numpy(), r["eval"],
                                    **LOGIT_TOL)
    model.train()
    with torch.no_grad():
        onp.testing.assert_allclose(model(x).numpy(), r["train"],
                                    **LOGIT_TOL)
    # one training forward committed the moving statistics
    _assert_arrays(model, r["after_forward"], r["prefix"], STAT_TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_spmd_trainer_steps(reference, version):
    r = reference[version]
    model = _port(version, r["arrays"])
    x, y = _batch()
    tr = pparallel.SPMDTrainer(model, pgluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", dict(OPT))
    launches = pconv.conv1x1_bwd_pair.launches
    with _Spy(pconv, "conv1x1_bwd_pair") as spy:
        got = [float(tr.step(x, y)) for _ in range(STEPS)]
    assert spy.calls == STEPS * K6_PER_STEP[version]
    # CPU tensors take the plain version: no kernel launch is counted
    assert pconv.conv1x1_bwd_pair.launches == launches
    onp.testing.assert_allclose(got, r["losses"], **LOSS_TOL)
    assert got[-1] < got[0]
    # the running statistics are neither trained nor decayed
    n_train = sum(1 for p in model.parameters() if p.requires_grad)
    assert len(tr._params) == n_train
    assert not any("running" in n for n, p in model.named_parameters()
                   if p.requires_grad)
    _assert_arrays(model, r["after_steps"], r["prefix"])


@pytest.mark.parametrize("version", [1, 2])
def test_gluon_trainer_step(reference, version):
    r = reference[version]
    model = _port(version, r["arrays"])
    x, y = (torch.as_tensor(a) for a in _batch())
    tr = pgluon.Trainer(model, "sgd", dict(OPT))
    L = pgluon.loss.SoftmaxCrossEntropyLoss()(model(x), y)
    with _Spy(pconv, "conv1x1_bwd_pair") as spy:
        L.backward(torch.ones_like(L))
    # the port calls the pair as often as the reference calls its kernel
    assert spy.calls == r["k6_calls"] == K6_PER_STEP[version]
    tr.step(2)
    onp.testing.assert_allclose(L.detach().numpy(), r["gluon_loss"],
                                **LOSS_TOL)
    _assert_arrays(model, r["after_gluon"], r["prefix"])


@pytest.mark.parametrize("version", [1, 2])
def test_nhwc_equals_nchw(reference, version):
    """The same OIHW parameters give the same logits (2e-5) and
    gradients in both layouts (one transpose at the stem).  The
    gradients of ``sum(logits^2)`` reach magnitudes of ~8, and the
    layouts sum the convolutions in other orders: 1e-4."""
    arrays = reference[version]["arrays"]
    x = torch.as_tensor(_batch()[0])
    outs, grads = {}, {}
    for layout in ("NCHW", "NHWC"):
        model = _port(version, arrays, layout)
        out = model(x)
        outs[layout] = out.detach().numpy()
        out.square().sum().backward()
        grads[layout] = [p.grad.numpy() for p in model.parameters()
                         if p.requires_grad]
    onp.testing.assert_allclose(outs["NHWC"], outs["NCHW"], rtol=2e-5,
                                atol=2e-5)
    for a, b in zip(grads["NHWC"], grads["NCHW"]):
        onp.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_arrays_round_trip(reference):
    """``arrays_from_port`` names every parameter as the reference does,
    and carrying the arrays back reproduces them."""
    r = reference[1]
    model = _port(1, r["arrays"])
    got = arrays_from_port(model, prefix=r["prefix"])
    assert sorted(got) == sorted(r["arrays"])
    twin = _port(1, got)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(MXNetError, match="no port parameter"):
        _port(1, {**got, "resnetv10_stage9_conv2d0_weight": onp.zeros(1)})


def test_resnet50_names_and_size():
    """``get_resnet(1, 50)`` has the reference's 299 parameters (25.6 M
    trainable) under the reference's names, and ``get_model`` builds the
    ResNet presets only."""
    from mxnet_tpu_torch.models import convert

    net = pvision.get_resnet(1, 50, classes=1000, layout="NHWC",
                             device="cpu")
    names = convert._gluon_names(net)
    assert len(names) == 299
    assert {"conv2d0_weight", "stage1_conv2d0_bias",
            "stage3_batchnorm7_running_var", "dense0_weight"} <= \
        set(names.values())
    assert sum(p.numel() for p in net.parameters() if p.requires_grad) \
        == 25575912
    assert isinstance(pvision.get_model("resnet18_v2", classes=4,
                                        device="cpu"), pvision.ResNetV2)
    for bad in ("vgg16", "resnet9000"):
        with pytest.raises(MXNetError):
            pvision.get_model(bad)
    with pytest.raises(MXNetError, match="model store"):
        pvision.get_resnet(1, 18, pretrained=True, device="cpu")
    with pytest.raises(MXNetError, match="deferred"):
        pgluon.nn.Conv2D(8, 3, device="cpu")
