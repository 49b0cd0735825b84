"""The port's model zoo (``mxnet_tpu_torch.gluon.model_zoo.vision``)
against ``mxnet_tpu``'s.

- Every one of the reference's 34 ``get_model`` names builds, with the
  reference's parameter names below ``net.prefix``, in its order.
- One member of each family (AlexNet, VGG, SqueezeNet, DenseNet,
  Inception, MobileNet v1 and v2) matches the reference in f32 on the
  CPU.  The weights are drawn in the port (Xavier, seeded), read out by
  the reference's names with ``models.arrays_from_port``, given to the
  reference (its parameter shapes set, then ``init.Load``: no deferred
  pass, so its hybridized net compiles once a mode) and to a second port
  net with ``models.load_mxnet_tpu_arrays``.  Parameter shapes equal; the
  logits of an inference forward within 1e-5 of their largest
  magnitude; after one SGD step (lr 0.1) recorded with
  ``train_mode=False`` every parameter within 1e-5 of the largest
  magnitude among the net's parameters (running statistics included:
  the variances are near 1), as the logits are held.  The step
  runs BatchNorm on its running statistics (and no dropout): at these
  sizes the batch-statistics path is ill-conditioned (a channel of 2-64
  values), and the reference's own eager and compiled steps differ by up
  to 17 % on Inception-v3 at 299², batch 2; the ResNet tests hold the
  batch-statistics backward.  Each runs at the smallest input it admits:
  32² where the net allows it, AlexNet at 64² (its third pool needs a 3
  x 3 map), Inception-v3 at 299² with batch 1.  DenseNet runs its class
  at narrow widths (16 initial features, growth 8, two layers a block),
  the published members only in the name test and on the card.
- SqueezeNet's ceil-mode pools leave a 13 x 13 map at 224², and
  Inception-v3 an 8 x 8 map before its ``AvgPool2D(8)`` at 299².
- ``cuda``-marked: a small member of each family on the card against
  the CPU (TF32 off; the logits within 1e-4 of their largest magnitude).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

rmx = LazyReference()     # the JAX package, imported at first use

TOL = 1e-5
CLASSES = 10
# (name, input side, batch): one member of each family at its least size
FAMILIES = [("alexnet", 64, 2), ("vgg11_bn", 32, 2),
            ("squeezenet1.1", 32, 2), ("densenet_small", 32, 2),
            ("inceptionv3", 299, 1), ("mobilenet0.25", 32, 2),
            ("mobilenetv2_0.25", 32, 2)]
NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
         "densenet121", "densenet161", "densenet169", "densenet201",
         "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
         "mobilenet0.75", "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
         "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25"]


def _below_prefix(net):
    """Parameter names below ``net.prefix``, in ``collect_params`` order:
    the counter in the prefix moves with every net built in the process,
    the rest does not."""
    cut = len(net.prefix)
    return [k[cut:] for k in net.collect_params().keys()]


@pytest.mark.parametrize("name", NAMES)
def test_every_name_builds_with_the_reference_names(name):
    from mxnet_tpu.gluon.model_zoo.vision import get_model as rget

    ref = rget(name, classes=CLASSES)
    with mx.cpu():
        port = pvision.get_model(name, classes=CLASSES)
    assert type(port).__name__ == type(ref).__name__
    assert _below_prefix(port) == _below_prefix(ref)
    assert port.prefix[:-1].rstrip("0123456789") == \
        ref.prefix[:-1].rstrip("0123456789")


def test_arrays_from_port_are_copies():
    """``models.arrays_from_port`` hands out copies: an update of the net
    afterwards leaves them as they were."""
    with mx.cpu():
        net = pvision.get_model("squeezenet1.1", classes=CLASSES)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    before = arrays_from_port(net, prefix=net.prefix)
    k = net.prefix + "conv2d0_weight"
    w = net.collect_params()[k]
    with mx.cpu():
        w.set_data(w.data() + 1.0)
    got = arrays_from_port(net, prefix=net.prefix)
    assert onp.array_equal(got[k], before[k] + 1.0)


def test_unknown_name_and_pretrained_raise():
    with mx.cpu():
        with pytest.raises(mx.base.MXNetError, match="unknown model"):
            pvision.get_model("vgg12")
        with pytest.raises(mx.base.MXNetError, match="model store"):
            pvision.get_model("densenet121", pretrained=True)
        with pytest.raises(mx.base.MXNetError, match="invalid vgg"):
            pvision.get_vgg(12)


def _walk(block):
    yield block
    for child in block._children.values():
        yield from _walk(child)


def _no_dropout(net):
    for b in _walk(net):
        if type(b).__name__ == "Dropout":
            b._rate = 0.0


def _batch(side, batch, seed=0):
    rs = onp.random.RandomState(seed)
    x = rs.standard_normal((batch, 3, side, side)).astype(onp.float32)
    y = rs.randint(0, CLASSES, batch).astype(onp.float32)
    return x, y


def _arrays(net):
    return {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in net.collect_params().items()}


def _build(pkg, name):
    if name == "densenet_small":
        return pkg.gluon.model_zoo.vision.DenseNet(16, 8, [2, 2, 2, 2],
                                                   classes=CLASSES)
    return pkg.gluon.model_zoo.vision.get_model(name, classes=CLASSES)


def _reference(name, arrays_of, x, y):
    """The reference net holding the port's weights (``arrays_of(prefix)``
    gives them by the reference's names): its logits, then its
    parameters after one SGD step."""
    from mxnet_tpu import autograd, gluon

    rmx.random.seed(0)      # before any jit: the root key is made eagerly
    net = _build(rmx, name)
    arrays = arrays_of(net.prefix)
    for k, p in net.collect_params().items():
        p.shape = arrays[k].shape
    net.initialize(rmx.init.Load(arrays))
    net.hybridize()
    logits = net(rmx.nd.array(x)).asnumpy()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record(train_mode=False):
        L = loss(net(rmx.nd.array(x)), rmx.nd.array(y))
    L.backward()
    tr.step(x.shape[0])
    return net.prefix, arrays, logits, _arrays(net)


def _close(got, ref, what, floor=0.0):
    scale = float(onp.abs(ref).max())
    err = float(onp.abs(got - ref).max())
    assert err <= max(TOL * scale, floor), f"{what}: {err} vs {scale}"


@pytest.mark.parametrize("name,side,batch", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_matches_the_reference(name, side, batch):
    x, y = _batch(side, batch)
    with mx.cpu():
        src = _build(mx, name)
        src.initialize(mx.init.Xavier(), ctx=mx.cpu(), seed=0)
        src(mx.nd.array(x))                 # the deferred shapes
    prefix, arrays, logits, after = _reference(
        name, lambda p: arrays_from_port(src, prefix=p), x, y)
    with mx.cpu():
        net = _build(mx, name)
        load_mxnet_tpu_arrays(net, arrays)
        got = arrays_from_port(net, prefix=prefix)
        assert sorted(got) == sorted(arrays)
        for k in arrays:
            assert got[k].shape == arrays[k].shape, k
        _close(net(mx.nd.array(x)).asnumpy(), logits, "logits")
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record(train_mode=False):
            L = loss(net(mx.nd.array(x)), mx.nd.array(y))
        L.backward()
        tr.step(batch)
    got = arrays_from_port(net, prefix=prefix)
    scale = max(float(onp.abs(a).max()) for a in after.values())
    for k in after:
        _close(got[k], after[k], k, floor=TOL * scale)


def test_relu6_gradient_at_its_bounds_is_the_reference():
    """``F.clip`` (MobileNet's ``_ReLU6``) hands half the gradient to an
    element at a bound, as ``jnp.clip`` does; a channel that is exactly
    zero meets the lower bound."""
    x = onp.array([[-1.0, 0.0, 3.0, 6.0, 7.0, 0.0]], onp.float32)
    grads = []
    for pkg, ctx in ((rmx, None), (mx, mx.cpu())):
        a = pkg.nd.array(x) if ctx is None else pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.clip(a, a_min=0.0, a_max=6.0) * 3.0
        y.backward()
        grads.append(a.grad.asnumpy())
    assert onp.array_equal(grads[1], grads[0])
    assert onp.array_equal(grads[1][0], [0, 1.5, 3, 1.5, 0, 1.5])


@pytest.mark.parametrize("name,side,shape", [
    ("squeezenet1.1", 224, (1, 512, 13, 13)),
    ("squeezenet1.0", 224, (1, 512, 13, 13)),
    ("inceptionv3", 299, (1, 2048, 8, 8))])
def test_feature_map_sizes(name, side, shape):
    """The ceil-mode pools and Inception's stem as the reference sizes
    them: the map before the classifier (SqueezeNet) or before
    ``AvgPool2D(8)`` (Inception-v3)."""
    with mx.cpu():
        net = pvision.get_model(name, classes=CLASSES)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        stop = -1 if name.startswith("squeeze") else -2
        x = mx.nd.array(onp.zeros((1, 3, side, side), onp.float32))
        assert net.features[:stop](x).shape == shape


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("name,side,batch", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_on_card_equals_cpu(name, side, batch):
    need_cuda()
    with mx.cpu():
        cpu = _build(mx, name)
        cpu.initialize(mx.init.Xavier(), ctx=mx.cpu(), seed=0)
        x, _ = _batch(side, batch)
        want = cpu(mx.nd.array(x)).asnumpy()
    card = _build(mx, name)
    load_mxnet_tpu_arrays(card, arrays_from_port(cpu, prefix=card.prefix))
    got = card(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    scale = float(onp.abs(want).max())
    assert float(onp.abs(got - want).max()) <= 1e-4 * scale
    assert next(iter(card.collect_params().values())).data().context == \
        mx.gpu(0)
    torch.cuda.synchronize()
