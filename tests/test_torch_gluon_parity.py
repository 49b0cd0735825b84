"""The port's Gluon parameter layer against the JAX package's, float32 on
the CPU.

Two nets, built the same way in both packages from inputs made with
numpy from a seed: the headline MLP (``Dense(32, activation="relu")``,
``Dense(10)``, ``in_units`` deferred) and a narrow bottleneck ResNet
(``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
classes=10, thumbnail=True)``, its BatchNorms and 1x1 convolutions
deferred, as the reference builds them) at 2 x 3 x 32 x 32.

The reference's weights reach the port through the reference's
``save_parameters`` and the port's ``load_parameters`` (the port's
deferred parameters take the file's shapes), and every array is equal
bit for bit; then the port's ``save_parameters`` into a fresh reference
net, bit for bit again.  Compared, each within 1e-4 of the array's
largest magnitude (the two packages sum the products and convolutions
in other orders): the forward output, the loss, every parameter's
gradient by structural name (``features.1.0.body.0.weight``), and the
parameters and running statistics after 3 ``Trainer`` SGD steps
(lr 0.01, momentum 0.9, wd 1e-4).  The biases of the bottleneck's 1x1
convolutions feed a BatchNorm, which subtracts the batch mean, so their
gradient is zero in exact arithmetic and what either side computes is
summation noise (~1e-6): those gradients, and those biases after the
steps, are held to 1e-4 of the largest magnitude among all the net's
gradients (parameters) instead.  ``collect_params()`` keys equal the
reference's once the model's counter is stripped.  A ``resnet50_v1``
``.params`` file carries both ways, every array equal.

The reference's ResNet is hybridized (one program, not op by op).

At lr 0.1 the batch of 2 is fit in one step (loss 3.78 -> 0.39), and the
reference's second-step gradients of stage 3 then depart from the port's
by more than 10% of their magnitude, while the weights and the loss
agree to 1e-5; the port's float32 step there agrees with its own
float64 step (``test_port_step_agrees_with_float64_at_lr_0_1``), so the
departure is the reference's (ROADMAP section 3), and the comparison
runs at lr 0.01.
"""
import re

import numpy as onp
import pytest

import mxnet_tpu_torch as pmx

TOL = 1e-4                        # of each array's largest magnitude
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
STEPS = 3
CPU = pmx.cpu()
RESNET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
              classes=10, thumbnail=True)


def _batch(kind, dtype="float32"):
    rs = onp.random.RandomState(11)
    if kind == "mlp":
        return (rs.rand(8, 20).astype(dtype),
                rs.randint(0, 10, 8).astype(dtype))
    return (rs.rand(2, 3, 32, 32).astype(dtype),
            rs.randint(0, 10, 2).astype(dtype))


def _unnumbered(keys):
    """Flat names with the model's counter stripped (``dense3_weight`` ->
    ``dense_weight``; the same cut on both sides)."""
    return [re.sub(r"^([a-z]+?)\d+_", r"\1_", k) for k in keys]


# biases whose gradient is zero in exact arithmetic (a BatchNorm follows)
_NOISE = re.compile(r"body\.[06]\.bias$")


def _close_all(got, ref, what):
    assert sorted(got) == sorted(ref), what
    net_scale = max(float(onp.abs(a).max()) for a in ref.values())
    for k in ref:
        _close(got[k], ref[k], f"{what} {k}",
               net_scale if _NOISE.search(k) else None)


def _close(got, ref, what, scale=None):
    got, ref = onp.asarray(got, onp.float32), onp.asarray(ref, onp.float32)
    assert got.shape == ref.shape, what
    if scale is None:
        scale = max(float(onp.abs(ref).max()), 1e-6)
    err = float(onp.abs(got - ref).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _build(pkg, kind):
    """The net of ``kind`` in ``pkg`` (the ``mxnet_tpu`` or the
    ``mxnet_tpu_torch`` module)."""
    nn = pkg.gluon.nn
    if kind == "mlp":
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"), nn.Dense(10))
        return net
    resnet = pkg.gluon.model_zoo.vision.resnet
    return resnet.ResNetV1(resnet.BottleneckV1, RESNET["layers"],
                           RESNET["channels"], classes=RESNET["classes"],
                           thumbnail=True)


def _by_structure(net, grads=False):
    return {k: (p.grad() if grads else p.data()).asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()
            if not grads or p.grad_req != "null"}


def _run(pkg, net, kind, opt=OPT, dtype="float32"):
    """Forward, loss and gradients on the batch, then 3 SGD steps."""
    mx, gluon, autograd = pkg, pkg.gluon, pkg.autograd
    ctx = dict(ctx=mx.cpu()) if pkg is pmx else {}
    x, y = (mx.nd.array(a, dtype=str(a.dtype), **ctx)
            for a in _batch(kind, dtype))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    r = {"out": net(x).asnumpy()}
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    for step in range(STEPS):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if step == 0:
            r["loss"] = loss.asnumpy()
            r["grads"] = _by_structure(net, grads=True)
        if step == 1:
            r["grads_2"] = _by_structure(net, grads=True)
        trainer.step(x.shape[0])
    r["after"] = _by_structure(net)
    r["after_loss"] = loss.asnumpy()
    return r


def _reference(kind, tmp):
    import mxnet_tpu as mx

    mx.random.seed(0)
    net = _build(mx, kind)
    net.initialize(mx.init.Xavier(rnd_type="uniform", factor_type="avg",
                                  magnitude=3))
    if kind == "resnet":
        net.hybridize()
    net(mx.nd.array(_batch(kind)[0]))          # infer the deferred shapes
    f = str(tmp / f"{kind}_ref.params")
    net.save_parameters(f)
    r = dict(file=f, names=list(net.collect_params()),
             arrays=_by_structure(net))
    r.update(_run(mx, net, kind))
    return r


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gluon_parity")
    return {kind: _reference(kind, tmp) for kind in ("mlp", "resnet")}


def _port(kind, ref):
    with CPU:
        net = _build(pmx, kind)
    net.load_parameters(ref["file"], ctx=CPU)
    return net


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_params_carry_both_ways_bit_for_bit(reference, kind, tmp_path):
    import mxnet_tpu as mx

    ref = reference[kind]
    net = _port(kind, ref)
    got = _by_structure(net)
    assert sorted(got) == sorted(ref["arrays"])
    for k, a in ref["arrays"].items():
        onp.testing.assert_array_equal(got[k], a, err_msg=k)
    assert _unnumbered(net.collect_params()) == _unnumbered(ref["names"])
    f = str(tmp_path / "port.params")
    net.save_parameters(f)
    back = _build(mx, kind)
    back.load_parameters(f)
    for k, a in _by_structure(back).items():
        onp.testing.assert_array_equal(a, got[k], err_msg=k)


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_forward_gradients_and_sgd_steps_match(reference, kind):
    ref = reference[kind]
    got = _run(pmx, _port(kind, ref), kind)
    _close(got["out"], ref["out"], "forward")
    _close(got["loss"], ref["loss"], "loss")
    _close_all(got["grads"], ref["grads"], "grad")
    _close_all(got["after"], ref["after"], f"after {STEPS} steps")
    if kind == "resnet":       # the running statistics moved, and agree
        k = "features.1.0.body.1.running_mean"
        assert onp.abs(got["after"][k]).max() > 0


def test_port_step_agrees_with_float64_at_lr_0_1(reference):
    """At lr 0.1 the port's second-step gradients in float32 agree with
    the same net's in float64, within the tolerance above."""
    fast = dict(OPT, learning_rate=0.1)
    got = {}
    for dtype in ("float32", "float64"):
        net = _port("resnet", reference["resnet"])
        net.cast(dtype)
        got[dtype] = _run(pmx, net, "resnet", fast, dtype)
    assert got["float32"]["loss"][0] > 3 * got["float32"]["after_loss"][0]
    _close_all(got["float32"]["grads_2"], got["float64"]["grads_2"],
               "second-step grad")


_REF64 = """
import sys
import numpy as onp
import jax
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[1])
import test_torch_gluon_parity as t
import mxnet_tpu as mx

mx.random.seed(0)        # the root key made here, not inside a trace
net = t._build(mx, "resnet")
net.load_parameters(sys.argv[2])
net.hybridize()
net.cast("float64")
r = t._run(mx, net, "resnet", dict(t.OPT, learning_rate=0.1), "float64")
onp.savez(sys.argv[3], **r["grads_2"])
"""


def test_port_step_agrees_with_reference_float64_at_lr_0_1(reference,
                                                           tmp_path):
    """At lr 0.1 the port's second-step gradients in float32 agree with
    the reference's in float64 (``jax_enable_x64``, which a subprocess
    keeps from this worker's other tests), within the tolerance above:
    the departure at lr 0.1 is the reference's float32 one-pass variance
    (ROADMAP section 3), not the port's."""
    import os
    import pathlib
    import subprocess
    import sys

    out = tmp_path / "ref64.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _REF64, str(pathlib.Path(__file__).parent),
         reference["resnet"]["file"], str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref64 = dict(onp.load(out))
    got = _run(pmx, _port("resnet", reference["resnet"]), "resnet",
               dict(OPT, learning_rate=0.1))
    _close_all(got["grads_2"], ref64, "second-step grad against float64")


def test_resnet50_params_file_carries_both_ways(tmp_path):
    """A full-width ``resnet50_v1`` file: the port's weights into the
    reference (its deferred parameters take the file's shapes) and back
    into a deferred port net, every array equal."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    net = get_model("resnet50_v1", classes=1000, device="cpu")
    net.initialize(pmx.init.Xavier(magnitude=3), seed=0)
    f = str(tmp_path / "r50.params")
    net.save_parameters(f)
    mine = _by_structure(net)
    ref = mx.gluon.model_zoo.vision.get_model("resnet50_v1", classes=1000)
    ref.load_parameters(f)
    f2 = str(tmp_path / "r50_ref.params")
    ref.save_parameters(f2)
    with CPU:
        back = get_model("resnet50_v1", classes=1000)
    back.load_parameters(f2, ctx=CPU)
    theirs, again = _by_structure(ref), _by_structure(back)
    assert len(mine) == len(theirs) == len(again) == 299
    for k, a in mine.items():
        onp.testing.assert_array_equal(theirs[k], a, err_msg=k)
        onp.testing.assert_array_equal(again[k], a, err_msg=k)
    assert _unnumbered(back.collect_params()) == \
        _unnumbered(ref.collect_params())


def test_headline_loop_names_match_reference():
    import mxnet_tpu as mx

    nets = [_build(pkg, "mlp") for pkg in (mx, pmx)]
    keys = [list(n.collect_params()) for n in nets]
    assert _unnumbered(keys[0]) == _unnumbered(keys[1]) == [
        "dense_weight", "dense_bias", "dense_weight", "dense_bias"]
