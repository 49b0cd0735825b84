"""The ``gluon.nn`` layers this slice ports, each against the reference's
layer of the same name, float32 on the CPU: the norms (``LayerNorm``,
``RMSNorm``, ``InstanceNorm``, ``GroupNorm``, ``SyncBatchNorm``),
``Embedding``, the activations (``LeakyReLU``, ``PReLU``, ``ELU``,
``SELU``, ``GELU``, ``Swish``), ``Lambda``/``HybridLambda``, the 1-D
and 3-D convolutions and pools, and the transposed convolutions.

Each layer is built with the same arguments in both packages, its sizes
left to the first forward where the reference defers them; the
reference's parameters (after that forward) reach the port by
``save_parameters``/``load_parameters``.  Compared within 1e-5
(relative and absolute): the deferred shapes, the forward output, the
input's gradient and every parameter's gradient under ``record()`` with
the same head gradient, and ``SyncBatchNorm``'s running statistics.
``ReflectionPad2D`` is held to ``numpy.pad(mode="reflect")``: the
reference's layer hands ``pad`` pairs, which its ``pad`` refuses.
"""
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = mx.cpu()

# (id, layer name, args, kwargs, input shape)
CASES = [
    ("LayerNorm", "LayerNorm", (), {}, (2, 3, 5)),
    ("LayerNorm_axis1", "LayerNorm", (), dict(axis=1, epsilon=1e-3),
     (2, 4, 3)),
    ("RMSNorm", "RMSNorm", (), {}, (3, 6)),
    ("InstanceNorm", "InstanceNorm", (), dict(scale=True), (2, 3, 4, 4)),
    ("GroupNorm", "GroupNorm", (), dict(num_groups=2), (2, 4, 3, 3)),
    ("SyncBatchNorm", "SyncBatchNorm", (), {}, (4, 3, 2, 2)),
    ("Embedding", "Embedding", (11, 5), {}, "tokens"),
    ("LeakyReLU", "LeakyReLU", (0.1,), {}, (2, 6)),
    ("PReLU", "PReLU", (), dict(in_channels=3), (2, 3, 4)),
    ("ELU", "ELU", (0.5,), {}, (2, 6)),
    ("SELU", "SELU", (), {}, (2, 6)),
    ("GELU_erf", "GELU", (), {}, (2, 6)),
    ("GELU_tanh", "GELU", (), dict(approximation="tanh"), (2, 6)),
    ("Swish", "Swish", (), {}, (2, 6)),
    ("Swish_beta", "Swish", (), dict(beta=2.0), (2, 6)),
    ("Lambda_name", "Lambda", ("tanh",), {}, (2, 6)),
    ("Lambda_fn", "Lambda", ("softrelu_fn",), {}, (2, 6)),
    ("HybridLambda_name", "HybridLambda", ("relu",), {}, (2, 6)),
    ("HybridLambda_fn", "HybridLambda", ("leaky_fn",), {}, (2, 6)),
    ("Conv1D", "Conv1D", (4, 3), dict(strides=2, padding=1), (2, 3, 9)),
    ("Conv1D_nwc_act", "Conv1D", (4, 3),
     dict(dilation=2, layout="NWC", activation="relu"), (2, 9, 3)),
    ("Conv3D", "Conv3D", (3, (2, 3, 2)), dict(padding=(1, 0, 1)),
     (1, 2, 4, 5, 4)),
    ("Conv3D_ndhwc_groups", "Conv3D", (4, 2),
     dict(groups=2, use_bias=False, layout="NDHWC"), (1, 4, 4, 4, 4)),
    ("Conv1DTranspose", "Conv1DTranspose", (4, 3),
     dict(strides=2, output_padding=1), (2, 3, 5)),
    ("Conv2DTranspose", "Conv2DTranspose", (2, (3, 2)),
     dict(strides=(2, 1), padding=(1, 0)), (1, 3, 4, 5)),
    ("Conv3DTranspose", "Conv3DTranspose", (2, 2),
     dict(strides=2, use_bias=False), (1, 3, 2, 3, 2)),
    ("MaxPool1D", "MaxPool1D", (3,), dict(strides=2, padding=1), (2, 3, 9)),
    ("AvgPool1D_ceil", "AvgPool1D", (3,),
     dict(strides=2, ceil_mode=True, count_include_pad=False), (2, 3, 8)),
    ("MaxPool3D", "MaxPool3D", (), {}, (1, 2, 4, 4, 6)),
    ("AvgPool3D", "AvgPool3D", ((2, 3, 2),), dict(padding=1),
     (1, 2, 4, 5, 4)),
    ("GlobalMaxPool1D", "GlobalMaxPool1D", (), {}, (2, 3, 7)),
    ("GlobalAvgPool1D", "GlobalAvgPool1D", (), {}, (2, 3, 7)),
    ("GlobalMaxPool3D", "GlobalMaxPool3D", (), {}, (1, 2, 3, 4, 2)),
    ("GlobalAvgPool3D", "GlobalAvgPool3D", (), {}, (1, 2, 3, 4, 2)),
]


def _functions(pkg):
    return {"softrelu_fn": lambda x: pkg.nd.Activation(x,
                                                       act_type="softrelu"),
            "leaky_fn": lambda F, x: F.LeakyReLU(x, slope=0.2)}


def _layer(pkg, name, args, kwargs):
    fns = _functions(pkg)
    args = tuple(fns.get(a, a) if isinstance(a, str) else a for a in args)
    return getattr(pkg.gluon.nn, name)(*args, **kwargs)


def _input(cid, shape):
    rs = onp.random.RandomState(sum(map(ord, cid)))
    if shape == "tokens":
        return rs.randint(0, 11, (3, 4)).astype(onp.float32)
    return rs.standard_normal(shape).astype(onp.float32)


def _run(pkg, net, x, head):
    a = pkg.nd.array(x)
    a.attach_grad()
    with pkg.autograd.record():
        out = net(a)
    out.backward(pkg.nd.array(head))
    named = net._collect_params_with_prefix()
    return dict(out=out.asnumpy(), dx=a.grad.asnumpy(),
                grads={k: p.grad().asnumpy() for k, p in named.items()
                       if p.grad_req != "null"},
                data={k: p.data().asnumpy() for k, p in named.items()},
                shapes={k: tuple(p.shape) for k, p in named.items()})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(case, tmp_path):
    cid, name, args, kwargs, shape = case
    x = _input(cid, shape)
    rmx.random.seed(0)
    ref = _layer(rmx, name, args, kwargs)
    ref.initialize(rmx.init.Uniform(0.5))
    out = ref(rmx.nd.array(x))              # the deferred shapes
    f = str(tmp_path / "layer.params")
    ref.save_parameters(f)
    with CPU:
        port = _layer(mx, name, args, kwargs)
    port.load_parameters(f, ctx=CPU)
    head = onp.random.RandomState(3).standard_normal(out.shape).astype(
        onp.float32)
    want = _run(rmx, ref, x, head)
    with CPU:
        got = _run(mx, port, x, head)
    assert got["shapes"] == want["shapes"]
    assert got["out"].shape == want["out"].shape
    onp.testing.assert_allclose(got["out"], want["out"], **TOL)
    if shape != "tokens":
        onp.testing.assert_allclose(got["dx"], want["dx"], **TOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k in want["grads"]:
        onp.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                    **TOL, err_msg=k)
    for k in want["data"]:          # SyncBatchNorm's running statistics
        onp.testing.assert_allclose(got["data"][k], want["data"][k], **TOL,
                                    err_msg=k)


@pytest.mark.parametrize("layer,args", [("LayerNorm", ()),
                                        ("Conv1DTranspose", (4, 3)),
                                        ("Conv3D", (2, 3))])
def test_deferred_shapes_wait_for_the_first_forward(layer, args):
    shape = {"LayerNorm": (2, 5), "Conv1DTranspose": (1, 6, 4),
             "Conv3D": (1, 3, 4, 4, 4)}[layer]
    with CPU:
        net = getattr(mx.gluon.nn, layer)(*args)
        net.initialize(ctx=CPU)
        assert any(p._data is None for p in net.collect_params().values())
        net(mx.nd.ones(shape))
    ref = getattr(rmx.gluon.nn, layer)(*args)
    ref.initialize()
    ref(rmx.nd.ones(shape))
    got = sorted(tuple(p.shape) for p in net.collect_params().values())
    want = sorted(tuple(p.shape) for p in ref.collect_params().values())
    assert got == want


def test_reflection_pad_matches_numpy():
    x = onp.arange(2 * 3 * 4 * 5, dtype=onp.float32).reshape(2, 3, 4, 5)
    with CPU:
        a = mx.nd.array(x)
        a.attach_grad()
        with mx.autograd.record():
            out = mx.gluon.nn.ReflectionPad2D(2)(a)
        out.backward()
        wide = mx.gluon.nn.ReflectionPad2D((0, 0, 0, 0, 1, 2, 3, 0))(
            mx.nd.array(x)).asnumpy()
    want = onp.pad(x, ((0, 0), (0, 0), (2, 2), (2, 2)), mode="reflect")
    onp.testing.assert_array_equal(out.asnumpy(), want)
    onp.testing.assert_array_equal(
        wide, onp.pad(x, ((0, 0), (0, 0), (1, 2), (3, 0)), mode="reflect"))
    # each input element's gradient counts the copies of it the pad made
    counts = onp.pad(onp.ones_like(x), ((0, 0), (0, 0), (2, 2), (2, 2)))
    assert a.grad.asnumpy().sum() == want.size
    assert counts.sum() == x.size
