"""The port's symbolic surface (``mxnet_tpu_torch.symbol``,
``HybridBlock.export``, ``SymbolBlock``, ``mx.name``, ``mx.viz``, the
``Predictor``, ``amp.convert_model``) against ``mxnet_tpu``'s, in f32 on
the CPU.

Graphs: ``tests/test_symbol.py::_mlp``'s (built by the builders), and
exported nets: two ``gluon.nn.Dense``, ``tests/_torch_hybrid_models.
bottleneck_stage`` (16 channels, NHWC), a 2-layer, 32-wide ``gpt``, the
model zoo's ResNet v1 (thumbnail, NHWC) and a 2-layer ``gluon.rnn.LSTM``
under a ``Dense`` (files and logits only: its zero states are constants
of the graph), each built in both
packages inside a fresh name scope (so their parameters have the same
names), the reference's weights carried into the port by name, and the
node counters of both packages cleared before each export (node names
then match).  Held:

- listing, ``infer_shape``, ``infer_shape_partial`` and ``infer_type``
  equal exactly; an ``Executor``'s outputs and gradients within 1e-5 of
  the largest magnitude;
- files in both directions: each package's export equal to the other's
  node for node (ops, names, attributes, inputs), heads and argument
  nodes equal, the ``.params`` keys equal, and the other package's
  ``SymbolBlock.imports`` of it giving logits within 1e-5;
- in the port alone: a ``SymbolBlock``'s two SGD steps bit for bit with
  its source block's, a hybridized ``SymbolBlock`` and its second
  export, a captured random op, the capture refusing an op outside the
  registry, the hook's count of active captures, export refusing a
  block whose forward runs outside the registry, the input signature
  kept for the outermost call only, and every layer marked
  ``_capture_runs = "hybrid_forward"`` giving the same outputs,
  gradients and running statistics bit for bit through either forward;
- ``mx.name``/``mx.AttrScope``, ``print_summary``'s totals (a tied
  weight counts once in the port), the ``Predictor`` and its
  self-contained file, ``amp.convert_model``;
- ``cuda``-marked: a CPU export imported on the card (logits within 1e-5
  of the CPU's, TF32 off), hybridized (one captured graph, replays equal
  to the eager forward bit for bit) and a ``Predictor`` replaying it.
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_hybrid_models import bottleneck_stage, gpt
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.symbol import symbol as psym

rmx = LazyReference()     # the JAX package, imported at first use

CPU = mx.cpu()
TOL = 1e-5


def _close(a, b, tol=TOL):
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    scale = max(onp.abs(b).max(), 1e-30)
    assert a.shape == b.shape
    assert onp.abs(a - b).max() <= tol * scale, onp.abs(a - b).max() / scale


def _mlp(pkg):
    s = pkg.sym if pkg is mx else pkg.symbol
    fc = s.FullyConnected(s.var("data"), s.var("w1"), s.var("b1"),
                          num_hidden=4, name="fc1")
    return s.Activation(fc, act_type="relu", name="relu1")


def _dense(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"),
            pkg.gluon.nn.Dense(10))
    return net


def _inputs(case):
    rs = onp.random.RandomState(11)
    if case == "mlp":
        return [rs.rand(3, 20).astype(onp.float32)], ["data"]
    if case == "stage":
        return [rs.rand(2, 8, 8, 8).astype(onp.float32)], ["data"]
    if case == "resnet":
        return [rs.rand(2, 3, 16, 16).astype(onp.float32)], ["data"]
    if case == "lstm":
        return [rs.rand(5, 2, 8).astype(onp.float32)], ["data"]
    tok = rs.randint(0, 50, (2, 8)).astype(onp.int32)
    pos = onp.tile(onp.arange(8, dtype=onp.int32), (2, 1))
    return [tok, pos], ["data0", "data1"]


def _resnet(pkg):
    """The model zoo's ResNet v1 (thumbnail, NHWC): the port's
    tensor-level layers, which run their hybrid_forward under a capture."""
    r = pkg.gluon.model_zoo.vision.resnet
    return r.ResNetV1(r.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                      classes=10, thumbnail=True, layout="NHWC")


def _lstm(pkg):
    """A 2-layer LSTM (TNC, zero states) under a Dense: the port's fused
    RNN layer, which runs its hybrid_forward under a capture."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.rnn.LSTM(16, num_layers=2),
            pkg.gluon.nn.Dense(10, flatten=False))
    return net


MAKE = {"mlp": _dense,
        "stage": lambda pkg: bottleneck_stage(pkg, channels=16,
                                              in_channels=8),
        "gpt": lambda pkg: gpt(pkg, 50, 32, 2, 4, 16),
        "resnet": _resnet,
        "lstm": _lstm}
CASES = list(MAKE)


def _scoped(pkg, make):
    """``make(pkg)`` inside a fresh name scope: the same parameter names
    in both packages whatever was built before."""
    outer = pkg.gluon.nn.HybridSequential(prefix="m_")
    with outer.name_scope():
        return make(pkg)


def _clear_node_names():
    from mxnet_tpu.symbol import symbol as rsym

    rsym._name_counter.clear()
    psym._name_counter.clear()


class _Pair:
    """One case built in both packages, the reference's weights in the
    port, both exported."""

    def __init__(self, case, d):
        self.case = case
        xs, self.in_names = _inputs(case)
        self.xs = xs
        rnet = _scoped(rmx, MAKE[case])
        rnet.initialize(rmx.init.Xavier())
        rnet(*[rmx.nd.array(x, dtype=x.dtype) for x in xs])
        with CPU:
            pnet = _scoped(mx, MAKE[case])
        pnet.initialize(mx.init.Xavier(), ctx=CPU)
        pnet(*self.px())
        rp, pp = rnet.collect_params(), pnet.collect_params()
        assert list(rp.keys()) == list(pp.keys())
        for name, p in pp.items():
            p.set_data(mx.nd.array(rp[name].data().asnumpy(), ctx=CPU))
        self.rnet, self.pnet = rnet, pnet
        self.rprefix, self.pprefix = str(d / f"{case}_r"), str(d / f"{case}_p")
        _clear_node_names()
        self.rsym = rnet.export(self.rprefix)
        _clear_node_names()
        self.psym = pnet.export(self.pprefix)

    def px(self):
        return [mx.nd.array(x, ctx=CPU, dtype=x.dtype) for x in self.xs]

    def rx(self):
        return [rmx.nd.array(x, dtype=x.dtype) for x in self.xs]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("exports")
    return {case: _Pair(case, d) for case in CASES}


# --------------------------------------------------------------------------- #
# composition, listing and inference
# --------------------------------------------------------------------------- #

def _graphs(pairs, case):
    if case == "_mlp":
        return _mlp(rmx), _mlp(mx)
    return pairs[case].rsym, pairs[case].psym


def _types(infer):
    try:
        args, outs, aux = infer()
    except Exception:
        return "raised"
    return [str(t) for t in args], [str(t) for t in outs], aux


@pytest.mark.parametrize("case", ["_mlp", "stage", "gpt", "resnet"])
def test_listing_and_inference_match_the_reference(pairs, case):
    r, p = _graphs(pairs, case)
    assert p.list_arguments() == r.list_arguments()
    assert p.list_outputs() == r.list_outputs()
    assert p.list_auxiliary_states() == r.list_auxiliary_states() == []
    if case == "_mlp":
        shapes = dict(data=(5, 8), w1=(4, 8), b1=(4,))
    else:
        shapes = dict(zip(pairs[case].in_names,
                          [x.shape for x in pairs[case].xs]))
        shapes.update({n: tuple(p.shape) for n, p in pairs[case].pnet
                       .collect_params().items()})
        shapes = {n: shapes[n] for n in p.list_arguments()}
    assert p.infer_shape(**shapes) == r.infer_shape(**shapes)
    assert p.infer_shape_partial(**shapes) == r.infer_shape_partial(**shapes)
    assert p.infer_shape_partial() == r.infer_shape_partial() == \
        (None, None, None)
    # infer_type runs the graph at shapes (1,), as the reference's does:
    # a graph that cannot run there raises in both
    assert _types(p.infer_type) == _types(r.infer_type)
    with pytest.raises(MXNetError, match="missing shapes"):
        p.infer_shape(data=(5, 8))


def test_infer_args_deduces_parameters_as_the_reference():
    from mxnet_tpu.symbol.symbol import infer_args as rinfer

    for shapes in ({"data": (5, 8)}, {"data": (2, 3, 4)}):
        assert psym.infer_args(_mlp(mx), **shapes) == \
            rinfer(_mlp(rmx), **shapes)
    s = mx.sym.Convolution(mx.sym.var("x"), mx.sym.var("w"), kernel=(3, 3),
                           num_filter=8, no_bias=True, layout="NHWC")
    # an NHWC convolution's weight from the channel axis (the reference
    # reads axis 1 and deduces (8, 10, 3, 3) here; ROADMAP §3)
    assert psym.infer_args(s, x=(2, 10, 10, 4))["w"] == (8, 4, 3, 3)


def test_builders_arithmetic_composition_and_outputs():
    for pkg in (rmx, mx):
        s = pkg.sym if pkg is mx else pkg.symbol
        x, y = s.var("x"), s.var("y")
        with CPU:
            xs = pkg.nd.array([4.0, -1.0])
            ys = pkg.nd.array([2.0, 3.0])
            a = ((x + y) * x / y - x).eval(x=xs, y=ys)[0].asnumpy()
            b = (x * 2.0 + 1.0 - 3.0 / x).eval(x=xs)[0].asnumpy()
            parts = s.split(s.var("z"), num_outputs=2, axis=0)
            comp = s.relu(s.var("h"))(h=parts[1])
            c = comp.eval(z=pkg.nd.array([[-1., 2.], [3., -4.]]))[0]
            g = parts.eval(z=pkg.nd.ones((4, 3)))
        onp.testing.assert_allclose(a, [8.0, 1.0 / 3.0], rtol=1e-6)
        onp.testing.assert_allclose(b, [8.25, 2.0], rtol=1e-6)
        onp.testing.assert_allclose(c.asnumpy(), [[3., 0.]])
        assert len(parts) == 2 and [o.shape for o in g] == [(2, 3), (2, 3)]
        assert parts.list_outputs() == [f"{parts.name}_output0",
                                        f"{parts.name}_output1"]
    names = [n.name for n in psym._topo(_mlp(mx).get_internals()._heads)]
    assert names == ["data", "w1", "b1", "fc1", "relu1"]


def test_executor_matches_the_reference_mlp():
    rs = onp.random.RandomState(2)
    x, w = rs.rand(2, 8).astype(onp.float32), rs.rand(4, 8).astype(
        onp.float32)
    b = rs.rand(4).astype(onp.float32)
    og = rs.rand(2, 4).astype(onp.float32)
    r = _mlp(rmx).simple_bind(grad_req="write", data=(2, 8))
    p = _mlp(mx).simple_bind(ctx=CPU, grad_req="write", data=(2, 8))
    outs = []
    for ex, pkg in ((r, rmx), (p, mx)):
        o = ex.forward(is_train=True, data=x, w1=w, b1=b)[0]
        with CPU:
            ex.backward(pkg.nd.array(og))
        outs.append((o.asnumpy(), {k: g.asnumpy()
                                   for k, g in ex.grad_dict.items()}))
    _close(outs[1][0], outs[0][0])
    assert list(outs[1][1]) == list(outs[0][1]) == ["data", "w1", "b1"]
    for k in outs[0][1]:
        _close(outs[1][1][k], outs[0][1][k])
    with pytest.raises(MXNetError, match="missing argument"):
        _mlp(mx).bind(ctx=CPU, args={"data": mx.nd.zeros((2, 8), ctx=CPU)})
    # simple_bind allocates zeros; copy_params_from binds the weights
    ex = _mlp(mx).simple_bind(ctx=CPU, grad_req="null", data=(2, 8))
    ex.copy_params_from({"w1": mx.nd.array(w, ctx=CPU), "b1": b, "x": w})
    assert ex.grad_arrays == [None, None, None]
    _close(ex.forward(data=x)[0].asnumpy(), outs[0][0])


# (the ResNet's gradients are the stage's layers': its reference side,
# run op by op, would take 20 s)
@pytest.mark.parametrize("case", ["mlp", "stage", "gpt"])
def test_executor_forward_and_gradients_match_the_reference(pairs, case):
    pr = pairs[case]
    rs = onp.random.RandomState(5)
    args = {n: a.data().asnumpy()
            for n, a in pr.pnet.collect_params().items()}
    args = {n: args[n] for n in pr.psym.list_arguments()
            if n not in pr.in_names}
    reqs = {n: "null" if n in pr.in_names else "write"
            for n in pr.psym.list_arguments()}
    res = []
    for sym, pkg, xs in ((pr.rsym, rmx, pr.rx()), (pr.psym, mx, pr.px())):
        with CPU:
            feed = {n: pkg.nd.array(a) for n, a in args.items()}
            feed.update(zip(pr.in_names, xs))
            ex = sym.bind(ctx=CPU if pkg is mx else None, args=feed,
                          grad_req=reqs)
            out = ex.forward(is_train=True)[0]
            og = rs.rand(*out.shape).astype(onp.float32)
            rs = onp.random.RandomState(5)
            ex.backward(pkg.nd.array(og))
        res.append((out.asnumpy(), {k: g.asnumpy()
                                    for k, g in ex.grad_dict.items()}))
    _close(res[1][0], res[0][0])
    assert list(res[1][1]) == list(res[0][1])
    for k in res[0][1]:
        _close(res[1][1][k], res[0][1][k])


# --------------------------------------------------------------------------- #
# files across packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", CASES)
def test_exports_equal_node_for_node(pairs, case):
    pr = pairs[case]
    jr = json.load(open(pr.rprefix + "-symbol.json"))
    jp = json.load(open(pr.pprefix + "-symbol.json"))
    assert jp["nodes"] == jr["nodes"]
    assert jp["heads"] == jr["heads"]
    assert jp["arg_nodes"] == jr["arg_nodes"]
    assert jp["node_row_ptr"] == jr["node_row_ptr"]
    rk = sorted(rmx.nd.load(pr.rprefix + "-0000.params"))
    pk = sorted(mx.nd.load(pr.pprefix + "-0000.params", ctx=CPU))
    assert pk == rk and all(k.startswith(("arg:", "aux:")) for k in pk)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("case", CASES)
def test_files_load_across_packages(pairs, case, direction):
    pr = pairs[case]
    ref = pr.rnet(*pr.rx()).asnumpy()
    if direction == "reference_to_port":
        blk = mx.gluon.SymbolBlock.imports(
            pr.rprefix + "-symbol.json", pr.in_names,
            pr.rprefix + "-0000.params", ctx=CPU)
        got = blk(*pr.px()).asnumpy()
        sym = mx.sym.load(pr.rprefix + "-symbol.json")
    else:
        blk = rmx.gluon.SymbolBlock.imports(
            pr.pprefix + "-symbol.json", pr.in_names,
            pr.pprefix + "-0000.params")
        got = blk(*pr.rx()).asnumpy()
        sym = rmx.symbol.load(pr.pprefix + "-symbol.json")
    _close(got, ref)
    assert json.loads(sym.tojson())["nodes"] == \
        json.loads(pr.psym.tojson())["nodes"]


def test_attributes_json_cannot_hold_are_written_as_repr(tmp_path):
    for pkg in (rmx, mx):
        s = pkg.sym if pkg is mx else pkg.symbol
        node = s.relu(s.var("x"), name="r")
        node._heads[0][0].attrs["odd"] = {1, 2}
        attrs = json.loads(node.tojson())["nodes"][1]["attrs"]
        assert attrs == {"odd": "{1, 2}"}


# --------------------------------------------------------------------------- #
# SymbolBlock in the port
# --------------------------------------------------------------------------- #

def _fresh_gpt(tmp_path, seed):
    with CPU:
        net = _scoped(mx, MAKE["gpt"])
    net.initialize(mx.init.Normal(0.1), ctx=CPU, seed=seed)
    xs, _ = _inputs("gpt")
    x = [mx.nd.array(a, ctx=CPU, dtype=a.dtype) for a in xs]
    net(*x)
    prefix = str(tmp_path / f"g{seed}")
    net.export(prefix)
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                       ["data0", "data1"],
                                       prefix + "-0000.params", ctx=CPU)
    return net, blk, x, prefix


def test_symbolblock_sgd_steps_bit_for_bit_with_its_source(tmp_path):
    net, blk, x, _ = _fresh_gpt(tmp_path, 3)
    label = mx.nd.array(onp.random.RandomState(4).randint(0, 50, (2, 8)),
                        ctx=CPU)
    loss_l = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for block in (net, blk):
        trainer = mx.gluon.Trainer(block.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        losses = []
        for _ in range(2):
            with mx.autograd.record():
                loss = loss_l(block(*x), label)
            loss.backward()
            trainer.step(2)
            losses.append(loss.asnumpy())
        runs.append((losses, {n: p.data().asnumpy()
                              for n, p in block.collect_params().items()}))
    (l0, w0), (l1, w1) = runs
    assert all(onp.array_equal(a, b) for a, b in zip(l0, l1))
    assert sorted(w0) == sorted(w1)
    assert all(onp.array_equal(w0[n], w1[n]) for n in w0)


def test_symbolblock_hybridizes_and_exports_again(tmp_path):
    net, blk, x, prefix = _fresh_gpt(tmp_path, 5)
    ref = net(*x).asnumpy()
    blk.hybridize()
    onp.testing.assert_array_equal(blk(*x).asnumpy(), ref)
    assert blk._cached_op.builds == 1
    again = blk.export(str(tmp_path / "again"))
    first = json.load(open(prefix + "-symbol.json"))["nodes"]
    second = json.loads(again.tojson())["nodes"]
    assert [(n["op"], n["attrs"], n["inputs"]) for n in second] == \
        [(n["op"], n["attrs"], n["inputs"]) for n in first]
    assert again.list_arguments() == mx.sym.load(
        prefix + "-symbol.json").list_arguments()
    blk2 = mx.gluon.SymbolBlock.imports(
        str(tmp_path / "again-symbol.json"), ["data0", "data1"],
        str(tmp_path / "again-0000.params"), ctx=CPU)
    onp.testing.assert_array_equal(blk2(*x).asnumpy(), ref)


def test_optimize_for_hybridizes_and_runs():
    with CPU:
        net = _dense(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = mx.nd.array(onp.ones((2, 5), onp.float32), ctx=CPU)
    ref = net(x).asnumpy()
    onp.testing.assert_array_equal(net.optimize_for(x, backend="x")
                                   .asnumpy(), ref)
    assert net._active


class _TensorForward(mx.gluon.HybridBlock):
    """A user block whose forward runs a torch op on tensors."""

    def forward(self, x):
        return x * 2


class _WithLoss(mx.gluon.HybridBlock):
    """A Dense and a Gluon loss (whose forward runs on tensors)."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.dense = mx.gluon.nn.Dense(4, in_units=3)
            self.loss = mx.gluon.loss.L1Loss()

    def hybrid_forward(self, F, x):
        y = self.dense(x)
        return self.loss(y, F.zeros_like(y))


@pytest.mark.parametrize("inner", ["tensor_forward", "loss"])
def test_export_refuses_a_forward_outside_the_registry(tmp_path, inner):
    with CPU:
        if inner == "loss":
            net = _WithLoss()
        else:
            net = mx.gluon.nn.HybridSequential()
            net.add(mx.gluon.nn.Dense(4, in_units=3), _TensorForward())
    net.initialize(ctx=CPU)
    x = mx.nd.array(onp.ones((2, 3), onp.float32), ctx=CPU)
    net(x)
    name = "_TensorForward" if inner == "tensor_forward" else "L1Loss"
    with pytest.raises(MXNetError, match=f"{name}: a symbol capture"):
        net.export(str(tmp_path / "bad"))
    assert not (tmp_path / "bad-symbol.json").exists()


def test_export_keeps_the_signature_of_the_outermost_call(pairs, tmp_path):
    pr = pairs["gpt"]
    # a hybrid_forward net calls its children with NDArrays: only the
    # outermost call is kept
    kept = [b for b in pr.pnet.modules()
            if "_last_input_structs" in b.__dict__]
    assert kept == [pr.pnet]
    assert pr.pnet.__dict__["_last_input_structs"] == [
        ((2, 8), torch.int32), ((2, 8), torch.int32)]
    child = next(iter(pr.pnet._children.values()))
    with pytest.raises(MXNetError, match="run the block"):
        child.export(str(tmp_path / "child"))
    # a hybridized call keeps it too
    with CPU:
        net = _dense(mx)
    net.initialize(ctx=CPU)
    net.hybridize()
    net(mx.nd.ones((3, 7), ctx=CPU))
    assert net.__dict__["_last_input_structs"] == [((3, 7), torch.float32)]
    net.export(str(tmp_path / "h"))
    nodes = json.load(open(tmp_path / "h-symbol.json"))["nodes"]
    assert nodes[0]["name"] == "data" and \
        nodes[0]["attrs"]["__shape__"] == [3, 7]


def _both_ways_cases():
    """Every layer marked ``_capture_runs = "hybrid_forward"``: (maker,
    input shape, the marked class it covers)."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn
    r = mx.gluon.model_zoo.vision.resnet
    return {
        "Dense": (lambda: nn.Dense(6, activation="relu", in_units=12),
                  (4, 3, 4)),
        "Dropout": (lambda: nn.Dropout(0.5, axes=(1,)), (4, 6, 5)),
        "BatchNorm": (lambda: nn.BatchNorm(axis=-1, in_channels=3),
                      (4, 5, 5, 3)),
        "Activation": (lambda: nn.Activation("tanh"), (4, 6)),
        "Flatten": (lambda: nn.Flatten(), (4, 2, 3)),
        "Conv2D": (lambda: nn.Conv2D(4, 3, padding=1, in_channels=3,
                                     layout="NHWC"), (2, 6, 6, 3)),
        "MaxPool2D": (lambda: nn.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
        "AvgPool2D": (lambda: nn.AvgPool2D(2, layout="NHWC"),
                      (2, 6, 6, 3)),
        "GlobalAvgPool2D": (lambda: nn.GlobalAvgPool2D(), (2, 3, 5, 5)),
        "BasicBlockV1": (lambda: r.BasicBlockV1(8, 2, True, in_channels=4,
                                                layout="NHWC"),
                         (2, 8, 8, 4)),
        "BottleneckV1": (lambda: r.BottleneckV1(16, 1, True, in_channels=8),
                         (2, 8, 6, 6)),
        "BasicBlockV2": (lambda: r.BasicBlockV2(8, 2, True, in_channels=4),
                         (2, 4, 8, 8)),
        "BottleneckV2": (lambda: r.BottleneckV2(16, 1, True, in_channels=8,
                                                layout="NHWC"),
                         (2, 6, 6, 8)),
        "ResNetV1": (lambda: r.ResNetV1(r.BasicBlockV1, [1, 1, 1, 1],
                                        [8, 8, 16, 32, 64], classes=5,
                                        thumbnail=True), (2, 3, 16, 16)),
        "ResNetV2": (lambda: r.ResNetV2(r.BottleneckV2, [1, 1, 1, 1],
                                        [8, 16, 32, 64, 128], classes=5,
                                        thumbnail=True, layout="NHWC"),
                     (2, 16, 16, 3)),
        "LSTM": (lambda: rnn.LSTM(6, num_layers=2, dropout=0.3,
                                  input_size=3), (5, 2, 3)),
        "GRU": (lambda: rnn.GRU(6, bidirectional=True, layout="NTC",
                                input_size=3), (2, 5, 3)),
    }


def _marked_owner(cls):
    return next(c for c in cls.__mro__ if "forward" in c.__dict__)


def test_every_hybrid_forward_mark_is_covered_both_ways():
    from mxnet_tpu_torch.gluon.block import Block

    marked, todo = set(), [Block]
    while todo:
        cls = todo.pop()
        todo += cls.__subclasses__()
        if cls.__dict__.get("_capture_runs") == "hybrid_forward":
            marked.add(cls)
    with CPU:
        covered = {_marked_owner(type(make()))
                   for make, _ in _both_ways_cases().values()}
    assert marked == covered


def _run_both_ways(make, shape, hybrid, training):
    from mxnet_tpu_torch.gluon.block import HybridBlock

    with CPU:
        owners = {_marked_owner(type(m)) for m in make().modules()}
    owners = {c for c in owners
              if c.__dict__.get("_capture_runs") == "hybrid_forward"}
    saved = {c: c.__dict__["forward"] for c in owners}
    try:
        if hybrid:
            for c in owners:
                c.forward = HybridBlock.forward
        with CPU:
            blk = make()
        blk.initialize(mx.init.Xavier(), ctx=CPU, seed=7)
        rs = onp.random.RandomState(3)
        x = mx.nd.array(rs.standard_normal(shape).astype(onp.float32),
                        ctx=CPU)
        x.attach_grad()
        mx.random.seed(11)
        with mx.autograd.record(train_mode=training):
            out = blk(x)
            w = mx.nd.array(rs.standard_normal(out.shape).astype(
                onp.float32), ctx=CPU)
            loss = (out * w).sum()
        loss.backward()
    finally:
        for c, fwd in saved.items():
            c.forward = fwd
    params = blk.collect_params()
    return ([out.asnumpy(), x.grad.asnumpy()] +
            [p.data().asnumpy() for p in params.values()] +
            [p.grad().asnumpy() for p in params.values()
             if p.grad_req != "null"])


@pytest.mark.parametrize("training", [True, False],
                         ids=["train", "predict"])
@pytest.mark.parametrize("name", list(_both_ways_cases()))
def test_marked_layers_give_the_same_bits_through_either_forward(name,
                                                                 training):
    make, shape = _both_ways_cases()[name]
    tensor = _run_both_ways(make, shape, False, training)
    hybrid = _run_both_ways(make, shape, True, training)
    assert len(tensor) == len(hybrid)
    for a, b in zip(tensor, hybrid):
        onp.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# capture
# --------------------------------------------------------------------------- #

def test_capture_records_ops_and_counts_captures():
    from mxnet_tpu_torch.ops import registry

    x = mx.nd.array(onp.random.RandomState(0).rand(2, 3), ctx=CPU)
    assert registry._captures == 0 and registry.current_capture() is None
    with psym.capture() as cap:
        assert registry._captures == 1 and registry.current_capture() is cap
        cap.mark_variable("x", x)
        y = mx.nd.relu(x)
        z = y + y
    assert registry._captures == 0
    sym = cap.symbol_for([z])
    assert sym.list_arguments() == ["x"]
    _close(sym.eval(x=x)[0].asnumpy(), 2 * onp.maximum(x.asnumpy(), 0))


def test_capture_of_a_random_op_replays_its_attributes():
    """``tests/test_symbol.py::TestCaptureRandomOps``'s case."""
    with CPU:
        mx.random.seed(3)
        with psym.capture() as cap:
            y = mx.random.uniform(2.0, 5.0, shape=(64,))
            z = mx.nd.relu(y)
        sym = cap.symbol_for([z])
        assert sym.list_arguments() == []
        out = sym.eval()[0].asnumpy()
    assert out.shape == (64,)
    assert out.min() >= 2.0 and out.max() < 5.0


def test_capture_refuses_an_op_outside_the_registry():
    from mxnet_tpu.ops import registry as rreg
    from mxnet_tpu.symbol.symbol import capture as rcapture
    from mxnet_tpu_torch.ops import registry as preg

    x = mx.nd.array([1.0], ctx=CPU)
    with psym.capture():
        with pytest.raises(MXNetError) as pe:
            preg.invoke(preg.Op("adhoc", lambda t: t * 2), [x], {})
    with rcapture():
        with pytest.raises(rmx.base.MXNetError) as re:
            rreg.invoke(rreg.Op("adhoc", lambda t: t * 2),
                        [rmx.nd.array([1.0])], {})
    assert str(pe.value) == str(re.value)


# --------------------------------------------------------------------------- #
# mx.name and mx.AttrScope
# --------------------------------------------------------------------------- #

def test_name_scopes_and_attr_scopes_match_the_reference():
    res = []
    for pkg in (rmx, mx):
        s = pkg.sym if pkg is mx else pkg.symbol
        with pkg.name.Prefix("scope_"):
            a = s.relu(s.var("x"))
            b = s.relu(s.var("x"), name="mine")
        with pkg.name.NameManager():
            c = s.relu(s.var("x"))
        with pkg.AttrScope(ctx_group="dev1"):
            t = s.relu(s.var("y"))
        with pkg.AttrScope(a="1"):
            with pkg.AttrScope(b="2"):
                u = s.relu(s.var("z"))
            v = s.relu(s.var("z"))
        with CPU:
            out = t.eval(y=pkg.nd.array([-1.0, 3.0]))[0].asnumpy()
        res.append((a.name, b.name, c.name, t.attr("__ctx_group__"),
                    u.list_attr(), v.list_attr(),
                    list(u.attr_dict().values()),
                    out.tolist(), pkg.name.current_attrs()))
    assert res[0] == res[1]
    assert res[1][:4] == ("scope_relu0", "mine", "relu0", "dev1")


# --------------------------------------------------------------------------- #
# print_summary, the Predictor, convert_model
# --------------------------------------------------------------------------- #

def test_print_summary_totals(pairs, capsys):
    for case in ("mlp", "stage"):
        pr = pairs[case]
        shape = dict(zip(pr.in_names, [x.shape for x in pr.xs]))
        total = mx.viz.print_summary(pr.psym, shape=shape)
        assert total == sum(p.data().size for p in pr.pnet.collect_params()
                            .values())
        # (the reference's infer_args deduces an NHWC convolution's weight
        # from axis 1, ROADMAP §3, so only the MLP's total is compared)
        if case == "mlp":
            assert total == rmx.viz.print_summary(pr.rsym, shape=shape)
    # the tied head reads the token table: counted once in the port, once
    # a reader in the reference
    pr = pairs["gpt"]
    shape = dict(zip(pr.in_names, [x.shape for x in pr.xs]))
    total = mx.viz.print_summary(pr.psym, shape=shape)
    elements = sum(p.data().size for p in pr.pnet.collect_params().values())
    assert total == elements
    assert rmx.viz.print_summary(pr.rsym, shape=shape) == total + 50 * 32
    assert "Total params" in capsys.readouterr().out


def test_plot_network_needs_graphviz(pairs, monkeypatch):
    import sys

    sym = pairs["mlp"].psym
    try:
        import graphviz  # noqa: F401
    except ImportError:
        pass
    else:
        dot = mx.viz.plot_network(sym)
        assert "fullyconnected0" in dot.source and \
            "m_dense0_weight" not in dot.source
    monkeypatch.setitem(sys.modules, "graphviz", None)
    with pytest.raises(MXNetError, match="graphviz"):
        mx.viz.plot_network(sym)
    with pytest.raises(rmx.base.MXNetError, match="graphviz"):
        rmx.viz.plot_network(pairs["mlp"].rsym)


def test_predictor_and_its_self_contained_file(pairs, tmp_path):
    pr = pairs["gpt"]
    ref = pr.pnet(*pr.px()).asnumpy()
    shapes = dict(zip(pr.in_names, [x.shape for x in pr.xs]))
    pred = mx.predictor.Predictor(pr.pprefix + "-symbol.json",
                                  pr.pprefix + "-0000.params", shapes,
                                  ctx=CPU)
    pred.set_input("data0", pr.xs[0])
    pred.set_input("data1", pr.xs[1])
    pred.run()
    onp.testing.assert_array_equal(pred.get_output(0).asnumpy(), ref)
    assert pred.num_outputs == 1
    out = pred.forward(data0=pr.xs[0], data1=pr.xs[1])[0]
    onp.testing.assert_array_equal(out.asnumpy(), ref)
    with pytest.raises(KeyError):
        pred.set_input("nope", pr.xs[0])
    with pytest.raises(MXNetError, match="bound"):
        pred.set_input("data0", pr.xs[0][:1])
    path = str(tmp_path / "model.predictor")
    pred.export_compiled(path)
    run = mx.predictor.Predictor.load_compiled(path, ctx=CPU)
    onp.testing.assert_array_equal(run(*pr.xs)[0].asnumpy(), ref)
    # the reference's Predictor on the port's pair
    rpred = rmx.predictor.Predictor(pr.pprefix + "-symbol.json",
                                    pr.pprefix + "-0000.params", shapes)
    _close(rpred.forward(data0=pr.xs[0], data1=pr.xs[1])[0].asnumpy(), ref)


def test_amp_convert_model(pairs):
    pr = pairs["gpt"]
    sym, args, aux = mx.model.load_checkpoint(pr.pprefix, 0, ctx=CPU)
    s2, a16, x16 = mx.amp.convert_model(sym, args, aux,
                                        target_dtype="bfloat16")
    _, ra, _ = rmx.amp.convert_model(
        None, {k: rmx.nd.array(v.asnumpy()) for k, v in args.items()}, {})
    assert s2 is sym and sorted(a16) == sorted(ra)
    assert all(v.dtype == torch.bfloat16 for v in a16.values())
    assert all(str(v.dtype) == "bfloat16" for v in ra.values())
    blk = mx.gluon.SymbolBlock(s2, pr.in_names, params=a16)
    with CPU:
        net = _scoped(mx, MAKE["gpt"])
    net.initialize(ctx=CPU)
    net(*pr.px())
    for n, p in net.collect_params().items():
        p.set_data(pr.pnet.collect_params()[n].data())
    net.cast("bfloat16")
    onp.testing.assert_array_equal(blk(*pr.px()).asnumpy(),
                                   net(*pr.px()).asnumpy())


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_imports_on_the_card_and_a_replayed_predictor(tmp_path):
    need_cuda()
    with CPU:
        net = _scoped(mx, MAKE["stage"])
    net.initialize(mx.init.Xavier(), ctx=CPU)
    xs, names = _inputs("stage")
    x = mx.nd.array(xs[0], ctx=CPU)
    ref = net(x).asnumpy()
    prefix = str(tmp_path / "stage")
    net.export(prefix)
    gpu = mx.gpu(0)
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", names,
                                       prefix + "-0000.params", ctx=gpu)
    xg = mx.nd.array(xs[0], ctx=gpu)
    eager = blk(xg).asnumpy()
    _close(eager, ref)
    # hybridized: one _GraphProgram, its capture replayed
    blk.hybridize()
    replayed = [blk(xg).asnumpy() for _ in range(3)]
    (prog,) = blk._cached_op._programs.values()
    assert prog.graph is not None and prog.replays == 2
    for o in replayed:
        onp.testing.assert_array_equal(o, eager)
    pred = mx.predictor.Predictor(prefix + "-symbol.json",
                                  prefix + "-0000.params",
                                  {"data": xs[0].shape}, ctx=gpu)
    outs = [pred.forward(data=xs[0])[0].asnumpy() for _ in range(3)]
    assert pred.replays == 2
    for o in outs:
        onp.testing.assert_array_equal(o, outs[0])
        _close(o, ref)


def test_parameter_var_is_its_symbol_variable():
    p = mx.gluon.Parameter("w", shape=(4, 8))
    v = p.var()
    assert v.list_arguments() == ["w"]
    assert v.attr("__shape__") == (4, 8) and v.attr("__dtype__") == "float32"
    fc = mx.sym.FullyConnected(mx.sym.var("data"), v, num_hidden=4,
                               no_bias=True)
    assert psym.infer_args(fc, data=(2, 8))["w"] == (4, 8)
