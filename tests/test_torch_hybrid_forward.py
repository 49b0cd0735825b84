"""``HybridBlock.hybrid_forward(F, x, *args, **params)`` in the PyTorch
port against the JAX package, float32 on the CPU.

Each block body below is written once, against either package (the
factory ``_classes(pkg)``), as a user writes an MXNet block: a
Dense-like block whose input width is deferred to ``infer_shape``, a
convolution block (``F.Convolution``, ``F.BatchNorm``,
``F.Activation``, ``F.Pooling``) and an attention block
(``F.FullyConnected``, ``F.flash_attention``).  The reference's weights
reach the port by its ``save_parameters`` and the port's
``load_parameters``.  Forward and gradients agree within 1e-5,
imperatively and hybridized, and through ``Trainer.fused_step`` (whose
gradients are all nonzero: the guard against the ops running under
``no_grad`` when ``autograd.is_recording()`` and torch's grad mode
disagree).  Also: deferred initialization through ``infer_shape`` and
the missing-``infer_shape`` error, ``forward`` winning over
``hybrid_forward``, hooks, and a block called with plain tensors.

The slice test: the GPT of ``_torch_hybrid_models`` (the one
``chip_smoke.py`` phase 20 drives at GPT-2 small's widths) at 2 layers,
64 units, 4 heads, context 32, two AdamW steps through
``gluon.Trainer`` in both packages: losses and parameters within 1e-5
(relative and absolute; AdamW's second step divides by sqrt(v), so a
near-zero gradient's rounding can show in its weight: measured 2e-7).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from _torch_hybrid_models import gpt

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = mx.cpu()


def _classes(pkg):
    gluon = pkg.gluon

    class DenseLike(gluon.HybridBlock):
        def __init__(self, units, in_units=0, **kw):
            super().__init__(**kw)
            self._units = units
            with self.name_scope():
                self.weight = self.params.get(
                    "weight", shape=(units, in_units),
                    allow_deferred_init=True)
                self.bias = self.params.get("bias", shape=(units,),
                                            init="zeros",
                                            allow_deferred_init=True)

        def infer_shape(self, x, *args):
            self.weight.shape = (self._units, x.shape[-1])

        def hybrid_forward(self, F, x, weight, bias):
            y = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                 flatten=False)
            return F.Activation(y, act_type="tanh")

    class ConvBlock(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(6, 3, 3, 3))
                self.gamma = self.params.get("gamma", shape=(6,),
                                             init="ones")
                self.beta = self.params.get("beta", shape=(6,),
                                            init="zeros")
                self.mean = self.params.get("mean", shape=(6,),
                                            init="zeros", grad_req="null")
                self.var = self.params.get("var", shape=(6,), init="ones",
                                           grad_req="null")

        def hybrid_forward(self, F, x, weight, gamma, beta, mean, var):
            y = F.Convolution(x, weight, kernel=(3, 3), pad=(1, 1),
                              num_filter=6, no_bias=True)
            y = F.BatchNorm(y, gamma, beta, mean, var, fix_gamma=False)
            y = F.Activation(y, act_type="relu")
            return F.Pooling(y, kernel=(2, 2), stride=(2, 2),
                             pool_type="avg")

    class AttnBlock(gluon.HybridBlock):
        def __init__(self, units=16, heads=2, **kw):
            super().__init__(**kw)
            self._u, self._h = units, heads
            with self.name_scope():
                self.qkv = self.params.get("qkv", shape=(3 * units, units))
                self.proj = self.params.get("proj", shape=(units, units))

        def hybrid_forward(self, F, x, qkv, proj):
            B, T, U = x.shape
            h = F.FullyConnected(x, qkv, num_hidden=3 * U, no_bias=True,
                                 flatten=False)
            h = F.transpose(F.reshape(h, shape=(B, T, 3, self._h,
                                                U // self._h)),
                            axes=(2, 0, 3, 1, 4))
            q, k, v = F.split(h, num_outputs=3, axis=0, squeeze_axis=True)
            o = F.flash_attention(q, k, v, causal=True)
            o = F.reshape(F.transpose(o, axes=(0, 2, 1, 3)), shape=(B, T, U))
            return F.FullyConnected(o, proj, num_hidden=U, no_bias=True,
                                    flatten=False)

    class Both(gluon.HybridBlock):
        def forward(self, x):
            return x * 2

        def hybrid_forward(self, F, x):
            return x * 3

    class NoInferShape(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(4, 0),
                                              allow_deferred_init=True)

        def hybrid_forward(self, F, x, weight):
            return F.FullyConnected(x, weight, num_hidden=4, no_bias=True)

    return dict(dense=DenseLike, conv=ConvBlock, attn=AttnBlock, both=Both,
                no_infer=NoInferShape)


_INPUTS = {"dense": (3, 5, 7), "conv": (2, 3, 8, 8), "attn": (2, 12, 16)}


def _make(pkg, kind):
    cls = _classes(pkg)[kind]
    return cls(4) if kind == "dense" else cls()


def _x(kind):
    return onp.random.RandomState(1).standard_normal(
        _INPUTS[kind]).astype(onp.float32)


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _run(pkg, net, kind, hybridize):
    """Forward outside ``record()``, then under it with a head gradient:
    the output, the input's gradient and every parameter's."""
    if hybridize:
        net.hybridize()
    x = pkg.nd.array(_x(kind))
    out = net(x).asnumpy()
    head = onp.random.RandomState(2).standard_normal(out.shape).astype(
        onp.float32)
    x.attach_grad()
    with pkg.autograd.record():
        y = net(x)
    y.backward(pkg.nd.array(head))
    return dict(out=out, rec=y.asnumpy(), dx=x.grad.asnumpy(),
                grads=_grads(net))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each block of the reference, initialized and run once (deferred
    shapes), saved with ``save_parameters``."""
    tmp = tmp_path_factory.mktemp("hybrid_forward")
    files = {}
    for kind in _INPUTS:
        rmx.random.seed(0)
        net = _make(rmx, kind)
        net.initialize(rmx.init.Xavier())
        net(rmx.nd.array(_x(kind)))
        files[kind] = str(tmp / f"{kind}.params")
        net.save_parameters(files[kind])
    return files


def _pair(kind, files):
    ref = _make(rmx, kind)
    ref.load_parameters(files[kind])
    with CPU:
        port = _make(mx, kind)
    port.load_parameters(files[kind], ctx=CPU)
    return ref, port


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("kind", list(_INPUTS))
def test_block_matches_reference(saved, kind, hybridize):
    ref, port = _pair(kind, saved)
    want = _run(rmx, ref, kind, hybridize)
    with CPU:
        got = _run(mx, port, kind, hybridize)
    for key in ("out", "rec", "dx"):
        onp.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        onp.testing.assert_allclose(got["grads"][k], g, **TOL, err_msg=k)
        assert onp.abs(got["grads"][k]).max() > 0, k


def test_deferred_init_through_infer_shape():
    with CPU:
        net = _make(mx, "dense")
        net.initialize(ctx=CPU)
        assert net.weight._data is None
        out = net(mx.nd.array(_x("dense")))
    assert net.weight.shape == (4, 7) and out.shape == (3, 5, 4)
    assert isinstance(net.weight.data(), mx.nd.NDArray)


def test_missing_infer_shape_raises_the_reference_message():
    msgs = []
    for pkg in (rmx, mx):
        with CPU:
            net = _classes(pkg)["no_infer"]()
            net.initialize(**({"ctx": CPU} if pkg is mx else {}))
            with pytest.raises(Exception) as err:
                net(pkg.nd.ones((2, 3)))
        msgs.append(str(err.value))
    assert "has deferred-init parameters but no infer_shape" in msgs[1]
    assert msgs[0] == msgs[1]


def test_forward_wins_over_hybrid_forward():
    x = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    want = _classes(rmx)["both"]()(rmx.nd.array(x)).asnumpy()
    with CPU:
        got = _classes(mx)["both"]()(mx.nd.array(x)).asnumpy()
    onp.testing.assert_array_equal(got, want)
    onp.testing.assert_array_equal(got, x * 2)


def test_hooks_fire_around_hybrid_forward(saved):
    def hooked(pkg, net):
        seen = []
        pre = net.register_forward_pre_hook(
            lambda b, a: seen.append(("pre", type(a[0]).__name__)))
        post = net.register_forward_hook(
            lambda b, a, o: seen.append(("post", type(o).__name__,
                                         o.asnumpy().sum())))
        net(pkg.nd.array(_x("dense")))
        pre.detach()
        post.detach()
        net(pkg.nd.array(_x("dense")))
        return seen

    ref, port = _pair("dense", saved)
    want = hooked(rmx, ref)
    with CPU:
        got = hooked(mx, port)
    assert [s[:2] for s in got] == [s[:2] for s in want] == [
        ("pre", "NDArray"), ("post", "NDArray")]
    onp.testing.assert_allclose(got[1][2], want[1][2], **TOL)


def test_tensor_call_records_under_torch_grad_mode(saved):
    """Called with tensors (an ``nn.Module`` call, as ``SPMDTrainer``
    makes it) outside ``autograd.record()``, a ``hybrid_forward`` block's
    ops follow torch's grad mode: every parameter gets its gradient, and
    under ``torch.no_grad()`` nothing records."""
    _, port = _pair("conv", saved)
    x = torch.from_numpy(_x("conv"))
    assert not mx.autograd.is_recording()
    port(x).square().sum().backward()
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and p.grad.abs().max() > 0, name
    with torch.no_grad():
        assert port(x).grad_fn is None


def _step_pair(kind, files, lr=0.1):
    """Two ports of the block on the reference's weights, each with an
    SGD ``gluon.Trainer``."""
    nets = []
    for _ in range(2):
        with CPU:
            net = _make(mx, kind)
        net.load_parameters(files[kind], ctx=CPU)
        nets.append((net, mx.gluon.Trainer(net.collect_params(), "sgd",
                                           {"learning_rate": lr})))
    return nets


@pytest.mark.parametrize("kind", ["dense", "conv", "attn"])
def test_fused_step_matches_phase_by_phase(saved, kind):
    """``Trainer.fused_step`` on a ``hybrid_forward`` block: two steps
    equal two phase-by-phase steps of the port bit for bit and the
    reference's ``fused_step`` within 1e-5; the traced gradients of
    every parameter are nonzero and every trained parameter moved."""
    rs = onp.random.RandomState(4)
    x = _x(kind)
    target = rs.standard_normal(_make_out_shape(kind)).astype(onp.float32)
    (fused, tf), (phase, tp) = _step_pair(kind, saved)
    with CPU:
        xs, ys = mx.nd.array(x), mx.nd.array(target)
        loss = mx.gluon.loss.L2Loss()

        def loss_fn(net):
            return lambda a, b: loss(net(a), b)

        before = {k: v.copy() for k, v in _params(fused).items()}
        params = [p for p in fused.collect_params().values()
                  if p.grad_req != "null"]
        pure = mx.autograd.trace_value_and_grad(loss_fn(fused), params)
        _, grads, _ = pure([p.data()._data for p in params], [],
                           xs._data, ys._data)
        for p, g in zip(params, grads):
            assert g.abs().max() > 0, p.name
        for _ in range(2):
            tf.fused_step(loss_fn(fused), xs, ys)
            with mx.autograd.record():
                out = loss_fn(phase)(xs, ys)
            out.backward()
            tp.step(x.shape[0])
    ref = _make(rmx, kind)
    ref.load_parameters(saved[kind])
    tr = rmx.gluon.Trainer(ref.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    rl = rmx.gluon.loss.L2Loss()
    for _ in range(2):
        tr.fused_step(lambda a, b: rl(ref(a), b), rmx.nd.array(x),
                      rmx.nd.array(target))
    got, want = _params(fused), _params(ref)
    for k, v in _params(phase).items():
        onp.testing.assert_array_equal(got[k], v, err_msg=k)
        onp.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        if k in {p.name for p in params}:
            assert (got[k] != before[k]).any(), k


def _make_out_shape(kind):
    return {"dense": (3, 5, 4), "conv": (2, 6, 4, 4),
            "attn": (2, 12, 16)}[kind]


def _params(net):
    return {p.name.split("_", 1)[1]: p.data().asnumpy().copy()
            for p in net.collect_params().values()}


# --------------------------------------------------------------------------- #
# the slice: phase 20's GPT at a small size in both packages
# --------------------------------------------------------------------------- #

GPT = dict(vocab=97, units=64, layers=2, heads=4, max_len=32)


def test_hybrid_gpt_two_adamw_steps_match_reference(tmp_path):
    rs = onp.random.RandomState(7)
    B, T = 2, GPT["max_len"]
    tokens = rs.randint(0, GPT["vocab"], (B, T)).astype(onp.float32)
    positions = onp.tile(onp.arange(T, dtype=onp.float32), (B, 1))
    labels = rs.randint(0, GPT["vocab"], (B, T)).astype(onp.float32)
    opt = {"learning_rate": 1e-3, "wd": 0.01}

    def train(pkg, net):
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        tr = pkg.gluon.Trainer(net.collect_params(), "adamw", dict(opt))
        t, p, y = (pkg.nd.array(a) for a in (tokens, positions, labels))
        losses = []
        for _ in range(2):
            with pkg.autograd.record():
                loss = loss_fn(net(t, p), y)
            loss.backward()
            losses.append(loss.asnumpy())
            tr.step(B)
        return losses, _params(net)

    rmx.random.seed(0)
    ref = gpt(rmx, **GPT)
    ref.initialize(rmx.init.Normal(0.05))
    ref(rmx.nd.array(tokens), rmx.nd.array(positions))
    f = str(tmp_path / "gpt.params")
    ref.save_parameters(f)
    with CPU:
        port = gpt(mx, **GPT)
    port.load_parameters(f, ctx=CPU)
    want_losses, want = train(rmx, ref)
    with CPU:
        got_losses, got = train(mx, port)
    for a, b in zip(got_losses, want_losses):
        onp.testing.assert_allclose(a, b, **TOL)
    assert sorted(got) == sorted(want)
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    # the LM head is the token table: one parameter, trained by both uses
    assert port.head.weight is port.tok.weight
