"""``mx.amp`` of the port (``mxnet_tpu_torch/amp``) against
``mxnet_tpu/amp``, on the CPU, over ``tests/test_amp.py``'s cases: the
casts of each list (target, f32, widest), ``init`` refusing a bad dtype
and being idempotent, the loss scaler's dynamic scale and overflow
detection, a skipped update on overflow, float16 training through
``init_trainer`` and ``scale_loss``, and ``convert_hybrid_block``.

The models, each built in both packages with the reference's weights
carried by ``save_parameters``/``load_parameters``:
- a ``hybrid_forward`` model (``tests/_torch_hybrid_models.gpt`` at 1
  layer, 16 units, 2 heads, context 8) whose ``F.FullyConnected`` and
  ``F.flash_attention`` take ``amp.init``'s casts and whose
  ``gluon.nn.LayerNorm``/``Dense`` do too;
- a ``gluon.nn`` model (Dense, LayerNorm, Dense) whose port ``Dense``
  computes on tensors and casts by the same lists (``amp.amp.layer_cast``).
Output dtypes equal; values within one fp16 (or bf16) rounding of the
output's largest magnitude plus 1e-3 relative (both packages cast at the
same places and sum in f32, but round the products' sums apart);
float16 training's losses within 1e-3 relative, its weights within
1e-4.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_hybrid_models import gpt
from _torch_parity import LazyReference
from mxnet_tpu_torch import amp as pamp
from mxnet_tpu_torch.amp.amp import layer_cast
from mxnet_tpu_torch.base import MXNetError, dtype_name

rmx = LazyReference()


def _name(x):
    d = x._data.dtype if hasattr(x._data, "dtype") else x.dtype
    return dtype_name(d) if isinstance(d, torch.dtype) else str(d)


@pytest.fixture
def both_amp(request):
    dtype = getattr(request, "param", "bfloat16")
    rmx.amp.init(target_dtype=dtype)
    pamp.init(target_dtype=dtype)
    yield dtype
    rmx.amp._uninit()
    pamp._uninit()


def _pair(shape, seed, dtype="float32"):
    a = onp.random.RandomState(seed).rand(*shape).astype(onp.float32)
    with pmx.cpu():
        p = pmx.nd.array(a).astype(dtype)
    return rmx.nd.array(a).astype(dtype), p


@pytest.mark.parametrize("both_amp", ["bfloat16", "float16"],
                         indirect=True)
def test_casts_by_list(both_amp):
    (ra, pa), (rb, pb) = _pair((4, 8), 0), _pair((8, 5), 1)
    assert _name(pmx.nd.dot(pa, pb)) == str(rmx.nd.dot(ra, rb).dtype) == \
        both_amp
    lo_r, lo_p = _pair((4, 8), 2, both_amp)
    assert _name(pmx.nd.softmax(lo_p)) == \
        str(rmx.nd.softmax(lo_r).dtype) == "float32"
    hi_r, hi_p = _pair((4, 8), 3)
    assert _name(pmx.nd.broadcast_add(lo_p, hi_p)) == \
        str(rmx.nd.broadcast_add(lo_r, hi_r).dtype) == "float32"
    onp.testing.assert_allclose(
        pmx.nd.broadcast_add(lo_p, hi_p).asnumpy(),
        rmx.nd.broadcast_add(lo_r, hi_r).asnumpy().astype(onp.float32),
        rtol=1e-6)
    pamp.init()                       # a second init wraps nothing again
    assert _name(pmx.nd.dot(pa, pb)) == both_amp


def test_init_rejects_a_bad_dtype_and_uninit_restores():
    with pytest.raises(MXNetError):
        pamp.init(target_dtype="int8")
    with pytest.raises(MXNetError):
        pamp.init_trainer(object())
    before = pmx.nd.FullyConnected
    pamp.init("float16")
    assert pmx.nd.FullyConnected is not before
    assert layer_cast("FullyConnected", torch.ones(2))[0].dtype == \
        torch.float16
    pamp._uninit()
    assert pmx.nd.FullyConnected is before
    assert layer_cast("FullyConnected", torch.ones(2))[0].dtype == \
        torch.float32
    # convert_model casts a checkpoint's f32 arrays (since symbol/)
    w = pmx.nd.array(onp.ones((2, 2), onp.float32), ctx=pmx.cpu())
    sym, args, aux = pamp.convert_model("graph", {"w": w}, {"s": w})
    assert sym == "graph" and args["w"].dtype == torch.bfloat16 and \
        aux["s"].dtype == torch.bfloat16


def test_loss_scaler_dynamic_scale_and_overflow():
    for pkg in (rmx, pmx):
        ls = pkg.amp.LossScaler(init_scale=1024, scale_window=2)
        ls.update_scale(False)
        ls.update_scale(False)
        assert ls.loss_scale == 2048
        ls.update_scale(True)
        assert ls.loss_scale == 1024
    with pmx.cpu():
        p = pmx.gluon.Parameter("w", shape=(3,))
        p.initialize()
        p.data()._grad = pmx.nd.array([1.0, onp.inf, 2.0])
    ls = pamp.LossScaler()
    assert ls.has_overflow([p])
    with pmx.cpu():
        p.data()._grad = pmx.nd.ones((3,))
    assert not ls.has_overflow([p])


def _dense_rig(pkg, units=2, seed=0):
    pkg.random.seed(seed)
    with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
        net = pkg.gluon.nn.Dense(units, in_units=3)
        net.initialize(pkg.init.Xavier())
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    return net, tr


@pytest.mark.parametrize("both_amp", ["float16"], indirect=True)
def test_overflow_skips_the_update(both_amp):
    net, tr = _dense_rig(pmx)
    pamp.init_trainer(tr)
    scaler = tr._amp_loss_scaler
    assert scaler.loss_scale == 2.0 ** 16
    scaler.loss_scale = 4.0
    with pmx.cpu():
        x = pmx.nd.array(onp.random.RandomState(0).rand(2, 3))
    with pmx.autograd.record():
        out = net(x)
        L = (out * out).sum()
    L.backward()
    w = net.weight
    w.data()._grad = w.grad() * onp.inf
    before = w.data().asnumpy().copy()
    tr.step(2)
    onp.testing.assert_array_equal(w.data().asnumpy(), before)
    assert scaler.loss_scale == 2.0


@pytest.mark.parametrize("both_amp", ["float16"], indirect=True)
def test_fp16_training_with_the_scaler_matches_the_reference(both_amp,
                                                             tmp_path):
    rs = onp.random.RandomState(5)
    x = rs.rand(8, 6).astype(onp.float32)
    y = rs.rand(8, 4).astype(onp.float32)
    runs = []
    f = str(tmp_path / "w.params")
    for pkg in (rmx, pmx):
        with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
            net = pkg.gluon.nn.Dense(4, in_units=6)
            net.initialize(pkg.init.Xavier())
            if pkg is rmx:
                net.save_parameters(f)
            else:
                net.load_parameters(f, ctx=pmx.cpu())
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
            pkg.amp.init_trainer(tr)
            bx, by = pkg.nd.array(x), pkg.nd.array(y)
        loss_fn = pkg.gluon.loss.L2Loss()
        losses = []
        for _ in range(5):
            with pkg.autograd.record():
                out = net(bx)
                L = loss_fn(out.astype("float32"), by)
                with pkg.amp.scale_loss(L, tr) as scaled:
                    pass
            scaled.backward()
            tr.step(8)
            losses.append(float(L.mean().asnumpy()))
        assert _name(out) == "float16"
        runs.append((losses, net.weight.data().asnumpy(),
                     tr._amp_loss_scaler.loss_scale))
    (rl, rw, rsc), (pl, pw, psc) = runs
    assert pl[-1] < pl[0] and psc == rsc
    onp.testing.assert_allclose(pl, rl, rtol=1e-3)
    onp.testing.assert_allclose(pw, rw, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("both_amp", ["float16"], indirect=True)
def test_scale_loss_outside_record_reaches_the_graph(both_amp):
    """The port records the scaling wherever ``scale_loss`` is entered,
    so a backward of the scaled loss outside ``record()`` gives the same
    gradients as inside; the reference's gives none (its product is not
    recorded and its weight gradient stays zero)."""
    x = onp.random.RandomState(3).rand(4, 3).astype(onp.float32)
    grads = {}
    for pkg, inside in ((pmx, True), (pmx, False), (rmx, False)):
        net, tr = _dense_rig(pkg)
        pkg.amp.init_trainer(tr)
        tr._amp_loss_scaler.loss_scale = 8.0
        with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
            bx = pkg.nd.array(x)
        with pkg.autograd.record():
            L = (net(bx).astype("float32") ** 2).sum()
            if inside:
                with pkg.amp.scale_loss(L, tr) as scaled:
                    pass
        if not inside:
            with pkg.amp.scale_loss(L, tr) as scaled:
                pass
        scaled.backward()
        grads[(pkg is pmx, inside)] = net.weight.grad().asnumpy()
    assert grads[(True, True)].any()
    onp.testing.assert_array_equal(grads[(True, False)],
                                   grads[(True, True)])
    assert not grads[(False, False)].any()


def test_convert_hybrid_block():
    for pkg in (rmx, pmx):
        net, _ = _dense_rig(pkg, units=4)
        pkg.amp.convert_hybrid_block(net, target_dtype="bfloat16")
        with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
            x = pkg.nd.array(onp.random.RandomState(0).rand(2, 3))
        out = net(x.astype("bfloat16"))
        assert _name(out) == "bfloat16"


def _close_lowp(got, ref, dtype):
    got = onp.asarray(got, onp.float32)
    ref = onp.asarray(ref, onp.float32)
    step = 2.0 ** (-10 if dtype == "float16" else -7)
    onp.testing.assert_allclose(got, ref, rtol=1e-3,
                                atol=step * float(onp.abs(ref).max()))


def _carry(build, tmp_path):
    """The model in both packages, the port's with the reference's
    weights."""
    f = str(tmp_path / "m.params")
    rmx.random.seed(0)
    ref = build(rmx)
    ref.initialize(rmx.init.Xavier())
    with pmx.cpu():
        port = build(pmx)
        port.initialize(pmx.init.Xavier())
    return ref, port, f


@pytest.mark.parametrize("both_amp", ["bfloat16", "float16"],
                         indirect=True)
def test_hybrid_forward_model_under_amp(both_amp, tmp_path):
    ref, port, f = _carry(lambda pkg: gpt(pkg, 50, 16, 1, 2, 8), tmp_path)
    toks = onp.random.RandomState(1).randint(0, 50, (2, 8))
    pos = onp.tile(onp.arange(8), (2, 1))
    r = ref(rmx.nd.array(toks, dtype="int32"), rmx.nd.array(pos,
                                                            dtype="int32"))
    ref.save_parameters(f)
    port.load_parameters(f, ctx=pmx.cpu())
    with pmx.cpu():
        p = port(pmx.nd.array(toks, dtype="int32"),
                 pmx.nd.array(pos, dtype="int32"))
    assert _name(p) == str(r.dtype) == both_amp
    _close_lowp(p.asnumpy(), r.asnumpy(), both_amp)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, in_units=8, flatten=False),
            pkg.gluon.nn.LayerNorm(in_channels=16),
            pkg.gluon.nn.Dense(4, in_units=16, flatten=False))
    return net


@pytest.mark.parametrize("both_amp", ["bfloat16", "float16"],
                         indirect=True)
def test_gluon_nn_model_under_amp(both_amp, tmp_path):
    ref, port, f = _carry(_mlp, tmp_path)
    x = onp.random.RandomState(2).randn(3, 5, 8).astype(onp.float32)
    rx = rmx.nd.array(x)
    rx.attach_grad()
    with rmx.autograd.record():
        r = ref(rx)
        rl = r.astype("float32").sum()
    rl.backward()
    ref.save_parameters(f)
    port.load_parameters(f, ctx=pmx.cpu())
    with pmx.cpu():
        px = pmx.nd.array(x)
    px.attach_grad()
    with pmx.autograd.record():
        p = port(px)
        pl = p.astype("float32").sum()
    pl.backward()
    assert _name(p) == str(r.dtype) == both_amp
    _close_lowp(p.asnumpy(), r.asnumpy(), both_amp)
    assert _name(px.grad) == "float32"
    _close_lowp(px.grad.asnumpy(), rx.grad.asnumpy(), both_amp)


@pytest.mark.cuda
def test_fp16_attention_and_dense_under_amp_on_the_card():
    """On the card under ``amp.init("float16")``: ``F.flash_attention``
    past 512² scores runs K1 in fp16 and ``gluon.nn.Dense`` computes in
    fp16, within one fp16 rounding of the same calls on the CPU."""
    from _torch_parity import need_cuda
    from mxnet_tpu_torch.ops import attention as pa

    need_cuda()
    rs = onp.random.RandomState(0)
    q = rs.randn(1, 2, 640, 64).astype(onp.float32)
    w = rs.randn(8, 64).astype(onp.float32)
    pamp.init("float16")
    try:
        outs = {}
        for dev in ("cpu", "gpu"):
            ctx = pmx.cpu() if dev == "cpu" else pmx.gpu(0)
            with ctx:
                d = pmx.gluon.nn.Dense(8, in_units=64, flatten=False)
                d.initialize()
                d.weight.set_data(w)
                before = pa.flash_fwd.launches
                a = pmx.nd.flash_attention(pmx.nd.array(q), pmx.nd.array(q),
                                           pmx.nd.array(q), causal=True)
                o = d(a)
            assert _name(a) == _name(o) == "float16"
            if dev == "gpu":
                assert pa.flash_fwd.launches == before + 1
            outs[dev] = o.asnumpy()
    finally:
        pamp._uninit()
    _close_lowp(outs["gpu"], outs["cpu"], "float16")
