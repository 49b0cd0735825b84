"""``mxnet_tpu_torch``'s recurrent layer against ``mxnet_tpu``'s: the
fused op ``fused_rnn`` (``ops/rnn.py``), the ``gluon.rnn`` layers and
the unrolled cells with their wrappers, on the same seeded numpy inputs
and weights (weights carried by ``models.load_mxnet_tpu_arrays``), f32
on the CPU.

Tolerance: outputs, states and the gradients of the inputs and weights
within 1e-5 (relative and absolute); the port takes the input
projection for all time steps in one product, the reference one a step.
Dropout draws other masks than the reference (threefry bits), so the
parity cases run at dropout 0 or in inference mode, and the port's
dropout is held to what a mask must be.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ["rnn_relu", "rnn_tanh", "lstm", "gru"]
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _fused_arrays(rs, mode, layers, bidir, layout, T=5, N=3, C=4, H=6):
    ndir = 2 if bidir else 1
    x = rs.standard_normal((T, N, C) if layout == "TNC" else (N, T, C))
    arrays = [x, rs.standard_normal((layers * ndir, N, H))]
    if mode == "lstm":
        arrays.append(rs.standard_normal((layers * ndir, N, H)))
    G = GATES[mode] * H
    for layer in range(layers):
        for _ in range(ndir):
            inp = C if layer == 0 else H * ndir
            arrays += [rs.standard_normal((G, inp)) * 0.4,
                       rs.standard_normal((G, H)) * 0.4,
                       rs.standard_normal(G) * 0.1,
                       rs.standard_normal(G) * 0.1]
    return [a.astype(onp.float32) for a in arrays]


def _run_op(pkg, arrays, heads, kwargs):
    nds = [pkg.nd.array(a) for a in arrays]
    for x in nds:
        x.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.fused_rnn(nds, **kwargs)
    pkg.autograd.backward(list(outs), [pkg.nd.array(h) for h in heads])
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in nds]


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_fused_rnn_matches_reference(mode, layers, bidir, layout):
    """Outputs, final states and the gradients of x, the initial states
    and every weight and bias, against the reference's op."""
    rs = onp.random.RandomState(layers * 7 + bidir + len(mode))
    arrays = _fused_arrays(rs, mode, layers, bidir, layout)
    kwargs = dict(mode=mode, num_layers=layers, bidirectional=bidir,
                  layout=layout)
    ref_outs = rmx.nd.fused_rnn([rmx.nd.array(a) for a in arrays], **kwargs)
    heads = [rs.standard_normal(o.shape).astype(onp.float32)
             for o in ref_outs]
    r_out, r_grad = _run_op(rmx, arrays, heads, kwargs)
    with mx.cpu():
        p_out, p_grad = _run_op(mx, arrays, heads, kwargs)
    assert len(p_out) == len(r_out) == (3 if mode == "lstm" else 2)
    for p, r in zip(p_out + p_grad, r_out + r_grad):
        assert p.shape == r.shape
        onp.testing.assert_allclose(p, r, **TOL)


def test_fused_rnn_refuses_a_wrong_weight_count():
    rs = onp.random.RandomState(0)
    arrays = _fused_arrays(rs, "gru", 2, False, "TNC")
    with mx.cpu(), pytest.raises(mx.base.MXNetError, match="expected 8"):
        mx.nd.fused_rnn([mx.nd.array(a) for a in arrays[:-1]], mode="gru",
                        num_layers=2)


# --------------------------------------------------------------------------- #
# the layers
# --------------------------------------------------------------------------- #

def _layer(pkg, kind, H, **kw):
    rnn = pkg.gluon.rnn
    if kind == "rnn_relu":
        return rnn.RNN(H, activation="relu", **kw)
    if kind == "rnn_tanh":
        return rnn.RNN(H, activation="tanh", **kw)
    return {"lstm": rnn.LSTM, "gru": rnn.GRU}[kind](H, **kw)


def _ref_arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _pair(kind, H, **kw):
    """A reference layer (Xavier, seeded) and the port's with its
    weights, both under one prefix (default ``<kind>0_``): each package
    counts its own unnamed layers, so names made by layers of earlier
    tests in the same process would otherwise differ."""
    kw.setdefault("prefix", f"{kind}0_")
    rmx.random.seed(0)
    ref = _layer(rmx, kind, H, **kw)
    ref.initialize(rmx.init.Xavier())
    with mx.cpu():
        port = _layer(mx, kind, H, **kw)
        port.initialize()
    return ref, port


def _layer_run(pkg, net, x, states, heads):
    xs = pkg.nd.array(x)
    xs.attach_grad()
    st = None if states is None else [pkg.nd.array(s) for s in states]
    with pkg.autograd.record():
        res = net(xs, st) if st is not None else net(xs)
        outs = [res[0]] + list(res[1]) if st is not None else [res]
    pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads[:len(outs)]])
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    return [o.asnumpy() for o in outs], xs.grad.asnumpy(), grads


LAYER_CASES = [
    ("lstm", dict(num_layers=2, input_size=4), "TNC", True),
    ("lstm", dict(bidirectional=True, input_size=4), "TNC", False),
    ("gru", dict(layout="NTC", input_size=4), "NTC", True),
    ("gru", dict(num_layers=2, bidirectional=True, input_size=4), "TNC",
     True),
    ("rnn_relu", dict(input_size=4), "TNC", False),
    ("rnn_tanh", dict(num_layers=2, layout="NTC", input_size=4), "NTC",
     True),
]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_layer_matches_reference(case):
    """The port's layer holding the reference's weights: outputs, the
    returned states (when states are passed in), the input's and every
    parameter's gradient, by the reference's parameter names."""
    kind, kw, layout, with_states = case
    T, N, C, H = 5, 3, 4, 6
    ref, port = _pair(kind, H, **kw)
    load_mxnet_tpu_arrays(port, _ref_arrays(ref))
    rs = onp.random.RandomState(len(kw) + with_states)
    x = rs.standard_normal((T, N, C) if layout == "TNC" else (N, T, C)) \
        .astype(onp.float32)
    states = None
    if with_states:
        states = [rs.standard_normal(s.shape).astype(onp.float32)
                  for s in ref.begin_state(N)]
    out0 = ref(rmx.nd.array(x))
    heads = [rs.standard_normal(out0.shape).astype(onp.float32)] + \
        [rs.standard_normal(s.shape).astype(onp.float32)
         for s in (states or [])]
    r_outs, r_dx, r_g = _layer_run(rmx, ref, x, states, heads)
    with mx.cpu():
        p_outs, p_dx, p_g = _layer_run(mx, port, x, states, heads)
    assert len(p_outs) == len(r_outs)
    for p, r in zip(p_outs + [p_dx], r_outs + [r_dx]):
        assert p.shape == r.shape
        onp.testing.assert_allclose(p, r, **TOL)
    assert set(p_g) == set(r_g)
    for name in r_g:
        onp.testing.assert_allclose(p_g[name], r_g[name], **TOL)


def test_layer_parameter_names_and_round_trip():
    ref, port = _pair("lstm", 5, num_layers=2, bidirectional=True,
                      input_size=3, prefix="lstm0_")
    names = sorted(port.collect_params())
    assert names == sorted(ref.collect_params())
    assert "lstm0_r1_h2h_bias" in names
    load_mxnet_tpu_arrays(port, _ref_arrays(ref))
    back = arrays_from_port(port, prefix="lstm0_")
    for k, v in _ref_arrays(ref).items():
        onp.testing.assert_array_equal(back[k], v)


def test_deferred_input_size_takes_the_reference_arrays():
    """A layer built without input_size infers it at the first forward;
    given the reference's arrays first, it takes their shape."""
    rmx.random.seed(0)
    ref = rmx.gluon.rnn.LSTM(4)
    ref.initialize(rmx.init.Xavier())
    x = onp.random.RandomState(3).standard_normal((3, 2, 7)) \
        .astype(onp.float32)
    r = ref(rmx.nd.array(x)).asnumpy()
    with mx.cpu():
        port = mx.gluon.rnn.LSTM(4)
        port.initialize()
        fresh = mx.gluon.rnn.LSTM(4)
        fresh.initialize()
        assert fresh(mx.nd.array(x)).shape == (3, 2, 4)
        assert fresh.l0_i2h_weight.shape == (16, 7)
        load_mxnet_tpu_arrays(port, _ref_arrays(ref))
        assert port.l0_i2h_weight.shape == (16, 7)
        p = port(mx.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(p, r, **TOL)


def test_begin_state_and_repr():
    with mx.cpu():
        lstm = mx.gluon.rnn.LSTM(5, num_layers=2, bidirectional=True,
                                 input_size=3)
        states = lstm.begin_state(4, ctx=mx.cpu())
        gru = mx.gluon.rnn.GRU(5, input_size=3)
    assert [s.shape for s in states] == [(4, 4, 5), (4, 4, 5)]
    assert [i["shape"] for i in gru.state_info(2)] == [(1, 2, 5)]
    assert repr(lstm) == "LSTM(5, num_layers=2, layout=TNC, bidirectional)"
    with pytest.raises(mx.base.MXNetError, match="invalid layout"):
        mx.gluon.rnn.GRU(5, layout="CTN")


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn_relu"])
def test_layer_equals_unrolled_cell(kind):
    """The reference's own consistency check, in the port: the fused
    layer and the unrolled cell share gate math and parameters."""
    T, N, C, H = 5, 3, 4, 6
    x = onp.random.RandomState(0).standard_normal((T, N, C)) \
        .astype(onp.float32)
    with mx.cpu():
        mx.random.seed(0)
        layer = _layer(mx, kind, H, input_size=C)
        layer.initialize(mx.init.Xavier())
        cell = {"lstm": mx.gluon.rnn.LSTMCell, "gru": mx.gluon.rnn.GRUCell}[
            kind](H, input_size=C) if kind != "rnn_relu" else \
            mx.gluon.rnn.RNNCell(H, activation="relu", input_size=C)
        cell.initialize()
        for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(cell, k).set_data(getattr(layer, f"l0_{k}").data())
        out = layer(mx.nd.array(x)).asnumpy()
        outs, _ = cell.unroll(T, mx.nd.array(x), layout="TNC",
                              merge_outputs=True)
    onp.testing.assert_allclose(out, outs.asnumpy(), **TOL)


def test_hybridized_layer_equals_imperative():
    with mx.cpu():
        lstm = mx.gluon.rnn.LSTM(4, input_size=3)
        lstm.initialize()
        x = mx.nd.array(onp.random.RandomState(2).standard_normal((5, 2, 3)))
        ref = lstm(x).asnumpy()
        lstm.hybridize()
        out = lstm(x).asnumpy()
    onp.testing.assert_allclose(ref, out, **TOL)


def test_inter_layer_dropout_follows_training_mode():
    """Dropout between layers only under ``autograd.record()`` (training);
    inference is deterministic and equals a dropout-free layer; masks
    come from the seeded generator, so a reseed repeats them."""
    x = onp.random.RandomState(4).standard_normal((5, 2, 3)) \
        .astype(onp.float32)
    with mx.cpu():
        drop = mx.gluon.rnn.LSTM(4, num_layers=3, dropout=0.5, input_size=3)
        drop.initialize()
        plain = mx.gluon.rnn.LSTM(4, num_layers=3, input_size=3)
        plain.initialize()
        load_mxnet_tpu_arrays(plain, arrays_from_port(drop, "lstm9_"))
        a = drop(mx.nd.array(x)).asnumpy()
        b = drop(mx.nd.array(x)).asnumpy()
        c = plain(mx.nd.array(x)).asnumpy()
        outs = []
        for _ in range(2):
            mx.random.seed(11)
            with mx.autograd.record(train_mode=True):
                outs.append(drop(mx.nd.array(x)).asnumpy())
    onp.testing.assert_array_equal(a, b)
    onp.testing.assert_array_equal(a, c)
    onp.testing.assert_array_equal(outs[0], outs[1])
    assert not onp.allclose(outs[0], a)


# --------------------------------------------------------------------------- #
# the cells
# --------------------------------------------------------------------------- #

def _cells(pkg, case, C, H):
    """The cell of ``case``; every parameterized cell gets an explicit
    prefix, so both packages name its parameters alike whatever their
    name counters."""
    rnn = pkg.gluon.rnn
    if case == "lstm":
        return rnn.LSTMCell(H, input_size=C, prefix="a_")
    if case == "gru":
        return rnn.GRUCell(H, input_size=C, prefix="a_")
    if case == "rnn":
        return rnn.RNNCell(H, input_size=C, prefix="a_")
    if case == "sequential":
        stack = rnn.SequentialRNNCell(prefix="s_")
        stack.add(rnn.LSTMCell(H, input_size=C, prefix="a_"))
        stack.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H,
                                               prefix="b_")))
        stack.add(rnn.DropoutCell(0.0))
        return stack
    if case == "bidirectional":
        return rnn.BidirectionalCell(
            rnn.LSTMCell(H, input_size=C, prefix="l_"),
            rnn.GRUCell(H, input_size=C, prefix="r_"))
    if case == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(H, input_size=C, prefix="a_"),
                               0.5, 0.5)
    raise ValueError(case)


def _unroll_run(pkg, cell, x, layout, valid, head_rs):
    xs = pkg.nd.array(x)
    xs.attach_grad()
    vl = None if valid is None else pkg.nd.array(valid)
    with pkg.autograd.record(train_mode=False):
        outs, states = cell.unroll(x.shape[layout.find("T")], xs,
                                   layout=layout, merge_outputs=True,
                                   valid_length=vl)
        heads = [pkg.nd.array(h) for h in head_rs(
            [outs.shape] + [s.shape for s in states])]
        loss = (outs * heads[0]).sum()
        for s, h in zip(states, heads[1:]):
            loss = loss + (s * h).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in cell.collect_params().items()}
    return ([outs.asnumpy()] + [s.asnumpy() for s in states],
            xs.grad.asnumpy(), grads)


CELL_CASES = [("lstm", "NTC", True), ("gru", "TNC", True),
              ("rnn", "NTC", False), ("sequential", "TNC", True),
              ("bidirectional", "NTC", False), ("zoneout", "TNC", False)]


@pytest.mark.parametrize("case,layout,valid", CELL_CASES,
                         ids=[c[0] for c in CELL_CASES])
def test_unrolled_cell_matches_reference(case, layout, valid):
    """``unroll`` (with ``valid_length`` where given: states at each
    sequence's last valid step, outputs past it zero) against the
    reference's: outputs, states, the input's and every parameter's
    gradient (zoneout in inference mode, where it is its base cell)."""
    T, N, C, H = 6, 3, 4, 5
    rmx.random.seed(0)
    ref = _cells(rmx, case, C, H)
    ref.initialize(rmx.init.Xavier())
    with mx.cpu():
        port = _cells(mx, case, C, H)
        port.initialize()
    assert sorted(port.collect_params()) == sorted(ref.collect_params())
    load_mxnet_tpu_arrays(port, _ref_arrays(ref))
    rs = onp.random.RandomState(T + len(case))
    x = rs.standard_normal((N, T, C) if layout == "NTC" else (T, N, C)) \
        .astype(onp.float32)
    vl = onp.array([2, 4, 6], onp.float32) if valid else None
    hs = {}

    def head_rs(shapes):
        if not hs:
            hs["h"] = [rs.standard_normal(s).astype(onp.float32)
                       for s in shapes]
        return hs["h"]

    r_outs, r_dx, r_g = _unroll_run(rmx, ref, x, layout, vl, head_rs)
    with mx.cpu():
        p_outs, p_dx, p_g = _unroll_run(mx, port, x, layout, vl, head_rs)
    assert len(p_outs) == len(r_outs)
    for p, r in zip(p_outs + [p_dx], r_outs + [r_dx]):
        assert p.shape == r.shape
        onp.testing.assert_allclose(p, r, **TOL)
    for name in r_g:
        onp.testing.assert_allclose(p_g[name], r_g[name], **TOL)
    if valid:
        o = p_outs[0] if layout == "NTC" else p_outs[0].swapaxes(0, 1)
        assert abs(o[0, 2:]).max() == 0 and abs(o[1, 4:]).max() == 0
        assert abs(o[0, :2]).max() > 0


def test_step_cell_and_wrappers():
    """One step through a cell returns (out, states); the bidirectional
    cell refuses a step; zoneout in training keeps some previous
    values."""
    with mx.cpu():
        cell = mx.gluon.rnn.LSTMCell(4, input_size=3)
        cell.initialize()
        x = mx.nd.array(onp.ones((2, 3), onp.float32))
        out, states = cell(x, cell.begin_state(2))
        assert out.shape == (2, 4) and len(states) == 2
        bi = mx.gluon.rnn.BidirectionalCell(
            mx.gluon.rnn.LSTMCell(4, input_size=3),
            mx.gluon.rnn.LSTMCell(4, input_size=3))
        with pytest.raises(mx.base.MXNetError, match="use unroll"):
            bi(x, bi.begin_state(2))
        zone = mx.gluon.rnn.ZoneoutCell(cell, zoneout_outputs=0.5)
        mx.random.seed(3)
        with mx.autograd.record(train_mode=True):
            z1, _ = zone(x, cell.begin_state(2))
            z2, _ = zone(x, cell.begin_state(2))
        kept = (z2.asnumpy() == z1.asnumpy()) | (z2.asnumpy() == 0)
        assert kept.any()


# --------------------------------------------------------------------------- #
# the user's LSTM language model (tests/_torch_lstm_models.py)
# --------------------------------------------------------------------------- #

LM = dict(vocab_size=60, embed_size=16, hidden_size=16)


def _lm_pair(layers, dropout=0.0):
    from _torch_lstm_models import standard_lstm_lm

    rmx.random.seed(0)
    ref = standard_lstm_lm(rmx, num_layers=layers, dropout=dropout, **LM)
    ref.initialize(rmx.init.Xavier())
    with mx.cpu():
        port = standard_lstm_lm(mx, num_layers=layers, dropout=dropout, **LM)
        port.initialize()
    load_mxnet_tpu_arrays(port, _ref_arrays(ref))
    return ref, port


def _lm_batch(pkg, seed, T=7, N=3):
    rs = onp.random.RandomState(seed)
    data = rs.randint(0, LM["vocab_size"], (T + 1, N))
    return (pkg.nd.array(data[:-1], dtype="int32"),
            pkg.nd.array(data[1:], dtype="int32"))


def _recipe_step(pkg, net, clip):
    """One step of GluonNLP's word_language_model.py loop: the per-word
    loss over X.size, backward, ``clip_global_norm``, ``update(1)``."""
    from _torch_lstm_models import lm_loss

    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 20.0})
    params = [p for p in net.collect_params().values()]
    x, y = _lm_batch(pkg, 1)
    h, c = net.begin_state(3)
    with pkg.autograd.record():
        L, h, c = lm_loss(pkg, net)(x, y, h, c)
        L = L / x.size
    L.backward()
    grads = {p.name: p.grad().asnumpy() for p in params}
    trainer.allreduce_grads()
    norm = pkg.gluon.utils.clip_global_norm([p.grad() for p in params],
                                            clip)
    trainer.update(1)
    return (L.asnumpy(), h.asnumpy(), c.asnumpy(), norm, grads,
            {p.name: p.data().asnumpy() for p in params})


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_language_model_matches_reference(layers):
    """``standard_lstm_lm`` (tied decoder) in both packages from the
    reference's weights: the per-word losses, the new states, the global
    norm and every gradient of one recipe step, then the weights after
    the clip and the SGD update (lr 20)."""
    ref, port = _lm_pair(layers)
    r = _recipe_step(rmx, ref, 0.25)
    with mx.cpu():
        p = _recipe_step(mx, port, 0.25)
    for a, b in zip(p[:3], r[:3]):
        onp.testing.assert_allclose(a, b, **TOL)
    assert p[3] == pytest.approx(r[3], rel=1e-5)
    for name, g in r[4].items():
        onp.testing.assert_allclose(p[4][name.replace(ref.prefix,
                                                      port.prefix)], g,
                                    **TOL, err_msg=name)
    for name, w in r[5].items():
        onp.testing.assert_allclose(p[5][name.replace(ref.prefix,
                                                      port.prefix)], w,
                                    **TOL, err_msg=name)
    # the decoder shares the embedding's weight: one parameter
    assert sum(k.endswith("embedding0_weight") for k in p[5]) == 1


def test_lstm_language_model_fused_step_equals_phase_by_phase():
    """The fused step with the elementwise clip against ``record``,
    ``backward``, ``step`` with the same clip, the state carried: losses,
    states and weights equal on the CPU."""
    from _torch_lstm_models import lm_loss, standard_lstm_lm

    res = []
    with mx.cpu():
        for fused in (True, False):
            mx.random.seed(0)
            net = standard_lstm_lm(mx, num_layers=2, dropout=0.0, **LM)
            net.initialize(mx.init.Xavier(), seed=3)
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 20.0,
                                        "clip_gradient": 0.25})
            loss = lm_loss(mx, net)
            h, c = net.begin_state(3)
            out = []
            for step in range(3):
                x, y = _lm_batch(mx, 10 + step)
                if fused:
                    L, h, c = trainer.fused_step(loss, x, y, h, c,
                                                 batch_size=x.size)
                else:
                    with mx.autograd.record():
                        L, h, c = loss(x, y, h.detach(), c.detach())
                    L.backward()
                    trainer.step(x.size)
                out.append([L.asnumpy(), h.asnumpy(), c.asnumpy()])
            out.append([p.data().asnumpy()
                        for p in net.collect_params().values()])
            res.append(out)
    for a_step, b_step in zip(*res):
        for a, b in zip(a_step, b_step):
            onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_fused_lstm_on_card_equals_cpu():
    need_cuda()
    rs = onp.random.RandomState(5)
    arrays = _fused_arrays(rs, "lstm", 2, True, "NTC", T=35, N=20, C=64,
                           H=64)
    kwargs = dict(mode="lstm", num_layers=2, bidirectional=True,
                  layout="NTC")
    heads = None
    res = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            outs = mx.nd.fused_rnn([mx.nd.array(a) for a in arrays],
                                   **kwargs)
            if heads is None:
                heads = [rs.standard_normal(o.shape).astype(onp.float32)
                         for o in outs]
            res[ctx.device_type] = _run_op(mx, arrays, heads, kwargs)
    for p, r in zip(res["gpu"][0] + res["gpu"][1],
                    res["cpu"][0] + res["cpu"][1]):
        onp.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    assert torch.cuda.is_available()
