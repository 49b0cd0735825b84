"""``mxnet_tpu_torch.gluon.contrib`` (its layers and recurrent cells)
against ``mxnet_tpu.gluon.contrib``, f32 on the CPU, on the same seeded
numpy inputs, weights carried by ``models.load_mxnet_tpu_arrays``.

Tolerances: ``PixelShuffle*``, ``Identity`` and the concurrent blocks
move or copy values, so they are exact; the nine convolutional cells
(outputs and states after 3 unrolled steps, the gradients of the input
and of every weight and bias) and ``SparseEmbedding`` within 1e-5
(relative and absolute).  ``VariationalDropoutCell`` is held to the
reference at rate 0; at rate 0.5 its masks (drawn from the port's
dropout generator, not threefry bits) are checked to be the same at
every time step.  ``cuda``-marked: phase 26.3's checks at small sizes,
the card against the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.gluon.contrib import nn as pcnn
from mxnet_tpu_torch.gluon.contrib import rnn as pcrnn
from mxnet_tpu_torch.models import load_mxnet_tpu_arrays

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).standard_normal(shape).astype(
        onp.float32)


def _cpu(a):
    return mx.nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("ndim,factor,shape", [
    (1, 3, (2, 6, 5)), (2, 2, (1, 8, 3, 3)), (2, (2, 3), (2, 12, 2, 4)),
    (3, (2, 1, 2), (1, 8, 2, 3, 4))])
def test_pixel_shuffle_equals_the_reference(ndim, factor, shape):
    cls = f"PixelShuffle{ndim}D"
    x = _rand(ndim, *shape)
    ref = getattr(rmx.gluon.contrib.nn, cls)(factor)(rmx.nd.array(x))
    with mx.cpu():
        got = getattr(pcnn, cls)(factor)(_cpu(x))
    assert onp.array_equal(got.asnumpy(), ref.asnumpy())
    if ndim == 2 and isinstance(factor, int):
        want = torch.pixel_shuffle(torch.from_numpy(x), factor).numpy()
        assert onp.array_equal(got.asnumpy(), want)


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_concurrent_and_identity_equal_the_reference(hybrid):
    x = _rand(4, 3, 5)

    def build(pkg):
        c = pkg.gluon.contrib.nn
        blk = (c.HybridConcurrent if hybrid else c.Concurrent)(
            axis=1, prefix="conc_")
        with blk.name_scope():
            blk.add(c.Identity())
            blk.add(pkg.gluon.nn.Dense(4, in_units=5))
            blk.add(c.Identity())
        return blk

    ref = build(rmx)
    ref.initialize(rmx.init.Xavier())
    want = ref(rmx.nd.array(x)).asnumpy()
    arrays = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    with mx.cpu():
        port = build(mx)
    load_mxnet_tpu_arrays(port, arrays)
    with mx.cpu():
        got = port(_cpu(x)).asnumpy()
    assert got.shape == want.shape == (3, 14)
    onp.testing.assert_allclose(got, want, **TOL)
    assert onp.array_equal(got[:, :5], x) and onp.array_equal(got[:, 9:], x)
    assert pcnn.SyncBatchNorm is mx.gluon.nn.SyncBatchNorm


def test_sparse_embedding_equals_the_reference_with_a_row_sparse_grad():
    idx = onp.array([[1, 3, 3], [0, 7, 1]], onp.float32)
    head = _rand(9, 2, 3, 4)
    ref = rmx.gluon.contrib.nn.SparseEmbedding(10, 4, prefix="emb_")
    ref.initialize(rmx.init.Xavier())
    r_idx = rmx.nd.array(idx)
    with rmx.autograd.record():
        r_out = ref(r_idx)
    r_out.backward(rmx.nd.array(head))
    r_grad = ref.weight.grad().asnumpy()
    with mx.cpu():
        port = pcnn.SparseEmbedding(10, 4, prefix="emb_")
    load_mxnet_tpu_arrays(port, {"emb_weight": ref.weight.data().asnumpy()})
    with mx.cpu():
        with mx.autograd.record():
            p_out = port(_cpu(idx))
        p_out.backward(_cpu(head))
    onp.testing.assert_allclose(p_out.asnumpy(), r_out.asnumpy(), **TOL)
    g = port.weight.grad()
    assert g.stype == "row_sparse"
    assert g.indices.asnumpy().tolist() == [0, 1, 3, 7]
    onp.testing.assert_allclose(g.asnumpy(), r_grad, **TOL)
    onp.testing.assert_allclose(g.data.asnumpy(), r_grad[[0, 1, 3, 7]],
                                **TOL)
    # the trainer applies it as the reference's dense update
    tr = mx.gluon.Trainer(port.collect_params(), "sgd",
                          {"learning_rate": 0.5})
    before = port.weight.data().asnumpy()
    tr.step(1)
    onp.testing.assert_allclose(port.weight.data().asnumpy(),
                                before - 0.5 * r_grad, **TOL)


# (dims, input shape (C, *spatial)) of the nine cells
CELL_SHAPES = {1: (2, 7), 2: (2, 5, 6), 3: (2, 3, 4, 4)}
CELLS = [(d, kind) for d in (1, 2, 3) for kind in ("RNN", "LSTM", "GRU")]


def _cell(pkg, dims, kind):
    cls = getattr(pkg.gluon.contrib.rnn, f"Conv{dims}D{kind}Cell")
    return cls(CELL_SHAPES[dims], 3, i2h_kernel=3, h2h_kernel=3,
               i2h_pad=1, prefix="cell_")


def _unroll(pkg, cell, x, heads, T):
    xs = pkg.nd.array(x) if pkg is rmx else _cpu(x)
    xs.attach_grad()
    with pkg.autograd.record():
        out, states = cell.unroll(T, xs, layout="NTC", merge_outputs=True)
    hs = [pkg.nd.array(h) if pkg is rmx else _cpu(h) for h in heads]
    pkg.autograd.backward([out] + list(states), hs)
    grads = {k: p.grad().asnumpy() for k, p in
             cell.collect_params().items()}
    return ([out.asnumpy()] + [s.asnumpy() for s in states],
            xs.grad.asnumpy(), grads)


@pytest.mark.parametrize("dims,kind", CELLS,
                         ids=[f"Conv{d}D{k}Cell" for d, k in CELLS])
def test_conv_cell_equals_the_reference(dims, kind):
    T, N = 3, 2
    x = _rand(dims, N, T, *CELL_SHAPES[dims])
    rmx.random.seed(0)
    ref = _cell(rmx, dims, kind)
    ref.initialize(rmx.init.Xavier())
    arrays = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    n_states = 2 if kind == "LSTM" else 1
    state_shape = (N, 3) + CELL_SHAPES[dims][1:]
    heads = [_rand(10 + i, *((N, T) + state_shape[1:]) if i == 0
                   else state_shape) for i in range(1 + n_states)]
    r_vals, r_dx, r_grads = _unroll(rmx, ref, x, heads, T)
    with mx.cpu():
        port = _cell(mx, dims, kind)
    load_mxnet_tpu_arrays(port, arrays)
    with mx.cpu():
        p_vals, p_dx, p_grads = _unroll(mx, port, x, heads, T)
    assert sorted(p_grads) == sorted(r_grads)
    for p, r in zip(p_vals, r_vals):
        assert p.shape == r.shape
        onp.testing.assert_allclose(p, r, **TOL)
    onp.testing.assert_allclose(p_dx, r_dx, **TOL)
    for k in r_grads:
        onp.testing.assert_allclose(p_grads[k], r_grads[k], err_msg=k, **TOL)


def test_conv_cell_rules():
    with mx.cpu():
        with pytest.raises(mx.base.MXNetError, match="odd"):
            pcrnn.Conv2DRNNCell((3, 8, 8), 4, i2h_kernel=3, h2h_kernel=2)
        cell = pcrnn.Conv2DLSTMCell((3, 8, 8), 5, i2h_kernel=3, h2h_kernel=5)
    # no i2h padding: the state is the i2h convolution's output (6 x 6)
    assert cell.state_info(2)[0]["shape"] == (2, 5, 6, 6)
    assert type(cell).__name__ == "Conv2DLSTMCell"
    assert cell.i2h_weight.shape == (20, 3, 3, 3)
    assert cell.h2h_weight.shape == (20, 5, 5, 5)


def _vd(pkg, rate, prefix):
    base = pkg.gluon.rnn.LSTMCell(6, input_size=4, prefix=prefix)
    return pkg.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=rate, drop_states=rate, drop_outputs=rate)


def test_variational_dropout_at_rate_0_equals_the_reference():
    x = _rand(5, 2, 5, 4)
    ref = _vd(rmx, 0.0, "vd_")
    ref.initialize(rmx.init.Xavier())
    arrays = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    with rmx.autograd.record():
        r_out, r_states = ref.unroll(5, rmx.nd.array(x), layout="NTC")
    with mx.cpu():
        port = _vd(mx, 0.0, "vd_")
    load_mxnet_tpu_arrays(port, arrays)
    with mx.cpu():
        with mx.autograd.record():
            p_out, p_states = port.unroll(5, _cpu(x), layout="NTC")
    onp.testing.assert_allclose(p_out.asnumpy(), r_out.asnumpy(), **TOL)
    for p, r in zip(p_states, r_states):
        onp.testing.assert_allclose(p.asnumpy(), r.asnumpy(), **TOL)


def test_variational_dropout_shares_its_masks_across_steps():
    """At rate 0.5 in training the input mask is drawn once and reused
    at every step: with a constant input the masked input, and so the
    pattern of zeros it feeds, is the same at every step; after
    ``reset()`` a fresh mask is drawn."""
    mx.random.seed(3)
    with mx.cpu():
        cell = _vd(mx, 0.5, "vd_")
        cell.initialize(ctx=mx.cpu())
        seen = []
        inner = cell.base_cell
        hook = inner.register_forward_pre_hook(
            lambda blk, args: seen.append(args[0].asnumpy().copy()))
        x = mx.nd.ones((8, 5, 4), ctx=mx.cpu())
        with mx.autograd.record():
            cell.unroll(5, x, layout="NTC")
        masks = [s for s in seen]
        assert len(masks) == 5
        for m in masks[1:]:
            assert onp.array_equal(m, masks[0])
        assert set(onp.unique(masks[0])) <= {0.0, 2.0}
        assert 0 < (masks[0] == 0).mean() < 1
        cell.reset()
        seen.clear()
        with mx.autograd.record():
            cell.unroll(5, x, layout="NTC")
        assert not onp.array_equal(seen[0], masks[0])
        # outside training the cell is its base cell
        seen.clear()
        cell.unroll(2, x[:, :2], layout="NTC")
        assert onp.array_equal(seen[0], onp.ones((8, 4), onp.float32))
        hook.detach()


# --------------------------------------------------------------------------- #
# on the card: phase 26.3's checks at small sizes
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_contrib_layers_on_card_equal_cpu():
    need_cuda()
    x = _rand(1, 2, 4, 6, 8, 8)
    with mx.cpu():
        cpu = pcrnn.Conv2DLSTMCell((6, 8, 8), 8, i2h_kernel=5, h2h_kernel=5,
                                   i2h_pad=2, prefix="c_")
        cpu.initialize(mx.init.Xavier(), ctx=mx.cpu())
        want, _ = cpu.unroll(4, _cpu(x), layout="NTC", merge_outputs=True)
    card = pcrnn.Conv2DLSTMCell((6, 8, 8), 8, i2h_kernel=5, h2h_kernel=5,
                                i2h_pad=2, prefix="c_")
    load_mxnet_tpu_arrays(card, {k: p.data().asnumpy() for k, p in
                                 cpu.collect_params().items()})
    got, _ = card.unroll(4, mx.nd.array(x, ctx=mx.gpu(0)), layout="NTC",
                         merge_outputs=True)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                                atol=1e-4)
    y = _rand(2, 2, 12, 5, 5)
    with mx.cpu():
        ps_cpu = pcnn.PixelShuffle2D((2, 3))(_cpu(y)).asnumpy()
    ps_card = pcnn.PixelShuffle2D((2, 3))(mx.nd.array(y, ctx=mx.gpu(0)))
    assert onp.array_equal(ps_card.asnumpy(), ps_cpu)
