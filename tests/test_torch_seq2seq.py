"""The port's Transformer seq2seq (``mxnet_tpu_torch/models/seq2seq.py``)
against ``mxnet_tpu/models/seq2seq.py``: units 32, 4 heads, 2 + 2
layers, weights carried by ``models.seq2seq_from_mxnet_tpu``, seeded
numpy tokens, f32 on the CPU.

Tolerances: logits and every parameter's gradient within 1e-5 (relative
and absolute); at lengths past 512² scores, where the reference runs its
Pallas kernels in interpret mode and the port K1-K3's plain versions,
gradients within 1e-4, as ``tests/test_torch_attention_bwd.py``; the
parameters after one Adam step within 1e-6 (an element whose gradient
is rounding noise within Adam's step bound);
``greedy_decode``'s tokens equal.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.models import (Seq2SeqConfig, arrays_from_port,
                                    seq2seq_from_mxnet_tpu)

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=50, units=32, hidden_size=64, num_heads=4,
             num_enc_layers=2, num_dec_layers=2, max_length=16,
             dropout=0.0)


def _ref(seed=0, **over):
    from mxnet_tpu.models import TransformerSeq2Seq

    rmx.random.seed(seed)
    net = TransformerSeq2Seq(**{**SMALL, **over})
    net.initialize(rmx.init.Xavier())
    return net


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port(ref, **over):
    return seq2seq_from_mxnet_tpu({**SMALL, **over}, _arrays(ref),
                                  device="cpu")


def _tokens(seed, B, Ls, Lt, V=50):
    rs = onp.random.RandomState(seed)
    return (rs.randint(3, V, (B, Ls)).astype(onp.int32),
            rs.randint(3, V, (B, Lt)).astype(onp.int32))


def _src_mask(lengths, Ls):
    """(B, 1, 1, Ls) additive key mask: -1e30 at padding."""
    pos = onp.arange(Ls)[None, :]
    m = onp.where(pos >= onp.asarray(lengths)[:, None], -1e30, 0.0)
    return m.reshape(len(lengths), 1, 1, Ls).astype(onp.float32)


def _forward_grads(pkg, net, src, tgt, mask, head):
    args = [pkg.nd.array(src, dtype="int32"), pkg.nd.array(tgt, dtype="int32")]
    if mask is not None:
        args.append(pkg.nd.array(mask))
    with pkg.autograd.record():
        logits = net(*args)
        loss = (logits * pkg.nd.array(head)).sum()
    loss.backward()
    # keyed below ``net.prefix``: each package's name counter moves with
    # every model the process has built before
    grads = {k[len(net.prefix):]: p.grad().asnumpy()
             for k, p in net.collect_params().items()}
    return logits.asnumpy(), grads


CASES = [("tied_masked", True, True), ("tied", True, False),
         ("free_masked", False, True), ("free", False, False)]


@pytest.mark.parametrize("cid,tie,masked", CASES,
                         ids=[c[0] for c in CASES])
def test_logits_and_gradients_match_reference(cid, tie, masked):
    ref = _ref(tie_embeddings=tie)
    port = _port(ref, tie_embeddings=tie)
    src, tgt = _tokens(1, 3, 9, 7)
    mask = _src_mask([9, 5, 2], 9) if masked else None
    head = onp.random.RandomState(2).standard_normal((3, 7, 50)) \
        .astype(onp.float32)
    r_logits, r_g = _forward_grads(rmx, ref, src, tgt, mask, head)
    with mx.cpu():
        p_logits, p_g = _forward_grads(mx, port, src, tgt, mask, head)
    assert p_logits.shape == r_logits.shape == (3, 7, 50)
    onp.testing.assert_allclose(p_logits, r_logits, **TOL)
    assert set(p_g) == set(r_g)
    for name, g in r_g.items():
        onp.testing.assert_allclose(p_g[name], g, **TOL, err_msg=name)


def test_long_lengths_reach_the_kernel_path():
    """Source 640 and target 420 tokens: every attention is past 512²
    scores with the key mask (cross-attention 420 x 640, Lq != Lk), so
    the port takes ``_FlashAttention`` (K1-K3's plain versions on the
    CPU) and the reference its Pallas kernels."""
    over = dict(num_enc_layers=1, num_dec_layers=1, max_length=640)
    ref = _ref(**over)
    port = _port(ref, **over)
    src, tgt = _tokens(3, 1, 640, 420)
    mask = _src_mask([600], 640)
    head = onp.random.RandomState(4).standard_normal((1, 420, 50)) \
        .astype(onp.float32)
    r_logits, r_g = _forward_grads(rmx, ref, src, tgt, mask, head)
    from mxnet_tpu_torch.ops import attention as pattn

    before = pattn.flash_fwd.launches if hasattr(pattn.flash_fwd,
                                                 "launches") else None
    with mx.cpu():
        p_logits, p_g = _forward_grads(mx, port, src, tgt, mask, head)
    onp.testing.assert_allclose(p_logits, r_logits, **LONG_TOL)
    for name, g in r_g.items():
        onp.testing.assert_allclose(p_g[name], g, **LONG_TOL, err_msg=name)
    assert before is None or pattn.flash_fwd.launches == before


def test_parameter_names_and_round_trip():
    ref = _ref()
    port = _port(ref)
    r_names = [k.split("_", 1)[1] for k in ref.collect_params()]
    p_names = [k.split("_", 1)[1] for k in port.collect_params()]
    assert sorted(p_names) == sorted(r_names)
    assert "dec_layer1_cross_kv_weight" in p_names
    back = arrays_from_port(port, prefix="transformerseq2seq0_")
    for (k, v), (k2, v2) in zip(sorted(_arrays(ref).items()),
                                sorted(back.items())):
        assert k.split("_", 1)[1] == k2.split("_", 1)[1]
        onp.testing.assert_array_equal(v, v2)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "free"])
def test_greedy_decode_tokens_equal(tie):
    ref = _ref(seed=3, tie_embeddings=tie)
    port = _port(ref, tie_embeddings=tie)
    src, _ = _tokens(5, 4, 7, 1)
    r = ref.greedy_decode(rmx.nd.array(src, dtype="int32"), max_len=8,
                          bos=1, eos=2)
    with mx.cpu():
        p = port.greedy_decode(mx.nd.array(src, dtype="int32"), max_len=8,
                               bos=1, eos=2)
    assert p.dtype == onp.int32 and p.shape == r.shape
    onp.testing.assert_array_equal(p, r)


@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_greedy_decode_places_numpy_sources(device):
    """A numpy source is placed on the model's device: a model on
    ``device`` decodes it to the tokens that the same weights on the CPU
    give for an NDArray source (one seeded port model, no JAX)."""
    if device == "cuda":
        need_cuda()
    with mx.cpu():
        mx.random.seed(0)
        cpu = Seq2SeqConfig(**SMALL).make()
        cpu.initialize(mx.init.Xavier())
    net = seq2seq_from_mxnet_tpu(
        SMALL, arrays_from_port(cpu, prefix="transformerseq2seq0_"),
        device=device)
    src, _ = _tokens(5, 4, 7, 1)
    with mx.cpu():
        want = cpu.greedy_decode(mx.nd.array(src, dtype="int32"), max_len=8)
    with (mx.gpu(0) if device == "cuda" else mx.cpu()):
        got = net.greedy_decode(src, max_len=8)
    onp.testing.assert_array_equal(got, want)


def test_greedy_decode_pins_finished_rows_to_eos():
    """A row that emitted ``eos`` stays at ``eos``; decoding stops once
    every row has finished (the reference's loop), checked with an
    ``eos`` that the model emits."""
    ref = _ref(seed=3)
    port = _port(ref)
    src, _ = _tokens(5, 4, 7, 1)
    with mx.cpu():
        first = port.greedy_decode(mx.nd.array(src, dtype="int32"),
                                   max_len=8)
        eos = int(first[0, 2])
        out = port.greedy_decode(mx.nd.array(src, dtype="int32"),
                                 max_len=8, eos=eos)
    r = ref.greedy_decode(rmx.nd.array(src, dtype="int32"), max_len=8,
                          eos=eos)
    onp.testing.assert_array_equal(out, r)
    for row in out:
        hit = onp.flatnonzero(row[1:] == eos)
        if hit.size:
            assert (row[1 + hit[0]:] == eos).all()


def _adam_step(pkg, net, src, tgt_in, tgt_out, fused):
    """(loss, gradients, weights after the step), keyed by the names
    below the model's own prefix (so two packages' nets pair up however
    many models each has made before)."""
    n = len(net.prefix)
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 3e-3})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    args = (pkg.nd.array(src, dtype="int32"),
            pkg.nd.array(tgt_in, dtype="int32"), pkg.nd.array(tgt_out))
    grads = None
    if fused:
        def step_loss(s, ti, to):
            return loss_fn(net(s, ti), to)
        loss = trainer.fused_step(step_loss, *args)
    else:
        with pkg.autograd.record():
            loss = loss_fn(net(args[0], args[1]), args[2])
        loss.backward()
        grads = {k[n:]: p.grad().asnumpy()
                 for k, p in net.collect_params().items()}
        trainer.step(src.shape[0])
    return loss.asnumpy(), grads, {k[n:]: p.data().asnumpy()
                                   for k, p in net.collect_params().items()}


# Adam's first step is lr * |g| / (|g| + eps / sqrt(1 - beta2)) in MXNet's
# form (eps / sqrt(1 - beta2) = 3.2e-7 here), so for a gradient within a
# few decades of that it moves with the gradient's last digits, which
# the two packages sum in other orders; a key bias's gradient is pure
# rounding noise (softmax does not see a constant added to a row of
# scores).  Such elements are held to the step bound instead.
NOISE_GRAD = 1e-5


@pytest.mark.parametrize("fused", [False, True], ids=["step", "fused_step"])
def test_one_adam_step_matches_reference(fused):
    """One Adam step (the reference's copy-task recipe) through
    ``Trainer.step`` or ``Trainer.fused_step``: the loss within 1e-5 and
    every parameter within 1e-6 of the reference's step; an element
    whose reference gradient is below ``NOISE_GRAD`` within Adam's step
    bound ``lr`` of its start."""
    ref = _ref()
    port = _port(ref)
    start = {k[len(ref.prefix):]: a for k, a in _arrays(ref).items()}
    seq = onp.random.RandomState(0).randint(3, 50, (4, 7))
    tgt_in = onp.concatenate([onp.ones((4, 1)), seq[:, :-1]], 1)
    r_loss, r_g, r_w = _adam_step(rmx, ref, seq, tgt_in,
                                  seq.astype(onp.float32), False)
    with mx.cpu():
        p_loss, _, p_w = _adam_step(mx, port, seq, tgt_in,
                                    seq.astype(onp.float32), fused)
    onp.testing.assert_allclose(p_loss, r_loss, **TOL)
    noisy = 0
    for name, w in r_w.items():
        p = p_w[name].copy()
        noise = abs(r_g[name]) < NOISE_GRAD
        noisy += int((noise & (r_g[name] != 0)).sum())
        assert (abs(p - start[name])[noise] <= 3e-3 * (1 + 1e-5)).all()
        p[noise] = w[noise]
        onp.testing.assert_allclose(p, w, rtol=0, atol=1e-6, err_msg=name)
    total = sum(w.size for w in r_w.values())
    assert noisy < 0.01 * total, (noisy, total)


def test_copy_task_learns_like_the_reference():
    """The reference's ``test_seq2seq_learns_copy_task`` in the port:
    the loss falls below 0.6 of the first within 25 Adam steps."""
    with mx.cpu():
        mx.random.seed(0)
        net = Seq2SeqConfig(**SMALL).make()
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 3e-3})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        seq = onp.random.RandomState(0).randint(3, 50, (4, 7))
        src = mx.nd.array(seq, dtype="int32")
        tgt_in = mx.nd.array(onp.concatenate([onp.ones((4, 1)),
                                              seq[:, :-1]], 1),
                             dtype="int32")
        tgt_out = mx.nd.array(seq.astype(onp.float32))
        losses = []
        for _ in range(25):
            with mx.autograd.record():
                L = loss_fn(net(src, tgt_in), tgt_out)
            L.backward()
            trainer.step(4)
            losses.append(float(L.mean().asnumpy()))
        dec = net.greedy_decode(src, max_len=8, bos=1, eos=2)
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])
    assert dec.shape[0] == 4 and dec[0, 0] == 1


def test_too_long_a_sequence_raises():
    with mx.cpu():
        net = Seq2SeqConfig(**SMALL).make()
        net.initialize()
        src, tgt = _tokens(0, 1, 17, 3)
        with pytest.raises(mx.base.MXNetError, match="max_length 16"):
            net(mx.nd.array(src, dtype="int32"),
                mx.nd.array(tgt, dtype="int32"))


def test_transformer_big_is_the_papers_configuration():
    from mxnet_tpu_torch.models import transformer_big

    with mx.cpu():
        net, cfg = transformer_big(num_enc_layers=1, num_dec_layers=1,
                                   vocab_size=100, max_length=8)
    assert (cfg.units, cfg.hidden_size, cfg.num_heads, cfg.dropout) == \
        (1024, 4096, 16, 0.3)
    assert Seq2SeqConfig().vocab_size == 37000
    assert net.collect_params()[net.prefix + "dec_layer0_ffn_fc1_weight"] \
        .shape == (4096, 1024)


def test_dropout_is_active_only_in_training():
    """With dropout, inference calls repeat bit for bit and equal the
    dropout-free model; a training call draws masks from the seeded
    generator (a reseed repeats it)."""
    ref = _ref()
    with mx.cpu():
        drop = seq2seq_from_mxnet_tpu({**SMALL, "dropout": 0.3},
                                      _arrays(ref), device="cpu")
        plain = _port(ref)
        src, tgt = _tokens(1, 2, 9, 7)
        a = drop(mx.nd.array(src, dtype="int32"),
                 mx.nd.array(tgt, dtype="int32")).asnumpy()
        b = plain(mx.nd.array(src, dtype="int32"),
                  mx.nd.array(tgt, dtype="int32")).asnumpy()
        outs = []
        for _ in range(2):
            mx.random.seed(7)
            with mx.autograd.record():
                outs.append(drop(mx.nd.array(src, dtype="int32"),
                                 mx.nd.array(tgt, dtype="int32")).asnumpy())
    onp.testing.assert_array_equal(a, b)
    onp.testing.assert_array_equal(outs[0], outs[1])
    assert not onp.allclose(outs[0], a)


@pytest.mark.cuda
def test_seq2seq_on_card_equals_cpu():
    """f32 logits and gradients on the card (K1-K3 at 640 x 640 source
    and 420 x 640 cross attention) against the CPU at the small
    widths, from one seeded port model (no JAX on the card's machine)."""
    need_cuda()
    over = dict(num_enc_layers=1, num_dec_layers=1, max_length=640)
    with mx.cpu():
        mx.random.seed(0)
        cpu = Seq2SeqConfig(**{**SMALL, **over}).make()
        cpu.initialize(mx.init.Xavier())
    arrays = arrays_from_port(cpu, prefix="transformerseq2seq0_")
    card = seq2seq_from_mxnet_tpu({**SMALL, **over}, arrays, device="cuda")
    src, tgt = _tokens(3, 2, 640, 420)
    mask = _src_mask([600, 533], 640)
    head = onp.random.RandomState(4).standard_normal((2, 420, 50)) \
        .astype(onp.float32)
    res = []
    for ctx, net in ((mx.gpu(0), card), (mx.cpu(), cpu)):
        with ctx:
            res.append(_forward_grads(mx, net, src, tgt, mask, head))
    onp.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-4, atol=1e-4)
    # both are keyed below their net's prefix (``_forward_grads``)
    card_g = res[0][1]
    assert sorted(card_g) == sorted(res[1][1])
    for name, g in res[1][1].items():
        onp.testing.assert_allclose(card_g[name], g,
                                    rtol=1e-4, atol=1e-4, err_msg=name)
    assert torch.cuda.is_available()
