"""``parallel.SPMDTrainer`` of the PyTorch port as one program a step,
against the JAX package's, on the CPU.

- bf16 weights without f32 masters (SGD with momentum at lr 0.1, and
  AdamW at lr 1e-4), three steps of a tiny GPT: each weight within 2
  bf16 steps of its array's largest magnitude of the reference's (the
  reference's traced f32 ``lr`` promotes the update to f32 before the
  rounding back; the port's device ``lr`` does the same through
  ``fused_step_apply``).  The arrays that start at zero (biases,
  LayerNorm's beta) are sums over every token in their gradient, whose
  order differs between XLA and PyTorch, so they are held to 2 bf16
  steps of the net's largest weight instead.  Adam's first step moves
  an element by lr times its gradient's sign, so a near-zero gradient
  whose sign the two summation orders flip moves by 2 lr: at lr 1e-4
  that stays under 2 bf16 steps of the weights.  Losses within 2e-2
  relative (bf16 forward);
- the bf16 update alone, ulp for ulp: a bias-free Dense layer (the
  probe) fed the identity, whose loss (the sum of its output times the
  label) makes each step's gradient the label over the batch exactly
  in both packages, so no summation order enters.  Three SGD steps at
  lr 0.1 with momentum and wd (0, 0), (0.5, 0) and ``chip_smoke.py``
  phase 14's (0.9, 1e-4): every weight and momentum element equal to
  the reference's, 0 bf16 steps apart (the reference's Python momentum
  and wd are turned into bf16 first, JAX's weak types, and XLA keeps
  the momentum's product in f32: ``SGD._spmd_rule``); and phase 14's
  plain-loop update, ``chip_smoke.reference_sgd``, equal to the
  reference's trainer the same way;
- a Gluon net with BatchNorm, its weights carried by
  ``save_parameters``: after two SGD steps the frozen running statistics
  and every weight within 1e-5 of their array's largest magnitude, the
  losses within 1e-5 relative;
- ``run_steps`` at dropout 0.1 equals N ``step`` calls bit for bit
  (``random.seed`` gives both the same keys), at T = 64 (plain
  attention) and T = 576 (K1-K3's plain versions);
- a ``step_hlo_op_count`` call in the middle of a run leaves its losses
  and weights unchanged, bit for bit;
- on the card (``cuda``): the captured step against the program's own
  function run eagerly, bit for bit, ``run_steps`` as replays, and a
  ``step_hlo_op_count`` call after the capture leaving the run
  unchanged.

The bit-for-bit comparisons run on one CPU thread: the CPU's threaded
reductions (the embedding's backward among them) are not reproducible
from run to run at these sizes with several threads."""
import numpy as onp
import pytest
import torch

from _torch_parity import jax_gpt, need_cuda, port_gpt
from mxnet_tpu_torch import gluon as pgluon
from mxnet_tpu_torch import parallel as pparallel
from mxnet_tpu_torch import random as prandom
from mxnet_tpu_torch.models import arrays_from_port, gpt2_small

BF16_STEPS = 2
BF16_EPS = 2.0 ** -7            # one bf16 step at 1.0
TINY = dict(vocab_size=97, max_length=640, num_layers=1, units=32,
            num_heads=2, hidden_size=64)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_device_mesh():
    import jax
    from mxnet_tpu import parallel

    return parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _tokens(B, T, seed, vocab=97):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, vocab, (B, T)).astype(onp.int32),
            rs.randint(0, vocab, (B, T)).astype(onp.int32))


OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        "adamw": {"learning_rate": 1e-4, "wd": 0.01}}


@pytest.mark.parametrize("opt", list(OPTS))
def test_bf16_without_masters_matches_jax(opt):
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel

    net = jax_gpt(init=0.02)
    model = port_gpt(net).to(torch.bfloat16)
    net.cast("bfloat16")
    data, label = _tokens(2, 32, 5)
    jtr = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               opt, dict(OPTS[opt]),
                               mesh=_one_device_mesh())
    ptr = pparallel.SPMDTrainer(model, pgluon.loss.SoftmaxCrossEntropyLoss(),
                                opt, dict(OPTS[opt]))
    ref = [float(jtr.step(mx.nd.array(data, dtype="int32"),
                          mx.nd.array(label, dtype="int32")).asnumpy())
           for _ in range(3)]
    got = [float(ptr.step(torch.as_tensor(data), torch.as_tensor(label)))
           for _ in range(3)]
    onp.testing.assert_allclose(got, ref, rtol=2e-2)
    want = {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in net.collect_params().items()}
    have = arrays_from_port(model, prefix=net.prefix)
    assert sorted(have) == sorted(want)
    net_scale = max(float(onp.abs(r).max()) for r in want.values())
    for k, r in want.items():
        from_zero = k.endswith(("bias", "beta"))
        scale = net_scale if from_zero else float(onp.abs(r).max())
        tol = BF16_STEPS * BF16_EPS * scale
        err = float(onp.abs(onp.asarray(have[k], onp.float32) - r).max())
        assert err <= tol, f"{opt} {k}: {err} > {tol} " \
            f"({err / tol * BF16_STEPS:.2f} bf16 steps)"


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 steps of two bf16-valued arrays (the
    bit patterns mapped onto one monotone integer line)."""
    def line(x):
        bits = (onp.asarray(x, onp.float32).view(onp.uint32) >> 16) \
            .astype(onp.int64)
        return onp.where(bits & 0x8000, 0x8000 - bits, bits)

    return onp.abs(line(a) - line(b))


PROBE_B, PROBE_UNITS = 16, 8


def _probe_inputs():
    """The bias-free Dense layer's weights (rows of magnitudes 2^-6 to
    2^2), three labels and the identity batch."""
    rs = onp.random.RandomState(11)
    w0 = (rs.standard_normal((PROBE_UNITS, PROBE_B))
          * 2.0 ** rs.randint(-6, 3, (PROBE_UNITS, 1))).astype(onp.float32)
    labels = rs.standard_normal((3, PROBE_B, PROBE_UNITS)).astype(onp.float32)
    return w0, labels, onp.eye(PROBE_B, dtype=onp.float32)


def _probe_jax(opt):
    """Three steps of the reference's SPMDTrainer on the probe in bf16;
    its weight and (with momentum) its momentum state."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel

    w0, labels, x = _probe_inputs()
    net = gluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B)
    net.initialize()
    net.weight.set_data(mx.nd.array(w0))
    net.cast("bfloat16")
    tr = parallel.SPMDTrainer(
        net, lambda out, label: (out * label).sum(axis=1), "sgd",
        dict(opt), mesh=parallel.make_mesh({"dp": 1},
                                           devices=jax.devices()[:1]))
    for g in labels:
        tr.step(mx.nd.array(x).astype("bfloat16"),
                mx.nd.array(g).astype("bfloat16"))
    state = onp.asarray(tr._opt_states[0], onp.float32) \
        if opt["momentum"] else None
    return net.weight.data().asnumpy(), state


def _probe_port(opt):
    """The same three steps through the port's SPMDTrainer."""
    import mxnet_tpu_torch as pmx

    w0, labels, x = _probe_inputs()
    port = pgluon.nn.Dense(PROBE_UNITS, use_bias=False, in_units=PROBE_B,
                           device="cpu")
    port.initialize()
    port.weight.set_data(pmx.nd.array(w0, ctx=pmx.cpu()))
    port.cast("bfloat16")
    tr = pparallel.SPMDTrainer(
        port, lambda out, label: (out * label).sum(dim=1), "sgd", dict(opt))
    for g in labels:
        tr.step(torch.as_tensor(x).bfloat16(), torch.as_tensor(g).bfloat16())
    state = tr._states[0].float().numpy() if opt["momentum"] else None
    return port.weight.data().asnumpy(), state


def _assert_same_bf16(want, have):
    for a, b in zip(want, have):
        if a is None:
            continue
        ulps = _bf16_ulps(a, b)
        assert ulps.max() == 0, \
            f"{int((ulps > 0).sum())} of {ulps.size} elements differ, " \
            f"up to {int(ulps.max())} bf16 steps"


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.5, 0.0),
                                         (0.9, 1e-4)])
def test_bf16_update_matches_jax_ulp_for_ulp(momentum, wd):
    opt = {"learning_rate": 0.1, "momentum": momentum, "wd": wd}
    _assert_same_bf16(_probe_jax(opt), _probe_port(opt))


def test_smoke_reference_sgd_matches_the_reference_trainer():
    """``chip_smoke.reference_sgd``, the update of phase 14's plain loop,
    against the reference's SPMDTrainer at phase 14's SGD (lr 0.1,
    momentum 0.9, wd 1e-4) on the probe's exact gradients (the label
    over the batch), three steps, 0 bf16 steps apart."""
    import chip_smoke

    opt = dict(chip_smoke.RESNET_OPT)
    w0, labels, _ = _probe_inputs()
    p = torch.as_tensor(w0).bfloat16()
    m = torch.zeros_like(p)
    for label in labels:
        g = (torch.as_tensor(label).bfloat16() / PROBE_B).t()
        chip_smoke.reference_sgd(p, g, m, opt["learning_rate"],
                                 opt["momentum"], opt["wd"])
    _assert_same_bf16(_probe_jax(opt), (p.float().numpy(), m.float().numpy()))


def _bn_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.BatchNorm(), nn.Dense(4))
    return net


def _by_structure(net):
    return {k: p.data().asnumpy().astype(onp.float32)
            for k, p in net._collect_params_with_prefix().items()}


def test_batchnorm_running_statistics_match_jax(tmp_path):
    import mxnet_tpu as mx
    from mxnet_tpu import gluon, parallel
    import mxnet_tpu_torch as pmx

    rs = onp.random.RandomState(4)
    x = rs.rand(32, 8).astype(onp.float32)
    y = rs.randint(0, 4, 32).astype(onp.float32)
    mx.random.seed(0)
    net = _bn_net(mx)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(x))
    f = str(tmp_path / "bn.params")
    net.save_parameters(f)
    with pmx.cpu():
        port = _bn_net(pmx)
    port.load_parameters(f, ctx=pmx.cpu())
    start = _by_structure(port)
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    jtr = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", dict(opt), mesh=_one_device_mesh())
    ptr = pparallel.SPMDTrainer(port, pgluon.loss.SoftmaxCrossEntropyLoss(),
                                "sgd", dict(opt))
    ref = [float(jtr.step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
           for _ in range(2)]
    got = [float(ptr.step(torch.as_tensor(x), torch.as_tensor(y)))
           for _ in range(2)]
    onp.testing.assert_allclose(got, ref, rtol=1e-5)
    want, have = _by_structure(net), _by_structure(port)
    assert sorted(want) == sorted(have)
    moved = [k for k in want if "running" in k]
    assert len(moved) == 2
    for k in moved:                     # the frozen statistics moved
        assert not onp.array_equal(have[k], start[k])
    for k, r in want.items():
        onp.testing.assert_allclose(
            have[k], r, rtol=0, atol=1e-5 * float(onp.abs(r).max()),
            err_msg=k)


def _dropout_gpt(T):
    model, _ = gpt2_small(device="cpu", dropout=0.1,
                          **dict(TINY, max_length=max(T, 64)))
    model.initialize(0.02, seed=0)
    return model


def _trainer(model):
    return pparallel.SPMDTrainer(model,
                                 pgluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw", {"learning_rate": 1e-2})


@pytest.mark.parametrize("T", [64, 576])
def test_run_steps_with_dropout_equals_steps(one_thread, T):
    data, label = (torch.as_tensor(a) for a in _tokens(3, T, 7))
    data, label = data[:, None], label[:, None]         # 3 steps of 1 row
    prandom.seed(21)
    a = _dropout_gpt(T)
    losses = _trainer(a).run_steps(data, label)
    prandom.seed(21)
    b = _dropout_gpt(T)
    tb = _trainer(b)
    ref = torch.stack([tb.step(data[i], label[i]) for i in range(3)])
    assert losses.shape == (3,)
    assert torch.equal(losses, ref)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    # dropout draws: another seed, other losses
    prandom.seed(22)
    c = _dropout_gpt(T)
    assert not torch.equal(_trainer(c).run_steps(data, label), losses)


def test_step_hlo_op_count_leaves_the_run_unchanged(one_thread):
    data, label = (torch.as_tensor(a) for a in _tokens(1, 64, 8))
    prandom.seed(3)
    a = _dropout_gpt(64)
    ta = _trainer(a)
    got = [ta.step(data, label)]
    n = ta.step_hlo_op_count(data, label)
    got += [ta.step(data, label) for _ in range(2)]
    assert n == ta.step_hlo_op_count(data, label) and n > 100
    prandom.seed(3)
    b = _dropout_gpt(64)
    tb = _trainer(b)
    ref = [tb.step(data, label) for _ in range(3)]
    assert torch.equal(torch.stack(got), torch.stack(ref))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert ta.optimizer.num_update == 3


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #

def _card_gpt(dropout, dtype=torch.bfloat16):
    model, _ = gpt2_small(dropout=dropout, dtype=dtype,
                          **dict(TINY, units=128, num_heads=2,
                                 hidden_size=256, num_layers=2))
    model.initialize(0.02, seed=0)
    return model


@pytest.mark.cuda
def test_captured_step_equals_eager_on_card():
    """Three bare replays of the captured step (its graph made by
    ``step_hlo_op_count``) against three eager calls of the program's
    own function, from the same weights and keys at dropout 0.1 and
    T = 576 (K1-K3): equal losses and weights bit for bit."""
    need_cuda()
    data, label = (torch.as_tensor(a, device="cuda")
                   for a in _tokens(2, 576, 9))
    runs = []
    for arm in ("eager", "captured"):
        model = _card_gpt(0.1)
        tr = _trainer(model)
        prandom.seed(4)
        if arm == "eager":
            losses = [tr._prepare(data[None], label[None], None).run()[0][0]
                      .clone() for _ in range(3)]
        else:
            assert tr.step_hlo_op_count(data, label) > 100
            losses = [tr.step(data, label) for _ in range(3)]
            (prog,) = tr._programs.values()
            assert prog.replays == 3 and prog.calls == 3
        runs.append((torch.stack(losses), list(model.parameters())))
    assert torch.equal(runs[0][0], runs[1][0])
    for p, q in zip(runs[0][1], runs[1][1]):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_run_steps_replays_on_card():
    """``run_steps`` over 4 steps: the eager call, the capture, then
    bare replays, equal to 4 ``step`` calls bit for bit; with lr 0 two
    replays at dropout 0.1 give different losses (f32)."""
    need_cuda()
    data, label = (torch.as_tensor(a, device="cuda")
                   for a in _tokens(2, 576, 10))
    out = []
    for arm in ("run", "steps"):
        prandom.seed(5)
        model = _card_gpt(0.1)
        tr = _trainer(model)
        if arm == "run":
            losses = tr.run_steps(data[None].expand(4, -1, -1),
                                  label[None].expand(4, -1, -1))
            (prog,) = tr._programs.values()
            assert prog.calls == 2 and prog.replays == 3
        else:
            losses = torch.stack([tr.step(data, label) for _ in range(4)])
        out.append((losses, list(model.parameters())))
    assert torch.equal(out[0][0], out[1][0])
    for p, q in zip(out[0][1], out[1][1]):
        assert torch.equal(p, q)
    # an f32 loss resolves a new mask (a bf16 one rounds it away)
    model = _card_gpt(0.1, torch.float32)
    tr = _trainer(model)
    tr.set_learning_rate(0.0)
    a, b, c = (tr.step(data, label) for _ in range(3))
    assert not torch.equal(b, c)


@pytest.mark.cuda
def test_step_hlo_op_count_after_capture_on_card():
    """Once the step graph exists, ``step_hlo_op_count`` captures a copy
    with its nodes kept: the program keeps its own plain graph, and the
    steps after the call equal those of a run without it, losses and
    weights bit for bit, at dropout 0.1 and T = 576 (K1-K3)."""
    need_cuda()
    data, label = (torch.as_tensor(a, device="cuda")
                   for a in _tokens(2, 576, 11))
    out = []
    for count in (False, True):
        prandom.seed(6)
        model = _card_gpt(0.1)
        tr = _trainer(model)
        losses = [tr.step(data, label) for _ in range(2)]
        (prog,) = tr._programs.values()
        graph = prog.graph
        if count:
            assert tr.step_hlo_op_count(data, label) > 100
            assert prog.graph is graph and not prog.graph_debug
        losses += [tr.step(data, label) for _ in range(2)]
        out.append((torch.stack(losses), list(model.parameters())))
    assert torch.equal(out[0][0], out[1][0])
    for p, q in zip(out[0][1], out[1][1]):
        assert torch.equal(p, q)
