"""The optimizers of the PyTorch port against the JAX package's update
rules: every registered optimizer but SGLD (SGD with and without
momentum, NAG, Signum, DCASGD, RMSProp plain and centered, AdaGrad,
AdaDelta, Adam, AdamW, Nadam, FTML, Ftrl, LAMB with and without its
bounds, LARS) over five steps of ``update_multi_precision``, with weight decay, gradient clipping,
``rescale_grad``, per-index ``lr_mult``/``wd_mult`` and multi-precision
bf16 weights (f32 master copies).

Tolerances: f32 weights, states and masters 1e-6 (the two sides compute
Adam's bias correction in f32 and in f64); bf16 weights to one bf16
rounding step (2**-8 relative), since a master that differs in its last
f32 bit may round to the neighbouring bf16 value."""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import optimizer as popt
from mxnet_tpu_torch.base import MXNetError

F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -8, atol=1e-6)
SHAPES = [(4, 5), (7,)]


def _flat(state):
    """Every tensor of a (nested) state, as f32 numpy, in order."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    if isinstance(state, torch.Tensor):
        return [state.detach().float().numpy()]
    return [onp.asarray(state.asnumpy() if hasattr(state, "asnumpy")
                        else state, onp.float32)]


# every registered optimizer but SGLD, whose noise no two packages share
# (``tests/test_torch_optimizer_bf16.py`` holds its deterministic part)
RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adam", {}),
         ("adamw", {}), ("nag", {"momentum": 0.9}), ("signum", {}),
         ("signum", {"momentum": 0.0, "wd_lh": 0.01}), ("dcasgd", {}),
         ("dcasgd", {"momentum": 0.9}), ("rmsprop", {}),
         ("rmsprop", {"centered": True, "clip_weights": 1.5}),
         ("adagrad", {}), ("adadelta", {}), ("nadam", {}), ("ftml", {}),
         ("ftrl", {}), ("lamb", {}),
         ("lamb", {"lower_bound": 0.5, "upper_bound": 2.0,
                   "bias_correction": False}), ("lars", {})]
RULE_IDS = ["sgd", "sgd_momentum", "adam", "adamw", "nag", "signum",
            "signum_plain", "dcasgd", "dcasgd_momentum", "rmsprop",
            "rmsprop_centered", "adagrad", "adadelta", "nadam", "ftml",
            "ftrl", "lamb", "lamb_bounds", "lars"]


@pytest.mark.parametrize("name,extra", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16_mp"])
def test_update_rules_match_jax(name, extra, mp):
    import mxnet_tpu as mx
    from mxnet_tpu import optimizer as jopt

    kw = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.5,
              rescale_grad=0.5, multi_precision=mp, **extra)
    jo, po = jopt.create(name, **kw), popt.create(name, **kw)
    for o in (jo, po):
        o.set_lr_mult({1: 0.3})
        o.set_wd_mult({0: 2.0})
    tdt, jdt = (torch.bfloat16, "bfloat16") if mp else \
        (torch.float32, "float32")
    rs = onp.random.RandomState(0)
    jw, pw, js, ps = [], [], [], []
    for i, shape in enumerate(SHAPES):
        w = torch.tensor(rs.standard_normal(shape), dtype=tdt)
        pw.append(w)
        # a copy: JAX may alias a numpy buffer, and the port updates `w`
        # in place (DCASGD keeps the reference's first array as its state)
        jw.append(mx.nd.array(w.float().numpy().copy(), dtype=jdt))
        js.append(jo.create_state_multi_precision(i, jw[i]))
        ps.append(po.create_state_multi_precision(i, pw[i]))
    for _ in range(5):
        for i, shape in enumerate(SHAPES):
            # gradients of both signs, some beyond the clip after rescale
            g = torch.tensor(rs.standard_normal(shape) * 2.0, dtype=tdt)
            js[i] = jo.update_multi_precision(
                i, jw[i], mx.nd.array(g.float().numpy(), dtype=jdt), js[i])
            ps[i] = po.update_multi_precision(i, pw[i], g, ps[i])
    assert po.num_update == jo.num_update == 5
    for i in range(len(SHAPES)):
        assert pw[i].dtype == tdt
        onp.testing.assert_allclose(pw[i].float().numpy(),
                                    jw[i].asnumpy().astype(onp.float32),
                                    **(BF16_TOL if mp else F32_TOL))
        got, ref = _flat(ps[i]), _flat(js[i])
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            onp.testing.assert_allclose(a, b, **F32_TOL)


def test_adamw_is_the_reference_rule_not_torch_adamw():
    """One AdamW step by hand: decay scaled by the bias-corrected lr_t,
    epsilon added to the uncorrected sqrt(v)."""
    o = popt.AdamW(learning_rate=0.1, wd=0.5, epsilon=1e-3)
    w = torch.tensor([1.0, -2.0])
    g = torch.tensor([0.2, 0.4])
    o.update(0, w, g, o.create_state(0, w))
    m, v = 0.1 * g, 0.001 * g * g
    lr_t = 0.1 * (1 - 0.999) ** 0.5 / (1 - 0.9)
    ref = torch.tensor([1.0, -2.0]) - lr_t * (
        m / (v.sqrt() + 1e-3) + 0.5 * torch.tensor([1.0, -2.0]))
    torch.testing.assert_close(w, ref, rtol=1e-6, atol=1e-7)


def test_create_and_register():
    assert isinstance(popt.create("AdamW"), popt.AdamW)
    o = popt.SGD()
    assert popt.create(o) is o
    with pytest.raises(MXNetError, match="unknown optimizer"):
        popt.create("nosuch")


def test_create_builds_every_reference_optimizer():
    """The reference's fifteen names and its two aliases, each with the
    constructor arguments the reference accepts (``lazy_update`` on SGD
    and Adam, ``use_fused_step``, ``aggregate_num``,
    ``param_idx2name``)."""
    from mxnet_tpu.optimizer.optimizer import _REGISTRY as ref_registry

    from mxnet_tpu_torch.optimizer.optimizer import _REGISTRY

    assert sorted(_REGISTRY) == sorted(ref_registry)
    assert len(_REGISTRY) == 15
    for name in ref_registry:
        o = popt.create(name, use_fused_step=True, aggregate_num=4,
                        param_idx2name={0: "w"})
        assert type(o).__name__ == ref_registry[name].__name__
        assert o.aggregate_num == 4 and o.idx2name == {0: "w"}
    for name in ("sgd", "adam"):
        assert popt.create(name, lazy_update=False).__class__ is \
            popt.create(name).__class__
    assert isinstance(popt.create("AdaGrad"), popt.AdaGrad)
    assert isinstance(popt.create("adadelta"), popt.AdaDelta)


def test_param_idx2name_mults_give_the_reference_lr_and_wd():
    from mxnet_tpu import optimizer as jopt

    kw = dict(learning_rate=0.1, wd=0.01,
              param_idx2name={0: "fc_weight", 1: "fc_bias", 2: "out"})
    jo, po = jopt.create("sgd", **kw), popt.create("sgd", **kw)
    for o in (jo, po):
        o.set_lr_mult({"fc_weight": 0.5, 1: 3.0, "fc_bias": 7.0})
        o.set_wd_mult({"fc_bias": 0.0, "out": 2.0})
    for i in range(4):
        assert po._get_lr(i) == jo._get_lr(i)
        assert po._get_wd(i) == jo._get_wd(i)
    assert po._get_lr(0) == pytest.approx(0.05)     # by name
    assert po._get_lr(1) == pytest.approx(0.3)      # the index wins
    assert po._get_wd(1) == 0.0 and po._get_wd(2) == pytest.approx(0.02)


@pytest.mark.parametrize("agg", [None, 2, 3])
def test_aggregate_num_chunks_groups_like_the_reference(agg):
    """``aggregate_num`` cuts each (multi-precision, dtype) group into
    applies of at most that many parameters: the apply counters and the
    weights equal the reference's."""
    import mxnet_tpu as mx
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.optimizer.optimizer import apply_counters as jcount
    from mxnet_tpu.optimizer.optimizer import reset_apply_counters as jreset

    from mxnet_tpu_torch.optimizer.optimizer import (apply_counters,
                                                     reset_apply_counters)

    kw = dict(learning_rate=0.05, momentum=0.9, aggregate_num=agg)
    jo, po = jopt.create("sgd", **kw), popt.create("sgd", **kw)
    rs = onp.random.RandomState(4)
    ws = [rs.standard_normal((3, i + 1)).astype(onp.float32)
          for i in range(7)]
    gs = [rs.standard_normal(w.shape).astype(onp.float32) for w in ws]
    jw = [mx.nd.array(w.copy()) for w in ws]
    pw = [torch.tensor(w) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ps = [po.create_state(i, w) for i, w in enumerate(pw)]
    jreset()
    reset_apply_counters()
    for _ in range(2):
        js = jo.multi_update(list(range(7)), jw, [mx.nd.array(g) for g in gs],
                             js)
        ps = po.multi_update(list(range(7)), pw,
                             [torch.tensor(g) for g in gs], ps)
    assert apply_counters == jcount
    assert apply_counters["fused_calls"] == 2 * (-(-7 // (agg or 7)))
    for a, b in zip(jw, pw):
        onp.testing.assert_allclose(b.numpy(), a.asnumpy(), **F32_TOL)


@pytest.mark.parametrize("name", ["sgd", "nag", "adam", "adamw", "lamb",
                                  "lars", "rmsprop", "adagrad", "adadelta",
                                  "ftrl", "ftml", "signum", "nadam"])
def test_all_optimizers_reduce_quadratic(name):
    """The reference's ``tests/test_optimizer_metric.py:50``: each
    optimizer makes progress on f(w) = ||w||^2 / 2 in 30 updates."""
    opt = popt.create(name)
    w = torch.ones(4)
    state = opt.create_state_multi_precision(0, w)
    for _ in range(30):
        state = opt.update_multi_precision(0, w, w.clone(), state)
    assert float(torch.linalg.vector_norm(w)) < 2.0
