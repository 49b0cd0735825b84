"""The optimizers of the PyTorch port against the JAX package's update
rules: SGD (with and without momentum), Adam and AdamW over five steps
of ``update_multi_precision``, with weight decay, gradient clipping,
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


@pytest.mark.parametrize("name,extra", [("sgd", {}),
                                        ("sgd", {"momentum": 0.9}),
                                        ("adam", {}), ("adamw", {})],
                         ids=["sgd", "sgd_momentum", "adam", "adamw"])
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
        jw.append(mx.nd.array(w.float().numpy(), dtype=jdt))
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
