"""The port's ``ops/optimizer_ops.py`` against
``mxnet_tpu/ops/optimizer_ops.py`` on the CPU: every update op on the
conformance sweep's inputs (``tests/_torch_corpus_cases.py``) and on
cases with weight decay, ``rescale_grad``, ``clip_gradient`` (the
``>= 0`` clip), momentum and later steps, and the multi-precision ops
with bfloat16 weights; the four aggregated ``multi_*`` SGD updates
equal their loop of single-tensor updates bit for bit.

Tolerances: the updates are elementwise, within 1e-6 relative and 1e-7
absolute in f32 (``tests/_torch_corpus_cases.py``); a bfloat16 weight
the ``mp_`` ops round from their f32 master copy equals the reference's
exactly (the master copies are within the f32 tolerance).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_corpus_cases import (N, Z, assert_same, check_case_on_card,
                                 make_inputs, module_cases)
from _torch_corpus_ref import check_case
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.ops import optimizer_ops as popt
from mxnet_tpu_torch.ops.registry import OPS

rmx = LazyReference()     # the JAX package, imported at first use

NAMES = sorted(n for n, o in OPS.items() if o.fn.__module__ == popt.__name__)
W, G, S1, S2 = N(1, 4, 5), N(2, 4, 5, scale=3.0), N(3, 4, 5, scale=0.2), \
    ("abs", N(4, 4, 5, scale=0.2))
HYPER = dict(wd=0.01, rescale_grad=0.5, clip_gradient=1.0)
CASES = module_cases(NAMES, OPS) + [
    ("sgd_clip", "sgd_update", [W, G], dict(lr=0.1, **HYPER)),
    ("sgd_clip_zero", "sgd_update", [W, G], dict(lr=0.1, clip_gradient=0.0)),
    ("sgd_mom", "sgd_mom_update", [W, G, S1],
     dict(lr=0.1, momentum=0.9, **HYPER)),
    ("mp_sgd", "mp_sgd_update", [W, G, W], dict(lr=0.1, **HYPER)),
    ("mp_sgd_mom", "mp_sgd_mom_update", [W, G, S1, W],
     dict(lr=0.1, momentum=0.9, **HYPER)),
    ("nag_mom", "nag_mom_update", [W, G, S1],
     dict(lr=0.1, momentum=0.9, **HYPER)),
    ("mp_nag_mom", "mp_nag_mom_update", [W, G, S1, W],
     dict(lr=0.1, momentum=0.9, **HYPER)),
    ("adam", "adam_update", [W, G, S1, S2],
     dict(lr=0.01, beta1=0.8, **HYPER)),
    ("adamw", "adamw_update", [W, G, S1, S2], dict(lr=0.01, eta=0.5, **HYPER)),
    ("mp_adamw", "mp_adamw_update", [W, G, S1, S2, W],
     dict(lr=0.01, eta=0.5, **HYPER)),
    ("lamb_phase1_t5", "lamb_update_phase1", [W, G, S1, S2],
     dict(t=5, **HYPER)),
    ("lamb_phase1_raw", "lamb_update_phase1", [W, G, S1, S2],
     dict(t=2, bias_correction=False)),
    ("lamb_phase2_bounds", "lamb_update_phase2",
     [W, G, ("abs", N(5, 1)), ("abs", N(6, 1))],
     dict(lr=0.01, lower_bound=0.5, upper_bound=1.5)),
    ("lamb_phase2_zero", "lamb_update_phase2", [W, G, Z(1), ("abs", N(6, 1))],
     dict(lr=0.01)),
    ("ftrl", "ftrl_update", [W, G, S1, S2],
     dict(lr=0.1, lamda1=0.05, beta=0.5, **HYPER)),
    ("ftml_t3", "ftml_update", [W, G, S2, S2, S1],
     dict(lr=0.05, t=3, wd=0.01, rescale_grad=0.5, clip_grad=1.0)),
    ("rmsprop_clip_weights", "rmsprop_update", [W, G, S2],
     dict(lr=0.01, clip_weights=0.5, **HYPER)),
    ("rmspropalex", "rmspropalex_update", [W, G, S2, Z(4, 5), S1],
     dict(lr=0.01, clip_weights=0.8, **HYPER)),
    ("signsgd", "signsgd_update", [W, G], dict(lr=0.1, **HYPER)),
    ("signum", "signum_update", [W, G, S1],
     dict(lr=0.1, momentum=0.9, wd_lh=0.01, **HYPER)),
    ("adagrad", "adagrad_update", [W, G, S2], dict(lr=0.1, **HYPER)),
    ("adadelta", "adadelta_update", [W, G, S2, S2],
     dict(rho=0.95, **HYPER)),
    ("multi_sgd_three", "multi_sgd_update",
     [W, G, N(7, 3), N(8, 3), N(9, 2, 2), N(10, 2, 2)],
     dict(lrs=[0.1, 0.2, 0.3], wds=[0.0, 0.01, 0.1], **{
         k: v for k, v in HYPER.items() if k != "wd"})),
    ("multi_mp_sgd_mom_two", "multi_mp_sgd_mom_update",
     [W, G, S1, W, N(7, 3), N(8, 3), N(11, 3), N(7, 3)],
     dict(lrs=[0.1, 0.2], wds=[0.0, 0.01], momentum=0.9, num_weights=2)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    check_case(case)


def test_every_reference_op_is_ported():
    from mxnet_tpu.ops import optimizer_ops as ropt
    from mxnet_tpu.ops.registry import OPS as ROPS

    ref = {n for n, o in ROPS.items() if o.fn.__module__ == ropt.__name__}
    assert ref == set(NAMES) == set(popt.__all__) and len(ref) == 23
    for name in NAMES:
        assert getattr(mx.nd, name) is OPS[name].wrapper


@pytest.mark.parametrize("name", ["mp_sgd_update", "mp_sgd_mom_update",
                                  "mp_nag_mom_update", "mp_adamw_update",
                                  "multi_mp_sgd_update",
                                  "multi_mp_sgd_mom_update"])
def test_mp_ops_with_bfloat16_weights(name):
    """A bfloat16 weight and gradient: the update runs in f32 on the
    master copy and rounds once to bfloat16, in both packages."""
    import jax.numpy as jnp

    w, g, m = make_inputs([N(12, 6, 8), N(13, 6, 8), N(14, 6, 8, scale=0.1)])
    arrays = {"mp_sgd_update": [w, g, w], "multi_mp_sgd_update": [w, g, w],
              "mp_adamw_update": [w, g, m, abs(m), w]}.get(name,
                                                        [w, g, m, w])
    kw = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=1.0)
    if name.startswith("multi"):
        kw = dict(lrs=[0.1], wds=[0.01], rescale_grad=0.5,
                  clip_gradient=1.0)
    if "mom" in name or "nag" in name:
        kw["momentum"] = 0.9
    from mxnet_tpu.ops.registry import get_op as rget

    r = rget(name).fn(jnp.asarray(arrays[0], jnp.bfloat16),
                      jnp.asarray(arrays[1], jnp.bfloat16),
                      *[jnp.asarray(a) for a in arrays[2:]], **kw)
    p = OPS[name].fn(torch.from_numpy(arrays[0]).bfloat16(),
                     torch.from_numpy(arrays[1]).bfloat16(),
                     *[torch.from_numpy(a) for a in arrays[2:]], **kw)
    assert p[0].dtype == torch.bfloat16
    onp.testing.assert_array_equal(p[0].float().numpy(),
                                   onp.asarray(r[0].astype(jnp.float32)))
    assert_same(name, [t.numpy() for t in p[1:]],
                [onp.asarray(t) for t in r[1:]], "elementwise")


LOOPS = {
    "multi_sgd_update": ("sgd_update", 2, ["lr", "wd"]),
    "multi_sgd_mom_update": ("sgd_mom_update", 3, ["lr", "wd"]),
    "multi_mp_sgd_update": ("mp_sgd_update", 3, ["lr", "wd"]),
    "multi_mp_sgd_mom_update": ("mp_sgd_mom_update", 4, ["lr", "wd"]),
}


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_multi_update_is_its_loop_bit_for_bit(name):
    """``multi_*`` over three tensors equals three single-tensor updates
    with the same hyperparameters, bit for bit (one body)."""
    single, k, _ = LOOPS[name]
    rs = onp.random.RandomState(3)
    shapes = [(4, 5), (7,), (2, 3, 2)]
    groups = []
    for s in shapes:
        w = torch.from_numpy(rs.standard_normal(s).astype(onp.float32))
        g = [w, torch.from_numpy(rs.standard_normal(s).astype(onp.float32)
                                 * 3)]
        if "mom" in name:
            g.append(torch.from_numpy(rs.standard_normal(s).astype(
                onp.float32) * 0.1))
        if "mp" in name:
            g[0] = w.bfloat16()
            g.append(w)
        groups.append(g)
    lrs, wds = [0.1, 0.05, 0.2], [0.0, 1e-4, 0.01]
    extra = dict(rescale_grad=1.0 / 128, clip_gradient=0.5)
    if "mom" in name:
        extra["momentum"] = 0.9
    with mx.cpu():
        flat = [mx.nd.from_torch(t) for g in groups for t in g]
        multi = getattr(mx.nd, name)(*flat, lrs=lrs, wds=wds,
                                     num_weights=3, **extra)
        loop = []
        for i, g in enumerate(groups):
            out = getattr(mx.nd, single)(*[mx.nd.from_torch(t) for t in g],
                                         lr=lrs[i], wd=wds[i], **extra)
            loop += out if isinstance(out, list) else [out]
    assert len(multi) == len(loop) == 3 * (k - 1)
    for a, b in zip(multi, loop):
        assert a.dtype == b.dtype
        assert torch.equal(a._data, b._data)


def test_update_writes_out():
    """A single-output update takes ``out=weight``; a multi-output one
    refuses ``out=``."""
    with mx.cpu():
        w = mx.nd.array(onp.ones((2, 3), onp.float32))
        g = mx.nd.array(onp.full((2, 3), 2.0, onp.float32))
        r = mx.nd.sgd_update(w, g, lr=0.1, out=w)
        assert r is w
        onp.testing.assert_allclose(w.asnumpy(), 0.8, rtol=1e-6)
        with pytest.raises(mx.base.MXNetError, match="multi-output"):
            mx.nd.sgd_mom_update(w, g, mx.nd.zeros((2, 3)), lr=0.1, out=w)


@pytest.mark.cuda
def test_optimizer_ops_on_card_match_cpu():
    need_cuda()
    for case in CASES:
        check_case_on_card(case)


@pytest.mark.cuda
def test_multi_update_loop_on_card_bit_for_bit():
    need_cuda()
    rs = onp.random.RandomState(5)
    args, singles = [], []
    for s in [(64, 3), (1000,)]:
        w32 = torch.from_numpy(rs.standard_normal(s).astype(onp.float32))
        grp = [w32.bfloat16(), torch.from_numpy(rs.standard_normal(s).astype(
            onp.float32)).bfloat16(), torch.zeros(s), w32]
        grp = [t.cuda() for t in grp]
        args += grp
        singles.append(grp)
    kw = dict(momentum=0.9, rescale_grad=1 / 128)
    multi = OPS["multi_mp_sgd_mom_update"].fn(*args, lrs=[0.1, 0.1],
                                             wds=[1e-4, 1e-4], **kw)
    loop = []
    for grp in singles:
        loop += OPS["mp_sgd_mom_update"].fn(*grp, lr=0.1, wd=1e-4, **kw)
    for a, b in zip(multi, loop):
        assert torch.equal(a, b)
