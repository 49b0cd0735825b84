"""The port's ``ops/samplers.py`` against ``mxnet_tpu/ops/samplers.py``
on the CPU.

- The deterministic ops (the fused multi-tensor updates, the int8
  pooling and ReLU, the contrib stragglers) on the conformance sweep's
  inputs and the trouble-spot cases of ``tests/_torch_corpus_cases.py``,
  within their class's tolerance (elementwise 1e-6 relative and 1e-7
  absolute; ``multi_lamb_update``'s norms 1e-5; the int8 ops and
  ``_contrib_gradientmultiplier`` exactly; gradients 1e-5).
- The draws: the reference's output shapes and dtypes for every
  ``_random_*``/``sample_*`` op; each op's distribution at a fixed seed
  (``tests/_torch_draws.py``: mean and variance within 6 standard errors,
  Kolmogorov--Smirnov or chi-square at p >= 1e-6); one seed the same
  draws, another seed others; under a traced key, one key the same
  draws and another key others.
- The ``multi_*``/``preloaded_*`` updates over three tensors equal three
  one-tensor calls bit for bit, and the ``preloaded_`` ones never read
  their device ``lrs``/``wds`` back to the host.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_corpus_cases import (DRAWS, assert_same, check_case_on_card,
                                 module_cases, port)
from _torch_corpus_ref import check_case, reference
from _torch_draws import DRAW_CASES, check_draws
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.ops import samplers as psamp
from mxnet_tpu_torch.ops.registry import OPS

rmx = LazyReference()     # the JAX package, imported at first use

NAMES = sorted(n for n, o in OPS.items()
               if o.fn.__module__ == psamp.__name__)
CASES = module_cases([n for n in NAMES if n not in DRAWS], OPS)
ALIASES = ["random_uniform", "random_normal", "random_gamma",
           "random_exponential", "random_poisson", "random_negative_binomial",
           "random_generalized_negative_binomial", "random_randint",
           "multinomial", "interp"]

# (id, op, parameter arrays, kwargs) for the shape and dtype comparison
SHAPE_CASES = [(f"{c[0]}_{tag}", c[1], c[2], {**c[3], **kw})
               for c in DRAW_CASES
               for tag, kw in (("default", {}), ("shape", dict(shape=(2, 3))))]
SHAPE_CASES += [
    ("uniform_f16", "_random_uniform", [], dict(shape=(3,), dtype="float16")),
    ("poisson_i32", "_random_poisson", [], dict(shape=(2, 2), dtype="int32")),
    ("sample_normal_3d", "sample_normal",
     [onp.zeros((2, 3), onp.float32), onp.ones((2, 3), onp.float32)],
     dict(shape=(4, 2))),
    ("multinomial_prob", "sample_multinomial",
     [onp.full((3, 5), 0.2, onp.float32)], dict(shape=(2, 3), get_prob=True)),
    ("multinomial_1d", "sample_multinomial",
     [onp.asarray([0.3, 0.7], onp.float32)], dict(shape=4)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    check_case(case)


def test_every_reference_op_is_ported():
    from mxnet_tpu.ops import samplers as rsamp
    from mxnet_tpu.ops.registry import OPS as ROPS

    ref = {n for n, o in ROPS.items() if o.fn.__module__ == rsamp.__name__}
    assert ref == set(NAMES) and len(ref) == 28
    assert DRAWS <= ref and len(DRAWS) == 16
    for pyname, obj in vars(rsamp).items():
        if callable(obj) and getattr(obj, "_op", None) is not None and \
                pyname != "sample_multinomial":
            assert getattr(mx.nd, pyname) is OPS[obj._op.name].wrapper


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_resolves(alias):
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES
    from mxnet_tpu_torch.ops.registry import get_op

    assert get_op(alias) is OPS[RALIASES[alias]]


@pytest.mark.parametrize("case", SHAPE_CASES, ids=[c[0] for c in SHAPE_CASES])
def test_draw_shapes_and_dtypes_match_reference(case):
    """The draws' shapes and dtypes (and output count) are the
    reference's; every value is finite."""
    cid, name, arrays, kwargs = case
    want, _ = reference(name, arrays, kwargs)
    got, _ = port(name, arrays, kwargs)
    assert_same(name, got, want, "draw")
    for g in got:
        assert onp.isfinite(g.astype(onp.float64)).all()


@pytest.mark.parametrize("case", DRAW_CASES, ids=[c[0] for c in DRAW_CASES])
def test_draw_distribution(case):
    """2**15 draws a row at a fixed seed follow the op's distribution."""
    cid, name, arrays, kwargs, specs = case
    mxrandom.seed(11)
    with mx.cpu():
        args = [mx.nd.array(a) for a in arrays]
        x = getattr(mx.nd, name)(*args, shape=(2 ** 15,), **kwargs)
    check_draws(x._data, specs)


@pytest.mark.parametrize("name,dtype", [("_random_normal", "float64"),
                                        ("_random_uniform", "float64"),
                                        ("_random_randint", "int64")])
def test_a_64_bit_dtype_is_honoured(name, dtype):
    """A draw asked for a 64-bit dtype gets it in the port; the
    reference, with JAX's 64-bit types off, returns the 32-bit one."""
    kw = dict(shape=(5,), dtype=dtype)
    if name == "_random_randint":
        kw.update(low=0, high=5)
    want, _ = reference(name, [], kw)
    got, _ = port(name, [], kw)
    assert got[0].dtype == onp.dtype(dtype) and got[0].shape == (5,)
    assert want[0].dtype == onp.dtype(dtype.replace("64", "32"))


def test_int8_max_pooling_runs_on_the_int8_values():
    """``quantized_pooling_int8`` max-pools int8 data into int8 (the
    block maxima) with the range passed through; the reference's int8
    max pool raises (its ``reduce_window`` init value is int32, ROADMAP
    section 3)."""
    x = (onp.arange(-64, 64).reshape(2, 1, 8, 8) % 97 - 48).astype(onp.int8)
    lo, hi = onp.float32(-1.0), onp.float32(1.5)
    with pytest.raises(TypeError, match="reduce_window"):
        reference("quantized_pooling_int8", [x, lo, hi],
                  dict(kernel=(2, 2), stride=(2, 2), pool_type="max"))
    q, qmin, qmax = port("quantized_pooling_int8", [x, lo, hi],
                         dict(kernel=(2, 2), stride=(2, 2),
                              pool_type="max"))[0]
    want = x.reshape(2, 1, 4, 2, 4, 2).max(axis=(3, 5))
    assert q.dtype == onp.int8
    onp.testing.assert_array_equal(q, want)
    assert (qmin, qmax) == (lo, hi)


def test_multinomial_get_prob_is_the_drawn_log_probability():
    p = onp.random.RandomState(4).dirichlet(onp.ones(7), size=3).astype(
        onp.float32)
    mxrandom.seed(2)
    with mx.cpu():
        idx, logp = OPS["sample_multinomial"].wrapper(
            mx.nd.array(p), shape=(5,), get_prob=True)
    i = idx.asnumpy()
    assert i.shape == (3, 5) and i.dtype == onp.int32
    onp.testing.assert_array_equal(
        logp.asnumpy(), torch.log(torch.from_numpy(
            onp.take_along_axis(p, i, axis=1))).numpy())


def test_multinomial_never_draws_a_zero_probability():
    mxrandom.seed(3)
    with mx.cpu():
        p = mx.nd.array(onp.asarray([[0.0, 0.5, 0.0, 0.5, 0.0]], onp.float32))
        x = OPS["sample_multinomial"].wrapper(p, shape=(4096,)).asnumpy()
    assert set(onp.unique(x)) == {1, 3}


@pytest.mark.parametrize("name", ["_random_uniform", "_random_normal",
                                  "_random_gamma", "_random_poisson",
                                  "_random_randint",
                                  "_random_negative_binomial"])
def test_seed_fixes_the_draws(name):
    kw = dict(shape=(64,))
    if name == "_random_randint":
        kw.update(low=0, high=1000)
    with mx.cpu():
        mxrandom.seed(7)
        a = getattr(mx.nd, name)(**kw).asnumpy()
        b = getattr(mx.nd, name)(**kw).asnumpy()
        mxrandom.seed(7)
        c = getattr(mx.nd, name)(**kw).asnumpy()
        mxrandom.seed(8)
        d = getattr(mx.nd, name)(**kw).asnumpy()
    onp.testing.assert_array_equal(a, c)
    assert not onp.array_equal(a, b) and not onp.array_equal(a, d)


@pytest.mark.parametrize("name", ["_random_uniform", "_random_normal",
                                  "_random_exponential", "_random_gamma",
                                  "_random_poisson"])
def test_draws_under_a_traced_key(name):
    """Under ``random.trace(key)`` a draw derives from the key: the same
    key gives the same values (eager and replay alike), another key
    others, and two draws in one program differ."""
    def run(key):
        with mx.cpu(), mxrandom.trace(torch.tensor([key], dtype=torch.int32)):
            x = getattr(mx.nd, name)(shape=(32,)).asnumpy()
            y = getattr(mx.nd, name)(shape=(32,)).asnumpy()
        return x, y

    a1, a2 = run(5)
    b1, b2 = run(5)
    c1, _ = run(6)
    onp.testing.assert_array_equal(a1, b1)
    onp.testing.assert_array_equal(a2, b2)
    assert not onp.array_equal(a1, a2) and not onp.array_equal(a1, c1)


def test_draw_in_capture_without_trace_raises(monkeypatch):
    """A draw while a CUDA graph captures raises unless a traced key is
    pushed (every replay would repeat the captured key)."""
    monkeypatch.setattr(mxrandom, "_capturing", lambda: True)
    with mx.cpu():
        with pytest.raises(mx.base.MXNetError, match="captured"):
            mx.nd._random_uniform(shape=(2,))
        with mxrandom.trace(torch.tensor([1], dtype=torch.int32)):
            mx.nd._random_uniform(shape=(2,))


def _split_equal(name, groups, k, kw, tail=()):
    flat = [t for g in groups for t in g]
    whole = OPS[name].fn(*flat, *tail, **kw)
    parts = []
    for i, g in enumerate(groups):
        one = {key: ([v[i]] if isinstance(v, list) else v)
               for key, v in kw.items()}
        t = [x[i:i + 1] for x in tail]
        parts += OPS[name].fn(*g, *t, **one)
    assert len(whole) == len(parts) == len(groups) * k
    for a, b in zip(whole, parts):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _groups(n_per, seed=0):
    rs = onp.random.RandomState(seed)
    out = []
    for s in [(4, 5), (7,), (2, 3, 2)]:
        g = [torch.from_numpy(rs.standard_normal(s).astype(onp.float32))
             for _ in range(n_per)]
        if n_per == 4:
            g[3] = g[3].abs()
        out.append(g)
    return out


def test_multi_adamw_is_its_loop_bit_for_bit():
    _split_equal("multi_adamw_update", _groups(4), 3,
                 dict(lrs=[0.1, 0.01, 0.05], etas=[1.0, 0.5, 1.0],
                      wds=[0.0, 0.1, 0.01], rescale_grad=0.5,
                      clip_gradient=1.0, step_count=4))


def test_multi_lamb_is_its_loop_bit_for_bit():
    _split_equal("multi_lamb_update", _groups(4, 1), 3,
                 dict(learning_rates=[0.1, 0.01, 0.05], wds=[0.0, 0.1, 0.01],
                      step_count=2, lower_bound=0.1, upper_bound=5.0))


def test_preloaded_updates_are_their_loops_and_never_read_the_host():
    lrs = torch.tensor([0.1, 0.05, 0.2])
    wds = torch.tensor([0.0, 0.01, 1e-4])
    real_item = torch.Tensor.item
    try:
        torch.Tensor.item = None            # any host read would fail
        _split_equal("preloaded_multi_sgd_update", _groups(2, 2), 1,
                     dict(rescale_grad=0.5, clip_gradient=0.8),
                     tail=(lrs, wds))
        _split_equal("preloaded_multi_sgd_mom_update", _groups(3, 3), 2,
                     dict(momentum=0.9), tail=(lrs, wds))
    finally:
        torch.Tensor.item = real_item


@pytest.mark.cuda
def test_sampler_ops_on_card_match_cpu():
    need_cuda()
    for case in CASES:
        check_case_on_card(case)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_random_uniform", "_random_randint",
                                  "_random_normal", "_random_exponential"])
def test_card_draws_equal_the_cpu(name):
    """One seed, the same draws on the card and on the CPU: bit for bit
    for uniform and randint, within 2 f32 ulps for the erfinv/log
    transforms."""
    need_cuda()
    kw = dict(shape=(1 << 16,))
    if name == "_random_randint":
        kw.update(low=-5, high=1 << 20)
    out = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mxrandom.seed(21)
        with ctx:
            out.append(getattr(mx.nd, name)(**kw).asnumpy())
    if name in ("_random_uniform", "_random_randint"):
        onp.testing.assert_array_equal(out[1], out[0])
    else:
        ulp = onp.spacing(onp.abs(out[0]).astype(onp.float32))
        assert (onp.abs(out[1] - out[0]) <= 2 * ulp).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", DRAW_CASES, ids=[c[0] for c in DRAW_CASES])
def test_card_draw_distribution(case):
    need_cuda()
    cid, name, arrays, kwargs, specs = case
    mxrandom.seed(13)
    with mx.gpu(0):
        args = [mx.nd.array(a) for a in arrays]
        x = getattr(mx.nd, name)(*args, shape=(2 ** 20,), **kwargs)
    check_draws(x._data, specs)


@pytest.mark.cuda
def test_preloaded_update_replays_in_a_graph():
    """``preloaded_multi_sgd_mom_update`` captured in a CUDA graph and
    replayed after its ``lrs`` change in place equals the eager call."""
    need_cuda()
    groups = [[t.cuda() for t in g] for g in _groups(3, 4)]
    flat = [t for g in groups for t in g]
    lrs = torch.tensor([0.1, 0.05, 0.2], device="cuda")
    wds = torch.tensor([0.0, 0.01, 1e-4], device="cuda")
    fn = OPS["preloaded_multi_sgd_mom_update"].fn
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*flat, lrs, wds, momentum=0.9)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*flat, lrs, wds, momentum=0.9)
    lrs.copy_(torch.tensor([0.3, 0.02, 0.07], device="cuda"))
    graph.replay()
    eager = fn(*flat, lrs, wds, momentum=0.9)
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)
