"""Every op that ``mxnet_tpu_torch/ops/nn.py`` and ``ops/attention.py``
register against the same op of ``mxnet_tpu/ops/nn.py`` and
``ops/attention.py``, on the same seeded numpy inputs (f32 on the CPU),
through each package's ``nd`` wrappers.

Tolerances: outputs within 1e-5 (relative and absolute); for the
differentiable ops, the input gradients under ``autograd.record()`` /
``backward()`` with the same random head gradients within 1e-5 of the
reference's tape.  Looser bounds, each with its reason:

- the attention cases past 512² scores (the reference's Pallas kernels
  in interpret mode, or its blockwise scan, against the port's K1-K3
  plain versions): 1e-4 on gradients, as ``test_torch_attention_bwd``;
- ``CTCLoss``: 2e-5, a log-space sum over every time step of values of
  size ~10.

The inputs of ``tests/test_op_conformance.py``'s ``SPECIALS`` and
generic builder run too, held to the reference and, where its
``VALUE_REF`` has the op, to that numpy value at its own tolerance.
``_DropoutImpl`` draws other masks than the reference (threefry bits),
so it is held to what a mask must be.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from _torch_nn_cases import CASES, _input
from mxnet_tpu_torch.ops import attention as pattn
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops.registry import NOT_PORTED, OPS

TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=1e-4, atol=1e-4)
CTC_TOL = dict(rtol=2e-5, atol=2e-5)

# the reference's ops/nn.py ops still to port, queued in ROADMAP: none
# since the detection and sampling family was ported
QUEUED: set = set()


DIFFERENT_MASKS = {"_DropoutImpl"}     # held to a mask's rules instead


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _run(pkg, fn, arrays, kwargs, grad, heads):
    """Outputs and input gradients of ``fn`` in package ``pkg``."""
    nds = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    wants = [grad and a.dtype == onp.float32 for a in arrays]
    for x, w in zip(nds, wants):
        if w:
            x.attach_grad()
    with pkg.autograd.record():
        outs = _outs(fn(*nds, **kwargs))
    if grad:
        pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads])
    grads = [x.grad.asnumpy() for x, w in zip(nds, wants) if w]
    return [o.asnumpy() for o in outs], grads


def _compare(name, arrays, kwargs, rs, tol=TOL, grad_tol=None):
    """The port's ``mx.nd.<name>`` against the reference's on ``arrays``:
    outputs (dtype and shape too) and input gradients."""
    ref_fn, port_fn = getattr(rmx.nd, name), getattr(mx.nd, name)
    ref_outs = _outs(ref_fn(*[rmx.nd.array(a, dtype=a.dtype)
                              for a in arrays], **kwargs))
    grad = OPS[name].differentiable and any(
        a.dtype == onp.float32 for a in arrays)
    heads = [rs.standard_normal(o.shape).astype(onp.float32)
             for o in ref_outs]
    r_out, r_grads = _run(rmx, ref_fn, arrays, kwargs, grad, heads)
    with mx.cpu():
        p_out, p_grads = _run(mx, port_fn, arrays, kwargs, grad, heads)
    assert len(p_out) == len(r_out)
    for p, r in zip(p_out, r_out):
        assert p.dtype == r.dtype and p.shape == r.shape, \
            (p.dtype, p.shape, r.dtype, r.shape)
        onp.testing.assert_allclose(p, r, **tol)
    for p, r in zip(p_grads, r_grads):
        onp.testing.assert_allclose(p, r, **(grad_tol or tol))
    return p_out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    cid, name, specs, kwargs = case
    rs = onp.random.RandomState(sum(map(ord, cid)))
    arrays = [_input(rs, s) for s in specs]
    _compare(name, arrays, kwargs, rs,
             tol=CTC_TOL if name == "CTCLoss" else TOL)


# --------------------------------------------------------------------------- #
# the conformance sweep's inputs (tests/test_op_conformance.py)
# --------------------------------------------------------------------------- #

def _ported():
    """The ops that ops/nn.py and ops/attention.py register."""
    return sorted(n for n, o in OPS.items()
                  if o.fn.__module__ in (pnn.__name__, pattn.__name__))


@pytest.mark.parametrize("name", [n for n in _ported()
                                  if n not in DIFFERENT_MASKS])
def test_conformance_inputs_match_reference(name):
    import jax.numpy as jnp
    import test_op_conformance as conf
    from mxnet_tpu.ops.registry import OPS as ROPS

    args, kwargs = conf.build_inputs(ROPS[name], jnp.float32)
    arrays = [onp.asarray(a) for a in args]
    out = _compare(name, arrays, kwargs, onp.random.RandomState(3),
                   tol=CTC_TOL if name == "CTCLoss" else TOL)
    ref = conf._resolve_ref(name) if name not in conf.VALUE_EXEMPT \
        else None
    if ref is not None:
        want = _outs(ref(*arrays, **kwargs))
        for got, w in zip(out, want):
            onp.testing.assert_allclose(got, onp.asarray(w, onp.float32),
                                        rtol=2e-3, atol=1e-4)


def test_dropout_impl_draws_a_keyed_mask():
    """``_DropoutImpl``: every element 0 or ``x / (1 - p)``, about ``1 -
    p`` of them kept, the same key the same mask, another key another;
    the gradient is the mask over ``1 - p``; ``axes`` shares a draw."""
    rs = onp.random.RandomState(0)
    x = rs.standard_normal((64, 32)).astype(onp.float32)
    key = onp.array([0, 7], onp.int32)
    with mx.cpu():
        a = mx.nd.array(x)
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd._DropoutImpl(a, mx.nd.array(key, dtype="int32"),
                                   p=0.25)
        y.backward()
        again = mx.nd._DropoutImpl(mx.nd.array(x),
                                   mx.nd.array(key, dtype="int32"), p=0.25)
        other = mx.nd._DropoutImpl(mx.nd.array(x),
                                   mx.nd.array(key + 1, dtype="int32"),
                                   p=0.25)
        shared = mx.nd._DropoutImpl(mx.nd.array(x),
                                    mx.nd.array(key, dtype="int32"),
                                    p=0.5, axes=(1,)).asnumpy()
    got, kept = y.asnumpy(), y.asnumpy() != 0
    onp.testing.assert_allclose(got[kept], x[kept] / 0.75, **TOL)
    assert 0.7 < kept.mean() < 0.8
    onp.testing.assert_array_equal(again.asnumpy(), got)
    assert (other.asnumpy() != got).any()
    onp.testing.assert_allclose(a.grad.asnumpy(), kept / 0.75, **TOL)
    rows = shared != 0
    assert ((rows == rows[:, :1]) | (x == 0)).all()


# --------------------------------------------------------------------------- #
# grouped Deconvolution: the reference's op raises for groups > 1 (its
# kernel layout is (in, out / groups) but lax reads in / groups), so the
# port's is held against the reference's op on each group alone
# --------------------------------------------------------------------------- #

def test_grouped_deconvolution_matches_reference_per_group():
    rs = onp.random.RandomState(11)
    G, cin, cout = 2, 4, 6
    x = rs.standard_normal((2, cin, 5, 4)).astype(onp.float32)
    w = rs.standard_normal((cin, cout // G, 3, 3)).astype(onp.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0))
    with pytest.raises(Exception):
        rmx.nd.Deconvolution(rmx.nd.array(x), rmx.nd.array(w),
                             num_filter=cout, num_group=G, **kw)
    parts = [rmx.nd.Deconvolution(
        rmx.nd.array(x[:, g * 2:(g + 1) * 2]),
        rmx.nd.array(w[g * 2:(g + 1) * 2]), num_filter=cout // G,
        **kw).asnumpy() for g in range(G)]
    with mx.cpu():
        got = mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w),
                                  num_filter=cout, num_group=G, **kw)
    onp.testing.assert_allclose(got.asnumpy(), onp.concatenate(parts, 1),
                                **TOL)


# --------------------------------------------------------------------------- #
# the public BatchNorm and the NDArray methods
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("recording", [False, True])
def test_batchnorm_follows_training_mode(recording):
    rs = onp.random.RandomState(5)
    arrays = [rs.standard_normal((2, 3, 4)).astype(onp.float32),
              rs.uniform(0.5, 2, 3).astype(onp.float32),
              rs.standard_normal(3).astype(onp.float32),
              rs.standard_normal(3).astype(onp.float32),
              rs.uniform(0.5, 2, 3).astype(onp.float32)]

    def run(pkg):
        nds = [pkg.nd.array(a) for a in arrays]
        nds[0].attach_grad()
        if recording:
            with pkg.autograd.record():
                outs = pkg.nd.BatchNorm(*nds, fix_gamma=False,
                                        output_mean_var=True)
            outs[0].backward(pkg.nd.array(arrays[0] * 0.5))
            return [o.asnumpy() for o in outs] + [nds[0].grad.asnumpy()]
        return [o.asnumpy() for o in pkg.nd.BatchNorm(
            *nds, fix_gamma=False, output_mean_var=True)]

    ref = run(rmx)
    with mx.cpu():
        got = run(mx)
    for p, r in zip(got, ref):
        onp.testing.assert_allclose(p, r, **TOL)


def test_ndarray_softmax_methods():
    """``NDArray.softmax``/``log_softmax`` are the ``softmax`` and
    ``log_softmax`` ops (the reference's methods name a ``defs`` op that
    does not exist, so the port is held to its ops)."""
    x = onp.random.RandomState(2).standard_normal((3, 4)).astype("f")
    want = rmx.nd.softmax(rmx.nd.array(x), axis=0).asnumpy()
    want_log = rmx.nd.log_softmax(rmx.nd.array(x)).asnumpy()
    with mx.cpu():
        a = mx.nd.array(x)
        onp.testing.assert_allclose(a.softmax(axis=0).asnumpy(), want, **TOL)
        onp.testing.assert_allclose(a.log_softmax().asnumpy(), want_log,
                                    **TOL)


# --------------------------------------------------------------------------- #
# flash_attention at the reference test's cases (tests/test_attention.py),
# the reference's long rows on its Pallas kernels in interpret mode
# --------------------------------------------------------------------------- #

@pytest.fixture
def ref_pallas(monkeypatch):
    """The reference's dispatch sends every row past 512² scores to its
    Pallas kernels, run in interpret mode on the CPU."""
    from mxnet_tpu.ops import attention as rattn

    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    monkeypatch.setitem(rattn._PATH_TABLE, "fwd", ((None, "pallas"),))
    monkeypatch.setitem(rattn._PATH_TABLE, "train", ((None, "pallas"),))


def _kmask(B, Lk, seed):
    m = onp.zeros((B, 1, 1, Lk), onp.float32)
    rs = onp.random.RandomState(seed)
    for b in range(B):
        m[b, ..., Lk - rs.randint(1, Lk // 3):] = -1e30
    return m


ATTN_CASES = {
    # test_flash_matches_naive / test_flash_autograd_through_tape
    "short": (dict(B=2, H=3, L=64, D=16), dict(causal=False)),
    "short_causal": (dict(B=2, H=3, L=64, D=16), dict(causal=True)),
    # test_flash_long_seq_blocks / unaligned past the plain threshold
    "unaligned_long_causal": (dict(B=1, H=2, L=600, D=16),
                              dict(causal=True)),
    # test_flash_padding_mask_bias as a key mask on the kernel path
    "kmask_long": (dict(B=2, H=1, L=576, D=16, kmask=True), {}),
    # test_flash_bias_grad_matches_naive: a dense learned bias
    "dense_bias": (dict(B=2, H=2, L=24, D=8, dense=True), dict(scale=0.3)),
    "dense_bias_long": (dict(B=1, H=1, L=544, D=8, dense=True), {}),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_op_matches_reference(ref_pallas, monkeypatch, name):
    calls = []
    fwd = pattn.flash_fwd
    monkeypatch.setattr(pattn, "flash_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    shape, kwargs = ATTN_CASES[name]
    B, H, L, D = (shape[k] for k in "BHLD")
    rs = onp.random.RandomState(sum(map(ord, name)))
    arrays = [rs.standard_normal((B, H, L, D)).astype(onp.float32)
              for _ in range(3)]
    if shape.get("kmask"):
        arrays.append(_kmask(B, L, 4))
    if shape.get("dense"):
        arrays.append((rs.standard_normal((B, 1, L, L)) * 0.1).astype(
            onp.float32))
    long = L * L > pattn._PLAIN_ATTN_MAX_SCORES
    _compare("flash_attention", arrays, kwargs, rs,
             grad_tol=LONG_TOL if long else None)
    # rows past the threshold with no bias or a key mask take K1's
    # wrapper (its plain version here); a dense bias stays on the plain
    # path, as the reference's never reaches its kernels
    assert bool(calls) == (long and not shape.get("dense"))


def test_flash_attention_dropout_follows_training_mode():
    """``training`` omitted: ``mx.nd.flash_attention(q, k, v,
    dropout=0.5)`` is the inference value outside ``record()`` and drops
    inside it, as the reference's (tests/test_attention.py)."""
    rs = onp.random.RandomState(0)
    q, k, v = (rs.standard_normal((1, 2, 32, 8)).astype("f")
               for _ in range(3))
    for pkg in (rmx, mx):
        with mx.cpu():
            a = [pkg.nd.array(x) for x in (q, k, v)]
            pkg.random.seed(0)
            infer = pkg.nd.flash_attention(*a, dropout=0.5).asnumpy()
            plain = pkg.nd.flash_attention(*a).asnumpy()
            with pkg.autograd.record(train_mode=True):
                train = pkg.nd.flash_attention(*a, dropout=0.5).asnumpy()
            with pkg.autograd.record(train_mode=False):
                off = pkg.nd.flash_attention(*a, dropout=0.5).asnumpy()
        onp.testing.assert_array_equal(infer, plain)
        onp.testing.assert_array_equal(off, plain)
        assert onp.abs(train - infer).max() > 1e-4
    # and the tensor function itself, under record() through the wrapper
    # and explicitly
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with mx.autograd.record():
        dropped = pattn.flash_attention(*t, dropout=0.5)
    assert (dropped - pattn.flash_attention(*t, training=False)).abs().max() \
        > 1e-4


def test_ring_attention_raises_naming_the_reason():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.registry import get_op

    with pytest.raises(MXNetError, match="device mesh and shard_map"):
        get_op("ring_attention")
    with mx.cpu(), pytest.raises(MXNetError, match="not ported"):
        x = mx.nd.ones((1, 1, 4, 2))
        mx.nd.ring_attention(x, x, x)


# --------------------------------------------------------------------------- #
# coverage
# --------------------------------------------------------------------------- #

SPECIAL_TESTS = {"_DropoutImpl", "Deconvolution", "_BatchNormStats"}


def test_every_ported_op_has_a_case():
    """Each op that ops/nn.py and ops/attention.py register has a case
    above (or a test of its own), is ``mx.nd.<name>`` with the
    reference's aliases, and carries a reference op name."""
    from mxnet_tpu.ops.registry import OPS as ROPS
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES

    ported = set(_ported())
    assert {c[1] for c in CASES} | SPECIAL_TESTS == ported
    assert ported <= set(ROPS)
    for name in ported:
        assert getattr(mx.nd, name) is OPS[name].wrapper
    for new, target in RALIASES.items():
        if target in ported:
            assert getattr(mx.nd, new) is OPS[target].wrapper, new


def test_unported_reference_nn_ops_are_the_queued_detection_set():
    """No reference ops/nn.py name is missing from the port (``QUEUED``
    is empty; any name queued again must stand in ROADMAP);
    ring_attention is the one attention op left out, with its reason."""
    from mxnet_tpu.ops.registry import OPS as ROPS

    ref_nn = {n for n, o in ROPS.items()
              if o.fn.__module__ == "mxnet_tpu.ops.nn"}
    assert ref_nn - set(OPS) == QUEUED
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for name in QUEUED:
        short = name.replace("_contrib_", "")
        assert short in roadmap, short
    ref_attn = {n for n, o in ROPS.items()
                if o.fn.__module__ == "mxnet_tpu.ops.attention"}
    assert ref_attn - set(OPS) == set(NOT_PORTED) == {"ring_attention"}


@pytest.mark.parametrize("module", ["image_ops", "quantization"])
def test_reference_op_module_is_ported_whole(module):
    """Every op that ``mxnet_tpu/ops/<module>.py`` registers is registered
    by the port's ``ops/<module>.py`` under the same name, and is
    ``mx.nd.<name>``."""
    import importlib

    from mxnet_tpu.ops.registry import OPS as ROPS

    mod = importlib.import_module(f"mxnet_tpu_torch.ops.{module}")
    ref = {n for n, o in ROPS.items()
           if o.fn.__module__ == f"mxnet_tpu.ops.{module}"}
    here = {n for n, o in OPS.items() if o.fn.__module__ == mod.__name__}
    assert ref == here and len(ref) == {"image_ops": 11,
                                        "quantization": 5}[module]
    for name in ref:
        assert getattr(mx.nd, name) is OPS[name].wrapper


@pytest.mark.parametrize("space", ["contrib", "image"])
def test_nd_namespaces_expose_the_reference_names(space):
    """``mx.nd.contrib`` and ``mx.nd.image`` expose the reference's names,
    each the wrapper of the op the reference's name stands for."""
    ref_ns, port_ns = getattr(rmx.nd, space), getattr(mx.nd, space)
    names = [n for n in (ref_ns.__all__ if space == "contrib"
                         else vars(ref_ns)) if not n.startswith("_")]
    assert len(names) == 11
    for name in names:
        ref_fn, port_fn = getattr(ref_ns, name), getattr(port_ns, name)
        want = getattr(ref_fn, "_op", None)
        if want is None:
            assert port_fn is getattr(mx.nd, name)
        else:
            assert port_fn is OPS[want.name].wrapper, name


def test_registered_op_count():
    """165 registered names before the detection, image and quantization
    ops, 13 + 11 + 5 after them, 1 + 13 + 18 more with ``rnn``, ``linalg``
    and ``legacy``, 97 + 23 + 28 with ``extended``, ``optimizer_ops`` and
    ``samplers``, 3 with ``ndarray/sparse.py``, and every alias of the
    reference's that names a registered op."""
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES
    from mxnet_tpu_torch.ops.registry import _ALIASES

    import mxnet_tpu_torch.ndarray  # noqa: F401  (registers the sparse ops)

    assert len(OPS) == 165 + 13 + 11 + 5 + 1 + 13 + 18 + 97 + 23 + 28 + 3
    assert {k: v for k, v in RALIASES.items() if v in OPS} == \
        {k: v for k, v in _ALIASES.items() if v in OPS}
