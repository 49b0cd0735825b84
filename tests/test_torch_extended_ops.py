"""The port's ``ops/extended.py`` against ``mxnet_tpu/ops/extended.py``
on the CPU: every registered op on the conformance sweep's inputs
(``tests/test_op_conformance.py``'s, rebuilt without JAX in
``tests/_torch_corpus_cases.py``) and on the cases that pin the trouble
spots (medians of even counts, every quantile method, NaN slices, the
static sizes of ``unique_op``/``bincount_op``, fully masked softmax
rows, integer signs and shifts past the width, ``digamma``'s poles,
cumulative products through zeros), through each package's registered
function.

Tolerances (stated in ``tests/_torch_corpus_cases.py``): integer, bool,
index and shape ops and selections exactly; float elementwise ops within
1e-6 relative and 1e-7 absolute; reductions, contractions, scans, LRN,
the spatial transformer and norms within 1e-5; input gradients (against
``jax.vjp`` under the same seeded head gradients) within 1e-5.
``digamma``'s non-finite positions are compared as sets.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from _torch_corpus_cases import check_case_on_card, module_cases
from _torch_corpus_ref import check_case
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import extended as pext
from mxnet_tpu_torch.ops.registry import OPS, get_op

rmx = LazyReference()     # the JAX package, imported at first use

NAMES = sorted(n for n, o in OPS.items() if o.fn.__module__ == pext.__name__)
CASES = module_cases(NAMES, OPS)
ALIASES = ["_ravel_multi_index", "_unravel_index", "_contrib_index_array",
           "_contrib_arange_like", "_contrib_allclose",
           "softmax_cross_entropy_mask"]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    check_case(case)


def test_every_reference_op_is_ported():
    """The reference's ``ops/extended.py`` registers 97 ops; the port's
    registers the same names, and ``mx.nd`` exposes each under its op
    name and the reference's Python name."""
    from mxnet_tpu.ops import extended as rext
    from mxnet_tpu.ops.registry import OPS as ROPS

    ref = {n for n, o in ROPS.items() if o.fn.__module__ == rext.__name__}
    assert ref == set(NAMES) and len(ref) == 97
    for name in NAMES:
        assert getattr(mx.nd, name) is OPS[name].wrapper
    for pyname, obj in vars(rext).items():
        if callable(obj) and getattr(obj, "_op", None) is not None:
            assert getattr(mx.nd, pyname) is OPS[obj._op.name].wrapper


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_resolves(alias):
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES

    assert get_op(alias) is OPS[RALIASES[alias]]
    assert getattr(mx.nd, alias) is OPS[RALIASES[alias]].wrapper


def test_median_averages_the_middle_pair():
    """``median`` of an even count is the mean of the two middle values
    (``jnp.median``), where ``torch.median`` returns the lower one."""
    x = onp.asarray([[4.0, 1.0, 3.0, 2.0], [10.0, -1.0, 0.0, 7.0]],
                    onp.float32)
    with mx.cpu():
        got = mx.nd.median(mx.nd.array(x), axis=1).asnumpy()
    onp.testing.assert_array_equal(got, [2.5, 3.5])
    assert torch.median(torch.from_numpy(x), dim=1).values.tolist() == \
        [2.0, 0.0]


def test_quantile_beyond_torch_quantile_limit():
    """``quantile`` sorts: an input over 2**24 elements (which
    ``torch.quantile`` refuses) against numpy's linear quantiles."""
    x = onp.random.RandomState(0).standard_normal(2 ** 24 + 3).astype(
        onp.float32)
    q = [0.001, 0.5, 0.999]
    with mx.cpu():
        got = mx.nd.quantile(mx.nd.array(x), q=q).asnumpy()
    onp.testing.assert_allclose(got, onp.quantile(x, q), rtol=1e-5,
                                atol=1e-5)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(x), 0.5)


def test_bincount_without_a_length_raises():
    """A static length is required, in the reference and the port."""
    x = onp.asarray([0, 1, 1], onp.int32)
    with pytest.raises(ValueError, match="static length"):
        rmx.nd.bincount_op(rmx.nd.array(x))
    with mx.cpu(), pytest.raises(ValueError, match="static length"):
        mx.nd.bincount_op(mx.nd.array(x))


def test_histogram_defaults_to_unit_range():
    """Without ``range`` the bins span (0, 1): values outside are
    dropped and 1.0 falls in the last bin."""
    x = onp.asarray([-0.5, 0.05, 0.25, 0.5, 0.99, 1.0, 1.5], onp.float32)
    with mx.cpu():
        counts, edges = mx.nd.histogram_op(mx.nd.array(x), bin_cnt=4)
    onp.testing.assert_array_equal(counts.asnumpy(), [1, 1, 1, 2])
    onp.testing.assert_allclose(edges.asnumpy(), [0, 0.25, 0.5, 0.75, 1])


def test_fully_masked_row_and_its_gradient():
    """A row with every entry masked: ``masked_softmax`` gives zeros,
    ``masked_log_softmax`` -inf, and the gradient of the softmax is 0
    there and finite everywhere."""
    x = onp.random.RandomState(1).standard_normal((2, 4)).astype(
        onp.float32)
    mask = onp.asarray([[1, 0, 1, 1], [0, 0, 0, 0]], onp.float32)
    with mx.cpu():
        d = mx.nd.array(x)
        d.attach_grad()
        with mx.autograd.record():
            p = mx.nd.masked_softmax(d, mx.nd.array(mask))
        p.backward(mx.nd.array(onp.arange(8.0).reshape(2, 4)))
        logp = mx.nd.masked_log_softmax(mx.nd.array(x), mx.nd.array(mask))
    onp.testing.assert_array_equal(p.asnumpy()[1], 0.0)
    assert onp.isneginf(logp.asnumpy()[1]).all()
    assert onp.isneginf(logp.asnumpy()[0, 1])
    g = d.grad.asnumpy()
    assert onp.isfinite(g).all()
    onp.testing.assert_array_equal(g[1], 0.0)


def test_clip_global_norm_shares_its_body_with_gluon():
    """The op and ``gluon.utils.clip_global_norm`` compute one norm
    (``global_norm_sq``); the op reads nothing back to the host and
    scales by ``max_norm / (norm * scale + 1e-12)``, gluon's by
    ``max_norm / (norm + 1e-8)`` in place and returns the norm."""
    from mxnet_tpu_torch.gluon.utils import clip_global_norm

    rs = onp.random.RandomState(2)
    arrays = [rs.standard_normal(s).astype(onp.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    norm = onp.sqrt(sum((a.astype(onp.float64) ** 2).sum() for a in arrays))
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        real_item = torch.Tensor.item
        try:
            torch.Tensor.item = None        # any host read would fail
            outs = mx.nd.clip_global_norm(*nds, max_norm=1.0)
        finally:
            torch.Tensor.item = real_item
        body = float(torch.sqrt(pext.global_norm_sq(
            [n._data for n in nds])))
        got = clip_global_norm(nds, 1.0)
    assert got == pytest.approx(body, rel=1e-6)
    assert body == pytest.approx(norm, rel=1e-6)
    for o, n, a in zip(outs, nds, arrays):
        onp.testing.assert_allclose(o.asnumpy(), a / (body + 1e-12),
                                    rtol=1e-6)
        onp.testing.assert_allclose(n.asnumpy(), a * (1.0 / (body + 1e-8)),
                                    rtol=1e-6)


def test_reset_arrays_returns_zeros():
    with mx.cpu():
        a, b = mx.nd.array(onp.ones((2, 3))), mx.nd.array(onp.ones(4))
        za, zb = mx.nd.reset_arrays(a, b, num_arrays=2)
    onp.testing.assert_array_equal(za.asnumpy(), onp.zeros((2, 3)))
    onp.testing.assert_array_equal(zb.asnumpy(), onp.zeros(4))
    onp.testing.assert_array_equal(a.asnumpy(), onp.ones((2, 3)))


def test_multi_output_ops_refuse_out():
    """``out=`` raises for a multi-output op, as in the reference."""
    with mx.cpu():
        x = mx.nd.array(onp.ones((2, 3)))
        with pytest.raises(MXNetError, match="multi-output"):
            mx.nd.moments(x, axes=(0,), out=x)


@pytest.mark.cuda
def test_extended_ops_on_card_match_cpu():
    """Every case on the card against the port on the CPU (1e-5)."""
    need_cuda()
    for case in CASES:
        check_case_on_card(case)
