"""The port's ``linalg`` ops (``mxnet_tpu_torch/ops/linalg.py``) against
``mxnet_tpu/ops/linalg.py`` on the inputs of ``tests/test_linalg_ops.py``
(seeded numpy, f32 on the CPU), through each package's ``mx.nd``.

Tolerance: outputs and input gradients within 1e-5 (relative and
absolute).  ``linalg_gelqf`` and ``linalg_syevd`` inherit the sign
conventions of their library's QR and eigensolver, so they are held by
reconstruction, orthonormality and their values with each row's sign
normalised; on the CPU ``gelqf``'s raw signs agree with the reference's
(both Householder QR), ``syevd``'s differ (torch's LAPACK ``syevd``
against XLA's ``eigh``), so only their magnitudes are held raw.
"""
import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference, need_cuda

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).rand(*shape).astype(onp.float32)


def _spd(n, batch=(), seed=0):
    a = onp.random.RandomState(seed).rand(*batch, n, n).astype(onp.float32)
    return a @ a.swapaxes(-1, -2) + n * onp.eye(n, dtype=onp.float32)


def _chol(n, batch=()):
    return onp.linalg.cholesky(_spd(n, batch)).astype(onp.float32)


# (id, op, inputs, kwargs)
CASES = [
    ("gemm", "linalg_gemm", [_rand(1, 2, 3, 4), _rand(2, 2, 4, 5),
                             _rand(3, 2, 3, 5)], dict(alpha=2.0, beta=0.5)),
    ("gemm_t", "linalg_gemm", [_rand(1, 4, 3), _rand(2, 5, 4),
                               _rand(3, 3, 5)],
     dict(transpose_a=True, transpose_b=True, alpha=2.0, beta=3.0)),
    ("trmm", "linalg_trmm", [_rand(2, 4, 4), _rand(3, 4, 3)],
     dict(alpha=1.5)),
    ("trmm_right_upper_t", "linalg_trmm", [_rand(2, 2, 3, 3),
                                           _rand(3, 2, 4, 3)],
     dict(rightside=True, lower=False, transpose=True)),
    ("potri", "linalg_potri", [_chol(4)], {}),
    ("potri_batched", "linalg_potri", [_chol(3, (2,))], {}),
    ("sumlogdiag", "linalg_sumlogdiag", [_spd(5)], {}),
    ("sumlogdiag_batched", "linalg_sumlogdiag", [_spd(4, (3,))], {}),
    ("extractdiag", "linalg_extractdiag", [_rand(4, 2, 3, 3)], {}),
    ("extractdiag_offset", "linalg_extractdiag", [_rand(4, 4, 4)],
     dict(offset=1)),
    ("makediag", "linalg_makediag", [_rand(4, 2, 3)], {}),
    ("makediag_offset", "linalg_makediag", [_rand(4, 3)], dict(offset=-1)),
    ("extracttrian", "linalg_extracttrian", [_rand(5, 4, 4)], {}),
    ("maketrian", "linalg_maketrian", [_rand(5, 2, 10)], {}),
    ("inverse", "linalg_inverse", [_spd(3)], {}),
    ("inverse_batched", "linalg_inverse", [_spd(4, (2,), seed=3)], {}),
    ("det", "linalg_det", [_spd(3)], {}),
    ("det_general", "linalg_det", [_rand(6, 2, 3, 3) - 0.5], {}),
    ("slogdet", "linalg_slogdet", [_rand(6, 2, 3, 3) - 0.5], {}),
    ("alias_det", "det", [_spd(3)], {}),
    ("alias_slogdet", "slogdet", [_spd(3)], {}),
    ("alias_inverse", "inverse", [_spd(3)], {}),
]
for _off in (1, -1):
    for _low in (True, False):
        CASES.append((f"trian_{_off}_{'lower' if _low else 'upper'}",
                      "linalg_extracttrian", [_rand(0, 4, 4)],
                      dict(offset=_off, lower=_low)))
        _n = {(1, True): 13, (-1, True): 6, (1, False): 6,
              (-1, False): 13}[(_off, _low)]
        CASES.append((f"maketrian_{_off}_{'lower' if _low else 'upper'}",
                      "linalg_maketrian", [_rand(0, _n)],
                      dict(offset=_off, lower=_low)))


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _run(pkg, name, arrays, kwargs, heads):
    nds = [pkg.nd.array(a) for a in arrays]
    for x in nds:
        x.attach_grad()
    with pkg.autograd.record():
        outs = _outs(getattr(pkg.nd, name)(*nds, **kwargs))
    pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads])
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in nds]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_linalg_matches_reference(case):
    """Outputs (dtype and shape too) and the input gradients under the
    same random head gradients."""
    cid, name, arrays, kwargs = case
    rs = onp.random.RandomState(sum(map(ord, cid)))
    ref = _outs(getattr(rmx.nd, name)(*[rmx.nd.array(a) for a in arrays],
                                      **kwargs))
    heads = [rs.standard_normal(o.shape).astype(onp.float32) for o in ref]
    if name.endswith("slogdet"):
        heads[0] = onp.zeros_like(heads[0])       # the sign is constant
    r_out, r_grad = _run(rmx, name, arrays, kwargs, heads)
    with mx.cpu():
        p_out, p_grad = _run(mx, name, arrays, kwargs, heads)
    for p, r in zip(p_out, r_out):
        assert p.dtype == r.dtype and p.shape == r.shape
        onp.testing.assert_allclose(p, r, **TOL)
    for p, r in zip(p_grad, r_grad):
        onp.testing.assert_allclose(p, r, **TOL)


def _lq_normalised(q, lo):
    """Each (row of Q, column of L) pair's sign flipped so L's diagonal is
    positive: the factorization's only freedom."""
    s = onp.sign(onp.diagonal(lo, axis1=-2, axis2=-1))
    s[s == 0] = 1
    return q * s[..., :, None], lo * s[..., None, :]


def _rows_normalised(u):
    """Each eigenvector (row) signed so its largest entry is positive."""
    idx = onp.abs(u).argmax(-1)
    s = onp.sign(onp.take_along_axis(u, idx[..., None], -1))
    return u * s


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 6), (4, 4)],
                         ids=["3x5", "2x4x6", "4x4"])
def test_gelqf_by_reconstruction_and_signs(shape):
    A = _rand(7, *shape) - 0.5
    rq, rl = [o.asnumpy() for o in rmx.nd.linalg_gelqf(rmx.nd.array(A))]
    with mx.cpu():
        pq, pl = [o.asnumpy() for o in mx.nd.linalg_gelqf(mx.nd.array(A))]
    m = shape[-2]
    onp.testing.assert_allclose(pl @ pq, A, **TOL)
    onp.testing.assert_allclose(pq @ pq.swapaxes(-1, -2),
                                onp.broadcast_to(onp.eye(m), pl.shape),
                                **TOL)
    onp.testing.assert_allclose(pl, onp.tril(pl), atol=0)
    for p, r in zip(_lq_normalised(pq, pl), _lq_normalised(rq, rl)):
        onp.testing.assert_allclose(p, r, **TOL)
    # on the CPU both packages call LAPACK's Householder QR: the raw
    # signs agree too
    onp.testing.assert_allclose(pq, rq, **TOL)
    onp.testing.assert_allclose(pl, rl, **TOL)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batched"])
def test_syevd_by_reconstruction_and_signs(batch):
    M = _spd(4, batch, seed=5)
    ru, rw = [o.asnumpy() for o in rmx.nd.linalg_syevd(rmx.nd.array(M))]
    with mx.cpu():
        pu, pw = [o.asnumpy() for o in mx.nd.linalg_syevd(mx.nd.array(M))]
    recon = pu.swapaxes(-1, -2) @ (pw[..., :, None] * pu)
    onp.testing.assert_allclose(recon, M, **TOL)
    onp.testing.assert_allclose(pu @ pu.swapaxes(-1, -2),
                                onp.broadcast_to(onp.eye(4), pu.shape),
                                **TOL)
    onp.testing.assert_allclose(pw, rw, **TOL)
    onp.testing.assert_allclose(_rows_normalised(pu), _rows_normalised(ru),
                                **TOL)
    # the raw signs are the eigensolvers' own: torch's LAPACK syevd and
    # XLA's eigh choose them differently (ROADMAP "Deliberate
    # differences"), the magnitudes agree
    onp.testing.assert_allclose(abs(pu), abs(ru), **TOL)


def test_maketrian_refuses_an_impossible_count():
    with mx.cpu(), pytest.raises(mx.base.MXNetError, match="cannot infer"):
        mx.nd.linalg_maketrian(mx.nd.array(onp.zeros(4, onp.float32)))


@pytest.mark.cuda
def test_linalg_on_card_equals_cpu():
    """The batched SPD ops on the card against the CPU (what
    ``chip_smoke.py`` phase 23.5 runs at 64 x 256²)."""
    need_cuda()
    M = _spd(32, (4,), seed=9)
    L = onp.linalg.cholesky(M).astype(onp.float32)
    for name, arr in (("linalg_potri", L), ("linalg_inverse", M),
                      ("linalg_slogdet", M), ("linalg_sumlogdiag", L)):
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                res.append([o.asnumpy() for o in _outs(
                    getattr(mx.nd, name)(mx.nd.array(arr)))])
        for g, c in zip(*res):
            onp.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-5)
