"""``mx.nd.sparse`` of the port (``mxnet_tpu_torch/ndarray/sparse.py``)
against ``mxnet_tpu/ndarray/sparse.py`` on the CPU, on the value tables
of ``tests/test_sparse.py`` (seeded scipy matrices and hand-written
row_sparse arrays) passed to both packages.

Tolerances: components (data, indices, indptr) and storage types equal
exactly; csr·dense, csrᵀ·dense, row_sparse·dense (and transposed) and
their gradients with respect to the dense operand within 1e-5; the
union and intersection kernels exact in pattern and within 1e-6 in
value (the reference sums in f32 with ``segment_sum``, the port with one
ordered addition a slot); the registered ops called through both
registries within 1e-5.  The card's ``cuda`` test holds the same ops on
the card against the CPU.
"""
import contextlib

import numpy as onp
import pytest
import scipy.sparse as sp
import torch

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference, need_cuda
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.ndarray import sparse as psp

rmx = LazyReference()
TOL = dict(rtol=1e-5, atol=1e-5)


def _rsp():
    from mxnet_tpu.ndarray import sparse
    return sparse


def _rand_csr(m, n, density=0.3, seed=0):
    return sp.random(m, n, density=density,
                     random_state=onp.random.RandomState(seed),
                     format="csr", dtype=onp.float32)


def _both_csr(mat):
    r = _rsp().csr_matrix((mat.data, mat.indices, mat.indptr),
                          shape=mat.shape)
    with pmx.cpu():
        p = psp.csr_matrix((mat.data, mat.indices, mat.indptr),
                           shape=mat.shape)
    return r, p


def _both_rs(vals, idx, shape):
    r = _rsp().row_sparse_array((vals, idx), shape=shape)
    with pmx.cpu():
        p = psp.row_sparse_array((vals, idx), shape=shape)
    return r, p


def _components_equal(r, p):
    assert r.stype == p.stype and tuple(r.shape) == tuple(p.shape)
    names = ("data", "indices", "indptr") if r.stype == "csr" else \
        ("data", "indices")
    for n in names:
        onp.testing.assert_array_equal(
            getattr(p, n).asnumpy(),
            onp.asarray(getattr(r, n).asnumpy()).astype(
                getattr(p, n).asnumpy().dtype), err_msg=n)


def test_construction_is_lazy_and_components_equal():
    r, p = _both_csr(_rand_csr(8, 6))
    assert p._dense_cache is None
    _components_equal(r, p)
    onp.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    vals = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    r, p = _both_rs(vals, onp.array([1, 4]), (6, 3))
    assert p._dense_cache is None
    _components_equal(r, p)
    onp.testing.assert_array_equal(p.asnumpy(), r.asnumpy())


DOT_CASES = {
    "csr": dict(kind="csr", shape=(16, 12), rhs=(12, 5)),
    "csr_t": dict(kind="csr", shape=(16, 12), rhs=(16, 7), ta=True),
    "csr_tb": dict(kind="csr", shape=(10, 8), rhs=(4, 8), tb=True),
    "rs": dict(kind="rs", shape=(9, 6), rhs=(6, 4)),
    "rs_t": dict(kind="rs", shape=(7, 6), rhs=(7, 4), ta=True),
}


@pytest.mark.parametrize("name", list(DOT_CASES))
def test_dot_and_its_gradient_match_the_reference(name):
    c = DOT_CASES[name]
    rs = onp.random.RandomState(1)
    if c["kind"] == "csr":
        r, p = _both_csr(_rand_csr(*c["shape"], seed=2))
    else:
        m, n = c["shape"]
        idx = onp.array(sorted(rs.choice(m, 3, replace=False)))
        r, p = _both_rs(rs.randn(3, n).astype(onp.float32), idx,
                        c["shape"])
    rhs = rs.randn(*c["rhs"]).astype(onp.float32)
    kw = dict(transpose_a=c.get("ta", False), transpose_b=c.get("tb", False))
    rx = rmx.nd.array(rhs)
    rx.attach_grad()
    with rmx.autograd.record():
        rout = _rsp().dot(r, rx, **kw)
        rl = (rout * rout).sum()
    rl.backward()
    with pmx.cpu():
        px = pmx.nd.array(rhs)
    px.attach_grad()
    with autograd.record():
        pout = psp.dot(p, px, **kw)
        pl = (pout * pout).sum()
    pl.backward()
    onp.testing.assert_allclose(pout.asnumpy(), rout.asnumpy(), **TOL)
    if kw["transpose_b"]:
        # the reference transposes rhs outside the tape
        # (mxnet_tpu/ndarray/sparse.py:377-378), so its gradient is zero; the
        # port's is the dense one, d sum(y^2) / d rhs = (2 y)^T A
        assert not rx.grad.asnumpy().any()
        want = (2 * pout.asnumpy()).T @ p.asnumpy()
        onp.testing.assert_allclose(px.grad.asnumpy(), want, **TOL)
        return
    onp.testing.assert_allclose(px.grad.asnumpy(), rx.grad.asnumpy(), **TOL)


UNION_CASES = [("add", 0.3), ("subtract", 0.3), ("multiply", 0.3),
               ("add", 0.05), ("multiply", 0.6)]


@pytest.mark.parametrize("opname,density", UNION_CASES,
                         ids=[f"{o}-{d}" for o, d in UNION_CASES])
def test_csr_union_matches_the_reference(opname, density):
    ra, pa = _both_csr(_rand_csr(9, 7, density, seed=6))
    rb, pb = _both_csr(_rand_csr(9, 7, density, seed=7))
    rout = getattr(_rsp(), opname)(ra, rb)
    pout = getattr(psp, opname)(pa, pb)
    assert pout.stype == "csr"
    for n in ("indices", "indptr"):
        onp.testing.assert_array_equal(getattr(pout, n).asnumpy(),
                                       getattr(rout, n).asnumpy())
    onp.testing.assert_allclose(pout.data.asnumpy(), rout.data.asnumpy(),
                                rtol=1e-6, atol=1e-6)


def test_csr_cancellation_prunes_explicit_zeros():
    mat = _rand_csr(6, 6, seed=11)
    ra, pa = _both_csr(mat)
    rout, pout = _rsp().subtract(ra, ra), psp.subtract(pa, pa)
    assert pout.data.shape == rout.data.shape == (0,)
    onp.testing.assert_array_equal(pout.indptr.asnumpy(),
                                   rout.indptr.asnumpy())


@pytest.mark.parametrize("opname", ["add", "subtract", "multiply"])
def test_row_sparse_union_matches_the_reference(opname):
    ra, pa = _both_rs(onp.ones((2, 3), onp.float32), onp.array([1, 3]),
                      (6, 3))
    rb, pb = _both_rs(2 * onp.ones((2, 3), onp.float32), onp.array([3, 5]),
                      (6, 3))
    rout = getattr(_rsp(), opname)(ra, rb)
    pout = getattr(psp, opname)(pa, pb)
    _components_equal(rout, pout)


def test_operators_dispatch_as_the_reference():
    vals = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    ra, pa = _both_rs(vals, onp.array([1, 4]), (6, 3))
    rb, pb = _both_rs(onp.ones((2, 3), onp.float32), onp.array([4, 5]),
                      (6, 3))
    for f in (lambda a, b: a + b, lambda a, b: a * b, lambda a, b: a - b):
        _components_equal(f(ra, rb), f(pa, pb))
    for f in (lambda a: a * 2.0, lambda a: 2.0 * a, lambda a: a / 2.0):
        out = f(pa)
        assert out.stype == "row_sparse" and out._dense_cache is None
        onp.testing.assert_array_equal(out.asnumpy(), f(ra).asnumpy())
    for f in (lambda a: 2.0 / a, lambda a: a + 1.0):
        assert f(pa).stype == f(ra).stype == "default"
    with pmx.cpu():
        ones = pmx.nd.ones((6, 3))
    assert (pa + ones).stype == "default"
    onp.testing.assert_array_equal((pa + ones).asnumpy(),
                                   (ra + rmx.nd.ones((6, 3))).asnumpy())
    r1, p1 = _both_csr(_rand_csr(6, 6, seed=20))
    r2, p2 = _both_csr(_rand_csr(6, 6, seed=21))
    _components_equal(r1 - r2, p1 - p2)


def test_operator_gradients_flow_under_record():
    vals = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    grads = []
    for pkg, mk in ((rmx, _rsp().row_sparse_array),
                    (pmx, psp.row_sparse_array)):
        with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
            a = mk((vals, onp.array([1, 4])), shape=(6, 3))
            b = mk((onp.ones((2, 3), onp.float32), onp.array([4, 5])),
                   shape=(6, 3))
        a.attach_grad(stype="row_sparse")
        b.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.sum(a * b)
        loss.backward()
        grads.append((a.grad.asnumpy(), b.grad.asnumpy()))
    for g_r, g_p in zip(*grads):
        onp.testing.assert_array_equal(g_p, g_r)


def test_retain_zeros_and_cast_storage():
    vals = onp.arange(12, dtype=onp.float32).reshape(4, 3)
    ra, pa = _both_rs(vals, onp.array([0, 2, 5, 6]), (8, 3))
    _components_equal(_rsp().sparse_retain(ra, rmx.nd.array([2, 6])),
                      psp.sparse_retain(pa, onp.array([2, 6])))
    with pmx.cpu():
        for stype in ("row_sparse", "csr"):
            z = psp.zeros(stype, (5, 4))
            _components_equal(_rsp().zeros(stype, (5, 4)), z)
        dense = onp.random.RandomState(8).randn(5, 5).astype(onp.float32)
        dense[dense < 0.5] = 0
        for stype in ("csr", "row_sparse"):
            p = pmx.nd.cast_storage(pmx.nd.array(dense), stype)
            r = rmx.nd.sparse.cast_storage(rmx.nd.array(dense), stype)
            _components_equal(r, p)
            assert pmx.nd.array(dense).tostype(stype).stype == stype
            back = pmx.nd.cast_storage(p, "default")
            assert back.stype == "default"
            onp.testing.assert_array_equal(back.asnumpy(), dense)


def test_rebind_refreshes_components():
    with pmx.cpu():
        a = psp.row_sparse_array((onp.ones((1, 2), onp.float32), [1]),
                                 shape=(4, 2))
    new = torch.zeros(4, 2)
    new[3] = 7
    a._data = new
    onp.testing.assert_array_equal(a.indices.asnumpy(), [3])
    onp.testing.assert_array_equal(a.data.asnumpy(), [[7, 7]])
    with pmx.cpu():
        c = psp.csr_matrix(onp.eye(3, dtype=onp.float32))
    c._data = c._data * 2
    onp.testing.assert_array_equal(c.data.asnumpy(), [2, 2, 2])


def test_shape_mismatch_and_params_files_refuse(tmp_path):
    from mxnet_tpu_torch.base import MXNetError

    with pmx.cpu():
        a = psp.row_sparse_array((onp.ones((1, 3), onp.float32), [1]),
                                 shape=(4, 3))
        b = psp.row_sparse_array((onp.ones((1, 3), onp.float32), [5]),
                                 shape=(6, 3))
    with pytest.raises(MXNetError):
        psp.add(a, b)
    # a .params file with sparse storage is refused, as the reference does
    import struct

    f = tmp_path / "s.params"
    rmx.nd.save(str(f), [rmx.nd.zeros((2,))])
    raw = bytearray(f.read_bytes())
    head = struct.pack("<I", 0xF993FAC9) + struct.pack("<i", 0)
    at = bytes(raw).index(head) + 4
    raw[at:at + 4] = struct.pack("<i", 1)
    f.write_bytes(bytes(raw))
    with pytest.raises(Exception, match="sparse"):
        rmx.nd.load(str(f))
    with pytest.raises(MXNetError, match="sparse"):
        pmx.nd.load(str(f), ctx=pmx.cpu())


@pytest.mark.parametrize("op", ["_sparse_segment_dot",
                                "_sparse_rowsparse_dot",
                                "_sparse_rowsparse_dot_t"])
def test_registered_ops_match_the_reference(op):
    from mxnet_tpu_torch.ops.registry import OPS as POPS

    ref_fn = {"_sparse_segment_dot": "_segment_dot",
              "_sparse_rowsparse_dot": "_rowsparse_dot",
              "_sparse_rowsparse_dot_t": "_rowsparse_dot_t"}[op]

    rs = onp.random.RandomState(4)
    rhs = rs.randn(6, 3).astype(onp.float32)
    if op == "_sparse_segment_dot":
        args = [rs.randn(10).astype(onp.float32),
                rs.randint(0, 6, 10).astype(onp.int32),
                rs.randint(0, 5, 10).astype(onp.int32), rhs]
        kw = dict(num_segments=5)
    else:
        args = [rs.randn(3, 6).astype(onp.float32),
                onp.array([0, 2, 5], onp.int32),
                rs.randn(6 if op.endswith("_t") else 6, 3).astype(
                    onp.float32)]
        kw = dict(num_rows=6) if op == "_sparse_rowsparse_dot" else \
            dict(num_cols=6)
    ref = getattr(_rsp(), ref_fn)(*[rmx.nd.array(a, dtype=a.dtype)
                                    for a in args], **kw)
    with pmx.cpu():
        got = POPS[op].wrapper(*[pmx.nd.array(a, dtype=str(a.dtype))
                                 for a in args], **kw)
    onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)


@pytest.mark.cuda
def test_sparse_ops_on_the_card_equal_the_cpu():
    """csr·dense, csrᵀ·dense and their gradient, and the unions, on the
    card against the same calls on the CPU: the sorted segment sums
    repeat bit for bit; the dots agree within 1e-5."""
    need_cuda()
    mat = _rand_csr(64, 48, seed=3)
    rhs = onp.random.RandomState(2).randn(48, 8).astype(onp.float32)
    out = {}
    for dev in ("cpu", "gpu"):
        ctx = pmx.cpu() if dev == "cpu" else pmx.gpu(0)
        with ctx:
            a = psp.csr_matrix((mat.data, mat.indices, mat.indptr),
                               shape=mat.shape)
            x = pmx.nd.array(rhs)
        x.attach_grad()
        with autograd.record():
            y = psp.dot(a, x)
            L = (y * y).sum()
        L.backward()
        out[dev] = (y.asnumpy(), x.grad.asnumpy(),
                    psp.add(a, a).data.asnumpy())
    for g, c in zip(out["gpu"], out["cpu"]):
        onp.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-5)
