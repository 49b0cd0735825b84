"""``mxnet_tpu_torch.nd.NDArray`` and ``context`` against the reference's
(``mxnet_tpu``), on the same numpy inputs: creation, metadata, host
copies, indexing, the operators with broadcasting, in-place rebinds,
conversions and moves, and ``nd.save``/``nd.load`` bit for bit in both
directions.  Float results within 1e-6 relative (f32 on the CPU);
integer results and file bytes exactly."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-6, atol=1e-7)


def _pair(a, dtype=None):
    """The same numpy array in both packages (the port's on the host)."""
    return rmx.nd.array(a, dtype=dtype), mx.nd.array(a, ctx=mx.cpu(),
                                                     dtype=dtype)


def _same(r, p, exact=False):
    assert p.shape == r.shape, (p.shape, r.shape)
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    if exact:
        onp.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    else:
        onp.testing.assert_allclose(p.asnumpy(), r.asnumpy(), **TOL)


def test_creation_and_metadata():
    rs = onp.random.RandomState(0)
    for src in ([[1.5, 2.0], [3.0, 4.0]], rs.standard_normal((2, 3)),
                onp.arange(6).reshape(2, 3), [1, 2, 3],
                rs.standard_normal((4,)).astype(onp.float16)):
        r, p = _pair(src)
        _same(r, p, exact=True)
        assert (p.size, p.ndim, len(p)) == (r.size, r.ndim, len(r))
        assert p.context == mx.cpu(0) and p.ctx.device_type == "cpu"
        assert p.stype == r.stype == "default"
    r, p = _pair([1, 2], dtype="float32")
    _same(r, p, exact=True)
    with mx.cpu():
        for name in ("zeros", "ones"):
            _same(getattr(rmx.nd, name)((2, 3), dtype="int32"),
                  getattr(mx.nd, name)((2, 3), dtype="int32"), exact=True)
        _same(rmx.nd.empty((2, 2)), mx.nd.empty((2, 2)), exact=True)
        x = mx.nd.array(onp.arange(4.0))
        assert x.astorch().device.type == "cpu"
        assert mx.nd.from_torch(x.astorch()).astorch() is x.astorch()


def test_host_copies_and_scalars():
    r, p = _pair([[7.0]])
    assert p.item() == r.item() == 7.0
    assert p.asscalar() == r.asscalar() == 7.0
    assert float(p) == 7.0 and int(p) == 7 and bool(p)
    assert p.tolist() == r.tolist()
    assert onp.asarray(p).shape == (1, 1)
    # a 0-d result reads back as the reference's: at least 1-d
    rs, ps = r.sum(), p.sum()
    assert ps.shape == rs.shape == ()
    assert ps.asnumpy().shape == rs.asnumpy().shape
    with pytest.raises(ValueError):
        _pair([1.0, 2.0])[1].asscalar()
    mx.nd.waitall()
    assert p.wait_to_read() is p


def test_bfloat16_reads_back_as_float32():
    with mx.cpu():
        x = mx.nd.array([1.0, 2.5], dtype="bfloat16")
    assert x.dtype == torch.bfloat16
    assert x.asnumpy().dtype == onp.float32
    onp.testing.assert_array_equal(x.asnumpy(), [1.0, 2.5])


@pytest.mark.parametrize("key", [1, -1, slice(1, 3), (0, slice(None, 2)),
                                 (slice(None), 2), (Ellipsis, 1),
                                 "nd_index", "bool_mask"])
def test_getitem(key):
    a = onp.arange(24, dtype=onp.float32).reshape(4, 6)
    r, p = _pair(a)
    if key == "nd_index":
        rk, pk = _pair(onp.array([2, 0, 3]), dtype="int32")
    elif key == "bool_mask":
        m = onp.array([True, False, True, True])
        rk, pk = m, m
    else:
        rk = pk = key
    _same(r[rk], p[pk], exact=True)


@pytest.mark.parametrize("key,value", [
    (1, 5.0), (slice(0, 2), -1.0), ((slice(None), 1), "array"),
    ((2, slice(1, 4)), "row")])
def test_setitem(key, value):
    a = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    r, p = _pair(a)
    if value == "array":
        rv, pv = _pair(onp.array([9.0, 8.0, 7.0], onp.float32))
    elif value == "row":
        rv, pv = _pair(onp.array([1.0, 2.0, 3.0], onp.float32))
    else:
        rv = pv = value
    handle = p.astorch()
    r[key] = rv
    p[key] = pv
    _same(r, p, exact=True)
    assert handle[0, 0].item() == 0.0       # a rebind, not a write


@pytest.mark.parametrize("op", [
    "add", "sub", "mul", "truediv", "mod", "pow", "radd", "rsub", "rmul",
    "rtruediv", "eq", "ne", "lt", "le", "gt", "ge", "neg", "abs",
    "matmul"])
def test_operators_with_broadcasting(op):
    rs = onp.random.RandomState(len(op))
    a = rs.uniform(0.5, 2.0, (3, 4)).astype(onp.float32)
    b = rs.uniform(0.5, 2.0, (4,)).astype(onp.float32)
    a[0, :2] = b[:2]                         # some equal entries
    ra, pa = _pair(a)
    rb, pb = _pair(b)
    f = {
        "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
        "mul": lambda x, y: x * y, "truediv": lambda x, y: x / y,
        "mod": lambda x, y: x % y, "pow": lambda x, y: x ** y,
        "radd": lambda x, y: 2 + x, "rsub": lambda x, y: 2 - x,
        "rmul": lambda x, y: 3 * x, "rtruediv": lambda x, y: 2 / x,
        "eq": lambda x, y: x == y, "ne": lambda x, y: x != y,
        "lt": lambda x, y: x < y, "le": lambda x, y: x <= y,
        "gt": lambda x, y: x > y, "ge": lambda x, y: x >= y,
        "neg": lambda x, y: -x, "abs": lambda x, y: abs(x),
        "matmul": lambda x, y: x.T @ x,
    }[op]
    _same(f(ra, rb), f(pa, pb))
    # a Python number takes the array's dtype (int: truncated)
    ri, pi = _pair(onp.arange(6).reshape(2, 3))
    _same(f(ri, 2.7) if op not in ("matmul", "pow", "truediv", "rtruediv")
          else ri, f(pi, 2.7) if op not in ("matmul", "pow", "truediv",
                                            "rtruediv") else pi, exact=True)


def test_inplace_rebinds():
    a = onp.arange(1, 7, dtype=onp.float32).reshape(2, 3)
    r, p = _pair(a)
    before = p.astorch()
    for name, v in (("__iadd__", 1.5), ("__isub__", 0.5),
                    ("__imul__", 3.0), ("__itruediv__", 2.0)):
        r2 = getattr(r, name)(v)
        p2 = getattr(p, name)(v)
        assert p2 is p and r2 is r
        _same(r, p)
    assert p.astorch() is not before
    onp.testing.assert_array_equal(before.numpy(), a)   # never written


def test_astype_copy_copyto_and_moves():
    a = onp.random.RandomState(3).standard_normal((2, 3)).astype(onp.float32)
    r, p = _pair(a)
    for dt in ("int32", "float16", onp.float32):
        _same(r.astype(dt), p.astype(dt), exact=True)
    assert p.astype("bfloat16").dtype == torch.bfloat16
    c = p.copy()
    assert c.astorch().data_ptr() != p.astorch().data_ptr()
    _same(r.copy(), c, exact=True)
    rt, pt = _pair(onp.zeros((2, 3), onp.float16))
    r.copyto(rt)
    p.copyto(pt)
    _same(rt, pt, exact=True)
    with pytest.raises(MXNetError):
        p.copyto(mx.nd.zeros((3, 2), ctx=mx.cpu()))
    assert p.copyto(mx.cpu()) is p
    assert p.as_in_context(mx.cpu()) is p
    d = p.detach()
    assert d.astorch().data_ptr() == p.astorch().data_ptr()


def test_method_forms_match_reference():
    a = onp.random.RandomState(4).standard_normal((2, 3, 4)).astype(
        onp.float32)
    r, p = _pair(a)
    for f in (lambda x: x.reshape(6, 4), lambda x: x.reshape((0, -1)),
              lambda x: x.transpose(), lambda x: x.transpose(1, 0, 2),
              lambda x: x.T, lambda x: x.expand_dims(1),
              lambda x: x.reshape(2, 1, 12).squeeze(1), lambda x: x.flatten(),
              lambda x: x.swapaxes(0, 2), lambda x: x.sum(axis=1),
              lambda x: x.mean(), lambda x: x.max(axis=2, keepdims=True),
              lambda x: x.min(axis=0), lambda x: x.norm(axis=1),
              lambda x: x.argmax(axis=2), lambda x: x.argmin(axis=1),
              lambda x: x.topk(k=2), lambda x: x.sort(), lambda x: x.argsort(),
              lambda x: x.abs().sqrt(), lambda x: x.exp().log(),
              lambda x: x.square(), lambda x: x.relu(), lambda x: x.sigmoid(),
              lambda x: x.tanh(), lambda x: x.clip(-0.5, 0.5),
              lambda x: x.round(), lambda x: x.slice_axis(2, 1, 3),
              lambda x: x.slice((0, 1), (2, 3)), lambda x: x.tile((1, 2, 1)),
              lambda x: x.repeat(2, axis=0), lambda x: x.flip(1),
              lambda x: x.broadcast_to((2, 2, 3, 4)),
              lambda x: x.reshape(6, 4).dot(x.reshape(6, 4).T),
              lambda x: x.reshape(4, 6).diag(1),
              lambda x: x.reshape(2, 3, 2, 2).pad(
                  pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
              lambda x: x.split(3, axis=1)[1], lambda x: x.prod(axis=2),
              lambda x: x.reshape_like(x.reshape(4, 6)),
              lambda x: x.broadcast_like(x.reshape(2, 3, 4)),
              lambda x: x.argmax(axis=2).one_hot(4),
              lambda x: x.take(x.argmax(axis=2).reshape(-1)[:3])):
        _same(f(r), f(p))


def test_iteration_and_len():
    r, p = _pair(onp.arange(6, dtype=onp.float32).reshape(3, 2))
    for a, b in zip(r, p):
        _same(a, b, exact=True)
    with pytest.raises(TypeError):
        len(mx.nd.array(1.0, ctx=mx.cpu()))


def test_sparse_storage_waits():
    """Sparse storage is ported (``ndarray/sparse.py``; the name keeps the
    slice before it was): ``tostype`` converts, and ``attach_grad(stype=)``
    takes a sparse storage type with a dense buffer, as the reference's;
    an unknown storage type raises."""
    with mx.cpu():
        x = mx.nd.ones((2, 2))
    assert x.tostype("default") is x
    c = x.tostype("csr")
    assert c.stype == "csr" and (c.asnumpy() == 1).all()
    x.attach_grad(stype="row_sparse")
    assert x.grad.stype == "default" and x.grad.shape == (2, 2)
    with pytest.raises(MXNetError, match="storage"):
        x.attach_grad(stype="coo")


# --------------------------------------------------------------------------- #
# nd.save / nd.load across the packages
# --------------------------------------------------------------------------- #

def _arrays():
    rs = onp.random.RandomState(7)
    return {"w": rs.standard_normal((3, 4)).astype(onp.float32),
            "h": rs.standard_normal((5,)).astype(onp.float16),
            "i": rs.randint(-9, 9, (2, 2)).astype(onp.int32),
            "u": rs.randint(0, 255, (4,)).astype(onp.uint8),
            "c": rs.randint(-100, 100, (3,)).astype(onp.int8),
            "s": onp.float32(2.5).reshape(()),
            "b": rs.standard_normal((2, 3)).astype(onp.float32)}


def _bits(nd):
    t = nd.astorch() if isinstance(nd, mx.nd.NDArray) else None
    if t is not None:
        t = t.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else
                t).numpy().tobytes()
    a = onp.asarray(nd._data)
    return a.view(onp.int16).tobytes() if a.dtype.name == "bfloat16" \
        else a.tobytes()


@pytest.mark.parametrize("as_dict", [True, False])
def test_save_load_bit_for_bit_both_ways(tmp_path, as_dict):
    arrays = _arrays()
    ref = {k: rmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    ref["b"] = ref["b"].astype("bfloat16")
    with mx.cpu():
        port = {k: mx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    port["b"] = port["b"].astype("bfloat16")
    names = list(arrays)
    fr, fp = tmp_path / "ref.params", tmp_path / "port.params"
    rmx.nd.save(str(fr), ref if as_dict else [ref[k] for k in names])
    mx.nd.save(str(fp), port if as_dict else [port[k] for k in names])
    # the two writers produce the same bytes
    assert fr.read_bytes() == fp.read_bytes()
    with mx.cpu():                  # load lands on the current context
        p_from_r = mx.nd.load(str(fr))
    r_from_p = rmx.nd.load(str(fp))
    if not as_dict:
        p_from_r = dict(zip(names, p_from_r))
        r_from_p = dict(zip(names, r_from_p))
    for k in names:
        assert p_from_r[k].shape == onp.atleast_1d(arrays[k]).shape
        assert _bits(p_from_r[k]) == _bits(ref[k]), k
        assert _bits(r_from_p[k]) == _bits(port[k]), k
        assert p_from_r[k].context == mx.cpu()


def test_load_refuses_bad_files(tmp_path):
    f = tmp_path / "bad.params"
    f.write_bytes(b"\x00" * 24)
    with pytest.raises(MXNetError, match="magic"):
        mx.nd.load(str(f), ctx=mx.cpu())
    with pytest.raises(MXNetError):
        mx.nd.save(str(f), [onp.zeros(2)])


# --------------------------------------------------------------------------- #
# contexts
# --------------------------------------------------------------------------- #

def test_context_stack_and_identity():
    c0, c1 = mx.cpu(), mx.cpu(1)
    assert c0 == mx.Context("cpu", 0) and c0 != c1
    assert hash(c0) == hash(mx.cpu(0)) and repr(c1) == "cpu(1)"
    assert c0.device_typeid == 1
    with c0:
        assert mx.current_context() == c0
        with c1:
            assert mx.current_context() == c1
        assert mx.current_context() == c0
        assert mx.nd.zeros((1,)).context == c0


def test_refusals_without_cuda(monkeypatch):
    """Without CUDA, ``gpu()``, the default context (``gpu(0)``) and every
    array made on it raise; ``tpu()`` raises naming ``gpu()``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="gpu()"):
        mx.context.tpu()
    with pytest.raises(MXNetError):
        mx.Context("tpu", 0)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.gpu()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.current_context()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.zeros((2,))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.context.gpu_memory_info()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.array([1.0], ctx=mx.cpu()).as_in_context(mx.Context("gpu"))
    assert mx.num_gpus() == 0
    with pytest.raises(MXNetError):
        mx.Context("fpga")
