"""``mx.io`` of the PyTorch port against the JAX package on the CPU:
``NDArrayIter`` (pad, discard, roll_over, seeded shuffle), ``ResizeIter``,
``PrefetchingIter`` (host thread, ``device=``, ``MXNET_DEVICE_PREFETCH=0``),
``CSVIter`` and ``MNISTIter`` over files written here, and
``ImageRecordIter`` over JPEG records written here with PIL.

Both packages get the same arrays (made from a seed with numpy) and
files; batches are compared bit for bit, dtypes, ``pad`` and ``index``
included.  Port iterators are made under ``with mx.cpu():``: an iterator
places its batches on the context current when it was made.
"""
import gzip
import random
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import recordio as prio
from mxnet_tpu_torch.base import MXNetError


def _seed(s):
    random.seed(s)
    onp.random.seed(s)


def _batches(it, n=None):
    out = []
    for k, b in enumerate(it):
        if n is not None and k == n:
            break
        out.append(dict(
            data=[d.asnumpy() for d in b.data],
            label=[l.asnumpy() for l in (b.label or [])], pad=b.pad,
            index=None if b.index is None else onp.asarray(b.index)))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["pad"] == y["pad"]
        if x["index"] is None or y["index"] is None:
            assert x["index"] is None and y["index"] is None
        else:
            onp.testing.assert_array_equal(x["index"], y["index"])
        for k in ("data", "label"):
            assert len(x[k]) == len(y[k])
            for u, v in zip(x[k], y[k]):
                assert u.dtype == v.dtype and u.shape == v.shape
                onp.testing.assert_array_equal(u, v)


def _data(n=25):
    rs = onp.random.RandomState(0)
    return rs.rand(n, 2, 3), rs.randint(0, 5, n)      # float64, int64


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter(handle, shuffle):
    x, y = _data()

    def run(mx):
        it = mx.io.NDArrayIter(x, y, batch_size=10, shuffle=shuffle,
                               last_batch_handle=handle)
        out = _batches(it)
        it.reset()
        return out + _batches(it), it

    _seed(3)
    a, ra = run(rmx)
    _seed(3)
    with pmx.cpu():
        b, pa = run(pmx)
    _equal(a, b)
    assert pa.provide_data == ra.provide_data
    assert pa.provide_label == ra.provide_label
    assert b[0]["data"][0].dtype == onp.float32
    assert b[0]["label"][0].dtype == onp.int32


def test_ndarray_iter_dict_and_list_inputs():
    x, y = _data(12)
    for data in ({"a": x, "b": x[:, 0]}, [x, x * 2]):
        a = _batches(rmx.io.NDArrayIter(data, {"lab": y}, batch_size=5))
        with pmx.cpu():
            it = pmx.io.NDArrayIter(data, {"lab": y}, batch_size=5)
            b = _batches(it)
        _equal(a, b)
        assert [d.name for d in it.provide_data] == \
            [d.name for d in rmx.io.NDArrayIter(data, batch_size=5)
             .provide_data]
    with pmx.cpu():
        with pytest.raises(MXNetError, match="size mismatch"):
            pmx.io.NDArrayIter(x, y[:3])
        with pytest.raises(MXNetError):
            pmx.io.NDArrayIter(None)
        host = pmx.nd.array(x, ctx=pmx.cpu())
        _equal(_batches(rmx.io.NDArrayIter(rmx.nd.array(x), batch_size=7)),
               _batches(pmx.io.NDArrayIter(host, batch_size=7)))


def test_iterators_need_a_context(monkeypatch):
    x, y = _data(6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        pmx.io.NDArrayIter(x, y, batch_size=2)
    with pmx.cpu():
        it = pmx.io.NDArrayIter(x, y, batch_size=2)
        with pytest.raises(MXNetError, match="CUDA is not available"):
            pmx.io.PrefetchingIter(it, device=pmx.context.Context("gpu"))
        with pytest.raises(MXNetError, match="one card"):
            pmx.io.PrefetchingIter(it, device=[pmx.cpu(), pmx.cpu(1)])


def test_resize_iter():
    x, y = _data(6)
    for size, reset_internal in ((7, True), (2, False)):
        ra = rmx.io.ResizeIter(rmx.io.NDArrayIter(x, y, batch_size=2), size,
                               reset_internal)
        with pmx.cpu():
            pa = pmx.io.ResizeIter(pmx.io.NDArrayIter(x, y, batch_size=2),
                                   size, reset_internal)
        for _ in range(2):
            _equal(_batches(ra), _batches(pa))
            ra.reset()
            pa.reset()
        assert pa.provide_data == ra.provide_data


@pytest.mark.parametrize("device", [None, "cpu", "one_list"])
@pytest.mark.parametrize("handle", ["pad", "roll_over"])
def test_prefetching_iter(device, handle):
    """Over host arrays, with and without the device stage: the batches
    equal the reference's across a ``reset()``."""
    x, y = _data(11)
    dev = {None: None, "cpu": pmx.cpu(), "one_list": [pmx.cpu()]}[device]

    def run(mx, **kw):
        inner = mx.io.NDArrayIter(x, y, batch_size=4,
                                  last_batch_handle=handle)
        p = mx.io.PrefetchingIter(inner, **kw)
        out = _batches(p)
        p.reset()
        return out + _batches(p), p

    a, _ = run(rmx)
    with pmx.cpu():
        b, p = run(pmx, device=dev)
    _equal([dict(r, index=None) for r in a], [dict(r, index=None)
                                              for r in b])
    assert (p._copier is None) == (dev is None)


def test_prefetching_iter_two_iters_and_renames():
    x, y = _data(8)

    def run(mx):
        its = [mx.io.NDArrayIter(x, y, batch_size=4),
               mx.io.NDArrayIter(x * 2, y, batch_size=4)]
        p = mx.io.PrefetchingIter(its, rename_data=[{"data": "a"},
                                                    {"data": "b"}],
                                  rename_label=[{"softmax_label": "la"},
                                                {"softmax_label": "lb"}])
        return _batches(p), p

    (a, ra) = run(rmx)
    with pmx.cpu():
        (b, pa) = run(pmx)
    _equal([dict(r, index=None) for r in a], [dict(r, index=None)
                                              for r in b])
    assert [d.name for d in pa.provide_data] == ["a", "b"] == \
        [d.name for d in ra.provide_data]
    assert [d.name for d in pa.provide_label] == ["la", "lb"]


def test_prefetching_iter_errors_and_sync_mode(monkeypatch):
    class Bad(pmx.io.DataIter):
        def next(self):
            raise RuntimeError("decode failed")

    for dev in (None, pmx.cpu()):
        p = pmx.io.PrefetchingIter(Bad(batch_size=2), device=dev)
        with pytest.raises(RuntimeError, match="decode failed"):
            p.next()
    x, y = _data(6)
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    with pmx.cpu():
        p = pmx.io.PrefetchingIter(pmx.io.NDArrayIter(x, y, batch_size=2),
                                   device=pmx.cpu())
        assert p._sync and p._thread is None
        sync = _batches(p)
        q = pmx.io.PrefetchingIter(pmx.io.NDArrayIter(x, y, batch_size=2))
        assert not q._sync and q._thread is not None
        _equal(sync, _batches(q))
    assert len(sync) == 3


def test_data_batch_and_desc():
    for mx in (rmx, pmx):
        d = mx.io.DataDesc("x", [2, 3])
        assert d.shape == (2, 3) and d.dtype == "float32"
        assert mx.io.DataDesc.get_batch_axis("NHWC") == 0
        assert mx.io.DataDesc.get_batch_axis(None) == 0
        b = mx.io.DataBatch(data=1, label=2, pad=3)
        assert b.data == [1] and b.label == [2] and b.pad == 3
        assert "DataBatch" in str(b)
        base = mx.io.DataIter(4)
        assert base.iter_next() is False and base.getpad() == 0
        with pytest.raises(StopIteration):
            base.next()


def test_csv_iter(tmp_path):
    rs = onp.random.RandomState(1)
    data_csv, label_csv = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    onp.savetxt(data_csv, rs.rand(7, 6), delimiter=",")
    onp.savetxt(label_csv, rs.randint(0, 3, (7, 1)), delimiter=",")
    for kw in (dict(data_shape=(6,)), dict(data_shape=(2, 3),
                                           label_csv=label_csv),
               dict(data_shape=(6,), round_batch=False)):
        ra = rmx.io.CSVIter(data_csv=data_csv, batch_size=3, **kw)
        with pmx.cpu():
            pa = pmx.io.CSVIter(data_csv=data_csv, batch_size=3, **kw)
        _equal(_batches(ra), _batches(pa))
        ra.reset()
        pa.reset()
        _equal(_batches(ra), _batches(pa))


def _idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(onp.uint8).tobytes())


@pytest.mark.parametrize("gz", [True, False])
@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter(tmp_path, gz, flat):
    rs = onp.random.RandomState(2)
    ext = ".gz" if gz else ""
    img, lab = str(tmp_path / f"i{ext}"), str(tmp_path / f"l{ext}")
    _idx(img, rs.randint(0, 256, (9, 28, 28)), gz)
    _idx(lab, rs.randint(0, 10, (9,)), gz)

    def run(mx):
        it = mx.io.MNISTIter(image=img, label=lab, batch_size=4,
                             shuffle=True, flat=flat)
        return _batches(it)

    _seed(4)
    a = run(rmx)
    _seed(4)
    with pmx.cpu():
        b = run(pmx)
    _equal(a, b)


def _jpegs(tmp_path, n=7):
    rec = str(tmp_path / "img.rec")
    rs = onp.random.RandomState(5)
    w = prio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w")
    for i in range(n):
        img = rs.randint(0, 256, (22, 20 + i, 3), dtype=onp.uint8)
        w.write_idx(i, prio.pack_img(prio.IRHeader(0, float(i % 4), i, 0),
                                     img, quality=90))
    w.close()
    return rec


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, rand_crop=True, rand_mirror=True, mean=True,
                 std=True),
    dict(prefetch_buffer=0, resize=20), dict(device="cpu"),
], ids=["plain", "augmented", "no_prefetch", "device"])
def test_image_record_iter(tmp_path, kw):
    """The same batches as the reference's (the augmentation draws run on
    one producer thread in each package, in the reference's order)."""
    pytest.importorskip("PIL")
    rec = _jpegs(tmp_path)
    kw = dict(kw)
    dev = kw.pop("device", None)

    def run(mx, **extra):
        it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 16, 16),
                                   batch_size=3, **kw, **extra)
        out = _batches(it)
        thread = getattr(it, "_thread", None)
        if thread is not None:
            thread.join(timeout=10)
        return out

    _seed(6)
    a = run(rmx)
    _seed(6)
    with pmx.cpu():
        b = run(pmx, **({"device": pmx.cpu()} if dev else {}))
    _equal([dict(r, index=None) for r in a],
           [dict(r, index=None) for r in b])
    assert b[0]["data"][0].shape == (3, 3, 16, 16)
