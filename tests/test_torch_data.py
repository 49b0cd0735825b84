"""The data slice of the PyTorch port against the JAX package on the CPU:
``recordio``, ``gluon.data`` (datasets, samplers, batchify functions, the
DataLoader and its device ring) and the slice as a whole (a narrow
ResNet trained from a RecordIO file through both packages' loaders).

Every case runs the reference and the port on the same inputs, made from
a seed with numpy, and files written here.  Batches are host integer or
f32 elementwise arithmetic on both sides and are compared bit for bit;
the ResNet's losses and weights within ``tests/test_torch_resnet.py``'s
tolerances.  Where a case draws from Python's ``random`` or numpy's
global generator, both generators are reseeded before each package's
call (the packages share them in one process).
"""
import gc
import os
import random
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as rmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import recordio as rrio
from mxnet_tpu.gluon import data as rdata
from mxnet_tpu_torch import recordio as prio
from mxnet_tpu_torch import telemetry as ptele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.gluon.data import batchify as pbatchify
from mxnet_tpu_torch.gluon.data import dataloader as pdl
from mxnet_tpu.gluon.data import batchify as rbatchify

WEIGHT_TOL = dict(rtol=1e-4, atol=5e-5)
LOSS_TOL = dict(rtol=1e-4, atol=0)


def _seed(s):
    random.seed(s)
    onp.random.seed(s)


def _np(x):
    """A batch (NDArray of either package, or nested lists/tuples of
    them) as numpy, structure kept."""
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy()


def _equal(a, b):
    """Nested batches equal bit for bit, dtypes included."""
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    onp.testing.assert_array_equal(a, b)


def _port_epoch(loader, make=None):
    """One epoch of a port loader under ``with mx.cpu():`` (``make`` starts
    it another way, e.g. ``iter_from``)."""
    with pmx.cpu():
        return [_np(b) for b in (loader if make is None else make())]


def _ref_epoch(loader, make=None):
    return [_np(b) for b in (loader if make is None else make())]


# --------------------------------------------------------------------- #
# recordio
# --------------------------------------------------------------------- #
def _records(rng):
    out = []
    for i in range(6):
        payload = bytes(rng.randint(0, 256, size=rng.randint(1, 40),
                                    dtype=onp.uint8))
        label = float(i % 3) if i % 2 else \
            rng.rand(rng.randint(1, 4)).astype(onp.float32)
        out.append((i, label, payload))
    return out


def _write(rio, d, recs, name):
    rec, idx = os.path.join(d, name + ".rec"), os.path.join(d, name + ".idx")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    for i, label, payload in recs:
        w.write_idx(i, rio.pack(rio.IRHeader(0, label, i, 7), payload))
    w.close()
    return rec, idx


def test_writers_write_the_same_bytes_and_idx(tmp_path):
    recs = _records(onp.random.RandomState(0))
    ra, ia = _write(rrio, str(tmp_path), recs, "ref")
    pa, pi = _write(prio, str(tmp_path), recs, "port")
    assert open(ra, "rb").read() == open(pa, "rb").read()
    assert open(ia).read() == open(pi).read()
    # and a sequential writer's stream with a payload holding the magic
    blobs = [b"", b"\x0a\x23\xd7\xce" * 3, bytes(range(13))]
    for rio, name in ((rrio, "r.rec"), (prio, "p.rec")):
        with rio.MXRecordIO(str(tmp_path / name), "w") as w:
            for b in blobs:
                w.write(b)
    assert (tmp_path / "r.rec").read_bytes() == \
        (tmp_path / "p.rec").read_bytes()


@pytest.mark.parametrize("writer,reader", [(rrio, prio), (prio, rrio)],
                         ids=["port_reads_ref", "ref_reads_port"])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    recs = _records(onp.random.RandomState(1))
    rec, idx = _write(writer, str(tmp_path), recs, "x")
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i for i, _, _ in recs]
    for i, label, payload in reversed(recs):
        h, s = reader.unpack(r.read_idx(i))
        assert s == payload and h.id == i and h.id2 == 7
        onp.testing.assert_array_equal(onp.asarray(h.label, onp.float32),
                                       onp.asarray(label, onp.float32))
    r.close()
    seq = reader.MXRecordIO(rec, "r")
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == len(recs)


def test_multipart_record_reassembled(tmp_path):
    """A record split by dmlc's cflag (1 first, 2 middle, 3 last) reads
    back whole in both packages."""
    import struct

    parts = [b"abcd", b"ef", b"ghijk"]
    path = tmp_path / "m.rec"
    with open(path, "wb") as f:
        for cflag, p in zip((1, 2, 3), parts):
            f.write(struct.pack("<II", 0xCED7230A, (cflag << 29) | len(p)))
            f.write(p + b"\x00" * ((-len(p)) % 4))
    for rio in (rrio, prio):
        r = rio.MXRecordIO(str(path), "r")
        assert r.read() == b"".join(parts)
        assert r.read() is None


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 3.0], onp.arange(5.0)],
                         ids=["scalar", "list", "vector"])
def test_pack_unpack_headers(label):
    for h in (rrio.IRHeader(0, label, 9, 2), prio.IRHeader(0, label, 9, 2)):
        assert rrio.pack(h, b"xyz") == prio.pack(h, b"xyz")
    s = prio.pack(prio.IRHeader(0, label, 9, 2), b"xyz")
    (ha, sa), (hb, sb) = rrio.unpack(s), prio.unpack(s)
    assert sa == sb == b"xyz" and ha.flag == hb.flag
    onp.testing.assert_array_equal(onp.asarray(ha.label),
                                   onp.asarray(hb.label))


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_unpack_img(fmt):
    pytest.importorskip("PIL")
    img = onp.random.RandomState(2).randint(0, 256, (12, 10, 3),
                                            dtype=onp.uint8)
    h = rrio.IRHeader(0, 4.0, 1, 0)
    sa = rrio.pack_img(h, img, quality=90, img_fmt=fmt)
    sb = prio.pack_img(h, img, quality=90, img_fmt=fmt)
    assert sa == sb
    (ha, ia), (hb, ib) = rrio.unpack_img(sa), prio.unpack_img(sb)
    assert float(ha.label) == float(hb.label) == 4.0
    onp.testing.assert_array_equal(ia, ib)
    if fmt == ".png":
        onp.testing.assert_array_equal(ib, img)


# --------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------- #
def _pair(make):
    return make(rdata), make(pdata)


def _items(ds):
    out = []
    for i in range(len(ds)):
        x = ds[i]
        out.append(tuple(_np(v) if hasattr(v, "asnumpy") else
                         onp.asarray(v) for v in x)
                   if isinstance(x, tuple) else
                   (_np(x) if hasattr(x, "asnumpy") else onp.asarray(x)))
    return out


def _same_items(a, b):
    ia, ib = _items(a), _items(b)
    assert len(ia) == len(ib)
    for u, v in zip(ia, ib):
        if isinstance(u, tuple):
            for p, q in zip(u, v):
                onp.testing.assert_array_equal(p, q)
        else:
            onp.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("method", ["transform", "transform_eager",
                                    "transform_first", "shard", "take",
                                    "filter", "sample"])
def test_dataset_methods(method):
    x = onp.arange(30, dtype=onp.float32).reshape(10, 3)
    y = onp.arange(10, dtype=onp.int32)
    calls = {
        "transform": lambda ds, d: ds.transform(lambda a, b: (a * 2, b + 1)),
        "transform_eager": lambda ds, d: ds.transform(
            lambda a, b: (a - 1, b), lazy=False),
        "transform_first": lambda ds, d: ds.transform_first(
            lambda a: a * 10),
        "shard": lambda ds, d: ds.shard(3, 1),
        "take": lambda ds, d: ds.take(4),
        "filter": lambda ds, d: ds.filter(lambda s: int(s[1]) % 3 == 0),
        "sample": lambda ds, d: ds.sample(
            d.IntervalSampler(10, 3, rollover=False)),
    }
    a, b = _pair(lambda d: calls[method](d.ArrayDataset(x, y), d))
    _same_items(a, b)


def test_simple_and_array_datasets():
    for d in (rdata, pdata):
        with pytest.raises(Exception):
            d.ArrayDataset(onp.zeros(3), onp.zeros(4))
        with pytest.raises(Exception):
            d.SimpleDataset(list(range(5))).shard(2, 2)
    _same_items(*_pair(lambda d: d.SimpleDataset(list(range(7)))))
    # a 1-d NDArray column is read as numpy, a 2-d one kept
    vals = onp.arange(8, dtype=onp.float32)
    with pmx.cpu():
        pcol = pmx.nd.array(vals)
        pmat = pmx.nd.array(vals.reshape(4, 2))
    ra = rdata.ArrayDataset(rmx.nd.array(vals[:4]), rmx.nd.array(
        vals.reshape(4, 2)))
    pa = pdata.ArrayDataset(pcol[:4] if False else pmx.nd.array(
        vals[:4], ctx=pmx.cpu()), pmat)
    assert isinstance(pa._data[0], onp.ndarray)
    _same_items(ra, pa)
    assert len(pdata.ArrayDataset(pcol)) == 8


def test_record_file_dataset(tmp_path):
    recs = _records(onp.random.RandomState(3))
    rec, _ = _write(prio, str(tmp_path), recs, "d")
    ra, pa = rdata.RecordFileDataset(rec), pdata.RecordFileDataset(rec)
    assert len(ra) == len(pa) == len(recs)
    assert [ra[i] for i in range(len(ra))] == [pa[i] for i in range(len(pa))]


def test_record_file_dataset_threads_share_the_file(tmp_path):
    """Workers are threads: concurrent reads of one file each get their
    own record (the lock makes seek-then-read one step)."""
    rng = onp.random.RandomState(4)
    recs = [(i, float(i), bytes(rng.randint(0, 256, 4096, dtype=onp.uint8)))
            for i in range(64)]
    rec, _ = _write(prio, str(tmp_path), recs, "t")
    ds = pdata.RecordFileDataset(rec)
    errs = []

    def read(k):
        for j in range(200):
            i = (k * 7 + j) % len(recs)
            if prio.unpack(ds[i])[1] != recs[i][2]:
                errs.append(i)

    old = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=read, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        __import__("sys").setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not errs


# --------------------------------------------------------------------- #
# samplers
# --------------------------------------------------------------------- #
def test_random_sampler_seeded_epochs():
    ra, pa = rdata.RandomSampler(13, seed=5), pdata.RandomSampler(13, seed=5)
    for _ in range(3):
        assert list(ra) == list(pa)
    ra.set_epoch(1)
    pa.set_epoch(1)
    assert list(ra) == list(pa) == \
        onp.random.RandomState(6).permutation(13).tolist()
    # unseeded: numpy's global generator, as the reference
    _seed(11)
    a = list(rdata.RandomSampler(9))
    _seed(11)
    assert list(pdata.RandomSampler(9)) == a
    assert list(pdata.SequentialSampler(4, start=2)) == \
        list(rdata.SequentialSampler(4, start=2)) == [2, 3, 4, 5]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler(last_batch):
    ra = rdata.BatchSampler(rdata.SequentialSampler(11), 4, last_batch)
    pa = pdata.BatchSampler(pdata.SequentialSampler(11), 4, last_batch)
    for _ in range(3):                     # rollover carries across epochs
        assert len(ra) == len(pa)
        assert list(ra) == list(pa)
    with pytest.raises(MXNetError):
        pdata.BatchSampler(pdata.SequentialSampler(3), 2, "bad")


def test_interval_and_filter_samplers():
    for roll in (True, False):
        assert list(rdata.IntervalSampler(7, 3, roll)) == \
            list(pdata.IntervalSampler(7, 3, roll))
    with pytest.raises(MXNetError):
        pdata.IntervalSampler(2, 3)
    vals = list(range(12))
    assert list(rdata.FilterSampler(lambda v: v % 5 == 1,
                                    rdata.SimpleDataset(vals))) == \
        list(pdata.FilterSampler(lambda v: v % 5 == 1,
                                 pdata.SimpleDataset(vals)))


# --------------------------------------------------------------------- #
# batchify
# --------------------------------------------------------------------- #
def test_default_batchify_casts_and_structure():
    rng = onp.random.RandomState(6)
    cases = [
        [rng.rand(3) for _ in range(4)],                       # float64
        [rng.randint(0, 9, (2, 2)) for _ in range(3)],         # int64
        [1.5, 2.5, 3.5],
        [(rng.rand(2).astype(onp.float32), i) for i in range(3)],
        [rng.randint(0, 255, (2, 3)).astype(onp.uint8) for _ in range(2)],
    ]
    for data in cases:
        _equal(_np(rdata.default_batchify_fn(data)),
               _np(pdata.default_batchify_fn(data)))
    # NDArray samples stack as they are (one sample too)
    for n in (1, 3):
        vals = [rng.rand(2, 2).astype(onp.float32) for _ in range(n)]
        ref = rdata.default_batchify_fn([rmx.nd.array(v) for v in vals])
        got = pdata.default_batchify_fn([pmx.nd.array(v, ctx=pmx.cpu())
                                         for v in vals])
        assert got.context == pmx.cpu()
        _equal(_np(ref), _np(got))


def test_batchify_functions():
    seqs = [onp.arange(n) for n in (3, 5, 2)]
    for kw in (dict(pad_val=-1, ret_length=True), dict(axis=0),
               dict(dtype="float32"), dict(pad_val=7, dtype="int64")):
        _equal(_np(rbatchify.Pad(**kw)(seqs)), _np(pbatchify.Pad(**kw)(seqs)))
    mats = [onp.ones((2, n)) * n for n in (1, 3)]
    _equal(_np(rbatchify.Pad(axis=1, ret_length=True)(mats)),
           _np(pbatchify.Pad(axis=1, ret_length=True)(mats)))
    for data in ([onp.array([1, 2]), onp.array([3, 4])],
                 [onp.array([1.5, 2.0]), onp.array([3.0, 4.0])]):
        _equal(_np(rbatchify.Stack()(data)), _np(pbatchify.Stack()(data)))
    samples = [(onp.arange(n, dtype=onp.float32), float(n)) for n in (2, 4)]
    for fn in ("Tuple", "Group"):
        a = getattr(rbatchify, fn)(rbatchify.Pad(), rbatchify.Stack())(samples)
        b = getattr(pbatchify, fn)([pbatchify.Pad(), pbatchify.Stack()])(
            samples)
        _equal(_np(a), _np(b))
    with pytest.raises(MXNetError, match="fields"):
        pbatchify.Tuple(pbatchify.Stack())(samples)
    assert pbatchify.List()(samples) == samples


class _FakeEvent:
    def __init__(self):
        self.synced = False

    def synchronize(self):
        self.synced = True


def test_pinned_staging_waits_before_refill(monkeypatch):
    """A staging buffer goes out again only after the event recorded
    after its copy has been waited on; buffers are reused, not remade.
    (Page-locked memory needs CUDA: here plain host memory stands in.)"""
    real_empty = torch.empty
    monkeypatch.setattr(pbatchify.torch, "empty",
                        lambda shape, dtype, pin_memory: real_empty(
                            shape, dtype=dtype))
    st = pbatchify.PinnedStaging()
    a = st.take((2, 3), torch.float32)
    b = st.take((2, 3), torch.float32)
    assert a.data_ptr() != b.data_ptr() and st.nbytes == 48
    ev = _FakeEvent()
    st.give_back([pmx.nd.NDArray(a), pmx.nd.NDArray(torch.zeros(1))], ev)
    assert not ev.synced
    c = st.take((2, 3), torch.float32)
    assert c.data_ptr() == a.data_ptr() and ev.synced and st.nbytes == 48
    # a batch assembled while a staging is set lands in its buffers
    pbatchify._assembling.staging = st
    try:
        out = pdata.default_batchify_fn([(onp.ones(3), 1)] * 2)
    finally:
        pbatchify._assembling.staging = None
    assert {t.data_ptr() for t in (out[0]._data, out[1]._data)} <= \
        set(st._mine)


# --------------------------------------------------------------------- #
# DataLoader
# --------------------------------------------------------------------- #
def _ds(d, n=17):
    rng = onp.random.RandomState(7)
    return d.ArrayDataset(rng.rand(n, 3).astype(onp.float32),
                          onp.arange(n))


@pytest.mark.parametrize("num_workers", [0, 3])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_loader_batches_equal_reference(num_workers, last_batch):
    kw = dict(batch_size=4, last_batch=last_batch, num_workers=num_workers)
    ra = rdata.DataLoader(_ds(rdata), sampler=rdata.RandomSampler(17, 3),
                          **kw)
    pa = pdata.DataLoader(_ds(pdata), sampler=pdata.RandomSampler(17, 3),
                          **kw)
    assert len(ra) == len(pa)
    for _ in range(2):                     # two epochs: rollover carries
        _equal(_ref_epoch(ra), _port_epoch(pa))


def test_loader_unseeded_shuffle_equal_reference():
    _seed(12)
    a = _ref_epoch(rdata.DataLoader(_ds(rdata), batch_size=5, shuffle=True))
    _seed(12)
    b = _port_epoch(pdata.DataLoader(_ds(pdata), batch_size=5,
                                     shuffle=True))
    _equal(a, b)
    with pytest.raises(MXNetError):
        pdata.DataLoader(_ds(pdata), batch_size=2, shuffle=True,
                         sampler=pdata.SequentialSampler(17))
    with pytest.raises(MXNetError):
        pdata.DataLoader(_ds(pdata))
    with pytest.raises(MXNetError):
        pdata.DataLoader(_ds(pdata), batch_size=2, batch_sampler=[[0]])


def test_loader_explicit_batch_sampler_and_batchify():
    seqs = [onp.arange(n, dtype=onp.float32) for n in (2, 4, 3, 5)]
    labels = onp.arange(4, dtype=onp.float32)
    ra = rdata.DataLoader(rdata.ArrayDataset(seqs, labels), batch_sampler=[
        [3, 0], [1, 2]], batchify_fn=rbatchify.Tuple(rbatchify.Pad(),
                                                     rbatchify.Stack()))
    pa = pdata.DataLoader(pdata.ArrayDataset(seqs, labels), batch_sampler=[
        [3, 0], [1, 2]], batchify_fn=pbatchify.Tuple(pbatchify.Pad(),
                                                     pbatchify.Stack()))
    _equal(_ref_epoch(ra), _port_epoch(pa))


def test_loader_timeout_names_the_batch():
    class Slow(pdata.SimpleDataset):
        def __getitem__(self, idx):
            time.sleep(1.0)
            return super().__getitem__(idx)

    dl = pdata.DataLoader(Slow(list(range(8))), batch_size=2,
                          num_workers=1, timeout=0.2)
    with pmx.cpu(), pytest.raises(MXNetError, match="batch 0"):
        next(iter(dl))


def test_loader_worker_error_propagates():
    class Bad(pdata.SimpleDataset):
        def __getitem__(self, idx):
            raise ValueError("boom")

    with pmx.cpu():
        it = iter(pdata.DataLoader(Bad(list(range(8))), batch_size=2,
                                   num_workers=1))
        with pytest.raises(ValueError, match="boom"):
            next(it)
    assert it._executor._shutdown
    it = iter(pdata.DataLoader(Bad(list(range(8))), batch_size=2,
                               device=pmx.cpu()))
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_iter_from_resumes_the_epoch(num_workers):
    def make(d):
        return d.DataLoader(_ds(d), batch_size=3, last_batch="discard",
                            sampler=d.RandomSampler(17, seed=9),
                            num_workers=num_workers)

    full = make(pdata)
    full.set_epoch(2)
    whole = _port_epoch(full)
    resumed = make(pdata)
    resumed.set_epoch(2)
    _equal(whole[2:], _port_epoch(resumed, lambda: resumed.iter_from(2)))
    ref = make(rdata)
    ref.set_epoch(2)
    _equal(_ref_epoch(ref, lambda: ref.iter_from(2)), whole[2:])
    with pytest.raises(MXNetError, match="past the end"):
        make(pdata).iter_from(9)
    roll = pdata.DataLoader(_ds(pdata), batch_size=3, last_batch="rollover")
    with pytest.raises(MXNetError, match="rollover"):
        roll.iter_from(1)


def test_iter_shard_equals_reference():
    def make(d):
        return d.DataLoader(_ds(d), batch_size=2, last_batch="keep",
                            sampler=d.RandomSampler(17, seed=4))

    for shard in range(3):
        ra, pa = make(rdata), make(pdata)
        _equal(_ref_epoch(ra, lambda: ra.iter_shard(1, 3, shard)),
               _port_epoch(pa, lambda: pa.iter_shard(1, 3, shard)))
    with pytest.raises(MXNetError, match="out of range"):
        make(pdata).iter_shard(0, 2, 2)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_device_ring_equals_synchronous_path(monkeypatch, num_workers):
    """``device=mx.cpu()`` through the ring equals
    ``MXNET_DEVICE_PREFETCH=0``'s inline placement bit for bit, and both
    equal the loader without a device."""
    def epoch(**kw):
        dl = pdata.DataLoader(_ds(pdata), batch_size=4,
                              sampler=pdata.RandomSampler(17, seed=1),
                              num_workers=num_workers, **kw)
        return _port_epoch(dl)

    plain = epoch()
    ring = epoch(device=pmx.cpu(), device_prefetch=2, pin_memory=True)
    with pmx.cpu():
        it = iter(pdata.DataLoader(_ds(pdata), batch_size=4,
                                   num_workers=num_workers,
                                   device=pmx.cpu()))
    assert isinstance(it, pdl.DevicePrefetchIter) and it._depth == 2
    it.close()
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    it = iter(pdata.DataLoader(_ds(pdata), batch_size=4,
                               device=pmx.cpu(), device_prefetch=4))
    assert it._depth == 0 and it._thread is None
    it.close()
    sync = epoch(device=pmx.cpu(), device_prefetch=4)
    _equal(plain, ring)
    _equal(ring, sync)


def test_device_placement_rules(monkeypatch):
    ds = _ds(pdata)
    for bad in ([pmx.cpu(), pmx.cpu(1)], (pmx.cpu(), pmx.cpu())):
        with pytest.raises(MXNetError, match="one card"):
            pdata.DataLoader(ds, batch_size=2, device=bad)

    class NamedSharding:                   # what a JAX sharding looks like
        device_set = {0, 1}

    with pytest.raises(MXNetError, match="one card"):
        pdata.DataLoader(ds, batch_size=2, device=NamedSharding())
    with pytest.raises(MXNetError, match="empty"):
        pdata.DataLoader(ds, batch_size=2, device=[])
    one = pdata.DataLoader(ds, batch_size=2, device=[pmx.cpu()])
    assert all(x.context == pmx.cpu() for x, _ in one)
    with pytest.raises(MXNetError, match="one card"):
        pmx.nd.ndarray.to_device(onp.zeros(2), [pmx.cpu(), pmx.cpu()])
    # no fallback: without CUDA a card's loader raises, and device=None
    # means the current context (gpu(0) unless a cpu scope says so)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        pdata.DataLoader(ds, batch_size=2, device=pmx.context.Context("gpu"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        pdata.DataLoader(ds, batch_size=2, device=pmx.gpu())
    dl = pdata.DataLoader(ds, batch_size=2)
    for nw in (0, 2):
        dl._num_workers = nw
        with pytest.raises(MXNetError, match="CUDA is not available"):
            iter(dl)
        with pmx.cpu():
            assert all(x.context == pmx.cpu() for x, _ in dl)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        pmx.nd.array([1.0], ctx=pmx.cpu_pinned())
    assert pmx.nd.array([1.0], ctx=pmx.cpu_shared()).context == pmx.cpu()


def test_fault_point_raises_through_the_ring(monkeypatch):
    """``MXNET_FAULT_INJECT`` at ``data.next`` (hit 3: batch 2) raises
    out of the ring: from its producer thread, and from the worker pool
    under the threadless ring, whose first pulls run ahead."""
    monkeypatch.setenv("MXNET_FAULT_INJECT", "data.next:raise:3")
    try:
        for nw in (0, 2):
            ptele.reset_faults()
            got = []
            with pytest.raises(MXNetError, match="injected fault at "
                               "data.next"):
                it = iter(pdata.DataLoader(_ds(pdata), batch_size=2,
                                           num_workers=nw, prefetch=1,
                                           device=pmx.cpu()))
                for b in it:
                    got.append(b)
            assert len(got) == (2 if nw == 0 else 0)
            it.close()
    finally:
        monkeypatch.delenv("MXNET_FAULT_INJECT")
        ptele.reset_faults()


def test_threadless_ring_counts_waiting_pulls():
    """Over the worker pool, a pull that has to wait for a batch counts a
    stall and its seconds; a pool that is ahead counts none."""
    class Slow(pdata.SimpleDataset):
        def __getitem__(self, idx):
            time.sleep(0.02)
            return super().__getitem__(idx)

    tele = pdl._ring_tele()
    ds = Slow([onp.float32(i) for i in range(16)])
    s0, t0 = tele["stalls"].value, tele["stall_s"].sum
    got = list(pdata.DataLoader(ds, batch_size=2, num_workers=1,
                                device=pmx.cpu(), device_prefetch=1))
    assert len(got) == 8
    assert tele["stalls"].value - s0 >= 4
    assert tele["stall_s"].sum - t0 >= 4 * 0.02
    it = iter(pdata.DataLoader(pdata.SimpleDataset(list(range(16))),
                               batch_size=2, num_workers=2,
                               device=pmx.cpu(), device_prefetch=1,
                               prefetch=8))
    deadline = time.time() + 10
    while not it._source.ready() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)                       # every queued batch done
    s1 = tele["stalls"].value
    for _ in range(4):
        next(it)
    assert tele["stalls"].value == s1
    it.close()


def test_ring_telemetry_and_accounting():
    from mxnet_tpu_torch.telemetry.memory import ACCOUNTANT

    stalls = pdl._ring_tele()["stalls"]
    before = stalls.value
    it = iter(pdata.DataLoader(_ds(pdata), batch_size=4, device=pmx.cpu(),
                               device_prefetch=2))
    x, _ = next(it)
    assert stalls.value >= before
    assert ACCOUNTANT.bytes("data.prefetch_ring", it._mem_key) == \
        2 * (x._data.nbytes + 4 * 4)
    assert it.device_bytes == 2 * (x._data.nbytes + 16)
    assert it.pinned_bytes == 0              # no page-locked memory here
    it.close()
    assert ACCOUNTANT.bytes("data.prefetch_ring", it._mem_key) == 0


def _live(prefixes, before=()):
    """Live threads named by ``prefixes`` that are not in ``before``: the
    reference's loader names its producer ``mx-device-prefetch`` too, and
    an earlier test in the same process may leave one running."""
    return [t for t in threading.enumerate()
            if t.name.startswith(prefixes) and t not in before]


def test_loader_closed_midway_leaves_no_thread():
    """Breaking out of an epoch mid-way unwinds the ring and the worker
    pool: no live worker or producer thread of this test's loaders, the
    executor shut down, the ledger entry dropped."""
    from mxnet_tpu_torch.telemetry.memory import ACCOUNTANT

    before = set(threading.enumerate())
    ds = pdata.SimpleDataset(list(range(48)))
    for nw in (0, 2):
        it = iter(pdata.DataLoader(ds, batch_size=4, num_workers=nw,
                                   device=pmx.cpu(), device_prefetch=1,
                                   prefetch=4))
        next(it)
        inner = it._source
        it.close()
        if nw:
            assert inner._closed and inner._executor._shutdown
            for t in list(inner._executor._threads):
                t.join(timeout=10)
        assert ACCOUNTANT.bytes("data.prefetch_ring", it._mem_key) == 0
    deadline = time.time() + 10
    names = ("mx-data-worker", "mx-device-prefetch")
    while _live(names, before) and time.time() < deadline:
        time.sleep(0.01)
    assert not _live(names, before)
    # an abandoned epoch's pool goes with its iterator
    it = iter(pdata.DataLoader(ds, batch_size=2, num_workers=2,
                               device=pmx.cpu()))
    next(it)
    executor = it._source._executor
    del it
    gc.collect()
    assert executor._shutdown


class TestIteratorConcurrency:
    """Concurrent ``next()`` + ``shutdown()``/``close()`` from several
    threads: no deadlock, no error off the shared deque, no leaked
    executor, no consumer stranded in ``queue.get()``."""

    def _consume(self, it, errs):
        from concurrent.futures import CancelledError
        try:
            while True:
                try:
                    next(it)
                except StopIteration:
                    return
        except (CancelledError, MXNetError):
            return
        except BaseException as e:  # noqa: BLE001 — recorded for assert
            errs.append(e)

    def _hammer(self, make_iter, closer, rounds=12, consumers=3):
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            for i in range(rounds):
                it = make_iter()
                errs = []
                threads = [threading.Thread(target=self._consume,
                                            args=(it, errs), daemon=True)
                           for _ in range(consumers)]
                for t in threads:
                    t.start()
                time.sleep(0.001 * (i % 4))
                closer(it)
                for t in threads:
                    t.join(timeout=10)
                assert not any(t.is_alive() for t in threads), \
                    f"round {i}: consumer thread deadlocked after close"
                assert not errs, f"round {i}: {errs!r}"
                yield it
        finally:
            sys.setswitchinterval(old)

    def test_multiworker_next_vs_shutdown(self):
        ds = pdata.SimpleDataset(list(range(64)))

        def make():
            with pmx.cpu():
                return iter(pdata.DataLoader(ds, batch_size=4,
                                             num_workers=2, prefetch=3))
        for it in self._hammer(make, lambda it: it.shutdown()):
            assert it._executor._shutdown
            with pytest.raises(StopIteration):
                next(it)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_device_prefetch_next_vs_close(self, depth):
        def make():
            def src():
                for j in range(64):
                    yield onp.full((2,), j, onp.float32)
            return pdl.DevicePrefetchIter(src(), pmx.cpu(), depth=depth)

        for it in self._hammer(make, lambda it: it.close()):
            assert it._thread is None
            with pytest.raises(StopIteration):
                next(it)

    def test_stacked_loader_close_midway(self):
        ds = pdata.SimpleDataset(list(range(48)))
        for _ in range(6):
            it = iter(pdata.DataLoader(ds, batch_size=4, num_workers=2,
                                       device=pmx.cpu(), device_prefetch=1,
                                       prefetch=4))
            assert isinstance(it, pdl.DevicePrefetchIter)
            next(it)
            inner = it._source
            it.close()
            assert inner._executor._shutdown


def test_device_prefetch_iter_standalone():
    src = [onp.full((2, 2), i, onp.float32) for i in range(5)]
    out = list(pdl.DevicePrefetchIter(iter(src), pmx.cpu(), depth=2))
    assert [o.context for o in out] == [pmx.cpu()] * 5
    _equal([o.asnumpy() for o in out], src)

    def bad():
        yield onp.zeros((2, 2), onp.float32)
        raise RuntimeError("pipeline broke")

    it = pdl.DevicePrefetchIter(bad(), pmx.cpu(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="pipeline broke"):
        next(it)
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)
    with pytest.raises(MXNetError):
        pdl.DevicePrefetchIter(iter(src), None)


# --------------------------------------------------------------------- #
# the slice as a whole: a narrow ResNet fed from one RecordIO file by
# both packages' loaders
# --------------------------------------------------------------------- #
NET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256], classes=10,
           thumbnail=True)
# lr 0.01: at lr 0.1 the reference's second ResNet step departs from the
# port (gradients ~1% apart here, the first step and the losses within
# 1e-6) through the reference's f32 one-pass BatchNorm variance, as
# ROADMAP §3 records; there the port is held against the reference run
# in float64 instead
# (test_torch_gluon_parity.py::test_port_step_agrees_with_reference_float64_at_lr_0_1)
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
MEAN = [123.68, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def _raw_records(path, n=8, side=36):
    rng = onp.random.RandomState(21)
    w = prio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, (side, side, 3), dtype=onp.uint8)
        w.write_idx(i, prio.pack(prio.IRHeader(0, float(rng.randint(10)),
                                               i, 0), img.tobytes()))
    w.close()


def _augment(mx, rio, side=36):
    augs = [mx.image.RandomCropAug((32, 32)), mx.image.HorizontalFlipAug(0.5),
            mx.image.CastAug(), mx.image.ColorNormalizeAug(MEAN, STD)]

    def fn(record):
        header, payload = rio.unpack(record)
        img = onp.frombuffer(payload, onp.uint8).reshape(side, side, 3)
        img = mx.nd.array(img, dtype="uint8", **(
            {"ctx": mx.cpu()} if mx is pmx else {}))
        for a in augs:
            img = a(img)
        return img, header.label
    return fn


def test_resnet_fed_from_record_file(tmp_path):
    from mxnet_tpu import autograd as rautograd, gluon as rgluon
    from mxnet_tpu.gluon.model_zoo.vision import resnet as rresnet
    from mxnet_tpu_torch import gluon as pgluon
    from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
    from mxnet_tpu_torch.models import arrays_from_port, load_mxnet_tpu_arrays

    rec = str(tmp_path / "train.rec")
    _raw_records(rec)

    def loader(d, mx, rio):
        return d.DataLoader(d.RecordFileDataset(rec).transform(
            _augment(mx, rio)), batch_size=4, last_batch="discard",
            sampler=d.RandomSampler(8, seed=3))

    # the reference: its net, its loader, two gluon.Trainer steps
    rmx.random.seed(0)
    rnet = rresnet.ResNetV1(rresnet.BottleneckV1, NET["layers"],
                            NET["channels"], classes=NET["classes"],
                            thumbnail=True, layout="NHWC")
    rnet.initialize(rmx.init.Xavier(magnitude=3))
    rnet.hybridize()
    rnet(rmx.nd.zeros((1, 3, 32, 32)))
    arrays = {k: onp.asarray(p.data().asnumpy(), onp.float32)
              for k, p in rnet.collect_params().items()}
    rtr = rgluon.Trainer(rnet.collect_params(), "sgd", dict(OPT))
    rloss = rgluon.loss.SoftmaxCrossEntropyLoss()
    _seed(5)
    ref_batches, ref_losses = [], []
    for x, y in loader(rdata, rmx, rrio):
        ref_batches.append([x.asnumpy(), y.asnumpy()])
        with rautograd.record():
            L = rloss(rnet(x.transpose((0, 3, 1, 2))), y)
        L.backward()
        rtr.step(4)
        ref_losses.append(L.asnumpy())
    after = {k: onp.asarray(p.data().asnumpy(), onp.float32)
             for k, p in rnet.collect_params().items()}

    # the port: the same weights, its loader, two Trainer steps
    pnet = pvision.ResNetV1(pvision.BottleneckV1, NET["layers"],
                            NET["channels"], classes=NET["classes"],
                            thumbnail=True, layout="NHWC", device="cpu")
    pnet = load_mxnet_tpu_arrays(pnet, arrays)
    ptr = pgluon.Trainer(pnet, "sgd", dict(OPT))
    ploss = pgluon.loss.SoftmaxCrossEntropyLoss()
    _seed(5)
    got_batches, got_losses = [], []
    with pmx.cpu():
        for x, y in loader(pdata, pmx, prio):
            assert x.context == pmx.cpu() and x.shape == (4, 32, 32, 3)
            got_batches.append([x.asnumpy(), y.asnumpy()])
            L = ploss(pnet(x._data.permute(0, 3, 1, 2)), y._data)
            L.backward(torch.ones_like(L))
            ptr.step(4)
            got_losses.append(L.detach().numpy())
    assert len(got_batches) == 2
    _equal(ref_batches, got_batches)
    onp.testing.assert_allclose(got_losses, ref_losses, **LOSS_TOL)
    got = arrays_from_port(pnet, prefix=rnet.prefix)
    for name, want in after.items():
        onp.testing.assert_allclose(got[name], want, err_msg=name,
                                    **WEIGHT_TOL)
