"""DataIter family (reference ``python/mxnet/io/io.py``; SURVEY.md L6, §4.5).

Port of ``mxnet_tpu/io/io.py``.  Iterators assemble host batches and place
each batch once, on the context current when the iterator was made
(``gpu(0)`` unless a ``with mx.cpu():`` scope says otherwise: the port's
default, so without CUDA making one outside such a scope raises).
``PrefetchingIter`` double-buffers on a background thread like the
reference's ``dmlc::ThreadedIter`` wrapper (anchor ``PrefetcherIter``);
with ``device=`` its thread copies each batch on a copy stream of its
own and the consumer's stream waits on the copy's event (the loader's
``_Copier``).
"""
from __future__ import annotations

import queue as _queue
import threading
import time as _time
from collections import namedtuple

import numpy as onp

from .. import telemetry
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import _HOST_32, _as_np, array


def _context():
    """The context current now, checked (a card's raises without CUDA)."""
    ctx = current_context()
    ctx.torch_device()
    return ctx


def _on(chunk, ctx):
    """A numpy batch as an NDArray on ``ctx``, 64-bit values as 32-bit."""
    return array(chunk, ctx=ctx, dtype=_HOST_32.get(chunk.dtype, chunk.dtype))


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Description of one data/label entry (reference ``DataDesc``)."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: lists of data/label NDArrays + pad/index metadata."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        lshapes = [getattr(l, "shape", None) for l in (self.label or [])]
        return f"DataBatch: data shapes: {shapes} label shapes: {lshapes}"


class DataIter:
    """Base iterator protocol: ``reset / next / iter_next / getdata /
    getlabel / getpad / getindex`` + ``provide_data/provide_label``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        return False

    def getdata(self):
        return None

    def getlabel(self):
        return None

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """Normalize data into an ordered list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise MXNetError(f"{default_name} must be provided")
        return []
    if isinstance(data, (NDArray, onp.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError(f"{default_name} must be non-empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("data must be NDArray, numpy array, list, or dict")
    out = []
    for k, v in data.items():
        out.append((k, onp.ascontiguousarray(_as_np(v))))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``NDArrayIter``): supports
    shuffle, ``last_batch_handle`` in {'pad','discard','roll_over'}."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._ctx = _context()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise MXNetError(f"size mismatch for {k}")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = onp.arange(self.num_data)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and getattr(self, "_cursor", 0) > self.num_data:
            self._cursor = self._cursor - self.num_data - self.batch_size
        else:
            self._cursor = -self.batch_size

    def iter_next(self):
        self._cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self._cursor + self.batch_size <= self.num_data
        return self._cursor < self.num_data

    def _slice(self, arrays):
        start = self._cursor
        end = min(start + self.batch_size, self.num_data)
        out = []
        for _, v in arrays:
            chunk = v[self.idx[start:end]]
            if end - start < self.batch_size:  # pad by wrapping
                pad = self.batch_size - (end - start)
                chunk = onp.concatenate([chunk, v[self.idx[:pad]]], axis=0)
            out.append(_on(chunk, self._ctx))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getindex(self):
        start = self._cursor
        end = min(start + self.batch_size, self.num_data)
        return self.idx[start:end]

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self._cursor + self.batch_size > self.num_data:
            return self._cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch, optionally resetting
    the inner iterator on exhaustion (reference ``ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


_prefetch_tele_cache = None


def _prefetch_tele():
    """Lazy shared stall instruments (hot-path callers hold the
    instrument instead of re-looking it up per batch — the
    ``_ring_tele`` pattern from gluon/data/dataloader.py)."""
    global _prefetch_tele_cache
    if _prefetch_tele_cache is None:
        _prefetch_tele_cache = {
            "stalls": telemetry.counter("io_prefetch_stalls_total"),
            "stall_s": telemetry.histogram(
                "io_prefetch_stall_seconds"),
        }
    return _prefetch_tele_cache


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators (reference
    ``PrefetchingIter`` ≈ ``dmlc::ThreadedIter`` double buffering).

    ``device`` (a ``Context``, a torch device, or a one-element list of
    one) adds the host-to-device stage: the producer thread copies every
    batch's data and label to the device on a copy stream of its own as
    it is prefetched, so the copy of batch ``k+1`` overlaps step ``k``;
    ``next()`` makes the consumer's current stream wait on the copy's
    event.  A sharding or more than one device raises ``MXNetError``
    (one card).  ``MXNET_DEVICE_PREFETCH=0`` drops the producer thread
    when a device is given (synchronous pull + inline placement, bit for
    bit the same values)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, device=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self._stop = threading.Event()
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        from ..gluon.data.dataloader import _Copier, _env_device_prefetch
        from ..ndarray.ndarray import _placement_target
        target = _placement_target(device)
        self._copier = _Copier(target) if target is not None else None
        # the escape hatch governs the DEVICE stage only: a device-less
        # PrefetchingIter keeps its reference host-side producer thread
        self._sync = target is not None and _env_device_prefetch() <= 0
        self._err = None
        self._depth = prefetch_depth
        self._queue = None
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype, d.layout)
                     for d in it.provide_data]
                    for r, it in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype, d.layout)
                     for d in it.provide_label]
                    for r, it in zip(self.rename_label, self.iters)], [])

    def _pull(self):
        """One host pull and, with a device, its copies (raises
        StopIteration); returns the batches and the copies' event."""
        batches = [it.next() for it in self.iters]
        if self._copier is None:
            return batches, None
        if self._sync:
            from ..ndarray.ndarray import to_device
            placed = to_device([(b.data, b.label) for b in batches],
                               self._copier.target)
            return self._rebuild(batches, placed), None
        placed, event = self._copier.place(
            [(b.data, b.label) for b in batches])
        return self._rebuild(batches, placed), event

    @staticmethod
    def _rebuild(batches, placed):
        return [DataBatch(data=d, label=l, pad=b.pad, index=b.index,
                          bucket_key=b.bucket_key,
                          provide_data=b.provide_data,
                          provide_label=b.provide_label)
                for b, (d, l) in zip(batches, placed)]

    def _producer(self):
        while not self._stop.is_set():
            try:
                item = self._pull()
            except StopIteration:
                self._queue.put(None)
                return
            except BaseException as e:  # deliver to the consumer — a dead
                self._err = e           # producer must not hang next()
                self._queue.put(None)
                return
            self._queue.put(item)

    def _start(self):
        if self._sync:  # MXNET_DEVICE_PREFETCH=0: no producer thread
            return
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def reset(self):
        if not self._sync:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=5)
        for it in self.iters:
            it.reset()
        self._start()

    def next(self):
        if self._sync:
            item = self._pull()  # StopIteration propagates
        else:
            # a consumer-side stall means the producer thread wasn't a
            # batch ahead — input-bound
            if self._queue.empty():
                tele = _prefetch_tele()
                tele["stalls"].inc()
                t0 = _time.perf_counter()
                item = self._queue.get()
                tele["stall_s"].observe(_time.perf_counter() - t0)
            else:
                item = self._queue.get()
            if item is None:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                raise StopIteration
        batches, event = item
        if event is not None:
            self._copier.deliver(
                ([(b.data, b.label) for b in batches], event))
        data = sum([b.data for b in batches], [])
        label = sum([(b.label or []) for b in batches], [])
        return DataBatch(data=data, label=label or None, pad=batches[0].pad,
                         index=batches[0].index)

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def __del__(self):
        self._stop.set()


class CSVIter(DataIter):
    """CSV file iterator (reference C++ ``CSVIter``; numpy-backed here)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32,
                           ndmin=2).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32,
                                ndmin=2).reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = onp.zeros((data.shape[0],), dtype=onp.float32)
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="pad" if round_batch else "discard",
                                  data_name=data_name, label_name=label_name)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference C++ ``MNISTIter``)."""

    def __init__(self, image, label, batch_size=1, shuffle=False, flat=False,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct as _struct

        def _read(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic, = _struct.unpack(">I", f.read(4))
                ndim = magic & 0xFF
                dims = _struct.unpack(f">{ndim}I", f.read(4 * ndim))
                return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

        imgs = _read(image).astype(onp.float32) / 255.0
        labels = _read(label).astype(onp.float32)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs[:, None, :, :]
        self._inner = NDArrayIter(imgs, labels, batch_size=batch_size,
                                  shuffle=shuffle, data_name=data_name,
                                  label_name=label_name)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224), batch_size=1,
                    shuffle=False, preprocess_threads=4, prefetch_buffer=2,
                    device=None, **kwargs):
    """RecordIO image iterator (reference C++ ``ImageRecordIter``, SURVEY.md
    §4.5).  Built from :class:`mxnet_tpu_torch.image.ImageIter` wrapped in
    :class:`PrefetchingIter` for background decode — the role the
    reference's OMP decode pool + ``PrefetcherIter`` play.  Honors the
    same keyword surface (augmentation kwargs pass through); ``device=``
    adds the host-to-device stage (batches arrive on the card)."""
    from ..image import ImageIter
    kwargs.pop("path_imgidx", None)
    inner = ImageIter(batch_size=batch_size, data_shape=data_shape,
                      path_imgrec=path_imgrec, shuffle=shuffle, **kwargs)
    if (prefetch_buffer and prefetch_buffer > 0) or device is not None:
        return PrefetchingIter(inner, prefetch_depth=max(1, prefetch_buffer),
                               device=device)
    return inner
