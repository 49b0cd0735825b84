"""Batchify functions (reference ``gluon/data/batchify.py`` /
GluonNLP ``nlp.data.batchify``): Stack, Pad, Tuple/Group — composable
``batchify_fn``s for DataLoader, the variable-length-sequence batching
surface that feeds BucketingModule-style training.

Port of ``mxnet_tpu/gluon/data/batchify.py``.  A batch is assembled on
the host: into a page-locked buffer of the loader's staging
(:class:`PinnedStaging`) when the thread assembling it belongs to a
loader that copies its batches to the card through its ring, else into
ordinary host memory.  64-bit values become 32-bit, as in the reference.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

from ...base import MXNetError
from ...ndarray import NDArray
from ...ndarray.ndarray import _as_np

# the staging of the loader whose batch this thread is assembling
# (set by the loader around its batchify call; None elsewhere)
_assembling = threading.local()


class PinnedStaging:
    """Page-locked host buffers that a loader's batches are stacked into
    (``torch.stack(..., out=)``), so that each batch's copy to the card
    can run ``non_blocking`` beside the card's work.  A buffer is handed
    out again only after the copy that read it has completed: the ring
    returns it with the event recorded after that copy
    (:meth:`give_back`), and :meth:`take` waits on that event.  Buffers
    are made at first need and kept for the loader's life; ``nbytes``
    is their total."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free = {}          # (shape, dtype) -> [(buffer, event)]
        self._mine = {}          # data_ptr -> buffer
        self.nbytes = 0

    def take(self, shape, dtype):
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            item = free.pop(0) if free else None
        if item is not None:
            buf, event = item
            if event is not None:
                event.synchronize()
            return buf
        buf = torch.empty(key[0], dtype=dtype, pin_memory=True)
        with self._lock:
            self._mine[buf.data_ptr()] = buf
            self.nbytes += buf.nbytes
        return buf

    def give_back(self, batch, event):
        """Return the buffers of host ``batch`` for reuse once ``event``
        (recorded after their copy) has completed."""
        for t in _tensor_leaves(batch):
            with self._lock:
                buf = self._mine.get(t.data_ptr())
                if buf is not None and buf.shape == t.shape and \
                        buf.dtype == t.dtype:
                    self._free.setdefault((tuple(buf.shape), buf.dtype),
                                          []).append((buf, event))


def _tensor_leaves(tree):
    if isinstance(tree, NDArray):
        yield tree._data
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensor_leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensor_leaves(x)


def _out(shape, dtype):
    staging = getattr(_assembling, "staging", None)
    return None if staging is None else staging.take(shape, dtype)


def _stack(tensors):
    """Host tensors stacked along a new axis 0, into a staging buffer
    where the loader has one."""
    out = None
    if all(t.device.type == "cpu" for t in tensors):
        out = _out((len(tensors),) + tuple(tensors[0].shape),
                   tensors[0].dtype)
    if out is None:
        return NDArray(torch.stack(tensors))
    torch.stack(tensors, out=out)
    return NDArray(out)


def _from_np(arr):
    """A batch the function made in numpy, as a host NDArray (into a
    staging buffer where the loader has one)."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = onp.ascontiguousarray(arr).copy()
    t = torch.from_numpy(arr)
    out = _out(t.shape, t.dtype)
    if out is None:
        return NDArray(t)
    out.copy_(t)
    return NDArray(out)


def _cast32(arr):
    if arr.dtype == onp.float64:
        return arr.astype(onp.float32)
    if arr.dtype == onp.int64:
        return arr.astype(onp.int32)
    return arr


class Stack:
    """Stack equal-shape samples into a batch tensor."""

    def __call__(self, data):
        return _from_np(_cast32(onp.stack([_as_np(d) for d in data])))


class Pad:
    """Pad variable-length samples to the batch max along ``axis``
    (reference ``Pad``): optionally also return the valid lengths."""

    def __init__(self, axis=0, pad_val=0, ret_length=False, dtype=None):
        self._axis = axis
        self._pad_val = pad_val
        self._ret_length = ret_length
        self._dtype = dtype

    def __call__(self, data):
        arrs = [_as_np(d) for d in data]
        lengths = onp.array([a.shape[self._axis] for a in arrs],
                            dtype=onp.int32)
        max_len = int(lengths.max())
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(onp.pad(a, pad_width, constant_values=self._pad_val))
        out = onp.stack(padded)
        out = _cast32(out.astype(self._dtype) if self._dtype else out)
        batch = _from_np(out)
        if self._ret_length:
            return batch, _from_np(lengths)
        return batch


class Tuple:
    """Apply one batchify fn per sample field: ``Tuple(Pad(), Stack())``."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        if len(data[0]) != len(self._fns):
            raise MXNetError(
                f"Tuple batchify: sample has {len(data[0])} fields but "
                f"{len(self._fns)} fns were given")
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


Group = Tuple  # reference alias


class List:
    """Return the samples as a plain python list (no batching)."""

    def __call__(self, data):
        return list(data)
