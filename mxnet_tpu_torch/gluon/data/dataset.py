"""Dataset classes (reference ``python/mxnet/gluon/data/dataset.py``).

Port of ``mxnet_tpu/gluon/data/dataset.py``.
"""
from __future__ import annotations

import threading

from ...base import MXNetError
from ...ndarray import NDArray


class Dataset:
    """Abstract dataset: ``__getitem__`` + ``__len__`` (reference
    ``gluon.data.Dataset``)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """Return a dataset with only samples for which ``fn(sample)`` is
        truthy (materializes the index list, like the reference)."""
        indices = [i for i in range(len(self)) if fn(self[i])]
        return _SampledDataset(self, indices)

    def shard(self, num_shards, index):
        """Every ``num_shards``-th sample starting at ``index`` (for
        data-parallel hosts)."""
        if not 0 <= index < num_shards:
            raise MXNetError("shard index out of range")
        indices = list(range(index, len(self), num_shards))
        return _SampledDataset(self, indices)

    def take(self, count):
        count = min(count, len(self))
        return _SampledDataset(self, list(range(count)))

    def sample(self, sampler):
        return _SampledDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        """Return a dataset whose samples are ``fn(*sample)``."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply ``fn`` to the first element of each sample only (the usual
        image-transform entry point)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, data, indices):
        self._data = data
        self._indices = list(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class SimpleDataset(Dataset):
    """Wrap any sized, indexable object."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip multiple equal-length arrays/datasets into (a, b, ...) samples."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise MXNetError(f"all arrays must have the same length; "
                                 f"arg {i} has {len(data)} != {self._length}")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (``.rec`` + ``.idx``);
    reference ``gluon.data.RecordFileDataset``.  Reads go through the
    pure-Python reader, the reference's path when its native library is
    absent (that library is not ported); a lock makes each read's
    seek-then-read one step, so loader workers (threads) share the
    file."""

    def __init__(self, filename):
        from ... import recordio
        self._filename = filename
        idx_file = filename[:-4] + ".idx" if filename.endswith(".rec") \
            else filename + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])
