"""Samplers (reference ``python/mxnet/gluon/data/sampler.py``).

Port of ``mxnet_tpu/gluon/data/sampler.py``: the same indices, and a
seeded ``RandomSampler``'s epoch ``e`` is ``RandomState(seed + e)``'s
permutation, as there.
"""
from __future__ import annotations

import numpy as onp

from ...base import MXNetError


class Sampler:
    """Abstract sampler: iterate over sample indices."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Shuffled indices.  With ``seed=None`` (default) each epoch draws
    from the process-global numpy RNG (reference behavior).  With a
    ``seed``, epoch ``e`` is the deterministic permutation of
    ``RandomState(seed + e)`` — the resumable-shuffle mode: after a
    restart, ``set_epoch(e)`` + a ``DataLoader.iter_from`` fast-forward
    reproduces exactly the batches the interrupted epoch would have
    yielded, without replaying data."""

    def __init__(self, length, seed=None):
        self._length = length
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch):
        """Position the seeded shuffle at ``epoch`` (the checkpoint
        data-cursor restore path; no-op ordering-wise when unseeded)."""
        self._epoch = int(epoch)

    def __iter__(self):
        if self._seed is None:
            indices = onp.random.permutation(self._length)
        else:
            rs = onp.random.RandomState(self._seed + self._epoch)
            indices = rs.permutation(self._length)
            self._epoch += 1
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class IntervalSampler(Sampler):
    """Samples i, i+interval, i+2*interval, ... for each start i (reference
    ``IntervalSampler``; used for distributed validation splits)."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise MXNetError("interval must be <= length")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    """Indices of samples passing ``fn(dataset[i])``."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Group a sampler's indices into batches; ``last_batch`` in
    {'keep','discard','rollover'}."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"invalid last_batch {last_batch!r}")
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return n // self._batch_size
