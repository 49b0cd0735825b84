"""DataLoader (reference ``python/mxnet/gluon/data/dataloader.py``;
SURVEY.md §3.2 "Gluon data" row, §4.5 bottom).

Port of ``mxnet_tpu/gluon/data/dataloader.py``.  As there,
``num_workers`` is a pool of THREADS (``_MultiWorkerIter``): the
reference's forked processes and shared-memory plumbing have no
counterpart, and ``cpu_shared()`` is plain host memory.  Samples and
their transforms stay on the host; a batch is assembled there and
reaches the card once:

- ``device=None``: each batch is placed synchronously on
  ``current_context()`` of the thread that starts the epoch (``gpu(0)``
  unless a ``with mx.cpu():`` scope says otherwise), so a loader runs on
  the card unless the caller asks for the CPU;
- ``device=ctx``: batches come off :class:`DevicePrefetchIter`, a ring of
  ``device_prefetch`` batches whose copies are in flight while the
  caller consumes the current one.  With ``pin_memory=True`` each batch
  is stacked into a page-locked buffer (:class:`~.batchify.
  PinnedStaging`); every copy goes ``non_blocking`` on the ring's own
  copy stream with a CUDA event recorded after it; ``__next__`` makes
  the caller's current stream wait on that event and records the batch's
  tensors for that stream; a staging buffer is filled again only after
  its copy's event has completed.

``MXNET_DEVICE_PREFETCH=0`` places every batch inline on the caller's
stream (no ring, no thread, no staging), bit for bit the same values.
A sharding or a list of more than one device raises ``MXNetError``: the
port has one card.  Without CUDA a loader with a card's context raises;
nothing falls back to the host.
"""
from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, TimeoutError as _FutTimeout

import numpy as onp
import torch

from ... import telemetry
from ...base import MXNetError
from ...context import current_context
from ...ndarray import NDArray
from ...ndarray.ndarray import _placement_target, to_device
from .batchify import (PinnedStaging, _assembling, _cast32, _from_np,
                       _stack, _tensor_leaves)
from .sampler import SequentialSampler, RandomSampler, BatchSampler


def default_batchify_fn(data):
    """Stack samples into host batch NDArrays (reference
    ``default_batchify_fn``): NDArrays stacked as they are, numbers and
    numpy through numpy with 64-bit values cast to 32 bits."""
    if isinstance(data[0], NDArray):
        return _stack([d._data for d in data])
    if isinstance(data[0], (tuple, list)):
        return [default_batchify_fn(list(x)) for x in zip(*data)]
    return _from_np(_cast32(onp.asarray(data)))


# with no process boundary there is no separate shared-memory variant, but
# the reference name is part of the public surface
default_mp_batchify_fn = default_batchify_fn


def _env_device_prefetch(default=2):
    """``MXNET_DEVICE_PREFETCH``: default device-ring depth; ``0`` forces
    the synchronous placement path everywhere."""
    try:
        return int(os.environ.get("MXNET_DEVICE_PREFETCH", str(default)))
    except ValueError:
        return default


def _resolve_device_prefetch(depth):
    """Effective device-ring depth: ``MXNET_DEVICE_PREFETCH=0`` wins over
    any explicit argument; otherwise an explicit ``depth`` wins over the
    env default."""
    env = _env_device_prefetch()
    if env <= 0:
        return 0
    return max(0, int(depth)) if depth is not None else env


def _assemble(dataset, batchify_fn, indices, staging):
    """One batch: load the samples and batchify them on the host, into
    ``staging``'s page-locked buffers where there is one."""
    samples = [dataset[i] for i in indices]
    _assembling.staging = staging
    try:
        return batchify_fn(samples)
    finally:
        _assembling.staging = None


class _MultiWorkerIter:
    """Prefetching iterator: worker threads run ``dataset[idx]`` + batchify;
    results are delivered in order (reference ``_MultiWorkerIter``).

    ``prefetch`` bounds the batches in flight (the ``2*num_workers``
    default is applied by :class:`DataLoader`).  ``timeout`` bounds the
    wait for any single batch; a stuck worker raises :class:`MXNetError`
    naming the batch index instead of hanging forever.  ``place_fn``, when
    given, places each batch in the consumer's thread as it is handed
    out (the loader's synchronous ``device=None`` path)."""

    def __init__(self, dataset, batch_sampler, batchify_fn, num_workers,
                 prefetch, pin_memory, timeout=None, place_fn=None,
                 staging=None):
        self._dataset = dataset
        self._batchify_fn = batchify_fn
        self._batch_iter = iter(batch_sampler)
        self._executor = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="mx-data-worker")
        self._prefetch = max(1, prefetch)
        self._pending = deque()
        self._pin_memory = pin_memory
        self._timeout = timeout if timeout and timeout > 0 else None
        self._place_fn = place_fn
        self._staging = staging
        self._batch_idx = 0
        self._closed = False
        # ``next()`` (the training thread) races ``shutdown()`` (``__del__``
        # runs on whatever thread drops the last reference): _pending,
        # _closed and _batch_iter move only under this lock; an RLock
        # because _push_next is reached both ways
        self._lock = threading.RLock()
        for _ in range(self._prefetch):
            self._push_next()

    def _push_next(self):
        with self._lock:
            if self._closed:
                return
            indices = next(self._batch_iter, None)
            if indices is None:
                return
            # a module-level function: queued work must not hold this
            # iterator, or an abandoned epoch's __del__ never runs
            self._pending.append(self._executor.submit(
                _assemble, self._dataset, self._batchify_fn, indices,
                self._staging))

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            fut = self._pending.popleft() if self._pending else None
            if fut is not None:
                self._push_next()
        if fut is None:
            self.shutdown()
            raise StopIteration
        # the (possibly blocking) wait happens OUTSIDE the lock so a
        # concurrent shutdown() is never stuck behind a slow batch
        try:
            batch = fut.result(self._timeout)
        except _FutTimeout:
            idx = self._batch_idx
            self.shutdown()
            raise MXNetError(
                f"DataLoader worker timed out after {self._timeout}s "
                f"waiting for batch {idx}; raise DataLoader(timeout=...) if "
                f"your per-batch load legitimately takes longer") from None
        except BaseException:
            self.shutdown()
            raise
        self._batch_idx += 1
        if self._place_fn is not None:
            batch = self._place_fn(batch)
        return batch

    next = __next__

    def ready(self):
        """Whether ``next()`` would hand out a batch without waiting."""
        with self._lock:
            return not self._pending or self._pending[0].done()

    def shutdown(self):
        """Cancel in-flight work and release the thread pool.  Safe to call
        repeatedly and from any thread; runs from ``__del__`` so an epoch
        abandoned mid-way (``break``) doesn't leak the executor.  The
        workers end once their current batch is done."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
        for fut in pending:
            fut.cancel()
        self._executor.shutdown(wait=False, cancel_futures=True)

    close = shutdown

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


_END = object()  # device-prefetch producer's end-of-stream marker

# process-wide ring telemetry: depth gauge + consumer-stall counters.  A
# stall = the consumer asked for a batch the ring didn't have ready — the
# step is input-bound at that moment.  Lazy so importing the module never
# touches the registry.
_ring_tele_cache = None


def _ring_tele():
    global _ring_tele_cache
    if _ring_tele_cache is None:
        _ring_tele_cache = {
            "depth": telemetry.gauge("data_prefetch_ring_depth"),
            "stalls": telemetry.counter("data_prefetch_stalls_total"),
            "stall_s": telemetry.histogram(
                "data_prefetch_stall_seconds"),
        }
    return _ring_tele_cache


# memory-ledger identity for device-prefetch rings (``device_bytes{
# subsystem="data.prefetch_ring"}``) — monotonic so a closed ring's
# key is never reused
_ring_seq = itertools.count()


class _Copier:
    """The host-to-device stage of a ring: :meth:`place` copies a host
    batch to ``target`` on the ring's own copy stream and records an
    event after the copies (the batch's staging buffers go back to
    ``staging`` with that event); :meth:`deliver`, on the consumer's
    thread, makes its current stream wait on the event and records the
    batch's tensors for that stream, so their memory is not reused before
    the consumer's work on them is done.  A host target has no stream:
    placing there is the synchronous path."""

    def __init__(self, target, staging=None):
        self.target = target
        self.staging = staging
        self.stream = torch.cuda.Stream(target) \
            if target.type == "cuda" else None

    def place(self, batch):
        if self.stream is None:
            return to_device(batch, self.target), None
        with torch.cuda.stream(self.stream):
            placed = to_device(batch, self.target)
            event = torch.cuda.Event()
            event.record(self.stream)
        if self.staging is not None:
            self.staging.give_back(batch, event)
        return placed, event

    def deliver(self, item):
        placed, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.target)
            cur.wait_event(event)
            for t in _tensor_leaves(placed):
                t.record_stream(cur)
        return placed


class DevicePrefetchIter:
    """Depth-``N`` device-resident prefetch ring over any batch iterator
    (reference ``DevicePrefetchIter``).

    While the caller consumes batch ``k``, batches ``k+1..k+N`` are
    already batchified with their host-to-device copies in flight on the
    ring's copy stream (:class:`_Copier`), so steady-state step latency is
    ``max(input time, compute time)`` rather than their sum.  ``device``
    is a ``Context``, a torch device, or a one-element list of one.

    Pump modes:

    * ``background=True`` (same-process sources): a producer thread pulls
      from ``source`` and issues each copy, so host batchify itself also
      overlaps the training step.
    * ``background=False`` (over :class:`_MultiWorkerIter`, whose thread
      pool already batchifies ahead): threadless ring — each ``__next__``
      pulls one completed host batch from the pool, issues its copy, and
      returns the batch whose copy was issued ``N`` calls earlier.

    ``depth=0`` (or ``MXNET_DEVICE_PREFETCH=0``) is the synchronous path:
    pull + place inline on the caller's stream, no ring, no thread —
    values are bit for bit the same, only the overlap disappears.
    ``pinned_bytes`` and ``device_bytes`` are the ring's page-locked
    staging and its device footprint (depth x a batch).
    """

    def __init__(self, source, device, depth=None, background=True,
                 staging=None):
        self._source = iter(source)
        target = _placement_target(device)
        if target is None:
            raise MXNetError("DevicePrefetchIter needs a device")
        self._target = target
        self._depth = _resolve_device_prefetch(depth)
        self._copier = _Copier(target, staging if self._depth else None)
        self._ring = deque()
        self._exhausted = False
        self._done = False
        self._queue = None
        self._thread = None
        self._stop = threading.Event()
        self._err = None
        # guards _ring/_done/_exhausted: ``close()`` runs from __del__
        # on whatever thread drops the last reference while ``next()``
        # may still be mid-pull on the training thread
        self._lock = threading.RLock()
        self._mem_key = f"ring{next(_ring_seq)}"
        self._batch_pd = None
        self.device_bytes = 0
        self._background = bool(background) and self._depth > 0
        if self._background:
            self._queue = _queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._produce, name="mx-device-prefetch", daemon=True)
            self._thread.start()

    @property
    def pinned_bytes(self):
        staging = self._copier.staging
        return staging.nbytes if staging is not None else 0

    # -- placement ------------------------------------------------------- #
    def _place(self, batch):
        item = self._copier.place(batch)
        self._account(item[0])
        return item

    def _account(self, placed):
        """Keep the ``data.prefetch_ring`` ledger entry at depth x
        per-batch device bytes (the ring's full-depth upper bound)."""
        from ...telemetry.memory import ACCOUNTANT, per_device_bytes

        pd = per_device_bytes(placed)
        with self._lock:
            if pd == self._batch_pd:
                return
            self._batch_pd = pd
        depth = max(self._depth, 1)
        self.device_bytes = sum(pd.values()) * depth
        ACCOUNTANT.set("data.prefetch_ring", self._mem_key,
                       per_device={d: b * depth for d, b in pd.items()})

    # -- background producer --------------------------------------------- #
    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if not self._put(self._place(batch)):
                    return
        except BaseException as e:  # deliver to the consumer thread
            self._err = e
        self._put(_END)

    # -- iterator protocol ----------------------------------------------- #
    def __iter__(self):
        return self

    def __next__(self):
        if self._background:
            with self._lock:
                if self._done:  # the single _END was already consumed
                    raise StopIteration
            tele = _ring_tele()
            tele["depth"].set(self._queue.qsize())
            if self._queue.empty():
                tele["stalls"].inc()
                t0 = time.perf_counter()
                item = self._queue.get()
                tele["stall_s"].observe(time.perf_counter() - t0)
            else:
                item = self._queue.get()
            if item is _END:
                with self._lock:
                    self._done = True
                # rebroadcast the pill so any OTHER consumer parked in
                # queue.get() wakes too; a full queue means no consumer
                # is parked
                try:
                    self._queue.put_nowait(_END)
                except _queue.Full:
                    pass
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                raise StopIteration
            return self._copier.deliver(item)
        if self._depth == 0:  # the synchronous path
            placed = to_device(next(self._source), self._target)
            self._account(placed)
            return placed
        # threadless ring over an already-asynchronous source; the pull
        # (which may block on the wrapped pool) stays outside the lock.  A
        # pull that has to wait for the pool is a stall: the consumer is
        # input-bound then, whatever the ring holds (the reference counts
        # only an empty ring, which happens once an epoch here)
        tele = _ring_tele()
        ready = getattr(self._source, "ready", None)
        while True:
            with self._lock:
                if len(self._ring) >= self._depth or self._exhausted:
                    break
            waits = ready is None or not ready()
            t0 = time.perf_counter()
            try:
                item = self._place(next(self._source))
            except StopIteration:
                with self._lock:
                    self._exhausted = True
                break
            finally:
                if waits:
                    tele["stalls"].inc()
                    tele["stall_s"].observe(time.perf_counter() - t0)
            with self._lock:
                self._ring.append(item)
        with self._lock:
            tele["depth"].set(len(self._ring))
            if not self._ring:
                raise StopIteration
            item = self._ring.popleft()
        return self._copier.deliver(item)

    next = __next__

    def close(self):
        """Stop the producer and release the source (cancels a wrapped
        ``_MultiWorkerIter``'s pool).  Called from ``__del__`` so breaking
        out of an epoch cleans up both layers; safe against a consumer
        concurrently blocked in ``next()``."""
        self._stop.set()
        if self._thread is not None:
            # drain so a producer stuck on a full queue exits its put
            # loop promptly (it re-checks _stop every 50 ms regardless)
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=5)
            self._thread = None
            # the producer skips its end-of-stream marker once _stop is
            # set — inject one so a consumer parked in queue.get() wakes;
            # evict a straggler batch until the pill lands
            while True:
                try:
                    self._queue.put_nowait(_END)
                    break
                except _queue.Full:
                    try:
                        self._queue.get_nowait()
                    except _queue.Empty:
                        pass
        with self._lock:
            self._ring.clear()
        from ...telemetry.memory import ACCOUNTANT

        # deferred: close() runs from __del__, and a finalizer may fire
        # inside a thread already holding the accountant lock
        ACCOUNTANT.drop_deferred("data.prefetch_ring", self._mem_key)
        for attr in ("shutdown", "close"):
            fn = getattr(self._source, attr, None)
            if callable(fn):
                try:
                    fn()
                except Exception:
                    pass
                break

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DataLoader:
    """Load a ``Dataset`` in mini-batches (reference ``gluon.data.DataLoader``
    API: sampler/batch_sampler/shuffle/last_batch/num_workers/batchify_fn/
    pin_memory/prefetch/timeout) plus the device ring
    (``device=``/``device_prefetch=`` — see :class:`DevicePrefetchIter`).
    ``thread_pool`` is accepted and has no effect: workers are always
    threads."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, timeout=120, device=None,
                 device_prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._num_workers = max(0, num_workers)
        self._prefetch = max(1, prefetch) if prefetch is not None \
            else 2 * self._num_workers
        self._timeout = timeout
        _placement_target(device)        # a bad or absent device raises now
        self._device = device
        self._device_prefetch = device_prefetch

        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size/shuffle/sampler/last_batch are "
                             "mutually exclusive with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _sampler_batches(self, skip=0):
        """The epoch's index-batch stream, fast-forwarded past the first
        ``skip`` batches: their indices are DRAWN from the sampler (so a
        seeded shuffle's position advances exactly as if they had been
        consumed) but no sample is loaded, batchified, or placed — the
        checkpoint data-cursor restore path.  Each yielded batch is a
        ``data.next`` fault-injection site (``MXNET_FAULT_INJECT``)."""
        it = iter(self._batch_sampler)
        for k in range(skip):
            try:
                next(it)
            except StopIteration:
                raise MXNetError(
                    f"iter_from({skip}): the sampler yields only {k} "
                    "batches this epoch — the resume cursor is past "
                    "the end of the data") from None

        def _gen():
            for i, batch in enumerate(it, start=skip):
                telemetry.fault_point("data.next", batch=i)
                yield batch
        return _gen()

    def __iter__(self):
        return self._make_iter(self._sampler_batches())

    def iter_from(self, batches_done):
        """One epoch's iterator resumed mid-epoch: identical to
        ``iter(loader)`` with the first ``batches_done`` batches skipped
        at the SAMPLER level (indices drawn, data never loaded).  With a
        seeded :class:`RandomSampler` positioned via ``set_epoch``, this
        reproduces the interrupted epoch's remaining batches exactly.
        ``last_batch='rollover'`` refuses: its carried-over indices are
        in-memory state a restarted process cannot reconstruct."""
        self._refuse_rollover("iter_from")
        return self._make_iter(self._sampler_batches(int(batches_done)))

    def _refuse_rollover(self, what):
        if getattr(self._batch_sampler, "_last_batch", None) == "rollover":
            raise MXNetError(
                f"{what}: last_batch='rollover' carries leftover "
                "indices across epochs in process memory, which a "
                "resume cannot reconstruct — bit-exact mid-epoch "
                "resume needs last_batch='keep' or 'discard'")

    def iter_shard(self, batches_done, num_shards=1, shard_id=0):
        """One shared batch stream resumed at global batch
        ``batches_done``, serving only the batches owned by ``shard_id``
        (global batch ``g`` belongs to rank ``(g - batches_done) %
        num_shards``); foreign shards' indices are drawn but never
        loaded.  Same ``last_batch`` restrictions as :meth:`iter_from`."""
        num_shards = int(num_shards)
        shard_id = int(shard_id)
        if num_shards < 1 or not (0 <= shard_id < num_shards):
            raise MXNetError(
                f"iter_shard: shard_id {shard_id} out of range for "
                f"{num_shards} shard(s)")
        if num_shards == 1:
            return self.iter_from(batches_done)
        self._refuse_rollover("iter_shard")
        batches_done = int(batches_done)
        it = iter(self._batch_sampler)
        for k in range(batches_done):
            try:
                next(it)
            except StopIteration:
                raise MXNetError(
                    f"iter_shard({batches_done}): the sampler yields "
                    f"only {k} batches this epoch — the resume cursor "
                    "is past the end of the data") from None

        def _gen():
            for g, batch in enumerate(it, start=batches_done):
                if (g - batches_done) % num_shards != shard_id:
                    continue
                telemetry.fault_point("data.next", batch=g)
                yield batch
        return self._make_iter(_gen())

    def set_epoch(self, epoch):
        """Forward the epoch position to samplers that support it
        (seeded :class:`RandomSampler` — the resume path)."""
        for obj in (self._batch_sampler,
                    getattr(self._batch_sampler, "_sampler", None)):
            fn = getattr(obj, "set_epoch", None)
            if callable(fn):
                fn(epoch)

    def _make_iter(self, batch_iter):
        if self._device is None:
            # the batch is placed synchronously on the caller's context
            target = current_context().torch_device()
            depth, staging = 0, None
        else:
            target = _placement_target(self._device)
            depth = _resolve_device_prefetch(self._device_prefetch)
            staging = PinnedStaging() if (
                self._pin_memory and depth and target.type == "cuda") \
                else None
        if self._num_workers == 0:
            def _same_process_iter():
                for batch in batch_iter:
                    yield _assemble(self._dataset, self._batchify_fn, batch,
                                    staging)
            base = _same_process_iter()
            if self._device is None:
                return (to_device(b, target) for b in base)
            # background producer: host batchify AND the copy both
            # overlap the consumer's step
            return DevicePrefetchIter(base, target, depth, background=True,
                                      staging=staging)
        place_fn = None
        if self._device is None:
            place_fn = lambda batch: to_device(batch, target)  # noqa: E731
        it = _MultiWorkerIter(self._dataset, batch_iter,
                              self._batchify_fn, self._num_workers,
                              self._prefetch, self._pin_memory,
                              timeout=self._timeout, place_fn=place_fn,
                              staging=staging)
        if self._device is None:
            return it
        # the worker pool already batchifies ahead — the threadless ring
        # pulls completed host batches straight into the device ring
        return DevicePrefetchIter(it, target, depth, background=False,
                                  staging=staging)

    def __len__(self):
        return len(self._batch_sampler)
