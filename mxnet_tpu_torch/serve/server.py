"""Continuous-batching decode server.

Port of ``mxnet_tpu/serve/server.py``: callers ``submit()`` ragged
requests at any time and new sequences join the running pool at step
boundaries.  One ``pump()`` is one step boundary:

1. **admit** — every pending request the free slots can take goes into
   one wave, padded to the ``admit_sizes`` (A) and ``prefill_buckets``
   (P) ladders, and ONE prefill + page scatter admits it
   (``PoolPrograms.admit``); a wave larger than the biggest A bucket
   spills into a second admission in the same pump.  When the backlog
   outgrows the pool, the pool grows to the next of ``pool_sizes``.
2. **step** — if any slot is live, ONE decode step advances every
   active slot by one token; retired slots are masked.  Kernel launches
   are asynchronous on the card: the host does not wait here.
3. **drain** — the PREVIOUS dispatches' small ``(token, emitted, done)``
   readbacks (copied to the host without blocking, each behind a CUDA
   event) are routed to the per-request ``TokenStream``s and retired
   slots are freed, while the card computes the newest step.

EOS (``eos_id``) and ``max_new_tokens`` retirement are computed on the
device by the step itself.

Not in this slice (each enabling argument raises ``MXNetError`` naming
it): speculative decoding, the prefix cache, chunked prefill, int8 KV
pages, deadlines and the watchdog, telemetry, the HBM budget, and the
synchronous ``kv_generate`` fallback (``MXNET_SERVE_SYNC``).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import MXNetError
from ..models.decoding import _DecodeEngine
from .engine import PagePool, PoolPrograms, pool_state_grow, pool_state_init

__all__ = ["DecodeServer", "TokenStream"]

_LATER_SLICE = {
    "spec": "speculative decoding", "spec_depth": "speculative decoding",
    "spec_sizes": "speculative decoding", "drafter": "speculative decoding",
    "prefix_cache": "the prefix cache", "hbm_budget": "the HBM budget",
    "default_deadline": "deadlines", "step_timeout": "the watchdog",
}


def _pow2_ladder(start, top):
    sizes, a = [], start
    while a < top:
        sizes.append(a)
        a *= 2
    sizes.append(top)
    return sizes


def _bucket_for(ladder, n):
    """Smallest ladder entry >= n."""
    for b in ladder:
        if b >= n:
            return b
    raise MXNetError(f"{n} exceeds the largest bucket {ladder[-1]}")


def _check_ladder(name, ladder, top=None):
    if not ladder or list(ladder) != sorted(set(ladder)) or ladder[0] < 1 \
            or (top is not None and ladder[-1] > top):
        raise MXNetError(f"{name} {ladder} must be strictly increasing "
                         "positive sizes" +
                         (f" within {top}" if top is not None else ""))


class _Readback:
    """Device tensors copied to the host without blocking the issuing
    thread; ``get()`` waits only for this copy's own CUDA event."""

    def __init__(self, tensors):
        cuda = tensors[0].is_cuda
        self._host = [t.to("cpu", non_blocking=cuda) for t in tensors]
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


class TokenStream:
    """Streaming view of one request's continuation: iterate it for token
    ids as they decode, or call :meth:`tokens` to wait for all of them.
    Host arrival times are kept in :attr:`times`, the time to first token
    in :attr:`ttft`."""

    def __init__(self, request_id, detokenize=None, on_token=None):
        self.request_id = request_id
        self.submit_time = time.perf_counter()
        self.times = []
        self._detok = detokenize
        self._on_token = on_token
        self._cv = threading.Condition()
        self._toks = []
        self._done = threading.Event()
        self._error = None

    @property
    def ttft(self):
        return self.times[0] - self.submit_time if self.times else None

    @property
    def done(self):
        return self._done.is_set()

    def _push(self, tok):
        if self._done.is_set():
            return
        self.times.append(time.perf_counter())
        with self._cv:
            self._toks.append(tok)
            self._cv.notify_all()
        if self._on_token is not None:
            try:
                self._on_token(self.request_id, tok)
            except Exception as e:      # a bad callback fails its stream
                self._on_token = None
                self._finish(e)

    def _finish(self, error=None):
        with self._cv:
            if self._error is None:
                self._error = error
            self._done.set()
            self._cv.notify_all()

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._toks) and not self._done.is_set():
                    self._cv.wait()
                if i >= len(self._toks):
                    if self._error is not None:
                        raise self._error
                    return
                tok = self._toks[i]
            yield tok
            i += 1

    def cancel(self):
        raise MXNetError("request cancellation is not ported yet (a later "
                         "slice of mxnet_tpu_torch.serve)")

    def tokens(self, timeout=None):
        """Block until the request retires; return its token list."""
        if not self._done.wait(timeout):
            raise MXNetError(f"request {self.request_id} not finished "
                             f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return list(self._toks)

    def text(self, timeout=None):
        if self._detok is None:
            raise MXNetError("TokenStream has no detokenize callable")
        return "".join(self._detok(t) for t in self.tokens(timeout))


class _Request:
    __slots__ = ("prompt", "max_new", "seed", "stream")

    def __init__(self, prompt, max_new, seed, stream):
        self.prompt, self.max_new = prompt, max_new
        self.seed, self.stream = seed, stream


class DecodeServer:
    """Continuous-batching decode server over a paged slot-pool KV cache.

    ``temperature``/``top_k``/``eos_id`` are server-level; ``seed`` is
    per request — a served stream reproduces ``kv_generate(model,
    prompt[None], max_new_tokens, temperature, top_k, seed)``.  The
    server runs on the model's device.  ``autostart=True`` runs the
    scheduler on a background thread; with ``autostart=False`` the owner
    calls :meth:`pump`.
    """

    def __init__(self, model, *, max_total_len=None, pool_sizes=(1, 2, 4, 8),
                 temperature=0.0, top_k=0, eos_id=None, weights="native",
                 max_pending=256, detokenize=None, admit_sizes=None,
                 prefill_buckets=None, page_size=16, num_pages=None,
                 kv_dtype=None, autostart=True, **later):
        for name, val in later.items():
            if name not in _LATER_SLICE:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if val not in (None, False, 0):
                raise MXNetError(f"DecodeServer({name}={val!r}): "
                                 f"{_LATER_SLICE[name]} is not ported yet "
                                 "(a later slice of mxnet_tpu_torch.serve)")
        if hasattr(model.blocks[0], "rms1"):
            raise MXNetError("DecodeServer serves the GPT family only: "
                             "Llama serving is not ported yet (a later "
                             "slice of mxnet_tpu_torch.serve); use "
                             "models.kv_generate for Llama")
        if kv_dtype not in (None, "native"):
            raise MXNetError(f"DecodeServer(kv_dtype={kv_dtype!r}): int8 KV "
                             "pages are not ported yet (a later slice)")
        if os.environ.get("MXNET_SERVE_SYNC", "0") == "1":
            raise MXNetError("MXNET_SERVE_SYNC=1: the synchronous "
                             "kv_generate fallback is not ported yet")
        self.model = model
        self.T = int(max_total_len if max_total_len is not None
                     else model._cfg.max_length)
        self.pool_sizes = tuple(pool_sizes)
        _check_ladder("pool_sizes", self.pool_sizes)
        self.admit_sizes = tuple(admit_sizes) if admit_sizes is not None \
            else tuple(_pow2_ladder(1, max(self.pool_sizes)))
        _check_ladder("admit_sizes", self.admit_sizes)
        self.prefill_buckets = tuple(prefill_buckets) \
            if prefill_buckets is not None \
            else tuple(sorted({min(b, self.T)
                               for b in _pow2_ladder(8, self.T)}))
        _check_ladder("prefill_buckets", self.prefill_buckets, self.T)
        self.temperature, self.top_k = temperature, top_k
        self.eos_id, self.weights = eos_id, weights
        self.max_pending = int(max_pending)
        self.page_size = int(page_size)
        self._num_pages_fixed = num_pages is not None
        self._detok = detokenize
        self._eng = _DecodeEngine(model, temperature, top_k, weights)
        self._progs = PoolPrograms(self._eng, self.pool_sizes[0], self.T,
                                   self.page_size, num_pages, eos_id)
        self._state = pool_state_init(self._progs)
        self._pages = PagePool(self._progs.num_pages)
        self._slot_pages = [[] for _ in range(self.pool_sizes[0])]
        self._slots = [None] * self.pool_sizes[0]
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending = deque()
        self._inflight = deque()    # (kind, _Readback, slot snapshot|wave)
        self._stopping = False
        self._fatal = None
        self._next_id = 0
        self._steps = 0
        self._occupied_lane_steps = 0
        self._capacity_lane_steps = 0
        self.counters = {"step_dispatches": 0, "admit_dispatches": 0,
                         "pool_grows": 0}
        self._thread = None
        if autostart:
            self.start()

    # -- public API ------------------------------------------------------ #
    def start(self):
        """Start the background scheduler thread (no-op if running)."""
        with self._work:
            if self._stopping:
                raise self._closed_error()
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-torch-serve", daemon=True)
            self._thread.start()

    def _closed_error(self):
        if self._fatal is not None:
            return MXNetError(
                f"server failed and stopped serving: {self._fatal}")
        return MXNetError("server is closed")

    def submit(self, prompt_tokens, max_new_tokens=32, seed=0,
               nowait=False, on_token=None, deadline=None):
        """Queue one request; returns its :class:`TokenStream`.  Blocks
        while ``max_pending`` requests are queued (``nowait=True``
        raises instead)."""
        if deadline is not None:
            raise MXNetError("per-request deadlines are not ported yet (a "
                             "later slice of mxnet_tpu_torch.serve)")
        prompt = np.asarray(prompt_tokens, dtype=np.int64).reshape(-1)
        if prompt.size == 0:
            raise MXNetError("empty prompt")
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.T:
            raise MXNetError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the pool cache length {self.T}")
        if prompt.size > self.prefill_buckets[-1]:
            raise MXNetError(
                f"prompt ({prompt.size}) exceeds the largest prefill bucket "
                f"{self.prefill_buckets[-1]}; chunked prefill is not "
                "ported yet (a later slice)")
        need = self._progs.pages_for(prompt.size + max_new_tokens)
        cap = self._pages.num_pages if self._num_pages_fixed \
            else self.pool_sizes[-1] * self._progs.maxp
        if need > cap:
            raise MXNetError(f"request needs {need} KV pages but the page "
                             f"pool holds at most {cap}")
        seed = int(seed)
        if not -2 ** 31 <= seed < 2 ** 31:
            raise MXNetError(f"seed {seed} does not fit int32")
        with self._work:
            if self._stopping:
                raise self._closed_error()
            while len(self._pending) >= self.max_pending:
                if nowait or self._thread is None:
                    raise MXNetError(
                        f"backpressure: {len(self._pending)} requests "
                        f"pending (max_pending={self.max_pending})")
                self._work.wait(0.05)
                if self._stopping:
                    raise self._closed_error()
            stream = TokenStream(self._next_id, self._detok, on_token)
            self._next_id += 1
            self._pending.append(_Request(prompt, int(max_new_tokens), seed,
                                          stream))
            self._work.notify_all()
        return stream

    def reset_counters(self):
        for k in self.counters:
            self.counters[k] = 0
        self._steps = 0
        self._occupied_lane_steps = 0
        self._capacity_lane_steps = 0

    def stats(self):
        """Scheduler / occupancy / page-pool snapshot."""
        return {
            "num_slots": len(self._slots),
            "steps": self._steps,
            "occupancy": (self._occupied_lane_steps /
                          self._capacity_lane_steps
                          if self._capacity_lane_steps else 0.0),
            "pending": len(self._pending),
            "in_flight": sum(r is not None for r in self._slots),
            "page_size": self._progs.page,
            "pages_total": self._pages.num_pages,
            "pages_in_use": self._pages.in_use,
            "pool_bytes": (self._pages.num_pages + 1) *
            self._progs.page_bytes(),
            "counters": dict(self.counters),
        }

    def close(self, drain=True, timeout=60.0):
        """Stop the scheduler.  ``drain=True`` serves everything already
        submitted first; otherwise outstanding requests fail."""
        deadline = time.monotonic() + timeout
        if drain:
            while self._pending or self._inflight or \
                    any(r is not None for r in self._slots):
                if self._fatal is not None:
                    break
                if self._thread is None or not self._thread.is_alive():
                    if not self.pump():
                        break
                elif time.monotonic() > deadline:
                    raise MXNetError("close(drain=True) timed out")
                else:
                    time.sleep(0.002)
        with self._work:
            self._stopping = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=max(deadline - time.monotonic(), 0.1))
            if self._thread.is_alive():
                raise MXNetError("close() timed out waiting for the "
                                 "scheduler thread; call close() again")
        self._teardown(MXNetError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler ------------------------------------------------------- #
    def pump(self):
        """One scheduler round: admissions, one step, drain.  Returns True
        if any work happened."""
        worked = self._admit_pending()
        stepped = False
        if any(r is not None for r in self._slots):
            self._dispatch_step()
            worked = stepped = True
        worked |= self._flush_drain(keep=1 if stepped else 0)
        return worked

    def _loop(self):
        while True:
            with self._work:
                if self._stopping:
                    return
            try:
                worked = self.pump()
            except Exception as e:
                # a failed dispatch must not hang consumers: fail every
                # outstanding stream with the error and stop serving
                self._fatal = e
                with self._work:
                    self._stopping = True
                    self._work.notify_all()
                self._inflight.clear()
                self._teardown(MXNetError(f"serving loop failed: {e!r}"))
                return
            if not worked:
                with self._work:
                    if self._stopping:
                        return
                    if not self._pending and not self._inflight:
                        self._work.wait(0.05)

    def _teardown(self, err):
        with self._lock:
            dropped = list(self._pending)
            self._pending.clear()
            leftover = [r for r in self._slots if r is not None]
            self._slots = [None] * len(self._slots)
            self._work.notify_all()
        for i in range(len(self._slot_pages)):
            self._free_slot_pages(i)
        for req in dropped + leftover:
            req.stream._finish(err)

    def _maybe_grow(self):
        """Grow the pool to the next pinned size when the backlog wants
        more lanes than exist."""
        S = len(self._slots)
        busy = sum(r is not None for r in self._slots)
        want = busy + len(self._pending)
        bigger = [s for s in self.pool_sizes if s > S]
        if not bigger or want <= S:
            return
        new_s = next((s for s in bigger if s >= want), bigger[-1])
        new_pages = self._pages.num_pages if self._num_pages_fixed \
            else new_s * self._progs.maxp
        self._progs = PoolPrograms(self._eng, new_s, self.T, self.page_size,
                                   new_pages, self.eos_id)
        self._state = pool_state_grow(self._state, new_s, new_pages)
        if new_pages > self._pages.num_pages:
            self._pages.grow(new_pages)
        with self._lock:
            self._slots.extend([None] * (new_s - S))
        self._slot_pages.extend([] for _ in range(new_s - S))
        self.counters["pool_grows"] += 1

    def _admit_pending(self):
        """Wave-building batched admission: every pending request the
        free slots (and free pages) can take, one admission per wave of
        at most the largest A bucket."""
        admitted = False
        self._maybe_grow()
        cap = self.admit_sizes[-1]
        while True:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                break
            wave = []
            with self._lock:
                while self._pending and len(wave) < min(len(free), cap):
                    req = self._pending[0]
                    pages = self._pages.alloc(self._progs.pages_for(
                        req.prompt.size + req.max_new))
                    if pages is None:
                        break       # retirements free pages; retry later
                    self._pending.popleft()
                    slot = free[len(wave)]
                    self._slots[slot] = req
                    self._slot_pages[slot] = pages
                    wave.append((slot, req))
                if wave:
                    self._work.notify_all()
            if not wave:
                break
            self._dispatch_admit(wave)
            admitted = True
        if admitted and any(r.max_new == 1 for r in self._slots
                            if r is not None):
            # a 1-token budget retires inside the admission itself: read
            # it back now so its slot is free before the step decision
            self._drain_kind("admit")
        return admitted

    def _dispatch_admit(self, wave):
        """ONE bucketed (A, P) admission for a wave of (slot, request)."""
        progs = self._progs
        A = _bucket_for(self.admit_sizes, len(wave))
        P = _bucket_for(self.prefill_buckets,
                        max(req.prompt.size for _, req in wave))
        npb = -(-P // progs.page)
        prompts = np.zeros((A, P), np.int64)
        true_len = np.ones((A,), np.int64)     # idle rows read column 0
        stop_pos = np.zeros((A,), np.int64)
        seeds = np.zeros((A,), np.int64)
        pages = np.full((A, npb), progs.sentinel, np.int64)
        for i, (slot, req) in enumerate(wave):
            n = req.prompt.size
            prompts[i, :n] = req.prompt
            true_len[i] = n
            stop_pos[i] = n + req.max_new - 1
            seeds[i] = req.seed
            row = self._slot_pages[slot]
            k = min(npb, len(row))
            pages[i, :k] = row[:k]
        dev = self._eng.device
        t = lambda a: torch.as_tensor(a, device=dev)
        first, done = progs.admit(self._state, t(prompts), t(true_len),
                                  [s for s, _ in wave], t(stop_pos),
                                  t(seeds), t(pages))
        self.counters["admit_dispatches"] += 1
        self._inflight.append(("admit", _Readback([first, done]),
                               list(wave)))

    def _page_table(self):
        progs = self._progs
        pt = np.full((len(self._slots), progs.maxp), progs.sentinel,
                     np.int64)
        for i, row in enumerate(self._slot_pages):
            if row and self._slots[i] is not None:
                pt[i, :len(row)] = row
        return torch.as_tensor(pt, device=self._eng.device)

    def _dispatch_step(self):
        out = self._progs.step(self._state, self._page_table())
        self.counters["step_dispatches"] += 1
        self._steps += 1
        self._occupied_lane_steps += sum(r is not None for r in self._slots)
        self._capacity_lane_steps += len(self._slots)
        self._inflight.append(("step", _Readback(list(out)),
                               list(self._slots)))

    # -- drain ----------------------------------------------------------- #
    def _retire(self, slot, req):
        req.stream._finish()
        freed = False
        with self._lock:
            if self._slots[slot] is req:
                self._slots[slot] = None
                freed = True
            self._work.notify_all()
        if freed:
            self._free_slot_pages(slot)

    def _free_slot_pages(self, slot):
        row = self._slot_pages[slot]
        self._slot_pages[slot] = []
        for p in row:
            self._pages.decref(p)

    def _route(self, kind, readback, meta):
        if kind == "admit":
            first, done = readback.get()
            for i, (slot, req) in enumerate(meta):
                req.stream._push(int(first[i]))
                if done[i]:
                    self._retire(slot, req)
            return
        toks, emitted, done = readback.get()
        for slot, req in enumerate(meta):
            if req is None or not emitted[slot]:
                continue
            req.stream._push(int(toks[slot]))
            if done[slot]:
                self._retire(slot, req)

    def _drain_kind(self, kind):
        """Route every in-flight readback of ``kind`` (an admission is
        always a request's first entry, so this keeps stream order)."""
        rest = deque()
        while self._inflight:
            entry = self._inflight.popleft()
            if entry[0] == kind:
                self._route(*entry)
            else:
                rest.append(entry)
        self._inflight = rest

    def _flush_drain(self, keep=0):
        """Route in-flight readbacks oldest first, leaving the ``keep``
        newest in flight while the card computes them."""
        worked = False
        while len(self._inflight) > keep:
            self._route(*self._inflight.popleft())
            worked = True
        return worked
