"""Continuous-batching decode server for the GPT and Llama families.

Port of ``mxnet_tpu/serve/server.py``: callers ``submit()`` ragged
requests at any time and new sequences join the running pool at step
boundaries.  One ``pump()`` is one step boundary:

0. **cancel** — requests whose ``TokenStream.cancel()`` was called free
   their slots (``_process_cancels``); the device lane is left alone: its
   page-table row points at the trash page, so it computes masked and
   writes nowhere that matters, at no extra dispatch.
1. **admit** — every pending request the free slots can take is popped
   into one wave and planned against the page pool and the prefix cache
   (``_plan_admission``), reserving all its pages up front; a request
   cancelled or past its deadline while queued retires here without a
   slot:
   - ``admit``: no cached prefix and a prompt within the largest of
     ``prefill_buckets``: ONE prefill + page scatter admits the wave's
     such requests, padded to the ``admit_sizes`` (A) and
     ``prefill_buckets`` (P) ladders (``PoolPrograms.admit``);
   - ``hit``: the prefix cache holds every prompt token but at most the
     last: the shared pages map read-only into the slot's table, at most
     one page is copied (copy-on-write), and no model forward runs
     (``PoolPrograms.admit_hit``); the first token comes from the next
     step.  Hits dispatch before the wave's admissions and chunks;
   - ``chunk``: a prompt past the largest bucket, or a partial hit's
     uncached suffix, streams in one chunk a pump, interleaved with the
     steps (``PoolPrograms.chunk``).
   When the backlog outgrows the pool, the pool grows to the next of
   ``pool_sizes``.
2. **step** — if any slot is live, ONE decode step advances every
   active slot by one token: one CUDA-graph replay on the card, one
   capture a pool size.  Kernel launches are asynchronous on the card:
   the host does not wait here.  On a greedy server with speculation on
   (the default, as in the reference: ``spec``, ``MXNET_SERVE_SPEC``),
   the pump first drains everything in flight, the drafter
   (``serve.draft.NGramDrafter`` unless ``drafter=`` is given) proposes
   up to ``spec_depth`` tokens a slot from its prompt and routed tokens,
   and when any slot proposed, ONE verify dispatch of the smallest
   ``spec_sizes`` bucket that fits scores them all and accepts each
   slot's longest matching prefix on the device (one CUDA-graph replay
   a (pool size, bucket)).  A stream is the same token for token as
   without speculation.
3. **drain** — the PREVIOUS dispatches' small ``(token, emitted, done)``
   readbacks (copied to the host without blocking, each behind a CUDA
   event) are routed to the per-request ``TokenStream``s and retired
   slots are freed, while the card computes the newest step.  A late
   readback of a cancelled or retired request is dropped by the
   request's identity, never by its slot index.

EOS (``eos_id``), ``max_new_tokens`` and deadline retirement are computed
on the device by the step itself: ``submit(deadline=)`` (or
``default_deadline`` / ``MXNET_SERVE_DEADLINE``) gives a request a
wall-clock budget, carried as a per-slot f32 deadline in server-epoch
seconds, and the step and the verify take the clock ``now`` as a device
operand written before each call.  The prefix cache (``_PrefixIndex``)
is on unless ``prefix_cache=False`` or ``MXNET_SERVE_PREFIX_CACHE=0``.
``kv_dtype="int8"`` (or ``MXNET_SERVE_KV_DTYPE=int8``) stores the pages
as int8 codes with one f32 scale a (layer, page, head): half a bf16
pool, and the reference's one lossy serving mode (PARITY.md).

Fault tolerance and telemetry, as in the reference: a watchdog thread
(``step_timeout`` / ``MXNET_SERVE_STEP_TIMEOUT``) fails every in-flight
stream with an ``MXNetError`` when the scheduler thread dies or one
dispatch wedges (a cold program, a first admission bucket and a kernel
build suspend it); ``hbm_budget`` / ``MXNET_SERVE_HBM_BUDGET`` refuses a
pool, a growth or an admission wave whose priced bytes would pass it;
``MXNET_FAULT_INJECT`` arms the sites ``serve.pump``, ``serve.admit``,
``serve.chunk``, ``serve.verify`` and ``serve.step``; ``counters`` is a
view over the telemetry registry (``serve_<key>_total{server=}``), with
TTFT, token-gap and queue-wait histograms and ``serve_config``,
``serve_admit``, ``serve_request``, ``deadline_exceeded``,
``request_cancelled``, ``watchdog_fired`` and ``serve_stats`` events.
``MXNET_SERVE_SYNC=1`` — or a model the slot-pool gate rejects — serves
each request through one ``models.kv_generate`` call on the same device
and kernels instead (``sync_mode``, ``sync_reason``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from collections.abc import MutableMapping

import numpy as np
import torch

from .. import _build, telemetry
from ..base import MXNetError, parse_seconds
from ..models.decoding import _DecodeEngine
from ..telemetry.faults import fault_point
from ..telemetry.memory import (ACCOUNTANT, format_bytes, nbytes_of,
                                parse_bytes)
from .draft import NGramDrafter
from .engine import (PagePool, PoolPrograms, admit_scratch_bytes,
                     pool_state_bytes, pool_state_grow, pool_state_init)

__all__ = ["DecodeServer", "TokenStream", "serve_counters",
           "reset_serve_counters"]

# process-wide aggregate of every server's dispatch counts; per-server
# truth is ``DecodeServer.counters``.  Mutations take ``_counters_lock``.
serve_counters = {"step_dispatches": 0, "admit_dispatches": 0,
                  "sync_requests": 0, "pool_grows": 0,
                  "prefix_hits": 0, "cow_copies": 0,
                  "chunk_dispatches": 0, "verify_dispatches": 0,
                  "draft_proposed": 0, "draft_accepted": 0,
                  "draft_rejected": 0}
_counters_lock = threading.Lock()
_server_seq = itertools.count()


def _bump(key, n=1):
    with _counters_lock:
        serve_counters[key] += n


def reset_serve_counters():
    with _counters_lock:
        for k in serve_counters:
            serve_counters[k] = 0


class _CounterView(MutableMapping):
    """``DecodeServer.counters``: the dict API as a live view over the
    server's registry counters (``serve_<key>_total{server=}``), so
    ``srv.counters["step_dispatches"]`` and ``telemetry.snapshot()`` /
    ``render_prometheus()`` read the same numbers.  Assignment (the reset
    path) writes the counter; the keys are fixed, in the reference's
    order."""

    _KEYS = ("step_dispatches", "admit_dispatches", "sync_requests",
             "pool_grows", "prefix_hits", "cow_copies",
             "chunk_dispatches", "verify_dispatches",
             "draft_proposed", "draft_accepted", "draft_rejected")

    def __init__(self, server_label):
        self._c = {k: telemetry.counter(f"serve_{k}_total",
                                        server=server_label)
                   for k in self._KEYS}

    def inc(self, key, n=1):
        self._c[key].inc(n)

    def __getitem__(self, key):
        return self._c[key].value

    def __setitem__(self, key, value):
        self._c[key]._assign(int(value))

    def __delitem__(self, key):
        raise MXNetError("DecodeServer.counters keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


def _parse_sizes(var, raw, what):
    try:
        sizes = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        raise MXNetError(f"{var}={raw!r}: expected a "
                         f"comma-separated list of {what}")
    if not sizes or sizes[0] < 1:
        raise MXNetError(f"{var}={raw!r}: {what} must be positive")
    return tuple(sizes)


def _pool_sizes_from_env():
    """``MXNET_SERVE_POOL_SIZES``: the pinned slot counts (default
    1,2,4,8)."""
    return _parse_sizes("MXNET_SERVE_POOL_SIZES",
                        os.environ.get("MXNET_SERVE_POOL_SIZES",
                                       "1,2,4,8"), "slot counts")


def _admit_sizes_from_env(pool_sizes):
    """``MXNET_SERVE_ADMIT_SIZES``: the admission-wave buckets (default:
    powers of two up to the largest pool size)."""
    raw = os.environ.get("MXNET_SERVE_ADMIT_SIZES")
    if raw is None:
        return tuple(_pow2_ladder(1, max(pool_sizes)))
    return _parse_sizes("MXNET_SERVE_ADMIT_SIZES", raw, "wave sizes")


def _prefill_buckets_from_env(T):
    """``MXNET_SERVE_PREFILL_BUCKETS``: the prompt buckets (default:
    powers of two from 8 up to the cache length, each clamped to it)."""
    raw = os.environ.get("MXNET_SERVE_PREFILL_BUCKETS")
    if raw is None:
        return tuple(sorted({min(b, T) for b in _pow2_ladder(8, T)}))
    buckets = _parse_sizes("MXNET_SERVE_PREFILL_BUCKETS", raw,
                           "prompt bucket lengths")
    return tuple(sorted({min(b, T) for b in buckets}))


def _page_size_from_env():
    """``MXNET_SERVE_PAGE_SIZE``: tokens a KV page (default 16)."""
    raw = os.environ.get("MXNET_SERVE_PAGE_SIZE", "16")
    try:
        page = int(raw)
    except ValueError:
        raise MXNetError(f"MXNET_SERVE_PAGE_SIZE={raw!r}: expected a "
                         "positive integer token count")
    if page < 1:
        raise MXNetError(f"MXNET_SERVE_PAGE_SIZE={raw!r}: page size "
                         "must be >= 1 tokens")
    return page


def _hbm_budget_from_env():
    """``MXNET_SERVE_HBM_BUDGET``: bytes (K/M/G/T suffixes accepted) the
    server's device-resident serving state may occupy; unset: no
    limit."""
    raw = os.environ.get("MXNET_SERVE_HBM_BUDGET")
    if raw is None:
        return None
    return parse_bytes(raw, "MXNET_SERVE_HBM_BUDGET")


def _prefix_cache_from_env():
    """``MXNET_SERVE_PREFIX_CACHE``: 0 disables copy-on-write shared-
    prefix caching (default on)."""
    return os.environ.get("MXNET_SERVE_PREFIX_CACHE", "1") != "0"


def _kv_dtype_from_env():
    """``MXNET_SERVE_KV_DTYPE``: the paged pool's storage, ``int8``
    (codes and one f32 scale a page and head: lossy, PARITY.md) or
    ``native`` (the model's dtype, the default).  ``DecodeServer(
    kv_dtype=)`` wins over it."""
    raw = os.environ.get("MXNET_SERVE_KV_DTYPE", "native").lower()
    if raw in ("native", "f32", "float32", "bf16", "bfloat16", ""):
        return "native"
    if raw == "int8":
        return "int8"
    raise MXNetError(f"MXNET_SERVE_KV_DTYPE={raw!r}: expected 'native' "
                     "(model cache dtype) or 'int8'")


def _spec_from_env():
    """``MXNET_SERVE_SPEC``: 0 disables speculative draft-and-verify
    decoding (default on; only greedy servers speculate)."""
    return os.environ.get("MXNET_SERVE_SPEC", "1") != "0"


def _spec_depth_from_env():
    """``MXNET_SERVE_SPEC_DEPTH``: the most draft tokens a slot proposes
    a verify dispatch (default 4; 0 disables speculation)."""
    raw = os.environ.get("MXNET_SERVE_SPEC_DEPTH", "4")
    try:
        depth = int(raw)
    except ValueError:
        raise MXNetError(f"MXNET_SERVE_SPEC_DEPTH={raw!r}: expected "
                         "a non-negative integer draft depth")
    if depth < 0:
        raise MXNetError(f"MXNET_SERVE_SPEC_DEPTH={raw!r}: draft "
                         "depth must be >= 0")
    return depth


def _spec_sizes_from_env(depth):
    """``MXNET_SERVE_SPEC_SIZES``: the verify program's k buckets (one
    program a bucket and pool size).  Default: powers of two up to the
    speculation depth."""
    raw = os.environ.get("MXNET_SERVE_SPEC_SIZES")
    if raw is None:
        return tuple(_pow2_ladder(1, max(depth, 1)))
    return _parse_sizes("MXNET_SERVE_SPEC_SIZES", raw, "draft depths")


def _parse_positive_seconds(var, raw):
    """A positive seconds knob; unset or 0: None, malformed: an error."""
    val = parse_seconds(var, raw)
    return val if val is not None and val > 0 else None


def _default_deadline_from_env():
    """``MXNET_SERVE_DEADLINE``: the default per-request wall-clock
    budget in seconds (``submit(deadline=)`` wins); unset/0: none."""
    return _parse_positive_seconds("MXNET_SERVE_DEADLINE",
                                   os.environ.get("MXNET_SERVE_DEADLINE"))


def _step_timeout_from_env():
    """``MXNET_SERVE_STEP_TIMEOUT``: seconds one dispatch of a scheduler
    pump may run before the watchdog declares it wedged and fails every
    in-flight stream; unset/0: off."""
    return _parse_positive_seconds(
        "MXNET_SERVE_STEP_TIMEOUT",
        os.environ.get("MXNET_SERVE_STEP_TIMEOUT"))


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


class _PrefixIndex:
    """Host-side copy-on-write shared-prefix page cache: a trie over FULL
    pages of prompt tokens, each node mapping one ``(parent,
    page-of-token-bytes)`` chunk to the pool page holding its K/V.
    ``register`` pins a producer's full prompt pages with one index-owned
    refcount each (so they outlive the producer); ``match`` walks the
    longest cached chain for a new prompt; ``evict`` drops the least
    recently touched LEAF nodes when the allocator runs dry.  Scheduler
    thread only, like the ``PagePool`` under it."""

    def __init__(self, page_size, pool):
        self.page = int(page_size)
        self.pool = pool
        self._nodes = {}    # (parent_id, chunk_bytes) -> node dict
        self._by_id = {}    # node id -> node (parent chains, eviction)
        self._ids = itertools.count(1)
        self._tick = itertools.count(1)

    def __len__(self):
        return len(self._nodes)

    def _chunk_key(self, prompt, parent, c):
        return (parent,
                prompt[c * self.page:(c + 1) * self.page].tobytes())

    def match(self, prompt):
        """Longest chain of cached full pages covering a prefix of
        ``prompt``: ``(num_matched_pages, [pool page ids])``."""
        pages, parent = [], 0
        for c in range(prompt.size // self.page):
            node = self._nodes.get(self._chunk_key(prompt, parent, c))
            if node is None:
                break
            node["last"] = next(self._tick)
            pages.append(node["page"])
            parent = node["id"]
        return len(pages), pages

    def register(self, prompt, length, slot_pages):
        """Index ``prompt[:length]``'s full pages, backed by the producer
        slot's ``slot_pages``.  Only new nodes incref their page; pages
        past the last full one are never indexed (the producer's own
        steps write into them)."""
        parent = 0
        for c in range(min(length // self.page, len(slot_pages))):
            key = self._chunk_key(prompt, parent, c)
            node = self._nodes.get(key)
            if node is None:
                node = {"id": next(self._ids), "key": key,
                        "page": slot_pages[c], "parent": parent,
                        "children": 0, "last": next(self._tick)}
                self._nodes[key] = node
                self._by_id[node["id"]] = node
                if parent:
                    self._by_id[parent]["children"] += 1
                self.pool.incref(node["page"])
            else:
                node["last"] = next(self._tick)
            parent = node["id"]

    def evict(self, need, protect=()):
        """Drop LRU leaf nodes (never pages in ``protect``) until ``need``
        pool pages have come free (a decref frees a page only once no
        slot maps it).  Returns the pages freed."""
        protect = set(protect)
        before = self.pool.free_pages
        while self.pool.free_pages - before < need:
            leaves = [nd for nd in self._nodes.values()
                      if nd["children"] == 0 and nd["page"] not in protect]
            if not leaves:
                break
            self._drop(min(leaves, key=lambda nd: nd["last"]))
        return self.pool.free_pages - before

    def _drop(self, node):
        del self._nodes[node["key"]]
        del self._by_id[node["id"]]
        if node["parent"]:
            self._by_id[node["parent"]]["children"] -= 1
        self.pool.decref(node["page"])

    def drop_all(self):
        """Release every index-owned page ref (server teardown)."""
        for node in self._by_id.values():
            self.pool.decref(node["page"])
        self._nodes.clear()
        self._by_id.clear()


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
    in :attr:`ttft`; how the request entered its slot in
    :attr:`admission` (``mode`` "admit", "hit" or "chunk" and its
    buckets, the reference's request-span admission fields); its draft
    ledger in :attr:`draft_accepted`, :attr:`draft_rejected` and
    :attr:`accept_rate`; why it retired in :attr:`reason` (the request
    span's reason).  :meth:`cancel` ends it early from any thread."""

    def __init__(self, request_id, detokenize=None, on_token=None):
        self.request_id = request_id
        self.admission = None
        # the draft tokens of this request that verify dispatches
        # accepted and rejected (scheduler thread)
        self.draft_accepted = 0
        self.draft_rejected = 0
        self.submit_time = time.perf_counter()
        self.times = []
        self._detok = detokenize
        self._on_token = on_token
        self._cv = threading.Condition()
        self._toks = []
        self._done = threading.Event()
        self._error = None
        self._cancel_hook = None    # set by DecodeServer.submit
        self._cancelled = False
        # why the request retired ("eos", "max_len", "deadline_exceeded",
        # "cancelled", "error", "closed"); None while it runs
        self.reason = None

    @property
    def ttft(self):
        return self.times[0] - self.submit_time if self.times else None

    @property
    def done(self):
        return self._done.is_set()

    @property
    def cancelled(self):
        """True once :meth:`cancel` took effect (the stream is done with
        the tokens that arrived before)."""
        return self._cancelled

    @property
    def accept_rate(self):
        """Share of this request's proposed draft tokens that were
        accepted (0.0 while none was proposed)."""
        total = self.draft_accepted + self.draft_rejected
        return self.draft_accepted / total if total else 0.0

    def _push(self, tok):
        if self._done.is_set():
            # a late readback of a cancelled or deadline-retired request:
            # the stream is sealed
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
        """Cancel the request: a queued one is dropped at once; an
        admitted one has its slot freed at the next step boundary by the
        scheduler, with no extra dispatch and no effect on the other
        slots.  The stream finishes cleanly with the tokens received so
        far.  Idempotent; False once the request retired (or, in sync
        mode, once its ``kv_generate`` call began).  Returns whether the
        cancellation took effect."""
        hook = self._cancel_hook
        if hook is None:
            raise MXNetError(f"stream {self.request_id} is not cancellable "
                             "(not attached to a server)")
        return hook()

    def tokens(self, timeout=None):
        """Block until the request retires; return its token list.  A
        timeout raises ``MXNetError`` and consumes nothing: a later call
        still drains the whole stream."""
        if not self._done.wait(timeout):
            raise MXNetError(f"request {self.request_id} not finished "
                             f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return list(self._toks)

    def text_iter(self):
        """Streaming detokenization: one text piece a token."""
        if self._detok is None:
            raise MXNetError("TokenStream has no detokenize callable")
        for tok in self:
            yield self._detok(tok)

    def text(self, timeout=None):
        if self._detok is None:
            raise MXNetError("TokenStream has no detokenize callable")
        return "".join(self._detok(t) for t in self.tokens(timeout))


class _Request:
    __slots__ = ("prompt", "max_new", "seed", "stream", "span", "deadline",
                 "cancelled", "retired")

    def __init__(self, prompt, max_new, seed, stream, deadline=None):
        self.prompt, self.max_new = prompt, max_new
        self.seed, self.stream = seed, stream
        # absolute deadline on the server's clock (None: none)
        self.deadline = deadline
        self.cancelled = False
        self.retired = False        # span closed (observed once)
        self.span = {}              # admission fields of the request span


class DecodeServer:
    """Continuous-batching decode server over a paged slot-pool KV cache.

    ``temperature``/``top_k``/``eos_id`` are server-level; ``seed`` is
    per request — a served stream reproduces ``kv_generate(model,
    prompt[None], max_new_tokens, temperature, top_k, seed)``.  The
    server runs on the model's device.  ``autostart=True`` runs the
    scheduler (and its watchdog) on background threads; with
    ``autostart=False`` the owner calls :meth:`pump`.  ``prefix_cache``
    (default: on, unless ``MXNET_SERVE_PREFIX_CACHE=0``) shares identical
    full prompt pages between requests, copy-on-write.  A prompt longer
    than the largest of ``prefill_buckets`` streams in chunk by chunk;
    the one length limit is the pool cache length ``max_total_len``.
    ``pool_sizes``, ``admit_sizes``, ``prefill_buckets`` and
    ``page_size`` default to ``MXNET_SERVE_POOL_SIZES``,
    ``MXNET_SERVE_ADMIT_SIZES``, ``MXNET_SERVE_PREFILL_BUCKETS`` and
    ``MXNET_SERVE_PAGE_SIZE``.

    ``kv_dtype`` ("native" or "int8"; default ``MXNET_SERVE_KV_DTYPE``)
    is the pages' storage.  Speculation (``spec``, default
    ``MXNET_SERVE_SPEC``: on) runs on greedy servers only: a slot drafts
    at most ``spec_depth`` tokens (default ``MXNET_SERVE_SPEC_DEPTH``,
    4; clamped to the largest bucket), ``spec_sizes`` (default
    ``MXNET_SERVE_SPEC_SIZES``: powers of two up to the depth) are the
    verify program's k buckets, and ``drafter`` is a
    ``serve.draft.Drafter`` (default ``NGramDrafter()``).

    ``default_deadline`` (``MXNET_SERVE_DEADLINE``) is every request's
    wall-clock budget unless ``submit(deadline=)`` gives one;
    ``step_timeout`` (``MXNET_SERVE_STEP_TIMEOUT``; 0: off) arms the
    watchdog; ``hbm_budget`` (bytes or "512M"-style, or
    ``MXNET_SERVE_HBM_BUDGET``) bounds the pool and the admission
    scratch.  ``_clock``/``_epoch`` (``time.monotonic`` and its value at
    construction) may be replaced, as the reference's tests do.
    """

    def __init__(self, model, *, max_total_len=None, pool_sizes=None,
                 temperature=0.0, top_k=0, eos_id=None, weights="native",
                 max_pending=256, detokenize=None, admit_sizes=None,
                 prefill_buckets=None, hbm_budget=None,
                 default_deadline=None, step_timeout=None, page_size=None,
                 num_pages=None, prefix_cache=None, spec=None,
                 spec_depth=None, spec_sizes=None, drafter=None,
                 kv_dtype=None, autostart=True):
        self.model = model
        # the server's clock and epoch: deadlines ride the slot state as
        # f32 seconds since the epoch, and the step's ``now`` operand is
        # f32(clock() - epoch)
        self._clock = time.monotonic
        self._epoch = self._clock()
        self.default_deadline = default_deadline \
            if default_deadline is not None \
            else _default_deadline_from_env()
        if self.default_deadline is not None \
                and self.default_deadline <= 0:
            raise MXNetError("default_deadline must be positive seconds")
        self.step_timeout = step_timeout if step_timeout is not None \
            else _step_timeout_from_env()
        if self.step_timeout is not None and self.step_timeout <= 0:
            self.step_timeout = None    # 0: the watchdog's gauge is off
        self._fatal = None          # the error the scheduler died with
        self._torn = False          # _teardown ran: a wedged dispatch
        # that completes late must not pin the released pool again
        self._watchdog = None
        self._pump_t0 = None        # start of the current dispatch's gauge
        self.T = int(max_total_len if max_total_len is not None
                     else model._cfg.max_length)
        self.pool_sizes = tuple(pool_sizes) if pool_sizes is not None \
            else _pool_sizes_from_env()
        _check_ladder("pool_sizes", self.pool_sizes)
        self.admit_sizes = tuple(admit_sizes) if admit_sizes is not None \
            else _admit_sizes_from_env(self.pool_sizes)
        _check_ladder("admit_sizes", self.admit_sizes)
        self.prefill_buckets = tuple(prefill_buckets) \
            if prefill_buckets is not None \
            else _prefill_buckets_from_env(self.T)
        _check_ladder("prefill_buckets", self.prefill_buckets, self.T)
        self.temperature, self.top_k = temperature, top_k
        self.eos_id, self.weights = eos_id, weights
        self.max_pending = int(max_pending)
        self._detok = detokenize
        self.hbm_budget = parse_bytes(hbm_budget, "hbm_budget") \
            if hbm_budget is not None else _hbm_budget_from_env()
        self.page_size = int(page_size) if page_size is not None \
            else _page_size_from_env()
        if self.page_size < 1:
            raise MXNetError(f"page_size must be >= 1, "
                             f"got {self.page_size}")
        self._num_pages_fixed = num_pages is not None
        self.kv_dtype = str(kv_dtype).lower() if kv_dtype is not None \
            else _kv_dtype_from_env()
        if self.kv_dtype in ("f32", "float32", "bf16", "bfloat16"):
            self.kv_dtype = "native"
        if self.kv_dtype not in ("native", "int8"):
            raise MXNetError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {kv_dtype!r}")
        self.prefix_cache_enabled = bool(prefix_cache) \
            if prefix_cache is not None else _prefix_cache_from_env()
        self.spec_depth = int(spec_depth) if spec_depth is not None \
            else _spec_depth_from_env()
        if self.spec_depth < 0:
            raise MXNetError(f"spec_depth must be >= 0, "
                             f"got {self.spec_depth}")
        self.spec_sizes = tuple(spec_sizes) if spec_sizes is not None \
            else _spec_sizes_from_env(self.spec_depth)
        if not self.spec_sizes \
                or list(self.spec_sizes) != sorted(set(self.spec_sizes)) \
                or self.spec_sizes[0] < 1:
            raise MXNetError(f"spec_sizes {self.spec_sizes} must be "
                             "strictly increasing positive draft depths")
        self.spec_depth = min(self.spec_depth, self.spec_sizes[-1])
        # greedy only: acceptance compares argmax tokens, so a sampled
        # server never builds a verify program
        self.spec_enabled = ((bool(spec) if spec is not None
                              else _spec_from_env())
                             and self.spec_depth > 0
                             and temperature == 0.0)
        self._drafter = drafter if drafter is not None else NGramDrafter()
        # this server's telemetry identity: labels its registry
        # instruments and its events
        self.telemetry_label = f"srv{next(_server_seq)}"
        label = self.telemetry_label
        self._tele = {
            "ttft": telemetry.histogram("serve_ttft_seconds", server=label),
            "gap": telemetry.histogram("serve_token_gap_seconds",
                                       server=label),
            "wait": telemetry.histogram("serve_queue_wait_seconds",
                                        server=label),
            "occ": telemetry.gauge("serve_occupancy", server=label),
            "pages": telemetry.gauge("serve_pages_in_use", server=label),
        }
        self.sync_mode = os.environ.get("MXNET_SERVE_SYNC", "0") == "1"
        self.sync_reason = "MXNET_SERVE_SYNC=1" if self.sync_mode else None
        self._eng = self._stream = self._progs = None
        self._pool_bytes = 0
        if not self.sync_mode:
            try:
                self._eng = _DecodeEngine(model, temperature, top_k, weights)
                # one side stream for every program the server captures
                self._stream = torch.cuda.Stream(self._eng.device) \
                    if self._eng.device.type == "cuda" else None
                self._progs = self._pool_programs(self.pool_sizes[0],
                                                  num_pages)
            except MXNetError as e:
                # a model the slot-pool gate rejects still serves, one
                # request at a time, through kv_generate
                self.sync_mode = True
                self.sync_reason = str(e)
                self._eng = self._stream = None
        if self.sync_mode and self.hbm_budget is not None:
            import warnings

            why = "" if self.sync_reason is None \
                else ": " + self.sync_reason
            warnings.warn(
                f"DecodeServer hbm_budget={self.hbm_budget} is NOT "
                f"enforced in sync mode (kv_generate fallback{why}) — "
                "per-request decode caches are unmetered", stacklevel=2)
        if not self.sync_mode:
            # the minimum usable configuration must fit: the smallest
            # pool and the smallest admission wave's scratch
            self._check_budget(
                self.pool_sizes[0],
                scratch=admit_scratch_bytes(self._progs,
                                            self.admit_sizes[0]),
                what=f"initial pool ({self.pool_sizes[0]} slots) plus "
                     f"the smallest admission wave's "
                     f"(A={self.admit_sizes[0]}) prefill scratch")
        self._state = None if self.sync_mode \
            else pool_state_init(self._progs)
        if self._state is not None:
            self._account_pool()
        self._pages = None if self.sync_mode \
            else PagePool(self._progs.num_pages)
        # slots mid-chunked-prefill (kept out of the steps until their
        # final chunk), their chunk records, and the prefix index
        self._chunk_slots = set()
        self._chunking = deque()    # {"req", "slot", "off", "start"}
        self._prefix = _PrefixIndex(self._progs.page, self._pages) \
            if not self.sync_mode and self.prefix_cache_enabled else None
        self._slot_pages = [[] for _ in range(self.pool_sizes[0])]
        self._slots = [None] * self.pool_sizes[0]
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending = deque()
        self._inflight = deque()    # (kind, _Readback, slot snapshot|wave)
        self._stopping = False
        self._next_id = 0
        self._steps = 0
        self._occupied_lane_steps = 0
        self._capacity_lane_steps = 0
        self.counters = _CounterView(label)
        self._stats_emitted = False
        self._retired = []      # program_records() of each outgrown pool
        self._thread = None
        telemetry.emit(
            "serve_config", server=label, pool_sizes=list(self.pool_sizes),
            admit_sizes=list(self.admit_sizes),
            prefill_buckets=list(self.prefill_buckets),
            max_total_len=self.T, sync_mode=self.sync_mode,
            sync_reason=self.sync_reason, hbm_budget=self.hbm_budget,
            pool_bytes=self._pool_bytes,
            default_deadline=self.default_deadline,
            step_timeout=self.step_timeout, page_size=self.page_size,
            num_pages=None if self.sync_mode else self._progs.num_pages,
            kv_dtype=self.kv_dtype,
            page_bytes=None if self.sync_mode
            else self._progs.page_bytes(),
            prefix_cache=self.prefix_cache_enabled,
            spec=self.spec_enabled, spec_depth=self.spec_depth,
            spec_sizes=list(self.spec_sizes))
        if autostart:
            self.start()

    # -- public API ------------------------------------------------------ #
    def start(self):
        """Start the background scheduler thread (no-op if running) and
        its watchdog, which fails every in-flight stream when the
        scheduler thread dies without its own failure path or one
        dispatch wedges past ``step_timeout``."""
        with self._work:
            if self._stopping:
                raise self._closed_error()
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-torch-serve", daemon=True)
            self._thread.start()
            if self._watchdog is None or not self._watchdog.is_alive():
                self._watchdog = threading.Thread(
                    target=self._watch, name="mxnet-torch-serve-watchdog",
                    daemon=True)
                self._watchdog.start()

    def _closed_error(self):
        if self._fatal is not None:
            return MXNetError(
                f"server failed and stopped serving: {self._fatal}")
        return MXNetError("server is closed")

    def submit(self, prompt_tokens, max_new_tokens=32, seed=0,
               nowait=False, on_token=None, deadline=None):
        """Queue one request; returns its :class:`TokenStream`.

        ``deadline`` (seconds from now; default ``default_deadline``) is
        the request's wall-clock budget: once it passes, the step retires
        the sequence on the device with the tokens made so far (reason
        ``deadline_exceeded``); a request whose deadline passes while it
        is queued retires at the admission boundary without a slot.
        Blocks while ``max_pending`` requests are queued (``nowait=True``
        raises instead)."""
        prompt = np.asarray(prompt_tokens, dtype=np.int64).reshape(-1)
        if prompt.size == 0:
            raise MXNetError("empty prompt")
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.T:
            raise MXNetError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the pool cache length {self.T}")
        if not self.sync_mode:
            need = self._progs.pages_for(prompt.size + max_new_tokens)
            cap = self._pages.num_pages if self._num_pages_fixed \
                else self.pool_sizes[-1] * self._progs.maxp
            if need > cap:
                raise MXNetError(f"request needs {need} KV pages but the "
                                 f"page pool holds at most {cap}")
        seed = int(seed)
        if not -2 ** 31 <= seed < 2 ** 31:
            raise MXNetError(f"seed {seed} does not fit int32")
        if deadline is None:
            deadline = self.default_deadline
        if deadline is not None and deadline <= 0:
            raise MXNetError(f"deadline {deadline} must be positive seconds")
        abs_deadline = None if deadline is None \
            else self._clock() + deadline
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
            req = _Request(prompt, int(max_new_tokens), seed, stream,
                           deadline=abs_deadline)
            stream._cancel_hook = lambda: self._cancel(req)
            self._pending.append(req)
            self._work.notify_all()
        return stream

    def _count(self, key, n=1):
        self.counters.inc(key, n)
        _bump(key, n)

    def reset_counters(self):
        for k in self.counters:
            self.counters[k] = 0
        self._steps = 0
        self._occupied_lane_steps = 0
        self._capacity_lane_steps = 0

    def stats(self):
        """Scheduler / occupancy / page-pool / draft-ledger / latency
        snapshot (the reference's keys)."""
        acc = self.counters["draft_accepted"]
        rej = self.counters["draft_rejected"]
        return {
            "server": self.telemetry_label,
            "num_slots": len(self._slots),
            "steps": self._steps,
            "spec": self.spec_enabled,
            "spec_depth": self.spec_depth,
            "draft_accepted": acc,
            "draft_rejected": rej,
            "draft_accept_rate": acc / (acc + rej) if acc + rej else 0.0,
            "occupancy": (self._occupied_lane_steps /
                          self._capacity_lane_steps
                          if self._capacity_lane_steps else 0.0),
            "pending": len(self._pending),
            "in_flight": sum(r is not None for r in self._slots),
            "sync_mode": self.sync_mode,
            # the state's bytes as allocated (0 in sync mode and once
            # closed)
            "pool_bytes": self._pool_bytes,
            "hbm_budget": self.hbm_budget,
            "kv_dtype": self.kv_dtype,
            "page_bytes": None if self.sync_mode
            else self._progs.page_bytes(),
            "page_size": None if self.sync_mode else self._progs.page,
            "pages_total": 0 if self._pages is None
            else self._pages.num_pages,
            "pages_in_use": 0 if self._pages is None
            else self._pages.in_use,
            "prefix_nodes": 0 if self._prefix is None else len(self._prefix),
            "counters": dict(self.counters),
            "ttft": self._tele["ttft"].summary(),
            "token_gap": self._tele["gap"].summary(),
            "queue_wait": self._tele["wait"].summary(),
        }

    def step_records(self):
        """What the step program of every pool size served so far did
        (``PoolPrograms.step_record``, one ``gluon.block._GraphProgram``
        a size, captured once on the card), oldest first: an outgrown
        pool keeps only its records, its state and graphs are freed."""
        return [r for r in self.program_records() if r["k"] is None]

    def program_records(self):
        """The records of every program served so far, each step's then
        its pool size's verify programs by k bucket
        (``PoolPrograms.program_records``), oldest pool size first."""
        if self._progs is None:
            return list(self._retired)
        return self._retired + self._progs.program_records()

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
        if self._watchdog is not None:
            self._watchdog.join(timeout=1.0)     # exits on _stopping
        self._flush_drain()
        self._emit_stats()
        self._teardown(MXNetError("server closed"), reason="closed")

    def _emit_stats(self):
        """One ``serve_stats`` event a server lifetime, at close."""
        if self._stats_emitted:
            return
        self._stats_emitted = True
        telemetry.emit("serve_stats", **self.stats())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler ------------------------------------------------------- #
    def pump(self):
        """One scheduler round: cancellations, admissions, one step or
        verify, drain.  Returns True if any work happened."""
        fault_point("serve.pump", server=self.telemetry_label)
        # cancellations first: a freed slot can be filled in this pump
        worked = self._process_cancels()
        if self.sync_mode:
            return self._pump_sync() or worked
        worked |= self._admit_pending()
        stepped = False
        # slots mid-chunked-prefill do not step: their lanes activate at
        # the final chunk
        if self._live_slots():
            drafts = None
            if self.spec_enabled:
                # drafts chain off each slot's newest token, in flight
                # until the previous dispatch drains: speculation gives
                # up the one-dispatch overlap; the drain may retire
                # slots, so liveness is asked again
                worked |= self._flush_drain()
                if self._live_slots():
                    drafts = self._build_drafts()
            if drafts:
                self._dispatch_verify(drafts)
                worked = stepped = True
            elif self._live_slots():
                self._dispatch_step()
                worked = stepped = True
        worked |= self._flush_drain(keep=1 if stepped else 0)
        return worked

    def _live_slots(self):
        return any(r is not None and i not in self._chunk_slots
                   for i, r in enumerate(self._slots))

    def _loop(self):
        while True:
            with self._work:
                if self._stopping:
                    return
            self._pump_t0 = self._clock()       # the watchdog's gauge
            try:
                worked = self.pump()
            except Exception as e:
                # a failed dispatch must not hang consumers: fail every
                # outstanding stream with the error and stop serving
                self._fail_all(e)
                return
            finally:
                self._pump_t0 = None
            if not worked:
                with self._work:
                    if self._stopping:
                        return
                    if not self._pending and not self._inflight:
                        self._work.wait(0.05)

    def _watch_dispatch(self, cold):
        """Re-arm the watchdog's gauge for one dispatch, or suspend it for
        the rest of the pump when the dispatch is ``cold``: a program's
        first calls (its eager run and its capture) and the first
        dispatch of an admission or chunk bucket may take far longer
        than any sane ``step_timeout``, building kernels included.
        Scheduler thread only."""
        if self._pump_t0 is None:
            return              # pump-driven, or already suspended
        self._pump_t0 = None if cold else self._clock()

    def _watch(self):
        """The watchdog (a daemon started beside the loop): fails every
        in-flight stream when the scheduler thread dies without running
        its failure path, or when one dispatch wedges past
        ``step_timeout``.  A kernel build in progress suspends the gauge
        for the rest of that pump.  Exits when the server stops."""
        while True:
            with self._work:
                if self._stopping:
                    return
            th = self._thread
            if th is not None and not th.is_alive():
                with self._work:
                    if self._stopping:
                        return      # a clean close() raced the check
                self._watchdog_fire("scheduler thread died without "
                                    "running its failure path")
                return
            if _build.building:
                self._pump_t0 = None
            t0 = self._pump_t0
            if self.step_timeout is not None and t0 is not None \
                    and self._clock() - t0 > self.step_timeout:
                self._watchdog_fire(
                    f"scheduler pump wedged for more than "
                    f"step_timeout={self.step_timeout}s "
                    "(MXNET_SERVE_STEP_TIMEOUT) — a dispatch is hung")
                return
            time.sleep(0.05)

    def _watchdog_fire(self, why):
        telemetry.emit("watchdog_fired", server=self.telemetry_label,
                       reason=why)
        telemetry.counter("serve_watchdog_fired_total",
                          server=self.telemetry_label).inc()
        self._fail_all(MXNetError(
            f"serve watchdog fired: {why}; all in-flight streams failed"))

    def _fail_all(self, exc):
        err = exc if isinstance(exc, MXNetError) else \
            MXNetError(f"serving loop failed: {exc!r}")
        with self._work:
            if self._fatal is None:     # the first cause is the one named
                self._fatal = err
            self._stopping = True
            self._work.notify_all()
        self._inflight.clear()          # readbacks are dropped, not routed
        self._teardown(err)

    # -- cancellation ---------------------------------------------------- #
    def _cancel(self, req):
        """``TokenStream.cancel`` from any thread: a queued request is
        dropped and finished here; an admitted one is only flagged, and
        its slot frees on the scheduler thread at the next step boundary
        (``_process_cancels``).  False once the request retired."""
        with self._work:
            if req.retired or req.stream.done:
                return False
            queued = req in self._pending
            if self.sync_mode and not queued:
                # inside kv_generate there is no step boundary to
                # retire at
                return False
            already = req.cancelled
            req.cancelled = True
            in_queue = False
            if not already and queued:
                self._pending.remove(req)
                in_queue = True
            self._work.notify_all()
        if in_queue:
            self._retire_aside(req, "cancelled")
        return True

    def _process_cancels(self):
        """Free cancelled requests' slots at the step boundary.  The
        device lane is left alone: with its page-table row all trash it
        computes masked until a new admission overwrites it, so the
        retirement costs no dispatch and touches no other stream."""
        with self._lock:
            hit = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.cancelled]
            for i, _ in hit:
                self._slots[i] = None
            if hit:
                self._work.notify_all()
        for i, r in hit:
            self._drop_chunk_record(i)
            self._free_slot_pages(i)
            self._retire_aside(r, "cancelled")
        # queued cancellations drop in _cancel; this sweeps any that
        # raced the pending-pop
        with self._lock:
            stale = [r for r in self._pending if r.cancelled]
            for r in stale:
                self._pending.remove(r)
        for r in stale:
            self._retire_aside(r, "cancelled")
        return bool(hit) or bool(stale)

    def _retire_aside(self, req, reason):
        """Finish a stream outside the drain (cancelled, or past its
        deadline while queued or mid-chunk): it seals with the tokens it
        has and its span closes with ``reason``."""
        req.stream._cancelled = reason == "cancelled"
        req.stream._finish()
        self._observe_retire(req, reason)

    def _teardown(self, err, reason="error"):
        """Release the pool and fail every queued and in-flight request
        with ``err`` (idempotent)."""
        # flag first: a wedged dispatch that completes after this sees
        # it and drops its result instead of pinning the pool again
        self._torn = True
        self._state = None
        if self._progs is not None:
            self._progs.release()
        ACCOUNTANT.drop("serve.kv_pool", self.telemetry_label)
        self._pool_bytes = 0
        if self._pages is not None:
            self._chunking.clear()
            self._chunk_slots.clear()
            for i in range(len(self._slot_pages)):
                self._free_slot_pages(i)
            if self._prefix is not None:
                self._prefix.drop_all()
            self._tele["pages"].set(0)
        with self._lock:
            dropped = list(self._pending)
            self._pending.clear()
            leftover = [r for r in self._slots if r is not None]
            self._slots = [None] * len(self._slots)
            self._work.notify_all()
        for req in dropped + leftover:
            req.stream._finish(err)
            self._observe_retire(req, reason)

    # -- memory budget --------------------------------------------------- #
    def _account_pool(self):
        """Register the pool state's bytes with the process-wide memory
        accountant (``device_bytes{subsystem="serve.kv_pool"}``)."""
        self._pool_bytes = nbytes_of(self._state)
        ACCOUNTANT.set("serve.kv_pool", self.telemetry_label, self._state)

    def _check_budget(self, num_slots, scratch=0, what="", num_pages=None):
        """Refuse an allocation the HBM budget cannot hold, naming
        requested against available bytes: the pool priced at
        ``num_slots`` slots (``num_pages`` pages) plus ``scratch``
        transient bytes."""
        if self.hbm_budget is None:
            return
        projected = pool_state_bytes(self._progs, num_slots,
                                     num_pages=num_pages) + scratch
        if projected <= self.hbm_budget:
            return
        requested = projected - self._pool_bytes
        available = max(self.hbm_budget - self._pool_bytes, 0)
        raise MXNetError(
            f"serve HBM budget exceeded: {what or 'allocation'} "
            f"requests {format_bytes(requested)} on top of the "
            f"{format_bytes(self._pool_bytes)} resident pool, but only "
            f"{format_bytes(available)} of the "
            f"{format_bytes(self.hbm_budget)} budget "
            f"(hbm_budget= / MXNET_SERVE_HBM_BUDGET) remains — raise "
            "the budget, pin smaller MXNET_SERVE_POOL_SIZES / "
            "MXNET_SERVE_ADMIT_SIZES, or lower max_total_len")

    # -- admissions ------------------------------------------------------ #
    def _take_pending(self):
        with self._lock:
            if not self._pending:
                return None
            req = self._pending.popleft()
            self._work.notify_all()
            return req

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
        # priced at the transient peak: the old state stays resident
        # until the grown one holds its copy
        self._check_budget(new_s, scratch=self._pool_bytes,
                           what=f"pool growth {S} -> {new_s} slots",
                           num_pages=new_pages)
        # growth allocates, and the new programs are cold: suspend the
        # watchdog's gauge for the rest of this pump
        self._pump_t0 = None
        # the outgrown pool's programs, state and graphs go (its last
        # dispatch may still run: the allocator reuses their memory in
        # stream order and a graph is destroyed once its replay ends)
        self._retired += self._progs.program_records()
        self._progs = self._pool_programs(new_s, new_pages)
        self._state = pool_state_grow(self._state, new_s, new_pages)
        self._account_pool()
        if new_pages > self._pages.num_pages:
            self._pages.grow(new_pages)
        with self._lock:
            self._slots.extend([None] * (new_s - S))
        self._slot_pages.extend([] for _ in range(new_s - S))
        self._count("pool_grows")

    def _pool_programs(self, S, num_pages):
        return PoolPrograms(self._eng, S, self.T, self.page_size, num_pages,
                            self.eos_id, self.kv_dtype, self._stream,
                            telemetry_label=self.telemetry_label)

    def _slot_spec_depth(self):
        """The speculation-depth cap a slot gets at admission (0: never
        speculate; the device clamps accepted drafts to it)."""
        return self.spec_depth if self.spec_enabled else 0

    def _dl(self, req):
        """The request's deadline as the device holds it: f32 seconds
        since the server's epoch (+inf: none)."""
        return np.float32(np.inf if req.deadline is None
                          else req.deadline - self._epoch)

    def _zero_rows(self, rows):
        """(len(rows), MAXP) int64 rows of the pages whose scales an int8
        pool zeroes in the dispatch, trash-padded; None on a native
        pool."""
        if self.kv_dtype != "int8":
            return None
        progs = self._progs
        z = np.full((len(rows), progs.maxp), progs.sentinel, np.int64)
        for i, row in enumerate(rows):
            z[i, :len(row)] = row
        return self._tensors(z)[0]

    def _admit_limit(self, limit):
        """The wave size the HBM budget lets this pump pop: clamped to the
        largest ``admit_sizes`` bucket whose prefill scratch fits beside
        the resident pool (0: nothing pending); raises when even the
        smallest does not fit."""
        with self._lock:
            limit = min(limit, len(self._pending))
        if not limit:
            return 0
        progs = self._progs
        resident = pool_state_bytes(progs, len(self._slots),
                                    num_pages=self._pages.num_pages)
        usable = [a for a in self.admit_sizes
                  if resident + admit_scratch_bytes(progs, a)
                  <= self.hbm_budget]
        if not usable:
            A = self.admit_sizes[0]
            self._check_budget(
                len(self._slots), scratch=admit_scratch_bytes(progs, A),
                num_pages=self._pages.num_pages,
                what=f"admission wave of {limit} (A={A} prefill scratch)")
        return min(limit, usable[-1])

    def _admit_pending(self):
        """Wave-building admission: pop every pending request the free
        slots can take (at most the largest A bucket a wave, or what the
        HBM budget allows), retire the cancelled and the deadline-lapsed
        ones at once without a slot, plan the rest against the page pool
        and the prefix cache, and dispatch each mode in bulk: the wave's
        hits as ONE no-forward hit admission, its prefills as ONE
        bucketed ``(A, P)`` admission, its long prompts as chunk records
        that ``_pump_chunks`` streams in.  A request the pool cannot
        cover now goes back to the queue front with everything behind it
        (retirements free pages)."""
        admitted = may_retire = False
        self._maybe_grow()
        cap = self.admit_sizes[-1]
        while True:
            free = [i for i, r in enumerate(self._slots)
                    if r is None and i not in self._chunk_slots]
            if not free:
                break
            limit = min(len(free), cap)
            if self.hbm_budget is not None:
                # priced before the pop: a refusal leaves the requests
                # pending and the slots free
                limit = self._admit_limit(limit)
                if not limit:
                    break
            # pop and record into the slot table at once, so close() and
            # teardown never miss a request while its dispatch is built
            wave, dropped = [], []
            now = self._clock()
            with self._lock:
                while self._pending and len(wave) < limit:
                    req = self._pending.popleft()
                    if req.cancelled or (req.deadline is not None
                                         and now >= req.deadline):
                        dropped.append(req)
                        continue
                    slot = free[len(wave)]
                    self._slots[slot] = req
                    wave.append((slot, req))
                if wave or dropped:
                    self._work.notify_all()
            for req in dropped:
                self._retire_aside(req, "cancelled" if req.cancelled
                                   else "deadline_exceeded")
            admitted |= bool(dropped)
            if not wave:
                if dropped:
                    continue        # the backlog behind may fit
                break
            plans, failed = [], None
            for k, (slot, req) in enumerate(wave):
                plan = self._plan_admission(req, slot)
                if plan is None:
                    failed = wave[k:]
                    break
                plans.append(plan)
            if failed is not None:
                with self._lock:
                    for slot, _ in failed:
                        self._slots[slot] = None
                    for _, req in reversed(failed):
                        self._pending.appendleft(req)
            for p in plans:
                if p["mode"] == "chunk":
                    self._chunk_slots.add(p["slot"])
                    self._chunking.append({"req": p["req"],
                                           "slot": p["slot"],
                                           "off": p["off"],
                                           "start": p["off"],
                                           "zero": p["zero"]})
            # hits first: a copy-on-write source page that another plan's
            # eviction freed and reallocated in this wave is copied before
            # any admission or chunk can overwrite it (one stream, FIFO)
            hits = [p for p in plans if p["mode"] == "hit"]
            if hits:
                self._dispatch_hits(hits)
            admits = [(p["slot"], p["req"]) for p in plans
                      if p["mode"] == "admit"]
            if admits:
                self._dispatch_admit(admits)
                may_retire |= any(r.max_new == 1 for _, r in admits)
            admitted |= bool(plans)
            if failed is not None:
                break
        chunked, chunk_retire = self._pump_chunks()
        if may_retire or chunk_retire:
            # a 1-token budget retires inside the admission itself: read
            # it back now so its slot is free before the step decision
            self._drain_kind("admit")
        return admitted or chunked

    def _alloc_pages(self, n, protect=()):
        """All-or-nothing page reservation, evicting least recently used
        prefix-cache pages (never ``protect``) when the free list runs
        dry."""
        got = self._pages.alloc(n)
        if got is None and self._prefix is not None:
            self._prefix.evict(n - self._pages.free_pages, protect=protect)
            got = self._pages.alloc(n)
        return got

    def _free_slot_pages(self, slot):
        """Release one slot's page references (idempotent)."""
        row = self._slot_pages[slot]
        self._slot_pages[slot] = []
        for p in row:
            self._pages.decref(p)

    def _drop_chunk_record(self, slot):
        """Forget a slot mid-chunked-prefill (cancel and deadline
        paths)."""
        if slot in self._chunk_slots:
            self._chunk_slots.discard(slot)
            for rec in list(self._chunking):
                if rec["slot"] == slot:
                    self._chunking.remove(rec)

    def _plan_admission(self, req, slot):
        """How one popped request enters its slot, with all its pages
        ``ceil((L + max_new) / page)`` reserved up front:

        - ``admit``: one bucketed prefill (no cached prefix, the prompt
          within the largest bucket);
        - ``hit``: the prefix cache covers every prompt token but at most
          the last: the shared pages map read-only into the row, no
          prefill, at most one copy-on-write page copy;
        - ``chunk``: the prompt, or its uncached suffix, streams in over
          chunk dispatches.

        Returns ``None`` when the pool cannot supply the pages now."""
        progs = self._progs
        PG = progs.page
        L = int(req.prompt.size)
        need = progs.pages_for(L + req.max_new)
        m, shared = (self._prefix.match(req.prompt)
                     if self._prefix is not None else (0, []))
        if m and m * PG >= L - 1:
            # full hit: the slot enters at pos = L - 1 and its first step
            # writes that position's K/V again.  When the cached pages
            # cover all L tokens that write lands in the last shared page,
            # which is therefore copied first; when they cover L - 1 it
            # lands in the first page the slot owns.
            copy = m * PG == L
            keep = m - 1 if copy else m
            # the whole matched chain is protected, the copy's source too
            owned = self._alloc_pages(need - keep, shared[:m])
            if owned is None:
                return None
            for p in shared[:keep]:
                self._pages.incref(p)
            self._slot_pages[slot] = list(shared[:keep]) + owned
            return {"mode": "hit", "req": req, "slot": slot,
                    "src": shared[m - 1] if copy else -1,
                    "dst": owned[0] if copy else -1, "shared": keep}
        if m == 0 and L <= self.prefill_buckets[-1]:
            owned = self._alloc_pages(need)
            if owned is None:
                return None
            self._slot_pages[slot] = owned
            return {"mode": "admit", "req": req, "slot": slot}
        # chunked prefill; a partial hit maps its cached pages and
        # streams only the rest
        owned = self._alloc_pages(need - m, shared)
        if owned is None:
            return None
        for p in shared:
            self._pages.incref(p)
        self._slot_pages[slot] = list(shared) + owned
        if m:
            self._count("prefix_hits")
            telemetry.emit("prefix_cache_hit", server=self.telemetry_label,
                           request_id=req.stream.request_id,
                           shared_pages=m, cow_copy=False, partial=True)
        return {"mode": "chunk", "req": req, "slot": slot, "off": m * PG,
                "zero": owned}

    def _tensors(self, *arrays):
        dev = self._eng.device
        return [torch.as_tensor(a, device=dev) for a in arrays]

    def _occupancy(self):
        S = len(self._slots)
        return sum(r is not None for r in self._slots) / S if S else 0.0

    def _admitted(self, req, wait, **fields):
        """Open a request's span at its admission: queue wait and the
        admission's buckets."""
        req.span.update(queue_wait_s=wait, **fields)
        self._tele["wait"].observe(wait)

    def _dispatch_admit(self, wave):
        """ONE bucketed (A, P) admission for a wave of (slot, request)."""
        fault_point("serve.admit", server=self.telemetry_label,
                    wave=len(wave))
        progs = self._progs
        A = _bucket_for(self.admit_sizes, len(wave))
        P = _bucket_for(self.prefill_buckets,
                        max(req.prompt.size for _, req in wave))
        self._watch_dispatch(progs.first_use("admit", (A, P)))
        npb = -(-P // progs.page)
        prompts = np.zeros((A, P), np.int64)
        true_len = np.ones((A,), np.int64)     # idle rows read column 0
        stop_pos = np.zeros((A,), np.int64)
        seeds = np.zeros((A,), np.int64)
        spec = np.zeros((A,), np.int64)
        dls = np.full((A,), np.inf, np.float32)
        pages = np.full((A, npb), progs.sentinel, np.int64)
        for i, (slot, req) in enumerate(wave):
            n = req.prompt.size
            prompts[i, :n] = req.prompt
            true_len[i] = n
            stop_pos[i] = n + req.max_new - 1
            seeds[i] = req.seed
            spec[i] = self._slot_spec_depth()
            dls[i] = self._dl(req)
            row = self._slot_pages[slot]
            k = min(npb, len(row))
            pages[i, :k] = row[:k]
        now = time.perf_counter()
        occ = self._occupancy()
        for _, req in wave:
            self._admitted(req, now - req.stream.submit_time,
                           wave=len(wave), a_bucket=A, p_bucket=P,
                           occupancy_at_admit=occ)
            req.stream.admission = {"mode": "admit", "a_bucket": A,
                                    "p_bucket": P}
        telemetry.emit("serve_admit", server=self.telemetry_label,
                       wave=len(wave), a_bucket=A, p_bucket=P,
                       pool=len(self._slots), occupancy=round(occ, 4))
        prompts, true_len, stop_pos, seeds, pages, spec, dls = \
            self._tensors(prompts, true_len, stop_pos, seeds, pages, spec,
                          dls)
        # every page the wave reserved, decode frontier included
        zpages = self._zero_rows([self._slot_pages[s] for s, _ in wave])
        with telemetry.annotation("mx:serve:admit"):
            first, done = progs.admit(self._state, prompts, true_len,
                                      [s for s, _ in wave], stop_pos, seeds,
                                      pages, spec, zpages, dls)
        if self._torn:
            # the watchdog tore the server down meanwhile: drop the
            # result instead of pinning the released pool
            self._state = None
            return
        self._count("admit_dispatches")
        self._inflight.append(("admit", _Readback([first, done]),
                               list(wave)))
        if self._prefix is not None:
            # index the wave's full prompt pages for later hits (any
            # reader is a later dispatch on the same stream)
            for slot, req in wave:
                self._prefix.register(req.prompt, req.prompt.size,
                                      self._slot_pages[slot])

    def _dispatch_hits(self, hits):
        """ONE admission of a wave of prefix-cache hits: copy-on-write
        page copies and slot state, no model forward; each request's
        first token arrives from the next step."""
        progs = self._progs
        A = _bucket_for(self.admit_sizes, len(hits))
        self._watch_dispatch(progs.first_use("hit", A))
        true_len = np.ones((A,), np.int64)
        last_tok = np.zeros((A,), np.int64)
        stop_pos = np.zeros((A,), np.int64)
        seeds = np.zeros((A,), np.int64)
        spec = np.zeros((A,), np.int64)
        dls = np.full((A,), np.inf, np.float32)
        src = np.full((A,), progs.sentinel, np.int64)
        dst = np.full((A,), progs.sentinel, np.int64)
        now = time.perf_counter()
        occ = self._occupancy()
        for i, plan in enumerate(hits):
            req = plan["req"]
            L = req.prompt.size
            true_len[i] = L
            last_tok[i] = req.prompt[-1]
            stop_pos[i] = L + req.max_new - 1
            seeds[i] = req.seed
            spec[i] = self._slot_spec_depth()
            dls[i] = self._dl(req)
            if plan["src"] >= 0:
                src[i], dst[i] = plan["src"], plan["dst"]
                self._count("cow_copies")
            self._count("prefix_hits")
            self._admitted(req, now - req.stream.submit_time,
                           wave=len(hits), a_bucket=A, p_bucket=0,
                           occupancy_at_admit=occ)
            req.stream.admission = {"mode": "hit", "a_bucket": A,
                                    "cow_copy": bool(plan["src"] >= 0)}
            telemetry.emit("prefix_cache_hit", server=self.telemetry_label,
                           request_id=req.stream.request_id,
                           shared_pages=plan["shared"],
                           cow_copy=plan["src"] >= 0, partial=False)
        # each row's freshly owned pages (decode frontier and the copy's
        # destination); the shared prefix keeps its scales
        zpages = self._zero_rows([self._slot_pages[p["slot"]][p["shared"]:]
                                  for p in hits])
        true_len, last_tok, stop_pos, seeds, src, dst, spec, dls = \
            self._tensors(true_len, last_tok, stop_pos, seeds, src, dst,
                          spec, dls)
        with telemetry.annotation("mx:serve:admit_hit"):
            progs.admit_hit(self._state, [p["slot"] for p in hits],
                            true_len, last_tok, stop_pos, seeds, src, dst,
                            spec, zpages, dls)
        if self._torn:
            self._state = None

    def _pump_chunks(self):
        """Advance every mid-prefill request by ONE chunk, interleaved
        with the steps so that resident sequences keep streaming while a
        long prompt fills in; a cancelled or deadline-lapsed one retires
        instead.  Returns ``(worked, may_retire)``, the latter when a
        final chunk could retire its request itself."""
        worked = may_retire = False
        for rec in list(self._chunking):
            req, slot = rec["req"], rec["slot"]
            if req.cancelled or (req.deadline is not None
                                 and self._clock() >= req.deadline):
                self._drop_chunk_record(slot)
                with self._lock:
                    if self._slots[slot] is req:
                        self._slots[slot] = None
                self._free_slot_pages(slot)
                self._retire_aside(req, "cancelled" if req.cancelled
                                   else "deadline_exceeded")
                worked = True
                continue
            final = self._dispatch_chunk(rec)
            worked = True
            if final:
                self._drop_chunk_record(slot)
                may_retire |= req.max_new == 1
        return worked, may_retire

    def _dispatch_chunk(self, rec):
        """ONE slice of a streaming prefill, up to the largest bucket of
        tokens at the record's offset through the slot's page-table row.
        The final slice samples the first token and activates the slot;
        its readback takes the admissions' path.  Returns whether this
        was the final slice."""
        req, slot, off = rec["req"], rec["slot"], rec["off"]
        fault_point("serve.chunk", server=self.telemetry_label)
        L = int(req.prompt.size)
        remaining = L - off
        top = self.prefill_buckets[-1]
        if remaining > top:
            C, final, ntok = top, False, top
        else:
            C = _bucket_for(self.prefill_buckets, remaining)
            final, ntok = True, remaining
        progs = self._progs
        self._watch_dispatch(progs.first_use("chunk", C))
        toks = np.zeros((C,), np.int64)
        toks[:ntok] = req.prompt[off:off + ntok]
        ptrow = np.full((progs.maxp,), progs.sentinel, np.int64)
        row = self._slot_pages[slot]
        ptrow[:len(row)] = row
        toks, ptrow = self._tensors(toks, ptrow)
        # the slot's fresh pages, at its first chunk only: later chunks
        # keep the scales the earlier ones raised
        zero = rec.pop("zero", None)
        zrow = self._zero_rows([zero]) if zero else None
        with telemetry.annotation("mx:serve:chunk"):
            first, done = progs.chunk(
                self._state, toks, ptrow, off,
                (L - 1 - off) if final else C - 1, final, slot, L,
                L + req.max_new - 1, req.seed, self._slot_spec_depth(),
                None if zrow is None else zrow[0], float(self._dl(req)))
        if self._torn:
            self._state = None
            return True
        self._count("chunk_dispatches")
        rec["off"] = off + ntok
        telemetry.emit("serve_chunk", server=self.telemetry_label,
                       request_id=req.stream.request_id, slot=slot,
                       c_bucket=C, offset=off, final=final)
        if final:
            self._admitted(req, time.perf_counter() - req.stream.submit_time,
                           wave=1, a_bucket=1, p_bucket=C)
            req.stream.admission = {"mode": "chunk", "c_bucket": C,
                                    "offset": rec["start"]}
            if self._prefix is not None:
                self._prefix.register(req.prompt, L, row)
            self._inflight.append(("admit", _Readback([first, done]),
                                   [(slot, req)]))
        return final

    def _page_table(self):
        """The step's (S, MAXP) page table, trash-padded.  Slots
        mid-chunked-prefill get all-trash rows: their masked lanes must
        not write into the pages the chunks are filling."""
        progs = self._progs
        pt = np.full((len(self._slots), progs.maxp), progs.sentinel,
                     np.int64)
        for i, row in enumerate(self._slot_pages):
            if row and self._slots[i] is not None and \
                    i not in self._chunk_slots:
                pt[i, :len(row)] = row
        return pt

    def _now(self):
        """The step's clock: f32 seconds since the server's epoch."""
        return np.float32(self._clock() - self._epoch)

    def _stepped(self, kind, out, meta):
        """Account one step or verify dispatch and queue its readback."""
        S = len(self._slots)
        busy = sum(r is not None for r in self._slots)
        self._occupied_lane_steps += busy
        self._capacity_lane_steps += S
        self._tele["occ"].set(busy / S)
        self._tele["pages"].set(self._pages.in_use)
        self._inflight.append((kind, _Readback(list(out)), meta))

    def _dispatch_step(self):
        fault_point("serve.step", server=self.telemetry_label)
        if self._torn:
            return
        self._watch_dispatch(self._progs.cold())
        with telemetry.annotation("mx:serve:step"):
            out = self._progs.step(self._state, self._page_table(),
                                   self._now())
        if self._torn:
            # a wedged dispatch that completed after the watchdog tore
            # the server down: do not pin the released pool again
            self._state = None
            return
        self._count("step_dispatches")
        self._steps += 1
        self._stepped("step", out, list(self._slots))

    # -- speculative decoding -------------------------------------------- #
    def _build_drafts(self):
        """The drafter's proposals for this pump, ``{slot: 1-D int64
        drafts}``, or None when no slot proposed (the pump then takes a
        plain step).  Drafts chain off the last token routed to each
        stream, so a just-admitted slot (a hit too, whose first step
        recomputes its last prompt position) proposes nothing until its
        first token has drained."""
        drafts = {}
        for slot, req in enumerate(self._slots):
            if req is None or req.cancelled or slot in self._chunk_slots:
                continue
            toks = req.stream._toks
            if not toks:
                continue
            # a verify emits up to k + 1 tokens: never past the budget
            k = min(self.spec_depth, req.max_new - len(toks) - 1)
            if k < 1:
                continue
            hist = np.concatenate([req.prompt, np.asarray(toks, np.int64)])
            prop = self._drafter.propose(hist, k)
            if prop is not None and len(prop):
                drafts[slot] = np.asarray(prop, np.int64).reshape(-1)[:k]
        return drafts or None

    def _dispatch_verify(self, drafts):
        """ONE verify dispatch at the smallest ``spec_sizes`` bucket that
        fits the longest draft; a slot without drafts takes a plain step
        through column 0.  A rejected tail needs no undo: its columns lie
        past the slot's advanced position, and its pages were reserved
        at admission."""
        fault_point("serve.verify", server=self.telemetry_label)
        if self._torn:
            return
        k = _bucket_for(self.spec_sizes, max(d.size for d in drafts.values()))
        self._watch_dispatch(self._progs.cold(k))
        S = len(self._slots)
        block = np.zeros((S, k), np.int64)
        nd = np.zeros((S,), np.int64)
        for slot, d in drafts.items():
            nd[slot] = d.size
            block[slot, :d.size] = d
        with telemetry.annotation("mx:serve:verify"):
            out = self._progs.verify(self._state, self._page_table(), block,
                                     nd, k, self._now())
        if self._torn:
            self._state = None
            return
        self._count("verify_dispatches")
        self._stepped("verify", out, (list(self._slots), nd, k))

    def _route_verify(self, readback, meta):
        """Route one verify's ``(out (S, K), adv (S,), done (S,))``: every
        live lane emits ``adv`` tokens (its accepted drafts, then the
        model's own next token), and the draft ledgers move by what each
        lane's proposals came to, so accepted + rejected == proposed per
        stream and per server."""
        toks, adv, done = readback.get()
        snapshot, nd, k = meta
        ledger = dict.fromkeys(("draft_proposed", "draft_accepted",
                                "draft_rejected"), 0)
        for slot, req in enumerate(snapshot):
            if req is None or req.cancelled:
                continue
            n = int(adv[slot])
            if n < 1:
                continue                    # an inactive lane
            for t in toks[slot, :n]:
                req.stream._push(int(t))
            proposed = int(nd[slot])
            if proposed:
                req.stream.draft_accepted += n - 1
                req.stream.draft_rejected += proposed - (n - 1)
                ledger["draft_proposed"] += proposed
                ledger["draft_accepted"] += n - 1
                ledger["draft_rejected"] += proposed - (n - 1)
            if done[slot]:
                self._retire(slot, req, int(toks[slot, n - 1]))
        if ledger["draft_proposed"]:
            for key, v in ledger.items():
                self._count(key, v)
        telemetry.emit("serve_spec", server=self.telemetry_label,
                       k_bucket=k, proposed=ledger["draft_proposed"],
                       accepted=ledger["draft_accepted"],
                       rejected=ledger["draft_rejected"])

    # -- drain ----------------------------------------------------------- #
    def _retire(self, slot, req, last_tok):
        """A request the device retired: finish its stream, close its
        span and free its slot (only if the slot still holds it)."""
        req.stream._finish()
        self._observe_retire(req, self._retire_reason(req, last_tok))
        freed = False
        with self._lock:
            if self._slots[slot] is req:
                self._slots[slot] = None
                freed = True
            self._work.notify_all()
        if freed:
            self._free_slot_pages(slot)

    def _route(self, kind, readback, meta):
        """Route one readback; a cancelled request's lane is void (its
        stream was sealed when the cancel took effect)."""
        if kind == "verify":
            self._route_verify(readback, meta)
            return
        if kind == "admit":
            first, done = readback.get()
            for i, (slot, req) in enumerate(meta):
                if req.cancelled:
                    continue
                tok = int(first[i])
                req.stream._push(tok)
                if done[i]:
                    self._retire(slot, req, tok)
            return
        toks, emitted, done = readback.get()
        for slot, req in enumerate(meta):
            if req is None or req.cancelled or not emitted[slot]:
                continue
            tok = int(toks[slot])
            req.stream._push(tok)
            if done[slot]:
                self._retire(slot, req, tok)

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

    # -- request spans --------------------------------------------------- #
    def _retire_reason(self, req, last_tok):
        """Which of EOS, the budget and the deadline retired a request the
        device retired (EOS wins on the same token; a full budget is
        ``max_len`` whether or not a deadline was also set)."""
        if self.eos_id is not None and last_tok == self.eos_id:
            return "eos"
        if len(req.stream._toks) >= req.max_new:
            return "max_len"
        if req.deadline is not None:
            return "deadline_exceeded"
        return "max_len"

    def _observe_retire(self, req, reason):
        """Close a request's span, once: TTFT and token-gap observations,
        ``serve_requests_total{reason=}``, one ``serve_request`` event,
        and the ``deadline_exceeded`` / ``request_cancelled`` events."""
        if req.retired:
            return
        req.retired = True
        st, sp, label = req.stream, req.span, self.telemetry_label
        st.reason = reason
        if reason == "deadline_exceeded":
            telemetry.emit("deadline_exceeded", server=label,
                           request_id=st.request_id, tokens=len(st._toks),
                           max_new=req.max_new)
        elif reason == "cancelled":
            telemetry.emit("request_cancelled", server=label,
                           request_id=st.request_id, tokens=len(st._toks))
        ttft = st.ttft
        if ttft is not None:
            self._tele["ttft"].observe(ttft)
        times = st.times
        for a, b in zip(times, times[1:]):
            self._tele["gap"].observe(b - a)
        telemetry.counter("serve_requests_total", server=label,
                          reason=reason).inc()
        telemetry.emit(
            "serve_request", server=label, request_id=st.request_id,
            reason=reason, tokens=len(times),
            ttft_s=None if ttft is None else round(ttft, 6),
            queue_wait_s=None if "queue_wait_s" not in sp
            else round(sp["queue_wait_s"], 6),
            wave=sp.get("wave"), a_bucket=sp.get("a_bucket"),
            p_bucket=sp.get("p_bucket"),
            occupancy_at_admit=sp.get("occupancy_at_admit"),
            draft_accepted=st.draft_accepted,
            draft_rejected=st.draft_rejected)

    # -- sync mode ------------------------------------------------------- #
    def _pump_sync(self):
        """Serve the next queued request through one
        ``models.kv_generate`` call on the model's device."""
        from ..models import decoding

        req = self._take_pending()
        if req is None:
            return False
        if req.cancelled:
            self._retire_aside(req, "cancelled")
            return True
        if req.deadline is not None and self._clock() >= req.deadline:
            # inside kv_generate there is no step boundary to retire at:
            # this check is the whole deadline story of sync mode
            self._retire_aside(req, "deadline_exceeded")
            return True
        self._count("sync_requests")
        wait = time.perf_counter() - req.stream.submit_time
        req.span["queue_wait_s"] = wait
        self._tele["wait"].observe(wait)
        try:
            out = decoding.kv_generate(
                self.model, req.prompt[None], max_new_tokens=req.max_new,
                temperature=self.temperature, top_k=self.top_k,
                seed=req.seed, weights=self.weights)
            last = None
            for t in out[0, req.prompt.size:]:
                last = int(t)
                req.stream._push(last)
                if self.eos_id is not None and last == self.eos_id:
                    break
            req.stream._finish()
            self._observe_retire(req, "max_len" if last is None
                                 else self._retire_reason(req, last))
        except Exception as e:                 # surface, don't hang
            req.stream._finish(e)
            self._observe_retire(req, "error")
        return True
