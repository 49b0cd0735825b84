"""Continuous-batching decode server for the GPT and Llama families.

Port of ``mxnet_tpu/serve/server.py``: callers ``submit()`` ragged
requests at any time and new sequences join the running pool at step
boundaries.  One ``pump()`` is one step boundary:

1. **admit** — every pending request the free slots can take is popped
   into one wave and planned against the page pool and the prefix cache
   (``_plan_admission``), reserving all its pages up front:
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
   slots are freed, while the card computes the newest step.

EOS (``eos_id``) and ``max_new_tokens`` retirement are computed on the
device by the step itself.  The prefix cache (``_PrefixIndex``) is on
unless ``prefix_cache=False`` or ``MXNET_SERVE_PREFIX_CACHE=0``.
``kv_dtype="int8"`` (or ``MXNET_SERVE_KV_DTYPE=int8``) stores the pages
as int8 codes with one f32 scale a (layer, page, head): half a bf16
pool, and the reference's one lossy serving mode (PARITY.md).

Not in this slice (each enabling argument raises ``MXNetError`` naming
it): deadlines, cancellation and the watchdog, telemetry, the HBM
budget, and the synchronous ``kv_generate`` fallback
(``MXNET_SERVE_SYNC``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import MXNetError
from ..models.decoding import _DecodeEngine
from .draft import NGramDrafter
from .engine import PagePool, PoolPrograms, pool_state_grow, pool_state_init

__all__ = ["DecodeServer", "TokenStream"]

_LATER_SLICE = {
    "hbm_budget": "the HBM budget",
    "default_deadline": "deadlines", "step_timeout": "the watchdog",
}


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
    try:
        sizes = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        raise MXNetError(f"MXNET_SERVE_SPEC_SIZES={raw!r}: expected a "
                         "comma-separated list of draft depths")
    if not sizes or sizes[0] < 1:
        raise MXNetError(f"MXNET_SERVE_SPEC_SIZES={raw!r}: draft depths "
                         "must be positive")
    return tuple(sizes)


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
    :attr:`accept_rate`."""

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

    @property
    def ttft(self):
        return self.times[0] - self.submit_time if self.times else None

    @property
    def done(self):
        return self._done.is_set()

    @property
    def accept_rate(self):
        """Share of this request's proposed draft tokens that were
        accepted (0.0 while none was proposed)."""
        total = self.draft_accepted + self.draft_rejected
        return self.draft_accepted / total if total else 0.0

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
    calls :meth:`pump`.  ``prefix_cache`` (default: on, unless
    ``MXNET_SERVE_PREFIX_CACHE=0``) shares identical full prompt pages
    between requests, copy-on-write.  A prompt longer than the largest of
    ``prefill_buckets`` streams in chunk by chunk; the one length limit
    is the pool cache length ``max_total_len``.

    ``kv_dtype`` ("native" or "int8"; default ``MXNET_SERVE_KV_DTYPE``)
    is the pages' storage.  Speculation (``spec``, default
    ``MXNET_SERVE_SPEC``: on) runs on greedy servers only: a slot drafts
    at most ``spec_depth`` tokens (default ``MXNET_SERVE_SPEC_DEPTH``,
    4; clamped to the largest bucket), ``spec_sizes`` (default
    ``MXNET_SERVE_SPEC_SIZES``: powers of two up to the depth) are the
    verify program's k buckets, and ``drafter`` is a
    ``serve.draft.Drafter`` (default ``NGramDrafter()``).
    """

    def __init__(self, model, *, max_total_len=None, pool_sizes=(1, 2, 4, 8),
                 temperature=0.0, top_k=0, eos_id=None, weights="native",
                 max_pending=256, detokenize=None, admit_sizes=None,
                 prefill_buckets=None, page_size=16, num_pages=None,
                 kv_dtype=None, prefix_cache=None, spec=None,
                 spec_depth=None, spec_sizes=None, drafter=None,
                 autostart=True, **later):
        for name, val in later.items():
            if name not in _LATER_SLICE:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if val not in (None, False, 0):
                raise MXNetError(f"DecodeServer({name}={val!r}): "
                                 f"{_LATER_SLICE[name]} is not ported yet "
                                 "(a later slice of mxnet_tpu_torch.serve)")
        self.kv_dtype = str(kv_dtype).lower() if kv_dtype is not None \
            else _kv_dtype_from_env()
        if self.kv_dtype in ("f32", "float32", "bf16", "bfloat16"):
            self.kv_dtype = "native"
        if self.kv_dtype not in ("native", "int8"):
            raise MXNetError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {kv_dtype!r}")
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
        # one side stream for every program the server captures
        self._stream = torch.cuda.Stream(self._eng.device) \
            if self._eng.device.type == "cuda" else None
        self._progs = self._pool_programs(self.pool_sizes[0], num_pages)
        self._state = pool_state_init(self._progs)
        self._pages = PagePool(self._progs.num_pages)
        self.prefix_cache_enabled = bool(prefix_cache) \
            if prefix_cache is not None else _prefix_cache_from_env()
        # slots mid-chunked-prefill (kept out of the steps and of the
        # free slots until their final chunk), their chunk records, and
        # the copy-on-write prefix index
        self._chunk_slots = set()
        self._chunking = deque()    # {"req", "slot", "off", "start"}
        self._prefix = _PrefixIndex(self._progs.page, self._pages) \
            if self.prefix_cache_enabled else None
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
                         "chunk_dispatches": 0, "prefix_hits": 0,
                         "cow_copies": 0, "pool_grows": 0,
                         "verify_dispatches": 0, "draft_proposed": 0,
                         "draft_accepted": 0, "draft_rejected": 0}
        self._retired = []      # program_records() of each outgrown pool
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
        """Scheduler / occupancy / page-pool / draft-ledger snapshot."""
        acc = self.counters["draft_accepted"]
        rej = self.counters["draft_rejected"]
        return {
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
            "page_size": self._progs.page,
            "pages_total": self._pages.num_pages,
            "pages_in_use": self._pages.in_use,
            "prefix_nodes": 0 if self._prefix is None else len(self._prefix),
            "kv_dtype": self.kv_dtype,
            "page_bytes": self._progs.page_bytes(),
            "pool_bytes": (self._pages.num_pages + 1) *
            self._progs.page_bytes(),
            "counters": dict(self.counters),
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
        self._teardown(MXNetError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler ------------------------------------------------------- #
    def pump(self):
        """One scheduler round: admissions, one step or verify, drain.
        Returns True if any work happened."""
        worked = self._admit_pending()
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
        self._chunking.clear()
        self._chunk_slots.clear()
        if self._prefix is not None:
            self._prefix.drop_all()
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
        # the outgrown pool's programs, state and graphs go (its last
        # dispatch may still run: the allocator reuses their memory in
        # stream order and a graph is destroyed once its replay ends)
        self._retired += self._progs.program_records()
        self._progs = self._pool_programs(new_s, new_pages)
        self._state = pool_state_grow(self._state, new_s, new_pages)
        if new_pages > self._pages.num_pages:
            self._pages.grow(new_pages)
        with self._lock:
            self._slots.extend([None] * (new_s - S))
        self._slot_pages.extend([] for _ in range(new_s - S))
        self.counters["pool_grows"] += 1

    def _pool_programs(self, S, num_pages):
        return PoolPrograms(self._eng, S, self.T, self.page_size, num_pages,
                            self.eos_id, self.kv_dtype, self._stream)

    def _slot_spec_depth(self):
        """The speculation-depth cap a slot gets at admission (0: never
        speculate; the device clamps accepted drafts to it)."""
        return self.spec_depth if self.spec_enabled else 0

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

    def _admit_pending(self):
        """Wave-building admission: pop every pending request the free
        slots can take (at most the largest A bucket a wave), plan each
        against the page pool and the prefix cache, and dispatch each
        mode in bulk: the wave's hits as ONE no-forward hit admission,
        its prefills as ONE bucketed ``(A, P)`` admission, its long
        prompts as chunk records that ``_pump_chunks`` streams in.  A
        request the pool cannot cover now goes back to the queue front
        with everything behind it (retirements free pages)."""
        admitted = may_retire = False
        self._maybe_grow()
        cap = self.admit_sizes[-1]
        while True:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                break
            # pop and record into the slot table at once, so close() and
            # teardown never miss a request while its dispatch is built
            wave = []
            with self._lock:
                while self._pending and len(wave) < min(len(free), cap):
                    req = self._pending.popleft()
                    slot = free[len(wave)]
                    self._slots[slot] = req
                    wave.append((slot, req))
                if wave:
                    self._work.notify_all()
            if not wave:
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
            self.counters["prefix_hits"] += 1
        return {"mode": "chunk", "req": req, "slot": slot, "off": m * PG,
                "zero": owned}

    def _tensors(self, *arrays):
        dev = self._eng.device
        return [torch.as_tensor(a, device=dev) for a in arrays]

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
        spec = np.zeros((A,), np.int64)
        pages = np.full((A, npb), progs.sentinel, np.int64)
        for i, (slot, req) in enumerate(wave):
            n = req.prompt.size
            prompts[i, :n] = req.prompt
            true_len[i] = n
            stop_pos[i] = n + req.max_new - 1
            seeds[i] = req.seed
            spec[i] = self._slot_spec_depth()
            row = self._slot_pages[slot]
            k = min(npb, len(row))
            pages[i, :k] = row[:k]
        prompts, true_len, stop_pos, seeds, pages, spec = self._tensors(
            prompts, true_len, stop_pos, seeds, pages, spec)
        # every page the wave reserved, decode frontier included
        zpages = self._zero_rows([self._slot_pages[s] for s, _ in wave])
        first, done = progs.admit(self._state, prompts, true_len,
                                  [s for s, _ in wave], stop_pos, seeds,
                                  pages, spec, zpages)
        self.counters["admit_dispatches"] += 1
        for _, req in wave:
            req.stream.admission = {"mode": "admit", "a_bucket": A,
                                    "p_bucket": P}
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
        true_len = np.ones((A,), np.int64)
        last_tok = np.zeros((A,), np.int64)
        stop_pos = np.zeros((A,), np.int64)
        seeds = np.zeros((A,), np.int64)
        spec = np.zeros((A,), np.int64)
        src = np.full((A,), progs.sentinel, np.int64)
        dst = np.full((A,), progs.sentinel, np.int64)
        for i, plan in enumerate(hits):
            req = plan["req"]
            L = req.prompt.size
            true_len[i] = L
            last_tok[i] = req.prompt[-1]
            stop_pos[i] = L + req.max_new - 1
            seeds[i] = req.seed
            spec[i] = self._slot_spec_depth()
            if plan["src"] >= 0:
                src[i], dst[i] = plan["src"], plan["dst"]
                self.counters["cow_copies"] += 1
            self.counters["prefix_hits"] += 1
            req.stream.admission = {"mode": "hit", "a_bucket": A,
                                    "cow_copy": bool(plan["src"] >= 0)}
        # each row's freshly owned pages (decode frontier and the copy's
        # destination); the shared prefix keeps its scales
        zpages = self._zero_rows([self._slot_pages[p["slot"]][p["shared"]:]
                                  for p in hits])
        progs.admit_hit(self._state, [p["slot"] for p in hits],
                        *self._tensors(true_len, last_tok, stop_pos, seeds,
                                       src, dst, spec), zpages)

    def _pump_chunks(self):
        """Advance every mid-prefill request by ONE chunk, interleaved
        with the steps so that resident sequences keep streaming while a
        long prompt fills in.  Returns ``(worked, may_retire)``, the
        latter when a final chunk could retire its request itself."""
        worked = may_retire = False
        for rec in list(self._chunking):
            final = self._dispatch_chunk(rec)
            worked = True
            if final:
                self._chunk_slots.discard(rec["slot"])
                self._chunking.remove(rec)
                may_retire |= rec["req"].max_new == 1
        return worked, may_retire

    def _dispatch_chunk(self, rec):
        """ONE slice of a streaming prefill, up to the largest bucket of
        tokens at the record's offset through the slot's page-table row.
        The final slice samples the first token and activates the slot;
        its readback takes the admissions' path.  Returns whether this
        was the final slice."""
        req, slot, off = rec["req"], rec["slot"], rec["off"]
        L = int(req.prompt.size)
        remaining = L - off
        top = self.prefill_buckets[-1]
        if remaining > top:
            C, final, ntok = top, False, top
        else:
            C = _bucket_for(self.prefill_buckets, remaining)
            final, ntok = True, remaining
        progs = self._progs
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
        first, done = progs.chunk(
            self._state, toks, ptrow, off,
            (L - 1 - off) if final else C - 1, final, slot, L,
            L + req.max_new - 1, req.seed, self._slot_spec_depth(),
            None if zrow is None else zrow[0])
        self.counters["chunk_dispatches"] += 1
        rec["off"] = off + ntok
        if final:
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

    def _dispatch_step(self):
        out = self._progs.step(self._state, self._page_table())
        self.counters["step_dispatches"] += 1
        self._steps += 1
        self._occupied_lane_steps += sum(r is not None for r in self._slots)
        self._capacity_lane_steps += len(self._slots)
        self._inflight.append(("step", _Readback(list(out)),
                               list(self._slots)))

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
            if req is None or slot in self._chunk_slots:
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
        past the slot's advanced position, and its pages were reserved at
        admission."""
        k = _bucket_for(self.spec_sizes, max(d.size for d in drafts.values()))
        S = len(self._slots)
        block = np.zeros((S, k), np.int64)
        nd = np.zeros((S,), np.int64)
        for slot, d in drafts.items():
            nd[slot] = d.size
            block[slot, :d.size] = d
        out = self._progs.verify(self._state, self._page_table(), block, nd,
                                 k)
        self.counters["verify_dispatches"] += 1
        self._occupied_lane_steps += sum(r is not None for r in self._slots)
        self._capacity_lane_steps += S
        self._inflight.append(("verify", _Readback(list(out)),
                               (list(self._slots), nd)))

    def _route_verify(self, readback, meta):
        """Route one verify's ``(out (S, K), adv (S,), done (S,))``: every
        live lane emits ``adv`` tokens (its accepted drafts, then the
        model's own next token), and the draft ledgers move by what each
        lane's proposals came to, so accepted + rejected == proposed per
        stream and per server."""
        toks, adv, done = readback.get()
        snapshot, nd = meta
        ledger = dict.fromkeys(("draft_proposed", "draft_accepted",
                                "draft_rejected"), 0)
        for slot, req in enumerate(snapshot):
            n = int(adv[slot])
            if req is None or n < 1:
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
                self._retire(slot, req)
        for key, v in ledger.items():
            self.counters[key] += v

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
        if kind == "verify":
            self._route_verify(readback, meta)
            return
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
