"""Paged slot-pool decode programs — the device side of the
continuous-batching server (``serve/server.py``).

Port of ``mxnet_tpu/serve/engine.py``.  The resident K/V store is a page
pool ``(NL, NPAGES + 1, H, PAGE, D)`` shared by all in-flight sequences
and addressed through per-slot page tables; with ``kv_dtype="int8"``
each of K and V is a ``(codes, scales)`` pair, int8 codes of that shape
and one f32 scale a (layer, page, head), ``(NL, NPAGES + 1, H)``.  Page
``NPAGES`` is the trash page that stands for the reference's
one-past-the-end sentinel (see ``models/decoding.py``): idle and retired
slots carry all-trash rows, so their masked lanes can never write into a
page they do not own.  On an int8 pool every page an admission, hit or
first chunk reserves has its scales zeroed in that same dispatch (the
``zpages``/``zrow`` operands): a recycled page's old scale would
otherwise floor its new tenant's first requantization.

Per pool size ``S`` there are five units of work:

- ``PoolPrograms.step`` — every slot advances one token
  (``_DecodeEngine.paged_step``), samples, and the retirement flags are
  computed on the device: EOS, the stop position and the slot's
  wall-clock deadline (``dl``, server-epoch seconds) against the step's
  ``now`` operand, all in one ``done`` mask.  It is ONE program
  (``gluon.block._GraphProgram``): on the card a CUDA-graph replay a
  step, captured once a pool size, the counterpart of the reference's
  one executable a pool size.  Its operands are static: the slot state, updated in place, an
  (S, MAXP) page table and the one-element f32 clock ``now``, both
  copied in from pinned memory before each call;
- ``PoolPrograms.admit`` — one causal prefill over an ``(A, P)`` block of
  right-padded prompts, scattered into the admitted slots' reserved
  pages, first tokens sampled at each row's own last prompt token;
- ``PoolPrograms.admit_hit`` — a prefix-cache hit: no model forward, at
  most one copy-on-write page copy a row, and the slot enters at ``pos =
  L - 1`` so that the next step recomputes the last prompt position;
- ``PoolPrograms.chunk`` — one slice of a long prompt (or of a partial
  hit's suffix) through the slot's page-table row
  (``_DecodeEngine.chunk_tokens``); only the final slice activates the
  slot;
- ``PoolPrograms.verify`` — speculative draft-and-verify (greedy only):
  every slot scores its last token and up to ``k`` drafts in one pass
  (``_DecodeEngine.pool_verify_paged``) and accepts its longest matching
  prefix on the device; one ``_GraphProgram`` per k bucket, captured as
  the step's is.

Every program of one ``PoolPrograms`` warms up and captures on the one
side stream it is given (a server passes its own to every pool size),
so K4's scratch, kept per (shape, stream), is made once per shape.  The
step and verify programs are watched by the telemetry capture watch
(sites ``serve.step`` and ``serve.verify``).  The state layout and the
operands are declared in ``serve/schema.py``; ``pool_state_bytes`` and
``admit_scratch_bytes`` price a pool and an admission wave from it.

``PagePool`` is the host-side free-list allocator with refcounts: the
prefix cache maps one page into many slots' tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..gluon.block import _GraphProgram
from ..models.decoding import (_KV_CODE_DTYPE, _KV_SCALE_DTYPE, _kv_requant,
                               _zero_trash, decode_mode)
from . import schema
from .schema import kv_page_int8_bytes

__all__ = ["PagePool", "PoolPrograms", "pool_state_init", "pool_state_grow",
           "pool_state_bytes", "admit_scratch_bytes", "kv_page_int8_bytes"]


class PagePool:
    """Host-side page allocator with refcounts (LIFO free list).  Pages
    are ints in ``[0, num_pages)``."""

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref = {}

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def in_use(self):
        return self.num_pages - len(self._free)

    def alloc(self, n):
        """``n`` fresh pages at refcount 1, or ``None`` (nothing allocated)
        when the pool cannot cover the request."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def incref(self, page):
        self._ref[page] += 1

    def decref(self, page):
        r = self._ref[page] - 1
        if r:
            self._ref[page] = r
        else:
            del self._ref[page]
            self._free.append(page)

    def grow(self, new_num):
        if new_num < self.num_pages:
            raise MXNetError(f"page pool can only grow: "
                             f"{self.num_pages} -> {new_num}")
        self._free.extend(range(new_num - 1, self.num_pages - 1, -1))
        self.num_pages = int(new_num)


_SLOT_FIELDS = tuple(n for n, _, _ in schema.SLOT_STATE)
_SLOT_DTYPES = {n: getattr(torch, dt) for n, dt, _ in schema.SLOT_STATE}
_SLOT_FILL = {"dl": float("inf")}          # +inf: no deadline


def _pool_arrays(pool):
    """The arrays of one pool: ``(pool,)``, or an int8 pool's codes and
    scales."""
    return pool if isinstance(pool, tuple) else (pool,)


def pool_state_init(progs):
    """Fresh all-idle pool state for ``progs``: a dict of the two page
    pools (trash page included; ``(codes, scales)`` pairs on an int8
    pool) and the per-slot vectors of ``schema.SLOT_STATE``: ``pos``
    (next write index), ``tok`` (last token), ``active``, ``stop``
    (retire position), ``seed``, ``dl`` (deadline, +inf: none) and
    ``spec`` (the slot's speculation-depth cap, 0: never)."""
    e, S = progs.eng, progs.S
    shape = (e.NL, progs.num_pages + 1, e.KV, progs.page, e.D)
    dev = e.device
    state = {}
    for name in ("kp", "vp"):
        if progs.quant_kv:
            state[name] = (
                torch.zeros(shape, dtype=_KV_CODE_DTYPE, device=dev),
                torch.zeros(shape[:3], dtype=_KV_SCALE_DTYPE, device=dev))
        else:
            state[name] = torch.zeros(shape, dtype=e.cdtype, device=dev)
    for name in _SLOT_FIELDS:
        state[name] = torch.full((S,), _SLOT_FILL.get(name, 0),
                                 dtype=_SLOT_DTYPES[name], device=dev)
    return state


def pool_state_grow(state, new_s, new_pages):
    """Pad the slot vectors up to ``new_s`` slots (new lanes idle) and
    the page pools up to ``new_pages`` pages (new pages zero, the trash
    page moved to the new end, an int8 pool's scales too; new lanes'
    deadlines +inf)."""
    S = state["pos"].shape[0]
    npages = _pool_arrays(state["kp"])[0].shape[1] - 1
    if new_s <= S or new_pages < npages:
        raise MXNetError(f"pool can only grow: {S} -> {new_s} slots, "
                         f"{npages} -> {new_pages} pages")
    out = {}
    for name in ("kp", "vp"):
        grown = []
        for old in _pool_arrays(state[name]):
            new = old.new_zeros((old.shape[0], new_pages + 1) +
                                old.shape[2:])
            new[:, :npages] = old[:, :npages]
            grown.append(new)
        out[name] = tuple(grown) if len(grown) > 1 else grown[0]
    for name in _SLOT_FIELDS:
        old = state[name]
        new = old.new_full((new_s,), _SLOT_FILL.get(name, 0))
        new[:S] = old
        out[name] = new
    return out


def pool_state_bytes(progs, num_slots=None, num_pages=None):
    """Device bytes of the pool state at ``num_slots`` slots and
    ``num_pages`` pages (defaults: ``progs``' own; the default page count
    is the dense-equivalent ``num_slots * MAXP``): the pages, trash page
    included, at ``progs``' page price, and each slot's columns at
    ``schema.slot_state_bytes()``.  Pure arithmetic, so a server prices
    a pool before allocating it; equal to ``telemetry.nbytes_of`` of the
    state ``pool_state_init``/``pool_state_grow`` allocate."""
    S = progs.S if num_slots is None else int(num_slots)
    npages = S * progs.maxp if num_pages is None else int(num_pages)
    return (npages + 1) * progs.page_bytes() + \
        S * schema.slot_state_bytes()


def admit_scratch_bytes(progs, a_bucket):
    """Transient device bytes of an ``a_bucket``-row admission wave: the
    dense K/V pair its prefill computes, priced at the cache horizon
    ``Tp`` (the largest prompt bucket it can take) in the model's
    compute dtype whatever the pool's ``kv_dtype`` (the prefill is
    dense and quantizes on the page scatter), plus the wave's rows of
    slot state."""
    e = progs.eng
    A = int(a_bucket)
    item = torch.empty((), dtype=e.cdtype).element_size()
    return 2 * e.NL * A * e.KV * progs.Tp * e.D * item + \
        A * schema.slot_state_bytes()


class _HostTable:
    """A static operand on the host: two pinned buffers used in turn,
    each written again only after the copy that read it has run (the
    host may run a step ahead of the card)."""

    def __init__(self, shape, device, dtype=torch.int64):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(shape, dtype=dtype,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.events = [None, None]
        self.turn = 0

    def copy_to(self, dst, rows):
        i, self.turn = self.turn, self.turn ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        self.bufs[i].numpy()[...] = rows
        dst.copy_(self.bufs[i], non_blocking=self.cuda)
        if self.cuda:
            self.events[i] = torch.cuda.Event()
            self.events[i].record()


def _with_eos(done, tok, eos_id):
    return done if eos_id is None else done | (tok == eos_id)


class _Program:
    """One ``_GraphProgram`` of a pool size (the step, or the verify of
    one k bucket), its static operands' host sides and its failed
    captures; watched by the telemetry capture watch at ``site``."""

    def __init__(self, fn, device, operands, stream, site, key, fields):
        self.operands = operands            # [(static tensor, _HostTable)]
        self.graph = telemetry.instrument_program(
            _GraphProgram(fn, device, None, [t for t, _ in operands],
                          stream=stream),
            site, key=key, fields=fields)
        self.capture_failures = 0

    @property
    def warm(self):
        """Whether a call replays a captured graph (on the card) or has
        run before (on the CPU): a cold call captures or runs eagerly
        and may build kernels, which a watchdog must not take for a
        wedged dispatch."""
        g = self.graph
        return g.graph is not None if g.on_card else g.calls > 0

    def __call__(self, *host):
        """Copy ``host`` into the static operands and run the program:
        captured at its second call in ``thread_local`` error mode
        (other threads may allocate, launch and synchronize their own
        streams meanwhile).  A device-wide ``torch.cuda.synchronize()``
        from another thread during the capture fails that call and the
        capture; the call then runs the program's own function (the same
        kernels, nothing replayed: a capture runs nothing) and the next
        call captures again (``capture_failures`` counts them)."""
        for (dst, table), rows in zip(self.operands, host):
            table.copy_to(dst, rows)
        prog = self.graph
        capturing = prog.on_card and prog.graph is None and prog.calls >= 1
        try:
            return prog()
        except Exception:
            if not capturing or prog.graph is not None:
                raise
            self.capture_failures += 1
            return prog.run()

    def record(self, S, k=None):
        """``S``, ``k`` (None for the step), ``calls``, ``captures``
        (graphs kept), ``capture_failures``, ``replays``, ``launches``
        (the kernels one replay launches), ``recorded`` (what its
        captures added to the kernels' counters, though a capture runs
        nothing) and ``capture_s``."""
        p = self.graph
        return {"S": S, "k": k, "calls": p.calls,
                "captures": int(p.graph is not None),
                "capture_failures": self.capture_failures,
                "replays": p.replays, "launches": dict(p.launches),
                "recorded": dict(p.recorded), "capture_s": p.capture_s}


class PoolPrograms:
    """Decode step, verify, admissions and chunks for ONE pool size
    ``num_slots`` over a ``num_pages``-page pool of ``page_size``-token
    pages (cache horizon ``max_total`` rounded up to whole pages),
    stored at ``kv_dtype`` ("native": the compute dtype; "int8": codes
    and per-page scales).  ``eng`` is the shared ``_DecodeEngine``
    (weights, weight mode, sampler); ``stream`` the side stream every
    program warms up and captures on (None: each makes its own)."""

    def __init__(self, eng, num_slots, max_total, page_size=16,
                 num_pages=None, eos_id=None, kv_dtype="native",
                 stream=None, telemetry_label=None):
        self.eng = eng
        if decode_mode(eng.model, 1, 32, "native", "off", "auto") != \
                "stacked":
            raise MXNetError(
                "slot-pool serving needs the stacked-layer decode step "
                "(uniform GPT/Llama stack — see ops/decode_fused."
                "stacked_decode_supported); this model resolved to "
                "'unrolled'.  MXNET_SERVE_SYNC=1 serves it through the "
                "synchronous kv_generate fallback instead.")
        if kv_dtype not in ("native", "int8"):
            raise MXNetError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.quant_kv = kv_dtype == "int8"
        self.S, self.T = int(num_slots), int(max_total)
        self.page = int(page_size)
        if self.page < 1:
            raise MXNetError(f"page_size must be >= 1, got {self.page}")
        self.Tp = -(-self.T // self.page) * self.page
        self.maxp = self.Tp // self.page
        self.num_pages = self.S * self.maxp if num_pages is None \
            else int(num_pages)
        if self.num_pages < 1:
            raise MXNetError(f"num_pages must be >= 1, "
                             f"got {self.num_pages}")
        self.sentinel = self.num_pages      # the trash page's index
        self.eos_id = None if eos_id is None else int(eos_id)
        self.stream = stream
        self.telemetry_label = telemetry_label
        # the programs' static page table and clock
        self.pt = torch.full((self.S, self.maxp), self.sentinel,
                             dtype=torch.int64, device=eng.device)
        self._table = _HostTable((self.S, self.maxp), eng.device)
        self.now = torch.zeros((1,), dtype=torch.float32, device=eng.device)
        self._clock = _HostTable((1,), eng.device, torch.float32)
        self._step = None
        self._verifies = {}         # k bucket -> _Program
        self._state = None          # the state the programs were made for
        self._used = set()          # (kind, bucket) run once already
        self._kept = None           # program_records() at release()

    def first_use(self, kind, bucket):
        """True at the first dispatch of an eager admission, hit or chunk
        ``bucket`` of this pool size (its allocations, library handles
        and kernel builds happen then), False after."""
        key = (kind, bucket)
        if key in self._used:
            return False
        self._used.add(key)
        return True

    def cold(self, k=None):
        """Whether the next call of the step (``k`` None) or of the verify
        of bucket ``k`` is cold (``_Program.warm``)."""
        prog = self._step if k is None else self._verifies.get(k)
        return prog is None or not getattr(prog, "warm", True)

    def release(self):
        """Drop the programs and the state they were made for (server
        teardown): a graph and its pool go with the last reference; the
        programs' records stay."""
        self._kept = self.program_records()
        self._step, self._verifies, self._state = None, {}, None

    @property
    def step_program(self):
        """The step's ``gluon.block._GraphProgram`` (None before the
        first step)."""
        return None if self._step is None else self._step.graph

    def page_bytes(self):
        """Device bytes of ONE page across all layers, K and V together:
        at the compute dtype, or an int8 page's codes and scales."""
        e = self.eng
        if self.quant_kv:
            return kv_page_int8_bytes(e.NL, e.KV, self.page, e.D)
        return 2 * e.NL * e.KV * self.page * e.D * \
            torch.empty((), dtype=e.cdtype).element_size()

    def pages_for(self, total_len):
        return -(-int(total_len) // self.page)

    def _done(self, done, tok):
        return _with_eos(done, tok, self.eos_id)

    def _own(self, state):
        """Drop programs made for another state (the state is static in
        every program)."""
        if self._state is not state:
            self._step, self._verifies = None, {}
            self._state = state

    def _step_fn(self, state):
        """The step program's function over ``state``, ``self.pt`` and
        ``self.now``: writes the slot vectors in place, returns
        ``[token, emitted, done]``; a slot retires at EOS, at its stop
        position or once ``now >= dl`` (the reference's
        ``_retire_flags``).  It holds no reference to ``self``, so a
        pool that is dropped frees its state and graph at once."""
        e, pt, page, eos = self.eng, self.pt, self.page, self.eos_id
        pos, tok, active = state["pos"], state["tok"], state["active"]
        now, dl = self.now, state["dl"]

        def fn():
            logits = e.paged_step(tok, pos, state["kp"], state["vp"], pt,
                                  page)
            nxt = torch.where(active, e.sample(logits, state["seed"], pos),
                              tok)
            newpos = torch.where(active, pos + 1, pos)
            done = _with_eos(active & (newpos >= state["stop"]), nxt, eos)
            done = (done | (now >= dl)) & active
            emitted = active.clone()
            pos.copy_(newpos)
            tok.copy_(nxt)
            active.copy_(emitted & ~done)
            return [nxt, emitted, done]

        return fn

    def _fields(self, **extra):
        return dict({"server": self.telemetry_label, "pool": self.S},
                    **extra)

    def step(self, state, rows, now=-np.inf):
        """One decode step for every slot; ``rows`` is the (S, MAXP) int64
        host page table, ``now`` the server-epoch clock (f32 seconds).
        Updates ``state`` in place and returns the readback ``[token,
        emitted, done]`` device tensors; one ``_Program`` (captured at
        its second call).  The default clock, -inf, retires no slot by
        its deadline."""
        self._own(state)
        if self._step is None:
            self._step = _Program(
                self._step_fn(state), self.eng.device,
                [(self.pt, self._table), (self.now, self._clock)],
                self.stream, "serve.step",
                key=(self.telemetry_label, self.S),
                fields=self._fields(
                    num_pages=self.num_pages,
                    cache_bytes=(self.num_pages + 1) * self.page_bytes()))
        return self._step(rows, np.float32(now))

    def _verify_fn(self, state, ops, K):
        """The verify program's function: the (S, K) block is each slot's
        last token and its drafts (``ops[:, :K - 1]``, ``ops[:, K - 1]``
        the drafts proposed, ``nd``); accepts the longest prefix of
        drafts that the model's own greedy tokens match within ``min(nd,
        spec)``, clamps at the first EOS and at the slot's stop
        (``max(stop - pos, 1)``), advances nothing on an inactive lane,
        and returns ``[out (S, K), adv (S,), done (S,)]``; the slot's
        deadline retires it after the accepted prefix, as a step's does."""
        e, pt, page, eos = self.eng, self.pt, self.page, self.eos_id
        pos, tok, active = state["pos"], state["tok"], state["active"]
        stop, spec = state["stop"], state["spec"]
        now, dl = self.now, state["dl"]
        drafts, nd = ops[:, :K - 1], ops[:, K - 1]
        S = ops.shape[0]

        def fn():
            toks = torch.cat([tok[:, None], drafts], 1)
            logits = e.pool_verify_paged(toks, pos, state["kp"],
                                         state["vp"], pt, page)
            out = torch.argmax(logits, dim=-1)                  # (S, K)
            iK = torch.arange(K, device=out.device)
            ok = (out[:, :-1] == drafts) & \
                (iK[None, :-1] < torch.minimum(nd, spec)[:, None])
            adv = torch.cumprod(ok.long(), 1).sum(1) + 1
            if eos is not None:
                first_eos = torch.where(out == eos, iK[None],
                                        torch.full_like(out, K)).amin(1)
                adv = torch.minimum(adv, first_eos + 1)
            adv = torch.minimum(adv, torch.clamp(stop - pos, min=1))
            adv = torch.where(active, adv, torch.zeros_like(adv))
            nxt = torch.where(
                active, out[torch.arange(S, device=out.device),
                            torch.clamp(adv, min=1) - 1], tok)
            newpos = pos + adv
            done = _with_eos(active & (newpos >= stop), nxt, eos)
            done = (done | (now >= dl)) & active
            pos.copy_(newpos)
            tok.copy_(nxt)
            active.copy_(active & ~done)
            return [out, adv, done]

        return fn

    def verify(self, state, rows, drafts, nd, k, now=-np.inf):
        """One draft-and-verify dispatch for every slot at k bucket ``k``:
        ``rows`` the (S, MAXP) host page table, ``drafts`` (S, k) and
        ``nd`` (S,) int64 host arrays (the drafts each slot proposed;
        0: a plain step through column 0), ``now`` the server-epoch
        clock.  Updates ``state`` in place
        and returns the readback ``[out (S, k + 1), adv (S,), done
        (S,)]``.  One ``_Program`` a k bucket, captured at its second
        call as ``step``'s.  Greedy only."""
        k = int(k)
        if k < 1:
            raise MXNetError(f"verify bucket {k} must be >= 1")
        if self.eng.temperature != 0.0:
            raise MXNetError(
                "draft-and-verify acceptance is exact only for greedy "
                f"decoding; temperature={self.eng.temperature} slots must "
                "run the plain step (rejection sampling is out of scope "
                "for v1)")
        self._own(state)
        prog = self._verifies.get(k)
        if prog is None:
            dev = self.eng.device
            ops = torch.zeros((self.S, k + 1), dtype=torch.int64, device=dev)
            prog = self._verifies[k] = _Program(
                self._verify_fn(state, ops, k + 1), dev,
                [(self.pt, self._table), (self.now, self._clock),
                 (ops, _HostTable((self.S, k + 1), dev))], self.stream,
                "serve.verify", key=(self.telemetry_label, self.S, k + 1),
                fields=self._fields(k_bucket=k))
        block = np.empty((self.S, k + 1), np.int64)
        block[:, :k] = drafts
        block[:, k] = nd
        return prog(rows, np.float32(now), block)

    def step_record(self):
        """What this pool size's step program did so far
        (``_Program.record``)."""
        if not isinstance(self._step, _Program):
            return {"S": self.S, "k": None, "calls": 0, "captures": 0,
                    "capture_failures": 0, "replays": 0, "launches": {},
                    "recorded": {}, "capture_s": None}
        return self._step.record(self.S)

    def program_records(self):
        """The step's record, then each verify program's by k bucket."""
        if self._kept is not None:
            return self._kept
        return [self.step_record()] + [
            self._verifies[k].record(self.S, k)
            for k in sorted(self._verifies)]

    def _reset_scales(self, state, zpages):
        """Zero the scales of the pages ``zpages`` (int64, trash-padded)
        of an int8 pool: freshly reserved pages enter with a zero
        scale."""
        if self.quant_kv and zpages is not None:
            flat = zpages.reshape(-1)
            for name in ("kp", "vp"):
                state[name][1][:, flat] = 0.0

    def admit(self, state, prompts, true_len, slots, stop_pos, seeds,
              pages, spec=None, zpages=None, dls=None):
        """Admit a wave: ``prompts`` (A, P) int64 right-padded prompts
        (rows past the wave are padding); ``true_len``/``stop_pos``/
        ``seeds``/``spec`` (A,) int64 (``spec``: the speculation-depth
        cap, default 0); ``dls`` (A,) f32 deadlines in server-epoch
        seconds (default: +inf, none); ``slots`` the wave's slot ids (a
        list as long as the wave); ``pages`` (A, NPB) int64 reserved-page rows,
        trash-padded; ``zpages`` (A, MAXP) every page each row reserved
        (an int8 pool zeroes their scales first; the prompt's own pages
        are quantized fresh, their padded tail zeroed so that it cannot
        raise a scale).  Returns the readback ``(first_tok, done)`` for
        the A rows."""
        e = self.eng
        A, P = prompts.shape
        npb = pages.shape[1]
        logits, knew, vnew = e.prefill(prompts, last_index=true_len - 1)
        first = e.sample(logits, seeds, true_len - 1)
        done = self._done(stop_pos <= true_len, first)
        ppad = npb * self.page
        flat = pages.reshape(A * npb)
        self._reset_scales(state, zpages)
        for name, new in (("kp", knew), ("vp", vnew)):
            NL, H, D = new.shape[0], new.shape[2], new.shape[4]
            new = torch.nn.functional.pad(new, (0, 0, 0, ppad - P))
            if self.quant_kv:
                col = torch.arange(ppad, device=e.device)[None] < \
                    true_len[:, None]                       # (A, ppad)
                new = torch.where(col[None, :, None, :, None], new,
                                  torch.zeros_like(new))
            new = new.reshape(NL, A, H, npb, self.page, D) \
                .permute(0, 1, 3, 2, 4, 5) \
                .reshape(NL, A * npb, H, self.page, D)
            if self.quant_kv:
                codes, scales = state[name]
                q, s = _kv_requant(new, 0.0)
                codes[:, flat] = q
                scales[:, flat] = s
            else:
                state[name][:, flat] = new
        n = len(slots)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=e.device)
        state["pos"][idx] = true_len[:n]
        state["tok"][idx] = first[:n]
        state["active"][idx] = ~done[:n]
        state["stop"][idx] = stop_pos[:n]
        state["seed"][idx] = seeds[:n]
        state["dl"][idx] = float("inf") if dls is None else dls[:n]
        state["spec"][idx] = 0 if spec is None else spec[:n]
        return first, done

    def admit_hit(self, state, slots, true_len, last_tok, stop_pos, seeds,
                  src, dst, spec=None, zpages=None, dls=None):
        """Admit a wave of prefix-cache hits (``true_len``/``last_tok``/
        ``stop_pos``/``seeds``/``src``/``dst``/``spec`` (A,) int64,
        ``dls`` (A,) f32 deadlines; ``slots`` the wave's slot ids).  No
        model forward: each row copies at most one copy-on-write page
        ``src`` -> ``dst`` (a row without a
        copy carries the trash page on both sides; an int8 page's codes
        and scale together), and its slot enters at ``pos = L - 1`` with
        ``tok`` = the last prompt token, so the next step recomputes that
        position and samples it with the admission's own (seed,
        position).  On an int8 pool the scales of ``zpages`` (A, MAXP),
        each row's freshly owned pages, are zeroed after the copies'
        sources are read and before their destinations are written.
        Returns nothing: a hit's first token comes from the step."""
        if self.quant_kv:
            got = {}
            for name in ("kp", "vp"):
                _zero_trash(state[name])
                got[name] = [a[:, src] for a in state[name]]
            self._reset_scales(state, zpages)   # every source read first
            for name in ("kp", "vp"):
                for a, g in zip(state[name], got[name]):
                    a[:, dst] = g
        else:
            for name in ("kp", "vp"):
                pool = state[name]
                pool[:, dst] = pool[:, src]     # every source read first
        n = len(slots)
        idx = torch.as_tensor(slots, dtype=torch.int64,
                              device=self.eng.device)
        state["pos"][idx] = true_len[:n] - 1
        state["tok"][idx] = last_tok[:n]
        state["active"][idx] = True
        state["stop"][idx] = stop_pos[:n]
        state["seed"][idx] = seeds[:n]
        state["dl"][idx] = float("inf") if dls is None else dls[:n]
        state["spec"][idx] = 0 if spec is None else spec[:n]

    def chunk(self, state, toks, ptrow, off, nlast, final, slot, true_len,
              stop_pos, seed, spec=0, zrow=None, dl=float("inf")):
        """One ``C``-token slice (``toks`` (C,) int64) of one prompt at
        absolute offset ``off`` through the slot's page-table row
        ``ptrow`` (MAXP,) int64.  An intermediate chunk changes no slot
        state.  The ``final`` chunk samples the first token at ``true_len
        - 1`` with the request's seed and sets the slot's ``pos``,
        ``tok``, ``active``, ``stop``, ``seed``, ``dl`` (the f32 deadline
        ``dl``, server-epoch seconds) and ``spec``.  ``zrow``
        (MAXP,): pages whose scales an int8 pool zeroes first (the
        slot's fresh pages, at its first chunk only).  Returns ``(first,
        done)``, one element each."""
        e = self.eng
        self._reset_scales(state, zrow)
        logits = e.chunk_tokens(toks, off, nlast, ptrow, state["kp"],
                                state["vp"], self.page)
        one = lambda v: torch.full((1,), v, dtype=torch.int64,  # noqa
                                   device=e.device)
        first = e.sample(logits, one(seed), one(true_len - 1))
        done = self._done(torch.full((1,), stop_pos <= true_len,
                                     device=e.device), first)
        if final:
            state["pos"][slot] = true_len
            state["tok"][slot] = first[0]
            state["active"][slot] = ~done[0]
            state["stop"][slot] = stop_pos
            state["seed"][slot] = seed
            state["dl"][slot] = dl
            state["spec"][slot] = spec
        return first, done
