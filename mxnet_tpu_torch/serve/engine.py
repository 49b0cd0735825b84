"""Paged slot-pool decode programs — the device side of the
continuous-batching server (``serve/server.py``).

Port of ``mxnet_tpu/serve/engine.py`` (native-dtype pages).  The resident
K/V store is a page pool ``(NL, NPAGES + 1, H, PAGE, D)`` shared by all
in-flight sequences and addressed through per-slot page tables.  Page
``NPAGES`` is the trash page that stands for the reference's
one-past-the-end sentinel (see ``models/decoding.py``): idle and retired
slots carry all-trash rows, so their masked lanes can never write into a
page they do not own.

Per pool size ``S`` there are four units of work:

- ``PoolPrograms.step`` — every slot advances one token
  (``_DecodeEngine.paged_step``), samples, and the retirement flags are
  computed on the device.  It is ONE program (``gluon.block.
  _GraphProgram``): on the card a CUDA-graph replay a step, captured once
  a pool size, the counterpart of the reference's one executable a pool
  size.  Its operands are static: the slot state, updated in place, and
  an (S, MAXP) page table the host copies in from pinned memory;
- ``PoolPrograms.admit`` — one causal prefill over an ``(A, P)`` block of
  right-padded prompts, scattered into the admitted slots' reserved
  pages, first tokens sampled at each row's own last prompt token;
- ``PoolPrograms.admit_hit`` — a prefix-cache hit: no model forward, at
  most one copy-on-write page copy a row, and the slot enters at ``pos =
  L - 1`` so that the next step recomputes the last prompt position;
- ``PoolPrograms.chunk`` — one slice of a long prompt (or of a partial
  hit's suffix) through the slot's page-table row
  (``_DecodeEngine.chunk_tokens``); only the final slice activates the
  slot.

``PagePool`` is the host-side free-list allocator with refcounts: the
prefix cache maps one page into many slots' tables.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..gluon.block import _GraphProgram

__all__ = ["PagePool", "PoolPrograms", "pool_state_init", "pool_state_grow"]


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


_SLOT_FIELDS = ("pos", "tok", "active", "stop", "seed")


def pool_state_init(progs):
    """Fresh all-idle pool state for ``progs``: a dict of the two page
    pools (trash page included) and the per-slot vectors ``pos`` (next
    write index), ``tok`` (last token), ``active``, ``stop`` (retire
    position) and ``seed``."""
    e, S = progs.eng, progs.S
    shape = (e.NL, progs.num_pages + 1, e.KV, progs.page, e.D)
    dev = e.device
    state = {"kp": torch.zeros(shape, dtype=e.cdtype, device=dev),
             "vp": torch.zeros(shape, dtype=e.cdtype, device=dev)}
    for name in _SLOT_FIELDS:
        dt = torch.bool if name == "active" else torch.int64
        state[name] = torch.zeros((S,), dtype=dt, device=dev)
    return state


def pool_state_grow(state, new_s, new_pages):
    """Pad the slot vectors up to ``new_s`` slots (new lanes idle) and
    the page pools up to ``new_pages`` pages (new pages zero, the trash
    page moved to the new end)."""
    S = state["pos"].shape[0]
    npages = state["kp"].shape[1] - 1
    if new_s <= S or new_pages < npages:
        raise MXNetError(f"pool can only grow: {S} -> {new_s} slots, "
                         f"{npages} -> {new_pages} pages")
    out = {}
    for name in ("kp", "vp"):
        old = state[name]
        new = old.new_zeros((old.shape[0], new_pages + 1) + old.shape[2:])
        new[:, :npages] = old[:, :npages]
        out[name] = new
    for name in _SLOT_FIELDS:
        old = state[name]
        new = old.new_zeros((new_s,))
        new[:S] = old
        out[name] = new
    return out


class _HostTable:
    """The step's page table on the host: two pinned buffers used in
    turn, each written again only after the copy that read it has run
    (the host may run a step ahead of the card)."""

    def __init__(self, shape, device):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(shape, dtype=torch.int64,
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


class PoolPrograms:
    """Decode step, admissions and chunks for ONE pool size ``num_slots``
    over a ``num_pages``-page pool of ``page_size``-token pages (cache
    horizon ``max_total`` rounded up to whole pages).  ``eng`` is the
    shared ``_DecodeEngine`` (weights, weight mode, sampler)."""

    def __init__(self, eng, num_slots, max_total, page_size=16,
                 num_pages=None, eos_id=None):
        self.eng = eng
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
        # the step program's static page table and its host side
        self.pt = torch.full((self.S, self.maxp), self.sentinel,
                             dtype=torch.int64, device=eng.device)
        self._table = _HostTable((self.S, self.maxp), eng.device)
        self.step_program = None
        self._step_state = None
        self.capture_failures = 0

    def page_bytes(self):
        """Device bytes of ONE page across all layers, K and V together."""
        e = self.eng
        return 2 * e.NL * e.KV * self.page * e.D * \
            torch.empty((), dtype=e.cdtype).element_size()

    def pages_for(self, total_len):
        return -(-int(total_len) // self.page)

    def _done(self, done, tok):
        return _with_eos(done, tok, self.eos_id)

    def _step_fn(self, state):
        """The step program's function over ``state`` and ``self.pt``:
        writes the slot vectors in place, returns ``[token, emitted,
        done]``.  It holds no reference to ``self``, so a pool that is
        dropped frees its state and graph at once."""
        e, pt, page, eos = self.eng, self.pt, self.page, self.eos_id
        pos, tok, active = state["pos"], state["tok"], state["active"]

        def fn():
            logits = e.paged_step(tok, pos, state["kp"], state["vp"], pt,
                                  page)
            nxt = torch.where(active, e.sample(logits, state["seed"], pos),
                              tok)
            newpos = torch.where(active, pos + 1, pos)
            done = _with_eos(active & (newpos >= state["stop"]), nxt, eos)
            done &= active
            emitted = active.clone()
            pos.copy_(newpos)
            tok.copy_(nxt)
            active.copy_(emitted & ~done)
            return [nxt, emitted, done]

        return fn

    def step(self, state, rows):
        """One decode step for every slot; ``rows`` is the (S, MAXP) int64
        host page table.  Updates ``state`` in place and returns the
        readback ``[token, emitted, done]`` device tensors.  The program
        is captured at its second call, in ``thread_local`` error mode:
        other threads may allocate, launch and synchronize their own
        streams meanwhile.  A device-wide ``torch.cuda.synchronize()``
        from another thread during the capture fails that call and the
        capture; the step then runs the program's own function (the same
        kernels, nothing replayed: a capture runs nothing) and the next
        step captures again (``capture_failures`` counts them)."""
        self._table.copy_to(self.pt, rows)
        prog = self.step_program
        if prog is None or self._step_state is not state:
            prog = self.step_program = _GraphProgram(
                self._step_fn(state), self.eng.device, None, [self.pt],
                error_mode="thread_local")
            self._step_state = state
        capturing = prog.on_card and prog.graph is None and prog.calls >= 1
        try:
            return prog()
        except Exception:
            if not capturing or prog.graph is not None:
                raise
            self.capture_failures += 1
            return prog.run()

    def step_record(self):
        """What this pool size's step program did so far: ``S``,
        ``captures`` (graphs kept), ``capture_failures``, ``replays``,
        ``launches`` (the kernels one replay launches), ``recorded``
        (what its captures added to the kernels' counters, though a
        capture runs nothing) and ``capture_s``."""
        p = self.step_program
        return {"S": self.S, "captures": int(p is not None and
                                             p.graph is not None),
                "capture_failures": self.capture_failures,
                "replays": 0 if p is None else p.replays,
                "launches": {} if p is None else dict(p.launches),
                "recorded": {} if p is None else dict(p.recorded),
                "capture_s": None if p is None else p.capture_s}

    def admit(self, state, prompts, true_len, slots, stop_pos, seeds,
              pages):
        """Admit a wave: ``prompts`` (A, P) int64 right-padded prompts
        (rows past the wave are padding); ``true_len``/``stop_pos``/
        ``seeds`` (A,) int64; ``slots`` the wave's slot ids (a list as
        long as the wave); ``pages`` (A, NPB) int64 reserved-page rows,
        trash-padded.  Returns the readback ``(first_tok, done)`` for the
        A rows."""
        e = self.eng
        A, P = prompts.shape
        npb = pages.shape[1]
        logits, knew, vnew = e.prefill(prompts, last_index=true_len - 1)
        first = e.sample(logits, seeds, true_len - 1)
        done = self._done(stop_pos <= true_len, first)
        ppad = npb * self.page
        flat = pages.reshape(A * npb)
        for name, new in (("kp", knew), ("vp", vnew)):
            NL, H, D = new.shape[0], new.shape[2], new.shape[4]
            new = torch.nn.functional.pad(new, (0, 0, 0, ppad - P))
            new = new.reshape(NL, A, H, npb, self.page, D) \
                .permute(0, 1, 3, 2, 4, 5) \
                .reshape(NL, A * npb, H, self.page, D)
            state[name][:, flat] = new
        n = len(slots)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=e.device)
        state["pos"][idx] = true_len[:n]
        state["tok"][idx] = first[:n]
        state["active"][idx] = ~done[:n]
        state["stop"][idx] = stop_pos[:n]
        state["seed"][idx] = seeds[:n]
        return first, done

    def admit_hit(self, state, slots, true_len, last_tok, stop_pos, seeds,
                  src, dst):
        """Admit a wave of prefix-cache hits (``true_len``/``last_tok``/
        ``stop_pos``/``seeds``/``src``/``dst`` (A,) int64; ``slots`` the
        wave's slot ids).  No model forward: each row copies at most one
        copy-on-write page ``src`` -> ``dst`` (a row without a copy
        carries the trash page on both sides), and its slot enters at
        ``pos = L - 1`` with ``tok`` = the last prompt token, so the
        next step recomputes that position and samples it with the
        admission's own (seed, position).  Returns nothing: a hit's first
        token comes from the step."""
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

    def chunk(self, state, toks, ptrow, off, nlast, final, slot, true_len,
              stop_pos, seed):
        """One ``C``-token slice (``toks`` (C,) int64) of one prompt at
        absolute offset ``off`` through the slot's page-table row
        ``ptrow`` (MAXP,) int64.  An intermediate chunk changes no slot
        state.  The ``final`` chunk samples the first token at ``true_len
        - 1`` with the request's seed and sets the slot's ``pos``,
        ``tok``, ``active``, ``stop`` and ``seed``.  Returns ``(first,
        done)``, one element each."""
        e = self.eng
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
        return first, done
