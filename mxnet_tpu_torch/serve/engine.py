"""Paged slot-pool decode programs — the device side of the
continuous-batching server (``serve/server.py``).

Port of ``mxnet_tpu/serve/engine.py`` (native-dtype pages).  The resident
K/V store is a page pool ``(NL, NPAGES + 1, H, PAGE, D)`` shared by all
in-flight sequences and addressed through per-slot page tables (host
numpy rows, copied in per dispatch).  Page ``NPAGES`` is the trash page
that stands for the reference's one-past-the-end sentinel (see
``models/decoding.py``): idle and retired slots carry all-trash rows, so
their masked lanes can never write into a page they do not own.

Per pool size ``S`` there are two units of work:

- ``PoolPrograms.step`` — every slot advances one token
  (``_DecodeEngine.paged_step``), samples, and the retirement flags are
  computed on the device;
- ``PoolPrograms.admit`` — one causal prefill over an ``(A, P)`` block of
  right-padded prompts, scattered into the admitted slots' reserved
  pages, first tokens sampled at each row's own last prompt token.

``PagePool`` is the host-side free-list allocator (refcounted, as in the
reference, so the prefix cache of a later slice can share pages).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

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


class PoolPrograms:
    """Decode step and admission for ONE pool size ``num_slots`` over a
    ``num_pages``-page pool of ``page_size``-token pages (cache horizon
    ``max_total`` rounded up to whole pages).  ``eng`` is the shared
    ``_DecodeEngine`` (weights, weight mode, sampler)."""

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

    def page_bytes(self):
        """Device bytes of ONE page across all layers, K and V together."""
        e = self.eng
        return 2 * e.NL * e.KV * self.page * e.D * \
            torch.empty((), dtype=e.cdtype).element_size()

    def pages_for(self, total_len):
        return -(-int(total_len) // self.page)

    def step(self, state, pt):
        """One decode step for every slot; ``pt`` is the (S, MAXP) page
        table (device int64).  Updates ``state`` in place and returns the
        readback ``(token, emitted, done)`` device tensors."""
        e = self.eng
        pos, tok, active = state["pos"], state["tok"], state["active"]
        logits = e.paged_step(tok, pos, state["kp"], state["vp"], pt,
                              self.page)
        nxt = torch.where(active, e.sample(logits, state["seed"], pos), tok)
        newpos = torch.where(active, pos + 1, pos)
        done = active & (newpos >= state["stop"])
        if self.eos_id is not None:
            done |= active & (nxt == self.eos_id)
        emitted = active.clone()
        state["pos"], state["tok"] = newpos, nxt
        state["active"] = active & ~done
        return nxt, emitted, done

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
        done = stop_pos <= true_len
        if self.eos_id is not None:
            done |= first == self.eos_id
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
