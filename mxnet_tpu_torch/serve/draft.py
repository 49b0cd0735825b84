"""Host-side draft proposers for speculative decoding
(``mxnet_tpu_torch.serve.DecodeServer``).

Port of ``mxnet_tpu/serve/draft.py`` (pure numpy, copied).

A drafter is CHEAP HOST CODE on the scheduler thread: between decode
dispatches it proposes up to ``k`` continuation tokens per slot from
that slot's prompt + generated history, and ONE bucketed ``(S, k)``
verify program (``serve.engine.PoolPrograms.verify``) scores
every proposal in a single dispatch — accepted drafts cost a fraction
of a dispatch each instead of one full step.  A drafter never touches
the device and never sees model weights, so a bad proposal costs
nothing but the verify column it rode in; a GOOD proposal must match
the model's own greedy emission, which is why self-speculation (the
sequence predicting its own continuation) is the zero-cost default.

The interface is deliberately one method, so a small zoo model (or any
future learned drafter) slots in by implementing ``propose``:

```python
class MyDrafter(Drafter):
    def propose(self, history, k):      # history: 1-D int numpy
        return my_tokens[:k]            # <= k ints, [] to skip
```

``NGramDrafter`` is the shipped default: longest-suffix n-gram
self-speculation.  It finds the most recent earlier occurrence of the
longest suffix (down to ``min_match`` tokens) of the slot's history
and proposes the tokens that followed it — repetitive continuations
(code, lists, template prose, greedy loops) verify at high acceptance,
and histories with no repeated suffix propose nothing (the slot takes
a plain step, costing exactly what it costs today).
"""
from __future__ import annotations

import numpy as onp

__all__ = ["Drafter", "NGramDrafter"]


class Drafter:
    """Pluggable draft-proposal interface (host-side, per slot)."""

    def propose(self, history, k):
        """Up to ``k`` proposed continuation tokens for one slot.

        ``history`` is the slot's full token context — prompt +
        every generated token routed to its stream so far — as a 1-D
        int numpy array.  Return a sequence of at most ``k`` ints (a
        list or 1-D array); return an empty sequence to skip this slot
        (it runs a plain step).  Called on the scheduler thread between
        dispatches: must be cheap and must not block."""
        raise NotImplementedError

    def observe(self, history, accepted, rejected):
        """Optional acceptance feedback after a verify drain (default:
        ignored).  Adaptive drafters can tune per-slot depth here."""


class NGramDrafter(Drafter):
    """Longest-suffix n-gram self-speculation.

    Matches the longest suffix of ``history`` (length ``max_match``
    down to ``min_match``) against its most recent EARLIER occurrence
    and proposes the ``k`` tokens that followed that occurrence.  Pure
    numpy over a bounded window (``window`` trailing tokens), so a
    proposal costs microseconds against the milliseconds a decode
    dispatch costs."""

    def __init__(self, min_match=1, max_match=4, window=512):
        if min_match < 1 or max_match < min_match:
            raise ValueError(f"need 1 <= min_match <= max_match, got "
                             f"{min_match}..{max_match}")
        self.min_match = int(min_match)
        self.max_match = int(max_match)
        self.window = int(window)

    def propose(self, history, k):
        hist = onp.asarray(history, dtype=onp.int64).ravel()
        if k < 1 or hist.size < self.min_match + 1:
            return []
        base = max(0, hist.size - self.window)
        h = hist[base:]
        n = h.size
        for m in range(min(self.max_match, n - 1), self.min_match - 1,
                       -1):
            suffix = h[n - m:]
            # candidate start positions of earlier suffix occurrences
            # (excluding the suffix itself); most recent match wins —
            # locality: the continuation that followed last time is
            # the likeliest to follow again
            starts = n - m - 1
            if starts < 1:
                continue
            windows = onp.lib.stride_tricks.sliding_window_view(
                h[:n - 1], m)[:starts]
            hits = onp.nonzero((windows == suffix).all(axis=1))[0]
            if hits.size:
                j = int(hits[-1]) + m      # first token AFTER the match
                return [int(t) for t in h[j:j + k]]
        return []
