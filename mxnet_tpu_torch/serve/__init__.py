"""Serving: the continuous-batching ``DecodeServer`` over a paged KV pool,
with int8 KV pages, speculative draft-and-verify decoding, deadlines,
cancellation, the watchdog, the HBM budget and the synchronous
``kv_generate`` mode."""
from . import schema
from .draft import Drafter, NGramDrafter
from .engine import (PagePool, PoolPrograms, admit_scratch_bytes,
                     pool_state_bytes, pool_state_grow, pool_state_init)
from .server import (DecodeServer, TokenStream, reset_serve_counters,
                     serve_counters)

__all__ = ["DecodeServer", "TokenStream", "PagePool", "PoolPrograms",
           "pool_state_init", "pool_state_grow", "pool_state_bytes",
           "admit_scratch_bytes", "Drafter", "NGramDrafter", "schema",
           "serve_counters", "reset_serve_counters"]
