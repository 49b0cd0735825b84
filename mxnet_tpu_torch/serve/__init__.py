"""Serving: the continuous-batching ``DecodeServer`` over a paged KV pool,
with int8 KV pages and speculative draft-and-verify decoding."""
from .draft import Drafter, NGramDrafter
from .engine import PagePool, PoolPrograms, pool_state_grow, pool_state_init
from .server import DecodeServer, TokenStream

__all__ = ["DecodeServer", "TokenStream", "PagePool", "PoolPrograms",
           "pool_state_init", "pool_state_grow", "Drafter", "NGramDrafter"]
