"""Serving: the continuous-batching ``DecodeServer`` over a paged KV pool."""
from .engine import PagePool, PoolPrograms, pool_state_grow, pool_state_init
from .server import DecodeServer, TokenStream

__all__ = ["DecodeServer", "TokenStream", "PagePool", "PoolPrograms",
           "pool_state_init", "pool_state_grow"]
