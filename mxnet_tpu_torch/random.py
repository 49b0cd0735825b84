"""Random state of the port: ``seed`` and one explicit
``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py`` (``seed``, ``next_key``).  JAX's
threefry keys have no torch equivalent, so the streams differ from the
reference's; what is shared is the contract that one ``seed(n)`` fixes
every draw after it.

- ``generator(device)``: the generator ``Dropout`` draws its masks from,
  one per device, on that device.
- ``attention_seed()``: a uint32 drawn from a host generator of its own,
  returned as a Python int, for attention dropout (whose keep mask is a
  position hash of that seed, computed inside the kernels).  A host draw
  needs no device sync, once per layer.

Both raise while the current CUDA stream is capturing a graph: a graph
would replay the seed or the generator's state it saw at capture, so
every replay would draw the same dropout mask.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import MXNetError

__all__ = ["seed", "generator", "attention_seed"]

_state = threading.local()


def _root():
    if not hasattr(_state, "seed"):
        # unseeded: a per-process draw, as the reference's lazy root key
        seed(int(np.random.randint(0, 2 ** 31 - 1)))
    return _state


def seed(seed_state) -> None:
    """``mx.random.seed``: every generator restarts from ``seed_state``."""
    _state.seed = int(seed_state)
    _state.gens = {}


def _make(device, salt):
    g = torch.Generator(device=device)
    g.manual_seed((_root().seed * 1000003 + salt) & 0x7FFFFFFFFFFFFFFF)
    return g


def _refuse_capture(what):
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            f"random.{what} called while a CUDA graph is being captured: "
            "every replay would draw the same numbers; a captured step "
            "cannot draw random numbers yet")


def generator(device) -> torch.Generator:
    """The device generator of ``device`` (created at first use)."""
    _refuse_capture("generator")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gens = _root().gens
    g = gens.get(dev)
    if g is None:
        g = gens[dev] = _make(dev, 1 + (dev.index or 0) +
                              (0 if dev.type == "cpu" else 1024))
    return g


def attention_seed() -> int:
    """A uint32 attention-dropout seed from the host generator."""
    _refuse_capture("attention_seed")
    gens = _root().gens
    g = gens.get("attention")
    if g is None:
        g = gens["attention"] = _make("cpu", 0)
    return int(torch.randint(0, 2 ** 32, (1,), generator=g,
                             dtype=torch.int64).item())
