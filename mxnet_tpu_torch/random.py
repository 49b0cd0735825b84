"""Random state of the port: ``seed``, one ``torch.Generator`` per
device, and a program's traced key.

Counterpart of ``mxnet_tpu/random.py`` (``seed``, ``push_trace_key``,
``pop_trace_key``, ``next_key``).  JAX's threefry keys have no torch
equivalent, so the streams differ from the reference's; what is shared
is the contract that one ``seed(n)`` fixes every draw after it, and that
a compiled program takes a fresh key as an operand at every call.

- ``generator(device)``: the generator ``Dropout`` draws its masks from,
  one per device, on that device.  A CUDA graph that draws from it
  registers it (``CUDAGraph.register_generator_state``; ``gluon.block.
  _GraphProgram`` does), so each replay advances it and draws a fresh
  mask; ``seed`` reseeds it in place, so a graph keeps reading the
  generator it registered.
- ``next_key()``: outside a trace, a uint32 from a host generator of its
  own, returned as a Python int: the key a program gets as an operand.
- ``attention_seed(device)``: outside a trace, a uint32 from the
  attention host generator (the same values as before the traced key
  existed), handed to the kernels as a one-element int64 device word
  made by a fill.
- ``push_trace_key(key)`` / ``pop_trace_key()`` / ``trace(key)``: a
  program's key, a one-element integer device tensor whose low 32 bits
  the host writes before each call (or a graph picks on the device).
  Under a trace, ``next_key()`` and ``attention_seed()`` return a device
  word derived from the key and the draw's index within the program (a
  Python int, fixed when the program is captured): a few integer ops on
  one element, which a graph captures and replays with the key it is
  given.

A draw while the current CUDA stream captures a graph raises unless a
trace is pushed (and, for ``generator``, unless the graph registered
it): a graph would otherwise replay the seed or the generator state it
saw at capture, and every replay would draw the same mask.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .base import MXNetError

__all__ = ["seed", "generator", "attention_seed", "next_key",
           "push_trace_key", "pop_trace_key", "trace"]

_M32 = 0xFFFFFFFF
_state = threading.local()


def _root():
    if not hasattr(_state, "seed"):
        # unseeded: a per-process draw, as the reference's lazy root key
        seed(int(np.random.randint(0, 2 ** 31 - 1)))
    return _state


def _salt(name):
    """Each generator's offset from the root seed: the host streams by
    name, a device's by its type and index."""
    if name == "attention":
        return 0
    if name == "key":
        return 2 ** 20
    return 1 + (name.index or 0) + (0 if name.type == "cpu" else 1024)


def _seed_of(name):
    return (_state.seed * 1000003 + _salt(name)) & 0x7FFFFFFFFFFFFFFF


def seed(seed_state) -> None:
    """``mx.random.seed``: every generator restarts from ``seed_state``
    (the device generators in place, so the graphs that registered them
    follow)."""
    _state.seed = int(seed_state)
    gens = _state.__dict__.setdefault("gens", {})
    for name, g in gens.items():
        g.manual_seed(_seed_of(name))


def _gen(name, device):
    gens = _root().gens
    g = gens.get(name)
    if g is None:
        g = gens[name] = torch.Generator(device=device)
        g.manual_seed(_seed_of(name))
    return g


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _refuse_capture(what):
    if _capturing() and not _traces():
        raise MXNetError(
            f"random.{what} called while a CUDA graph is being captured "
            "with no traced key: every replay would draw the same "
            "numbers; run the program through gluon.block._GraphProgram "
            "(hybridize, Trainer.fused_step, SPMDTrainer), which pushes "
            "its key")


def generator(device) -> torch.Generator:
    """The device generator of ``device`` (created at first use)."""
    _refuse_capture("generator")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _gen(dev, dev)
    if _traces():
        tr = _traces()[-1]
        if _capturing() and g not in tr.registered:
            raise MXNetError(
                f"random.generator({dev}) drawn in a capture that did not "
                "register it: the program's eager call drew nothing from "
                "it, so its graph cannot advance it")
        if g not in tr.generators:
            tr.generators.append(g)
    return g


# --------------------------------------------------------------------------- #
# the traced key (reference ``push_trace_key``/``pop_trace_key``)
# --------------------------------------------------------------------------- #

class _Trace:
    """One program's key while it runs or is captured: the key tensor,
    the draws so far (each draw's index), the generators the program
    drew from and the ones its graph registered."""

    def __init__(self, key, registered=()):
        self.key = key
        self.word = None        # the key's low 32 bits as int64, made once
        self.draws = 0
        self.generators: list = []
        self.registered = list(registered)


def _traces():
    st = _root()
    if not hasattr(st, "trace_stack"):
        st.trace_stack = []
    return st.trace_stack


def push_trace_key(key, registered=()):
    """Make ``key`` (a one-element integer tensor) the key of the draws
    that follow, until ``pop_trace_key``; ``registered`` lists the
    generators the capturing graph registered."""
    if not isinstance(key, torch.Tensor) or key.numel() != 1 or \
            key.dtype not in (torch.int32, torch.int64):
        raise MXNetError("push_trace_key: the key must be a one-element "
                         "int32 or int64 tensor")
    tr = _Trace(key, registered)
    _traces().append(tr)
    return tr


def pop_trace_key():
    return _traces().pop()


@contextlib.contextmanager
def trace(key, registered=()):
    """``push_trace_key(key)`` for the body of a ``with``; yields the
    trace (its ``draws`` and ``generators`` after the body)."""
    tr = push_trace_key(key, registered)
    try:
        yield tr
    finally:
        pop_trace_key()


def _mul32(a, c: int):
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a Python
    ``c``: split so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _derive(word, index: int):
    """murmur3's finalizer over ``word ^ h(index)``: the uint32 (held in
    int64) of draw ``index`` under key ``word``.  Tensor-scalar ops
    only, so a graph captures it."""
    h = word ^ ((index * 0x9E3779B1 + 0x7F4A7C15) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _traced_draw():
    tr = _traces()[-1]
    if tr.word is None:
        tr.word = tr.key.reshape(1).to(torch.int64) & _M32
    i = tr.draws
    tr.draws += 1
    return _derive(tr.word, i)


def next_key():
    """A fresh key: under a trace, the device word of this draw (derived
    from the trace's key and the draw's index); outside one, a uint32
    Python int from the key host generator."""
    if _traces():
        return _traced_draw()
    _refuse_capture("next_key")
    return int(torch.randint(0, 2 ** 32, (1,), generator=_gen("key", "cpu"),
                             dtype=torch.int64).item())


def attention_seed(device="cpu"):
    """The attention-dropout seed: a one-element int64 word on
    ``device`` holding a uint32.  Under a trace, ``next_key()``;
    outside one, a draw of the attention host generator, written by a
    fill (no host-to-device copy)."""
    if _traces():
        return _traced_draw()
    _refuse_capture("attention_seed")
    value = int(torch.randint(0, 2 ** 32, (1,),
                              generator=_gen("attention", "cpu"),
                              dtype=torch.int64).item())
    return torch.full((1,), value, dtype=torch.int64, device=device)
