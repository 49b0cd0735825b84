"""Random state of the port: ``seed``, one ``torch.Generator`` per
device, a program's traced key, and ``mx.random``'s user functions.

Counterpart of ``mxnet_tpu/random.py`` (``seed``, ``current_seed``,
``get_state``/``set_state``, ``push_trace_key``, ``pop_trace_key``,
``next_key`` and the draws ``uniform`` ... ``shuffle``).  JAX's threefry
keys have no torch equivalent, so the streams differ from the
reference's; what is shared is the contract that one ``seed(n)`` fixes
every draw after it, that ``set_state(get_state())`` resumes every
stream where it was, and that a compiled program takes a fresh key as
an operand at every call.

The user draws (``uniform``, ``normal``, ``randn``, ``randint``,
``gamma``, ``exponential``, ``poisson``, ``bernoulli``, ``multinomial``,
``shuffle``) call the registered ops of ``ops/samplers.py``, as the
reference's do, and keep its ``ctx=``/``out=``/``dtype=`` rules: a draw
with scalar parameters is made on ``ctx`` (default: the current
context), one with NDArray parameters on their device.  Every draw takes
one ``next_key()`` and is counter-based: value ``i`` of sub-stream ``s``
is a hash of the key and ``i`` (``key_bits``), so a draw under a trace
derives from the program's key (fresh at every replay, equal to the
eager call under the same key) and the same seed gives the same bits on
the CPU and on the card.

- ``generator(device)``: the generator ``Dropout`` draws its masks from,
  one per device, on that device.  A CUDA graph that draws from it
  registers it (``CUDAGraph.register_generator_state``; ``gluon.block.
  _GraphProgram`` does), so each replay advances it and draws a fresh
  mask; ``seed`` reseeds it in place, so a graph keeps reading the
  generator it registered.
- ``next_key()``: outside a trace, a uint32 from a host generator of its
  own, returned as a Python int: the key a program gets as an operand.
- ``key_uniform(n, device)``: ``n`` uniform f32 draws in [0, 1) from
  one fresh ``next_key()``, counter-based (draw ``i`` hashes the key with
  ``i``), so the same key gives the same draws on any device and under
  a trace (the ``mx.nd.image`` random ops, one draw an image).
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

__all__ = ["seed", "current_seed", "get_state", "set_state", "generator",
           "attention_seed", "next_key", "key_bits", "key_uniform",
           "push_trace_key", "pop_trace_key", "trace", "uniform",
           "normal", "randn", "randint", "gamma", "exponential",
           "poisson", "bernoulli", "multinomial", "shuffle"]

_M32 = 0xFFFFFFFF
_state = threading.local()


def _root():
    if not hasattr(_state, "seed"):
        # unseeded: a per-process draw, as the reference's lazy root key
        _reseed(int(np.random.randint(0, 2 ** 31 - 1)))
        _state.seed_val = None
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


def _reseed(root):
    _state.seed = int(root)
    gens = _state.__dict__.setdefault("gens", {})
    for name, g in gens.items():
        g.manual_seed(_seed_of(name))


def seed(seed_state, ctx="all") -> None:
    """``mx.random.seed``: every generator restarts from ``seed_state``
    (the device generators in place, so the graphs that registered them
    follow).  ``ctx`` is accepted and, as in the reference, every
    device's streams are reseeded."""
    _reseed(seed_state)
    _state.seed_val = int(seed_state)


def current_seed():
    """The last ``seed()`` value; None before any (the lazy root)."""
    return _root().seed_val


def _gen_key(text):
    return text if text in ("attention", "key") else torch.device(text)


def get_state():
    """A snapshot of the calling thread's streams (the ``mx.checkpoint``
    RNG capture): the seed, the root every stream derives from and each
    generator's state (a CUDA generator's holds its seed and offset).
    The trace-key stack is left out, as in the reference: it exists only
    while a program runs, and traced draws read the program's key."""
    st = _root()
    return {"seed": st.seed_val, "root": st.seed,
            "generators": {str(k): g.get_state().clone()
                           for k, g in st.gens.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot: the key stream, the device
    generators (in place, so the graphs that registered them follow) and
    the seed continue exactly where the snapshot was taken.  A generator
    made after the snapshot restarts as it would have at its first use."""
    st = _root()
    st.seed = int(state["root"])
    st.seed_val = state.get("seed")
    saved = {_gen_key(k): v for k, v in state["generators"].items()}
    for name in saved:
        if name not in st.gens:
            _gen(name, "cpu" if isinstance(name, str) else name)
    for name, g in st.gens.items():
        if name in saved:
            g.set_state(saved[name])
        else:
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


def key_bits(key, n: int, device="cpu", stream: int = 0):
    """``n`` uint32 values (held in int64) of sub-stream ``stream`` of
    ``key`` (a ``next_key()``: a Python int or a device word): value
    ``i`` is ``_derive(word, i)``, where sub-stream 0's word is the key
    and sub-stream ``s``'s is ``_derive(key, 2**32 - s)``, an index no
    draw reaches.  Integer ops only: the same on every device."""
    if isinstance(key, torch.Tensor):
        word = key.reshape(1).to(device=device, dtype=torch.int64)
    else:
        word = torch.full((1,), int(key) & _M32, dtype=torch.int64,
                          device=device)
    if stream:
        word = _derive(word, _M32 + 1 - stream)
    return _derive(word, torch.arange(n, dtype=torch.int64, device=device))


def key_uniform(n: int, device="cpu"):
    """``n`` f32 draws in [0, 1) from one ``next_key()``: the top 24 bits
    of the key's hash with each draw's index (``_derive``), times
    2**-24."""
    bits = key_bits(next_key(), n, device)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


# --------------------------------------------------------------------------- #
# mx.random's user functions (reference ``random.py:120-240``): each calls
# the registered op of ops/samplers.py the reference's calls
# --------------------------------------------------------------------------- #

def _is_nd(x):
    from .ndarray.ndarray import NDArray
    return isinstance(x, NDArray)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _on(ctx):
    """The context a scalar-parameter draw is made on."""
    from .context import current_context
    return ctx if ctx is not None else current_context()


def _out(r, out):
    if out is not None:
        return out._rebind(r._data)
    return r


def _draw(op_name, nd_name, nd_args, scalars, shape, dtype, ctx, out):
    from .ops import samplers as _s

    if any(_is_nd(a) for a in nd_args):
        r = getattr(_s, nd_name)(*nd_args, shape=_shape(shape),
                                 dtype=dtype or "float32")
        if ctx is not None:
            r = r.as_in_context(ctx)
    else:
        with _on(ctx):
            r = getattr(_s, op_name)(shape=_shape(shape),
                                     dtype=dtype or "float32", **scalars)
    return _out(r, out)


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None):
    return _draw("_random_uniform", "sample_uniform", (low, high),
                 dict(low=_f(low), high=_f(high)), shape, dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None):
    return _draw("_random_normal", "sample_normal", (loc, scale),
                 dict(loc=_f(loc), scale=_f(scale)), shape, dtype, ctx, out)


def randn(*shape, dtype="float32", ctx=None):
    return normal(0.0, 1.0, shape or (1,), dtype=dtype, ctx=ctx)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    from .ops import samplers as _s

    with _on(ctx):
        r = _s._random_randint(low=int(low), high=int(high),
                               shape=_shape(shape), dtype=dtype or "int32")
    return _out(r, out)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None):
    return _draw("_random_gamma", "sample_gamma", (alpha, beta),
                 dict(alpha=_f(alpha), beta=_f(beta)), shape, dtype, ctx,
                 out)


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None,
                out=None):
    """Draws with mean ``scale``: the ops take the rate, ``1 / scale``
    (reference ``random.py:164-176``)."""
    rate = 1.0 / scale if _is_nd(scale) else None
    return _draw("_random_exponential", "sample_exponential", (rate,),
                 dict(lam=None if rate is not None else 1.0 / float(scale)),
                 shape, dtype, ctx, out)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _draw("_random_poisson", "sample_poisson", (lam,),
                 dict(lam=_f(lam)), shape, dtype, ctx, out)


def _f(x):
    return None if _is_nd(x) else float(x)


def bernoulli(prob=0.5, shape=(1,), dtype="float32", ctx=None, out=None):
    """1 with probability ``prob``: key bit word ``i`` below
    ``prob * 2**32`` (exact integer compare, the same on every
    device)."""
    from .base import torch_dtype
    from .ndarray.ndarray import NDArray

    dev = _on(ctx).torch_device()
    n = int(np.prod(_shape(shape)))
    bits = key_bits(next_key(), n, dev)
    limit = min(max(int(round(float(prob) * 2.0 ** 32)), 0), 2 ** 32)
    r = NDArray((bits < limit).to(torch_dtype(dtype or "float32"))
                .reshape(_shape(shape)))
    return _out(r, out)


def multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Draws from the categorical distributions in the last axis of
    ``data`` (probabilities): ``shape`` draws a row (an int, or a tuple
    whose product is the count), the draw axis squeezed for ``shape=1``.
    With ``get_prob`` also the log of each drawn entry's probability."""
    from .base import torch_dtype
    from .ndarray.ndarray import NDArray
    from .ops.samplers import categorical

    n = shape if isinstance(shape, int) else int(np.prod(shape))
    p = data._data
    s = categorical(next_key(), p, n)
    logp = torch.log(torch.gather(
        p.reshape(-1, p.shape[-1]), 1,
        s.reshape(-1, n))).reshape(s.shape) if get_prob else None
    if shape == 1 and s.shape[-1] == 1:
        s = s[..., 0]
        logp = logp[..., 0] if logp is not None else None
    samp = NDArray(s.to(torch_dtype(dtype)))
    return (samp, NDArray(logp)) if get_prob else samp


def shuffle(data, **kwargs):
    """``data`` with its first axis permuted: the permutation sorts
    ``bits * n + i`` (distinct keys, so the same order on every
    device)."""
    from .ndarray.ndarray import NDArray

    x = data._data
    n = x.shape[0]
    bits = key_bits(next_key(), n, x.device)
    order = torch.argsort(bits * n + torch.arange(n, device=x.device))
    return NDArray(x[order])


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
