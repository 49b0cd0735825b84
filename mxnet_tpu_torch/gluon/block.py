"""Gluon ``Block`` and ``HybridBlock``.

Port of ``mxnet_tpu/gluon/block.py``.  A block is an ``nn.Module`` (so
``.to()``, ``named_parameters()``, ``state_dict()`` and
``parallel.SPMDTrainer`` work on it) with the reference's Gluon surface:
name scopes (``prefix``, ``name``, ``params``, ``name_scope()``), so
``collect_params()`` gives the reference's flat names (``dense0_weight``)
and ``save_parameters`` its structural ones (``features.0.weight``);
``register_child``; forward hooks and pre-hooks with handles;
``initialize(init, ctx)``; ``save_parameters``/``load_parameters``;
``cast``; ``zero_grad``; ``reset_ctx``; ``summary``; and deferred shape
inference: a layer built without a size (``Dense(in_units=0)``) infers
it from its first input (``infer_shape``) and creates its parameters
then.

A Gluon ``Parameter`` assigned to a block (``self.weight =
self.params.get("weight", ...)``) stays the attribute, and its tensor is
registered under the same name in the module's ``_parameters``: layers
read their tensors from ``self._parameters``.

Called with ``NDArray``s, a block unwraps them, runs its forward under
``torch.enable_grad()`` inside ``autograd.record()`` and under
``torch.no_grad()`` otherwise, and wraps its outputs back into
``NDArray``s; inside such a call the layers follow
``autograd.is_training()`` (BatchNorm's batch statistics and their
commit).  Called with tensors, a block is a plain ``nn.Module``: the
layers follow ``nn.Module.training`` (``SPMDTrainer`` sets ``train()``).

``hybridize()`` makes a ``HybridBlock`` called with NDArrays outside
``autograd.record()`` run through ``_CachedOp``: on the card its forward
is captured as a CUDA graph once per (input shapes and dtypes, training
flag) and replayed (``_GraphProgram``); on the CPU it is the forward
itself.  Under ``record()`` the forward runs imperatively, so torch's
graph records it: a hybridized training step is the fused train step's
(``Trainer.fused_step``), a deliberate difference from the reference,
whose recorded ``CachedOp`` is one tape node.  A forward that a graph
replays fires the block's hooks but not its children's.  The
reference's jit of unhybridized inference (``MXNET_JIT_BY_DEFAULT``) is
not ported: an unhybridized block stays imperative.  ``export``,
``optimize_for`` and ``SymbolBlock`` raise ``MXNetError``.

``trace_scope`` is the reference's trace discipline for the fused step:
recording in the step's training mode, hybridized blocks inlined
(``_no_hybrid``: a graph cannot be captured inside another's capture).
"""
from __future__ import annotations

import contextlib
import gc
import os
import re
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from ..device import resolve_device
from ..ndarray.ndarray import NDArray
from ..ops.registry import _unwrap
from ..optimizer.optimizer import _write
from .parameter import Parameter, ParameterDict, _load_file, generation

__all__ = ["Block", "HybridBlock", "SymbolBlock", "trace_scope"]


def _later(what):
    return MXNetError(f"{what} is not ported yet: the port has no symbolic "
                      "graph; hybridize() runs the forward as a CUDA graph, "
                      "and a later slice of mxnet_tpu_torch brings the "
                      "symbolic surface")


# --------------------------------------------------------------------------- #
# trace state (reference ``_TraceState``, ``trace_scope``, ``_no_hybrid``)
# --------------------------------------------------------------------------- #

class _TraceState(threading.local):
    def __init__(self):
        self.no_hybrid = 0   # >0: hybridized blocks run their forward


_trace_state = _TraceState()


class _no_hybrid:
    """Run every ``HybridBlock`` of this thread imperatively (inside a
    capture or a trace, nested cached blocks are inlined, as the
    reference inlines child graphs into the parent's)."""

    def __enter__(self):
        _trace_state.no_hybrid += 1
        return self

    def __exit__(self, *a):
        _trace_state.no_hybrid -= 1


@contextlib.contextmanager
def trace_scope(training):
    """The fused step's trace discipline: ops record (in ``training``
    mode) so the backward can follow them, and hybridized blocks are
    inlined.  The reference stages aux-state updates here; the port's
    layers commit them in place (BatchNorm's ``copy_``), which a graph
    replays."""
    from .. import autograd

    with autograd.record(train_mode=training), _no_hybrid():
        yield


def _launch_counts():
    """The launch counts of the port's kernel wrappers (K1-K6) and of the
    runtime-compiled kernels (K7); host counters, raised at a launch, so
    a graph's capture raises them and its replays do not."""
    from .. import rtc
    from ..ops.attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from ..ops.conv_fused import conv1x1_bwd_pair
    from ..ops.decode_fused import decode_step
    from ..ops.q8_matvec import q8_matvec

    return {"flash_fwd": flash_fwd.launches,
            "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches,
            "q8_matvec": q8_matvec.launches,
            "decode_fused": decode_step.launches,
            "conv1x1_bwd": conv1x1_bwd_pair.launches,
            "rtc": rtc.launch_total()}


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic garbage collector held off: a collection inside a
    capture can free a dead program's graph, and destroying a graph
    while a stream captures invalidates the capture (PyTorch no longer
    collects before a capture)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _GraphProgram:
    """``fn()`` (a list of tensors out, reading and writing static
    tensors) as one program: the CPU runs ``fn`` at every call; on the
    card call 1 runs it eagerly on a side stream (PyTorch's warm-up: the
    deferred shapes, optimizer states, library handles and kernels'
    first-use set-up, such as K4's scratch, which is kept per stream),
    call 2 captures it on the same stream into a ``torch.cuda.CUDAGraph``
    (in ``pool``) and replays it once, later calls replay it (every call
    replays once a graph exists, made by ``_capture`` ahead of the calls
    after a warm-up of the caller's).  So each call does ``fn``'s work
    exactly once.  A replay overwrites the outputs, so the card's calls
    return clones.

    ``key`` is the program's PRNG key operand (reference ``CachedOp``'s
    key argument): a one-element integer tensor the caller writes before
    each call, or a function that picks it on the device inside the
    program.  ``run()`` (every call, and the eager arm a test compares
    with) runs ``fn`` with it pushed (``random.trace``), so each random
    draw in ``fn`` derives its seed from the key on the device; the
    device generators the eager call drew from are registered with the
    graph, so every replay advances them.

    ``inputs`` are the static tensors a caller copies its arguments
    into.  ``launches`` holds what the capture added to
    ``_launch_counts()``: the kernels one replay launches (the counters
    do not see replays).  With ``debug`` set before the capture the
    graph keeps its nodes for ``graph.debug_dump`` (``kernel_nodes``
    reads them).  ``recorded`` holds what every capture (kept, failed
    or read for its nodes) added to the counters.  ``error_mode`` is
    ``torch.cuda.graph``'s ``capture_error_mode``: ``"thread_local"``
    lets other threads use the card while this one captures (a server's
    scheduler thread).  A capture that fails leaves no graph, restores
    the caller's stream and hands its memory pool to the next capture,
    so a caller may run ``run()`` instead and capture again later.
    ``stream`` is the side stream of the warm-up and the captures
    (default: a new one at the first call); programs that share one
    share what is kept per stream (K4's scratch, the allocator's cached
    blocks).  ``watch`` is the telemetry capture watch
    (``telemetry.instrument_program``): told of the first call on the
    CPU and of each kept capture on the card."""

    debug = False

    def __init__(self, fn, device, pool, inputs, key=None,
                 error_mode="global", stream=None):
        self.fn = fn
        self.on_card = torch.device(device).type == "cuda"
        self.pool = pool
        self.inputs = inputs
        self.key = key
        self.error_mode = error_mode
        self.generators: list = []
        self.draws = None
        self.is_seq = False
        self.calls = 0
        self.replays = 0
        self.graph = None
        self.graph_debug = False
        self.outs = None
        self.launches = {}
        self.recorded = {}
        self.capture_s = None
        self.stream = stream        # the warm-up's, then the captures'
        self.watch = None

    def run(self, capturing=False):
        """``fn()`` with the program's key pushed; outside a capture it
        records the generators and keyed draws ``fn`` made."""
        if self.key is None:
            return self.fn()
        key = self.key() if callable(self.key) else self.key
        with _random.trace(key, self.generators if capturing else ()) as tr:
            outs = self.fn()
        if not capturing:
            self.generators, self.draws = tr.generators, tr.draws
        return outs

    def __call__(self):
        self.calls += 1
        if not self.on_card:
            if self.calls == 1 and self.watch is not None:
                return self.watch.first_call(self)
            return self.run()
        if self.calls == 1 and self.graph is None:
            cur = torch.cuda.current_stream()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            side = self.stream
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                outs = self.run()
            cur.wait_stream(side)
            for o in outs:
                o.record_stream(cur)
            return outs
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return [o.clone() for o in self.outs]

    def kernel_nodes(self):
        """``{kernel name: count}`` of the kernel nodes one replay
        launches, from ``CUDAGraph.debug_dump``: each kernel node's label
        holds ``{ID | n (topoId: m) | <mangled name>\\<\\<\\<``.  A graph
        captured with ``debug`` set is read itself; otherwise ``fn`` is
        captured again with its nodes kept, into a graph that is never
        replayed (a capture records and runs nothing), and that one is
        read.  The counters of ``_launch_counts()`` rise by one capture."""
        import tempfile

        g = self.graph if self.graph is not None and self.graph_debug \
            else self._record(debug=True)[0]
        with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
            # torch announces every dump with a UserWarning
            warnings.simplefilter("ignore", UserWarning)
            path = os.path.join(d, "graph.dot")
            g.debug_dump(path)
            with open(path) as fh:
                text = fh.read()
        every: dict = {}
        for k in re.findall(
                r"\{ID \| \d+(?: \(topoId: \d+\))? \| ([^|}\\<]+)", text):
            k = k.strip()
            every[k] = every.get(k, 0) + 1
        return every

    def _record(self, debug):
        """``fn`` captured into a new graph in ``pool``, with its nodes
        kept for ``debug_dump`` if ``debug``; returns the graph and the
        outputs."""
        keep = False
        if debug:
            try:
                g = torch.cuda.CUDAGraph(keep_graph=True)
                keep = True
            except TypeError:           # an older PyTorch
                g = torch.cuda.CUDAGraph()
                g.enable_debug_mode()
        else:
            g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        cur = torch.cuda.current_stream()
        before = _launch_counts()
        try:
            with _no_collection(), torch.cuda.graph(
                    g, pool=self.pool, stream=self.stream,
                    capture_error_mode=self.error_mode):
                outs = self.run(capturing=True)
        except BaseException:
            # an invalidated capture raises at its end, before the graph
            # context restores the stream; the failed graph never frees
            # its pool, so the next capture allocates from it
            torch.cuda.set_stream(cur)
            if self.pool is None:
                self.pool = g.pool()
            raise
        finally:
            for k, v in _launch_counts().items():
                if v != before[k]:
                    self.recorded[k] = self.recorded.get(k, 0) + v - before[k]
        if keep:
            g.instantiate()
        return g, outs

    def _capture(self, debug=None):
        """Capture the program's graph (with its nodes kept when
        ``debug``, by default the class's ``debug``)."""
        debug = self.debug if debug is None else debug
        before = _launch_counts()
        t0 = time.perf_counter()
        self.graph, self.outs = self._record(debug)
        self.capture_s = time.perf_counter() - t0
        self.graph_debug = debug
        self.launches = {k: v - before[k] for k, v in
                         _launch_counts().items() if v != before[k]}
        if self.watch is not None:
            self.watch.captured(self)


# --------------------------------------------------------------------------- #
# naming scope (reference ``_BlockScope``)
# --------------------------------------------------------------------------- #

class _BlockScope:
    _current = threading.local()
    _global_counter: dict = {}

    def __init__(self, block):
        self._block = block
        self._counter: dict = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        """(prefix, ParameterDict) of a new block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                _BlockScope._global_counter[hint] = count + 1
                prefix = f"{hint}{count}_"
            params = ParameterDict(prefix) if params is None else \
                ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        full_prefix = current._block.prefix + prefix
        params = ParameterDict(full_prefix) if params is None else \
            ParameterDict(params.prefix, params)
        return full_prefix, params

    def __enter__(self):
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *a):
        _BlockScope._current.value = self._old


def _classname_hint(name):
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and not name[i - 1].isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out).replace("_", "")


class _HookHandle:
    _next_id = [0]

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1
        hooks[self._id] = hook

    def detach(self):
        self._hooks.pop(self._id, None)

    remove = detach


# the training flag of the innermost call made with NDArrays (None
# outside one: layers then follow nn.Module.training)
_MODE = threading.local()


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


# --------------------------------------------------------------------------- #
# Block
# --------------------------------------------------------------------------- #

class Block(nn.Module):
    """Base container (reference ``Block``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        hint = _classname_hint(type(self).__name__)
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._mx_hooks: OrderedDict = OrderedDict()
        self._mx_pre_hooks: OrderedDict = OrderedDict()
        self._ready = False     # every own parameter created

    # -- naming ----------------------------------------------------------- #
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """``with self.name_scope():`` children and parameters made inside
        are named under this block's prefix."""
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def _children(self):
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if isinstance(m, Block))

    # -- registration ----------------------------------------------------- #
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            self._parameters.pop(name, None)
            self._modules.pop(name, None)
            object.__setattr__(self, name, value)
            reg[name] = value
            value._attach(self, name)
            self._ready = False
            return
        if reg is not None and name in reg:
            del reg[name]
            self._parameters.pop(name, None)
            object.__delattr__(self, name)
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after every forward; returns a
        handle with ``detach()``."""
        return _HookHandle(self._mx_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before every forward."""
        return _HookHandle(self._mx_pre_hooks, hook)

    # -- parameter management --------------------------------------------- #
    def _place(self, device):
        """Create this block's parameters now if every shape is known:
        on ``device``, else on the current context.  A block with a size
        left to infer waits for its first forward (``initialize`` then
        creates the others on its ``ctx``); given a ``device`` it is
        built at once, so it needs every size."""
        todo = [p for p in self._reg_params.values() if p._data is None]
        unknown = [p for p in todo if not all(p.shape or (0,))]
        if unknown:
            if device is not None:
                raise MXNetError(
                    f"{type(self).__name__}: parameter {unknown[0].name} "
                    f"has unknown shape {unknown[0].shape}; a block built "
                    "with device= creates its parameters at once and needs "
                    "every size: give it, or leave device out for deferred "
                    "shape inference at the first forward")
            return
        if todo:
            dev = resolve_device(device) if device is not None else \
                current_context().torch_device()
            for p in todo:
                p._create(dev)

    def collect_params(self, select=None) -> ParameterDict:
        """Every parameter of the subtree by its flat name, optionally
        those matching the regex ``select`` (reference
        ``collect_params('.*weight')``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Structural names (``features.0.weight``), those of
        ``save_parameters`` and of ``named_parameters()``."""
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Initialize every parameter (``ParameterDict.initialize``) on
        ``ctx`` (default the current context, ``gpu(0)``); ``seed`` draws
        from generators of that seed instead of ``mx.random``'s.
        Returns ``self``."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         seed=seed)
        return self

    def save_parameters(self, filename, deduplicate=False):
        """The reference's ``.params`` file, by structural name."""
        from ..ndarray import serialization

        arrays, seen = {}, set()
        for name, p in self._collect_params_with_prefix().items():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            arrays[name] = p.data()
        serialization.save(filename, arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file by structural name, or by flat name
        (one that ``ParameterDict.save`` wrote).  Arrays take each
        parameter's dtype, unless ``cast_dtype`` with ``dtype_source=
        "saved"``, where the parameters take the file's."""
        loaded = _load_file(filename)
        params = self._collect_params_with_prefix()
        cast = cast_dtype and dtype_source == "saved"
        if not any("." in k for k in loaded) and \
                any("." in k for k in params):
            params = {p.name: p for p in params.values()}
        for name, p in params.items():
            if name in loaded:
                p._load_init(loaded[name], ctx, cast_dtype=cast)
            elif not allow_missing:
                raise MXNetError(f"missing parameter {name} in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra parameters in {filename}: "
                                 f"{sorted(extra)}")

    def cast(self, dtype):
        """Convert every parameter (running statistics included) to
        ``dtype``; returns ``self``."""
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        return self

    def zero_grad(self, set_to_none=True):
        """Zero every parameter's ``grad()`` (and clear the tensors'
        ``.grad``, as ``nn.Module.zero_grad`` does)."""
        self.collect_params().zero_grad()
        super().zero_grad(set_to_none)

    def reset_ctx(self, ctx):
        self.collect_params().reset_ctx(ctx)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print each block with its parameter count (reference
        ``Block.summary``)."""
        rows = []

        def walk(block, depth):
            n = sum(int(np.prod(p.shape)) for p in block._reg_params.values()
                    if p.shape and all(s > 0 for s in p.shape))
            rows.append(("  " * depth + type(block).__name__, block.name, n))
            for c in block._children.values():
                walk(c, depth + 1)

        walk(self, 0)
        lines = [f"{'Layer':<40}{'Name':<30}{'Params':>12}", "-" * 82]
        lines += [f"{r[0]:<40}{r[1]:<30}{r[2]:>12}" for r in rows]
        lines += ["-" * 82,
                  f"{'Total params:':<70}{sum(r[2] for r in rows):>12}"]
        print("\n".join(lines))

    # -- forward ----------------------------------------------------------- #
    def _is_training(self):
        """``autograd.is_training()`` inside a call made with NDArrays,
        else ``nn.Module.training``."""
        mode = getattr(_MODE, "training", None)
        return self.training if mode is None else mode

    def infer_shape(self, *args):
        raise MXNetError(
            f"{type(self).__name__} has deferred-init parameters but no "
            "infer_shape; give explicit in_units/in_channels or override "
            "infer_shape")

    def _prepare(self, args):
        """Create the parameters whose shapes wait on the first input."""
        if any(p._data is None for p in self._reg_params.values()):
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
        self._ready = True

    def _cached(self, args, kwargs):
        return False

    def __call__(self, *args, **kwargs):
        for hook in self._mx_pre_hooks.values():
            hook(self, args)
        if self._cached(args, kwargs):
            out = self._call_cached_op(args)
        elif any(isinstance(a, NDArray) for a in args):
            out = self._call_nd(args, kwargs)
        else:
            if not self._ready:
                self._prepare(args)
            out = super().__call__(*args, **kwargs)
        for hook in self._mx_hooks.values():
            hook(self, args, out)
        return out

    def _call_nd(self, args, kwargs):
        from .. import autograd

        return _wrap(self._run_nd(
            [_unwrap(a) for a in args],
            {k: _unwrap(v) for k, v in kwargs.items()},
            autograd.is_training(), autograd.is_recording()))

    def _run_nd(self, tensors, kwargs, training, recording):
        """The forward of a call made with NDArrays, on their tensors."""
        prev = getattr(_MODE, "training", None)
        _MODE.training = training
        try:
            with torch.enable_grad() if recording else torch.no_grad():
                if not self._ready:
                    self._prepare(tensors)
                out = nn.Module.__call__(self, *tensors, **kwargs)
        finally:
            _MODE.training = prev
        return out


class HybridBlock(Block):
    """A block that can be hybridized (reference ``HybridBlock``): once
    ``hybridize()``d, a call with NDArrays outside ``autograd.record()``
    runs through ``_CachedOp``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _cached(self, args, kwargs):
        return (self._active and not kwargs and bool(args) and
                not _trace_state.no_hybrid and
                all(isinstance(a, NDArray) for a in args))

    def _call_cached_op(self, args):
        if self._cached_op is None:
            self._cached_op = _CachedOp(self, self._flags)
        return self._cached_op(args)

    def export(self, path, epoch=0, remove_amp_cast=True):
        raise _later("HybridBlock.export (symbol.json + .params)")

    def optimize_for(self, x, *args, backend=None, **kwargs):
        raise _later("HybridBlock.optimize_for")


class _CachedOp:
    """A hybridized block's forward as one program (reference
    ``CachedOp``), keyed by (input shapes and dtypes, training flag).

    Outside ``autograd.record()`` on the card each key's forward is a
    ``_GraphProgram`` over static inputs: the call's arrays are copied in,
    the graph replayed, the outputs cloned (its eager first call also
    infers deferred shapes).  Every program reads one key word (the
    reference's per-call key operand), written before a call from
    ``random.next_key()`` while the program draws from it, so a dropout
    in the forward draws a fresh mask at every replay.  On the CPU the
    forward runs directly (the keys are still counted in ``builds``).
    Under ``record()`` the forward runs imperatively.  A move of the
    parameters' storage generation (``parameter.generation()``:
    ``cast``, ``load_parameters``, ``reset_ctx``, deferred init) drops
    every program, so the next call captures again."""

    def __init__(self, block, flags=None):
        self._block = block
        self._flags = dict(flags or {})
        self._programs = {}
        self._generation = None
        self._pool = None
        self._key_word = None
        self.builds = 0

    def _key(self, tensors, training):
        return (tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
                training)

    def __call__(self, args):
        from .. import autograd

        block = self._block
        if autograd.is_recording():
            return block._call_nd(args, {})
        tensors = [a._data for a in args]
        if self._generation != generation():
            self._programs.clear()
            self._generation = generation()
        training = autograd.is_training()
        key = self._key(tensors, training)
        if key not in self._programs:
            self._programs[key] = self._program(tensors, training)
            self.builds += 1
        prog = self._programs[key]
        if prog is None:        # the CPU: the forward itself
            return block._call_nd(args, {})
        for s, t in zip(prog.inputs, tensors):
            s.copy_(t)
        if prog.draws != 0:     # unknown before the first call
            _write(self._key_word, [], [_random.next_key()])
        outs = prog()
        if prog.graph is None:
            # the eager first call may have created deferred parameters;
            # the capture, next, reads them as they now are
            self._generation = generation()
        return _wrap(list(outs) if prog.is_seq else outs[0])

    def _program(self, tensors, training):
        device = tensors[0].device
        if device.type != "cuda":
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._key_word = torch.zeros(1, device=device)
        block = self._block
        static = [torch.empty_like(t) for t in tensors]

        def fn():
            with _no_hybrid():
                out = block._run_nd(static, {}, training, False)
            prog.is_seq = isinstance(out, (tuple, list))
            return list(out) if prog.is_seq else [out]

        prog = _GraphProgram(fn, device, self._pool, static,
                             key=self._key_word.view(torch.int32))
        return prog


class SymbolBlock(HybridBlock):
    """The reference's block over a Symbol graph."""

    def __init__(self, outputs, inputs, params=None, prefix=None):
        raise _later("SymbolBlock (the port has no symbolic graph)")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise _later("SymbolBlock.imports")
