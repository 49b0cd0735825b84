"""Autograd over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py``.  The reference keeps its own
tape of ``jax.vjp`` closures; here the tape is torch's graph.  What the
port keeps of MXNet's semantics:

- thread-local ``record``/``pause`` and ``train_mode``/``predict_mode``
  flags; ops reach the graph only inside ``record()``
  (``ops.registry.invoke``);
- ``backward`` seeds every head with ones, whatever its shape, unless a
  head gradient is given; gradients land in each variable's persistent
  ``.grad`` following its ``grad_req`` (``ndarray._leaf``);
- ``retain_graph=False`` frees the graph: a second ``backward`` through
  it raises ``MXNetError`` (the reference's ``_FreedGraph``), and every
  array the backward reached, heads and intermediates alike, enters
  later ops as a constant;
- ``grad`` returns gradients without touching ``.grad``;
  ``create_graph=True`` raises, as in the reference;
- ``Function``: user forward and backward on NDArrays, bridged by a
  ``torch.autograd.Function``.

``get_symbol`` raises as in the reference.  ``trace_value_and_grad``
gives the fused train step its forward, loss and gradients without
touching any ``.grad``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function", "get_symbol", "trace_value_and_grad",
]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(flag: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    st = _st()
    prev, st.training = st.training, bool(flag)
    return prev


class _ScopeCtx:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode: bool = True):
    """``with autograd.record():`` — turn on recording (+training mode)."""
    return _ScopeCtx(True, train_mode)


def pause(train_mode: bool = False):
    return _ScopeCtx(False, train_mode)


def train_mode():
    return _ScopeCtx(None, True)


def predict_mode():
    return _ScopeCtx(None, False)


_FREED = ("graph already freed: call backward(retain_graph=True) to "
          "backprop through the same graph twice")


def _seeds(heads, head_grads):
    """The heads that reach the graph, with their head gradients (ones
    where none is given, whatever the head's shape)."""
    from .ndarray.ndarray import NDArray

    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    else:
        head_grads = list(head_grads)
    if len(head_grads) != len(heads):
        raise MXNetError("heads and head_grads length mismatch")
    outs, seeds = [], []
    for h, g in zip(heads, head_grads):
        if h._freed:
            raise MXNetError(_FREED)
        t = h._data
        if not t.requires_grad:
            continue
        outs.append(t)
        seeds.append(torch.ones_like(t) if g is None
                     else g._data.to(device=t.device, dtype=t.dtype))
    return heads, outs, seeds


# whether the backward running now keeps its graph.  Read by
# ``_Bridge.backward``, which torch may run on its own device thread, so
# it is process-wide rather than thread-local.
_retaining = False
# whether a backward of this module is running: an adopted parameter's
# hook (``ndarray._leaf``) hands its gradient to ``.grad`` only then
_in_backward = False


def _run(fn, heads, retain_graph):
    global _retaining
    prev, _retaining = _retaining, retain_graph
    try:
        res = fn()
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError(_FREED) from e
        raise
    finally:
        _retaining = prev
    if not retain_graph:
        _free(heads)
    return res


def _free(heads):
    """Mark freed every recorded array whose producing node the backward
    from ``heads`` reached, as the reference marks each node it consumed:
    the heads, and the intermediates still alive (``ndarray._RECORDED``)."""
    from .ndarray.ndarray import _RECORDED

    roots = []
    for h in heads:
        if h._data.grad_fn is not None:
            h._freed = True
            roots.append(h._data.grad_fn)
            _RECORDED.pop(id(h), None)
    # valuerefs() copies in one step: safe against another thread
    # recording while this one walks
    live = [a for a in (r() for r in _RECORDED.valuerefs())
            if a is not None]
    if not roots or not live:
        return
    seen, stack = set(), roots
    while stack:
        fn = stack.pop()
        if fn not in seen:
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions if f is not None)
    for a in live:
        if a._data.grad_fn in seen:
            a._freed = True
            _RECORDED.pop(id(a), None)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """``mx.autograd.backward`` — gradients land in each variable's
    ``.grad``."""
    global _in_backward
    heads, outs, seeds = _seeds(heads, head_grads)
    if not outs:
        return
    prev, _in_backward = _in_backward, True
    try:
        with pause(train_mode=train_mode):
            _run(lambda: torch.autograd.backward(outs, seeds,
                                                 retain_graph=retain_graph),
                 heads, retain_graph)
    finally:
        _in_backward = prev


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """``mx.autograd.grad`` — the gradients of ``heads`` with respect to
    ``variables`` (leaves or intermediates), leaving ``.grad`` as it
    is.  ``create_graph`` (higher order) raises, as in the reference."""
    from .ndarray.ndarray import NDArray

    if create_graph:
        raise MXNetError("create_graph=True (higher-order grad) is not "
                         "supported")
    single = isinstance(variables, NDArray)
    targets = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    heads, outs, seeds = _seeds(heads, head_grads)
    live = [t for t in targets if t._data.requires_grad]
    got = []
    if outs and live:
        with pause(train_mode=train_mode):
            got = _run(lambda: torch.autograd.grad(
                outs, [t._data for t in live], seeds,
                retain_graph=retain_graph, allow_unused=True),
                heads, retain_graph)
    by_id = {id(t): g for t, g in zip(live, got)}
    res = []
    for t in targets:
        g = by_id.get(id(t))
        res.append(NDArray(g.detach() if g is not None
                           else torch.zeros_like(t._data.detach())))
    return res[0] if single else res


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make arrays variables with the given gradient buffers (reference
    ``MXAutogradMarkVariables``)."""
    from .ndarray.ndarray import NDArray, _leaf

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        if r not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {r}")
        v._grad = g
        v._grad_req = r
        v._freed = False
        v._data = _leaf(v._data, v) if r != "null" else v._data.detach()


def trace_value_and_grad(fn, params, frozen_params=(), train_mode=True):
    """The fused train step's forward and backward (reference
    ``trace_value_and_grad``): returns ``pure(train_vals, frozen_vals,
    *args) -> (outs, grads, new_frozen)``.

    - ``fn`` is NDArray-level user code (``lambda x, y: loss(net(x),
      y)``) returning the per-sample loss or a sequence whose first
      element is the loss; the extras ride along undifferentiated.
    - ``params``/``frozen_params`` are the Gluon ``Parameter``s whose
      values ``train_vals``/``frozen_vals`` give.  In the port a value is
      the parameter's own tensor (a captured graph reads that storage);
      another tensor is copied into it first.
    - ``fn`` runs under ``gluon.block.trace_scope`` (recording, in
      ``train_mode``, hybridized blocks inlined), and the gradient is
      ``torch.autograd.grad`` of ``sum(outs[0])``, the seeding of
      ``loss.backward()``.  The ``Parameter.grad()`` buffers and the
      tensors' ``.grad`` are never touched: no gradient is accumulated,
      so the leaves' hooks do not fire.
    - ``new_frozen`` are the frozen parameters' tensors after the call
      (BatchNorm commits its running statistics into them in place).
    - ``pure.out_struct['is_seq']`` says whether ``fn`` returned a
      sequence.
    """
    from .gluon.block import trace_scope
    from .ndarray.ndarray import NDArray

    params = list(params)
    frozen = list(frozen_params)
    struct: dict = {}

    def take(ps, vals):
        for p, v in zip(ps, vals):
            leaf = p._data._data
            if v is not leaf:
                with torch.no_grad():
                    leaf.copy_(v)

    def pure(train_vals, frozen_vals, *args):
        take(params, train_vals)
        take(frozen, frozen_vals)
        leaves = [p._data._data for p in params]
        with trace_scope(train_mode):
            out = fn(*(a if isinstance(a, NDArray) else NDArray(a)
                       for a in args))
        is_seq = isinstance(out, (tuple, list))
        struct["is_seq"] = is_seq
        outs = [o._data if isinstance(o, NDArray) else o
                for o in (out if is_seq else [out])]
        head = outs[0]
        got = torch.autograd.grad(head.sum(), leaves, allow_unused=True) \
            if head.requires_grad else [None] * len(leaves)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, got)]
        return (tuple(o.detach() for o in outs), grads,
                [p._data._data for p in frozen])

    pure.out_struct = struct
    return pure


def get_symbol(x):
    """The reference returns the recorded Symbol; the port has no
    symbolic graph."""
    raise MXNetError("get_symbol: tape-to-symbol export is not supported")


# --------------------------------------------------------------------------- #
# Custom Function
# --------------------------------------------------------------------------- #

class _Bridge(torch.autograd.Function):
    """Runs a ``Function``'s forward and backward on NDArrays inside
    torch's graph."""

    @staticmethod
    def forward(ctx, func, is_nd, *args):
        from .ndarray.ndarray import NDArray

        ins = [NDArray(a) if nd else a for a, nd in zip(args, is_nd)]
        with pause(train_mode=is_training()):
            out = func.forward(*ins)
        ctx.func, ctx.is_nd = func, is_nd
        ctx.multi = isinstance(out, (tuple, list))
        outs = list(out) if ctx.multi else [out]
        return tuple(o._data for o in outs) if ctx.multi else outs[0]._data

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        func = ctx.func
        if func is None:
            raise MXNetError(_FREED)
        if not _retaining:
            # free the Function's state (a custom op's buffers) with the
            # graph, as torch frees saved tensors
            ctx.func = None
        with pause():
            res = func.backward(*(NDArray(g) for g in grads))
        res = res if isinstance(res, (tuple, list)) else (res,)
        it = iter(res)
        in_grads = []
        for nd in ctx.is_nd:
            g = next(it, None) if nd else None
            in_grads.append(g._data if isinstance(g, NDArray) else g)
        return (None, None, *in_grads)


class Function:
    """User-defined differentiable function with an explicit backward
    (reference ``mx.autograd.Function``)."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        is_nd = tuple(isinstance(a, NDArray) for a in inputs)
        args = [a._data.detach() if nd and a._freed else
                a._data if nd else a for a, nd in zip(inputs, is_nd)]
        with torch.enable_grad():
            res = _Bridge.apply(self, is_nd, *args)
        if isinstance(res, tuple):
            return [NDArray(r) for r in res]
        return NDArray(res)
