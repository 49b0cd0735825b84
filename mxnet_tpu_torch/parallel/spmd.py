"""The performance-path trainer: ``step(data, label)`` runs forward, the
mean loss, backward and the optimizer update of every parameter as one
program.

Port of ``mxnet_tpu/parallel/spmd.py`` ``SPMDTrainer`` on one device.
The reference jits the step into one executable with donated buffers;
here it is a ``gluon.block._GraphProgram``: on the card call 1 runs
eagerly (on a side stream), call 2 captures a ``torch.cuda.CUDAGraph``
and replays it, later calls replay it; on the CPU the same program runs
eagerly at every call.  Numerics are the reference's: the loss is the
mean of the loss function's per-sample output, the gradients of the
trainable parameters come from ``torch.autograd.grad`` (a parameter the
loss does not reach gets a zero gradient, as ``jax.value_and_grad``
gives it), and the update is ``Optimizer.fused_step_apply`` with the
reference step's own arithmetic (``spmd=True``): its f32 device
learning rates promote a bf16 weight's update to f32 before the
rounding back, as the reference's traced f32 ``lr`` does, and SGD
rounds ``wd`` and the momentum as the reference's Python numbers are
rounded (``SGD._spmd_rule``).

The parameters split as the reference's ``_ensure_built`` splits them:
trainable (``requires_grad``) and frozen (BatchNorm's running
statistics, which the forward commits in place, so a replay updates
them too).  They are collected after one forward in inference mode when
a Gluon layer still waits on its first input for its sizes.

A program serves one batch signature and holds a stage of ``C`` batches
(``C`` the largest step count asked so far), and one f32 operand vector
the host writes from pinned memory before each dispatch
(``optimizer._write``): every parameter's learning rate and weight
decay, the first step's ``t``, the rescale, the step index within the
dispatch, and one PRNG key a step as raw bits.  The program picks its
batch, its key and its ``t`` on the device by the step index, writes its
loss into a loss vector at that index and advances the index.  The key
is the program's traced key (``random.trace``): attention dropout
derives its seeds from it on the device, and the graph registers the
dropout generator, so every replay draws fresh masks.

- ``step`` is one dispatch of one step; it returns the loss as a device
  scalar (a clone; nothing is read back to the host).
- ``run_steps(data, label)`` over a leading ``(N, ...)`` axis stages the
  N batches and N keys in one write, then runs the program N times: on
  the card, after the first two calls, N bare ``graph.replay()`` calls
  with no write and no sync between them.  It returns the ``(N,)``
  losses as one device tensor.  Its N steps equal N ``step`` calls bit
  for bit, given the same keys (``random.seed``): both draw the same
  keys from the same host stream and run the same program.  The
  reference splits one key into N instead; threefry streams have no
  torch counterpart anyway.
- ``step_hlo_op_count(data, label)`` keeps the reference's name: on the
  card, the kernel nodes of the captured step graph; on the CPU, the
  aten ops one step dispatches.  Neither advances any random stream nor
  changes the weights.

A move of the parameters' storage generation (``parameter.generation()``
: ``cast``, ``load_parameters``, ``reset_ctx``) or of the optimizer's
scalar hyperparameters drops every program.  Programs share one graph
memory pool.  A mesh or sharding rules over more than one device belong
to a later slice of the port and raise.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError
from ..optimizer.optimizer import _write

__all__ = ["SPMDTrainer"]


def _mesh_devices(mesh):
    """How many devices ``mesh`` names: None is the block's own device;
    a device or device string is one; a list, tuple or dict (axis ->
    size) names their count (or product)."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return 1
    if isinstance(mesh, dict):
        n = 1
        for size in mesh.values():
            n *= int(size)
        return n
    if isinstance(mesh, (list, tuple)):
        return len(mesh)
    raise MXNetError(f"SPMDTrainer: unsupported mesh {mesh!r}")


def _deferred(block):
    """True while a Gluon layer of ``block`` waits on its first input
    for a parameter's size."""
    return any(p._data is None for m in block.modules()
               for p in getattr(m, "_reg_params", {}).values())


def _tensors(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, tuple):
        return [t for s in state for t in _tensors(s)]
    return []


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class SPMDTrainer:
    def __init__(self, block, loss_fn: Callable, optimizer,
                 optimizer_params: Optional[dict] = None, mesh=None,
                 rules=None, dp_axis: str = "dp", donate: bool = True):
        if _mesh_devices(mesh) != 1:
            raise MXNetError(
                "SPMDTrainer: a mesh over more than one device is not "
                "ported yet; it comes with a later slice of "
                "mxnet_tpu_torch (one device here)")
        # ``rules`` and ``dp_axis`` shard nothing on one device, and
        # ``donate`` is moot: the update is in place
        self._block = block
        self._loss_fn = loss_fn
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, opt_mod.Optimizer):
            self._opt = optimizer
            self._rescale = float(optimizer_params.pop(
                "rescale_grad", optimizer.rescale_grad))
        else:
            self._rescale = float(optimizer_params.pop("rescale_grad", 1.0))
            self._opt = opt_mod.create(optimizer, **optimizer_params)
        self._t = 0
        self._built = False
        self._generation = None
        self._params: list = []
        self._frozen_params: list = []
        self._states: list = []
        self._state_ids: list = []
        self._mp: list = []
        self._programs: dict = {}
        self._pool = None
        # kernel launches recorded by captures and run by replays
        self.captured_launches: dict = {}
        self.replayed_launches: dict = {}

    @property
    def optimizer(self):
        return self._opt

    @property
    def learning_rate(self):
        return self._opt.learning_rate

    def set_learning_rate(self, lr):
        self._opt.set_learning_rate(lr)

    # ------------------------------------------------------------------ #
    def _device(self):
        """The block's device (None while every parameter waits on the
        first forward: the data then stays where it is)."""
        p = next(self._block.parameters(), None)
        return None if p is None else p.device

    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            dev = self._device()
            return x if dev is None else x.to(dev)
        return torch.as_tensor(x, device=self._device())

    def _ensure_built(self, data):
        from ..gluon.parameter import generation

        if self._built and self._generation == generation():
            return
        block = self._block
        if _deferred(block):
            # the deferred sizes, by one forward in inference mode (the
            # reference's ``autograd.pause(train_mode=False)``)
            was = block.training
            block.eval()
            with torch.no_grad():
                block(data)
            block.train(was)
        params = list(block.parameters())
        self._params = [p for p in params if p.requires_grad]
        self._frozen_params = [p for p in params if not p.requires_grad] \
            + list(block.buffers())
        if not self._params:
            raise MXNetError("SPMDTrainer: the block has no trainable "
                             "parameter")
        ids = [id(p) for p in self._params]
        if ids != self._state_ids:     # new tensors: new states
            self._states = [self._opt.create_state_multi_precision(i, p)
                            for i, p in enumerate(self._params)]
            self._state_ids = ids
        self._mp = [self._opt._use_mp(p, s)
                    for p, s in zip(self._params, self._states)]
        self._programs = {}
        self._generation = generation()
        self._built = True

    def _forward_loss(self, data, label):
        self._block.train()
        out = self._block(data)
        out0 = out[0] if isinstance(out, (list, tuple)) else out
        return self._loss_fn(out0, label).mean()

    # ------------------------------------------------------------------ #
    def _program(self, data, label):
        """The program for this batch signature with a stage of at least
        ``data.shape[0]`` batches (made, with a larger stage, when none
        is)."""
        from ..gluon.block import _GraphProgram

        n = data.shape[0]
        sig = (tuple(data.shape[1:]), data.dtype, tuple(label.shape[1:]),
               label.dtype, data.device, self._opt._hyper_key(),
               self._opt.clip_gradient is not None)
        prog = self._programs.get(sig)
        if prog is not None and prog.stage >= n:
            return prog
        dev = data.device
        if dev.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        P = len(self._params)
        T0, RESCALE, IDX, KEYS = 2 * P, 2 * P + 1, 2 * P + 2, 2 * P + 3
        hyper = torch.zeros(KEYS + n, dtype=torch.float32, device=dev)
        stage_d = torch.empty((n, *data.shape[1:]), dtype=data.dtype,
                              device=dev)
        stage_l = torch.empty((n, *label.shape[1:]), dtype=label.dtype,
                              device=dev)
        train, states, mp = self._params, self._states, self._mp
        opt = self._opt
        losses = []

        def index():
            return hyper[IDX:IDX + 1].to(torch.int64)

        def fn():
            i = index()
            loss = self._forward_loss(stage_d.index_select(0, i)[0],
                                      stage_l.index_select(0, i)[0])
            grads = torch.autograd.grad(loss, train, allow_unused=True)
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(train, grads)]
                t = (hyper[T0] + hyper[IDX]).expand(P)
                opt.fused_step_apply(train, grads, states, mp, hyper[:P],
                                     hyper[P:T0], t, hyper[RESCALE],
                                     spmd=True)
                if not losses:
                    losses.append(torch.empty(n, dtype=loss.dtype,
                                              device=dev))
                losses[0].index_copy_(0, i, loss.detach().reshape(1))
                hyper[IDX:IDX + 1].add_(1.0)
            return [losses[0]]

        prog = _GraphProgram(fn, dev, self._pool, [stage_d, stage_l],
                             key=lambda: hyper[KEYS:].view(
                                 torch.int32).index_select(0, index()))
        prog.stage, prog.hyper = n, hyper
        self._programs[sig] = prog
        return prog

    def _feed(self, prog, data, label, batch_size, keys):
        """The host's write before a dispatch of ``len(keys)`` steps: the
        batches into the stage, then one write of the operand vector."""
        n = len(keys)
        prog.inputs[0][:n].copy_(data)
        prog.inputs[1][:n].copy_(label)
        lr, wd = self._opt.learning_rate, self._opt.wd
        rescale = self._rescale / (batch_size if batch_size else 1.0)
        _write(prog.hyper[:2 * len(self._params) + 3 + n],
               [lr * getattr(p, "lr_mult", 1.0) for p in self._params] +
               [wd * getattr(p, "wd_mult", 1.0) for p in self._params] +
               [self._t + 1, rescale, 0.0], keys)

    def _prepare(self, data, label, batch_size):
        """The program of a dispatch of ``data.shape[0]`` steps, fed with
        its batches and fresh keys; the step count advances."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        self._ensure_built(data[0])
        prog = self._program(data, label)
        n = data.shape[0]
        self._feed(prog, data, label, batch_size,
                   [_random.next_key() for _ in range(n)])
        self._t += n
        self._opt.num_update = self._t
        return prog

    def _count(self, prog, launches, times):
        for k, c in prog.launches.items():
            launches[k] = launches.get(k, 0) + c * times

    def _call(self, prog):
        """One call of ``prog`` (eager, capture + replay, or replay)."""
        had_graph, replays = prog.graph is not None, prog.replays
        outs = prog()
        if prog.graph is not None and not had_graph:
            self._count(prog, self.captured_launches, 1)
        self._count(prog, self.replayed_launches, prog.replays - replays)
        return outs

    # ------------------------------------------------------------------ #
    def step(self, data, label, batch_size: Optional[int] = None):
        """One train step; returns the loss as a device scalar (nothing
        is read back to the host).  ``batch_size`` divides the gradient
        (the gradient is the mean loss's, so the default is 1)."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        prog = self._prepare(data[None], label[None], batch_size)
        # a copy: the program's loss vector is overwritten by the next
        # call (a replay returns a copy of it, the eager call the vector)
        return self._call(prog)[0][0].clone()

    def run_steps(self, data, label, batch_size: Optional[int] = None):
        """``data``/``label`` carry a leading steps axis (N, batch, ...);
        runs N steps and returns the (N,) losses as one device tensor.
        Equal to N ``step`` calls bit for bit, given the same keys: the
        keys are drawn from the same host stream, and the program is
        the same."""
        prog = self._prepare(data, label, batch_size)
        n = data.shape[0]
        done, outs = 0, None
        while done < n and (not prog.on_card or prog.graph is None):
            outs = self._call(prog)
            done += 1
        if done < n:
            replay = prog.graph.replay
            for _ in range(n - done):
                replay()
            prog.replays += n - done
            self._count(prog, self.replayed_launches, n - done)
            outs = prog.outs
        return outs[0][:n].clone()

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def _preserved(self):
        """Everything a step changes (weights, frozen values, optimizer
        states, the dropout generator) restored on exit."""
        keep = self._params + self._frozen_params + [
            t for s in self._states for t in _tensors(s)]
        saved = [t.detach().clone() for t in keep]
        dev = keep[0].device
        gen = _random.generator(dev)
        gen_state = gen.get_state()
        try:
            yield
        finally:
            with torch.no_grad():
                for t, s in zip(keep, saved):
                    t.copy_(s)
            gen.set_state(gen_state)

    def step_hlo_op_count(self, data, label):
        """The size of the step program (the reference's optimized-HLO
        instruction count): on the card, the kernel nodes of the step
        graph (``_GraphProgram.kernel_nodes``: the graph is captured
        with its nodes kept, here and only here; as the program's own
        graph if no step has captured one, else as a copy that is never
        replayed); on the CPU, the aten ops one step dispatches.  A fixed
        key and restored state: no random stream advances and no weight
        moves."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        self._ensure_built(data)
        prog = self._program(data[None], label[None])
        if prog.on_card and prog.graph is not None:
            if not prog.graph_debug:    # kernel_nodes captures a copy
                self._count(prog, self.captured_launches, 1)
            return sum(prog.kernel_nodes().values())
        with self._preserved():
            self._feed(prog, data[None], label[None], None, [0])
            if not prog.on_card:
                with _CountOps() as counter:
                    prog.run()
                return counter.n
            if prog.calls == 0:
                prog.run()      # the warm-up a capture needs
                torch.cuda.synchronize()
        prog._capture(debug=True)   # records; runs nothing
        self._count(prog, self.captured_launches, 1)
        return sum(prog.kernel_nodes().values())
