"""The fused train step: forward, loss, backward, the gradient rescale
and the optimizer apply as one program, a CUDA-graph replay a call.

Port of ``mxnet_tpu/gluon/fused_step.py``.  The reference traces the
step into one jitted executable; on Hopper its counterpart is a
``torch.cuda.CUDAGraph`` captured once a program key and replayed
(``block._GraphProgram``: call 1 runs eagerly, call 2 captures and
replays, later calls replay, so every call is exactly one step).  On the
CPU the same program runs eagerly, which is how the tests hold it
against the reference.

A program works on static tensors: the batch is copied into static
inputs; ``autograd.trace_value_and_grad`` gives the outputs and the
gradients (``torch.autograd.grad``, so no ``grad()`` buffer or ``.grad``
is touched); with ``Trainer(update_interval=N)`` the gradients
accumulate into a static ring; and at the window's last call
``Optimizer.fused_step_apply`` updates the weights, master copies and
optimizer states (``Trainer._states``, the tensors the phase-by-phase
path updates too) in place and the ring is zeroed.  The learning rates,
weight decays and step counts of every parameter and the rescale
``scale / (batch * N)`` are one device vector that the host writes
before each apply (``optimizer._write``), so one graph serves every
step and every schedule.  The vector's last word is the program's PRNG
key (``random.next_key()``, written at every call as raw bits, read
through an int32 view): the program draws its attention-dropout seeds
from it on the device (``_GraphProgram``'s key), and its graph
registers the dropout generator, so every replay draws fresh masks, as
the reference's step takes a fresh key operand.  There is one program
a (phase: micro or apply, batch signature, training flag, ``N > 1``,
the optimizer's scalar hyperparameters, clip present); micro and apply
graphs share one memory pool.  A replay overwrites the program's
outputs: the caller gets clones.

The kernel wrappers count launches on the host, so a replay adds
nothing to them: each program keeps what its capture added (the
launches of one replay), and ``FusedStep.launches()`` multiplies by the
replays.  A move of the parameters' storage generation
(``parameter.generation()``: ``cast``, ``load_parameters``,
``reset_ctx``, deferred init) drops every program.

``MXNET_FUSED_STEP=0`` runs the phase-by-phase step instead (record,
backward, ``Trainer.step``), bit for bit.

Telemetry, as the reference's: the histograms
``fused_step_seconds{phase=micro|apply}`` time the host's call of each
replay (no device sync is added), ``fused_step_dispatches_total{phase=
micro|apply|legacy}`` count the calls and ``fused_step_window_pos`` is
the accumulation window's position; each replay runs inside the
annotation ``mx:fused_step:micro`` or ``mx:fused_step:apply``, so the
trace parser gives its kernels that ``tf_op``; every program is watched
at the site ``gluon.fused_step`` (a ``compile`` event a capture); the
accumulator ring is the ledger entry ``train.grad_accum`` of this step,
dropped by ``release_accounting``.
"""
from __future__ import annotations

import os
import time

import torch

from .. import telemetry
from ..base import MXNetError
from ..optimizer.optimizer import _write

__all__ = ["FusedStep", "fused_step_enabled", "step_counters",
           "reset_step_counters"]

# (reference names)
#   dispatches        fused calls (one program run each)
#   micro_dispatches  calls that only accumulated (mid-window)
#   apply_dispatches  calls that ran the optimizer apply
#   legacy_steps      calls that took the phase-by-phase path
#   compiles          programs made: captures on the card, builds on the
#                     CPU
step_counters = {"dispatches": 0, "micro_dispatches": 0,
                 "apply_dispatches": 0, "legacy_steps": 0, "compiles": 0}


def reset_step_counters():
    for k in step_counters:
        step_counters[k] = 0


# the registry's instruments, made at first use (importing the module
# must not touch the registry)
_tele = None


def _instruments():
    global _tele
    if _tele is None:
        _tele = {
            "lat_micro": telemetry.histogram("fused_step_seconds",
                                             phase="micro"),
            "lat_apply": telemetry.histogram("fused_step_seconds",
                                             phase="apply"),
            "d_micro": telemetry.counter("fused_step_dispatches_total",
                                         phase="micro"),
            "d_apply": telemetry.counter("fused_step_dispatches_total",
                                         phase="apply"),
            "d_legacy": telemetry.counter("fused_step_dispatches_total",
                                          phase="legacy"),
            "window": telemetry.gauge("fused_step_window_pos"),
        }
    return _tele


def fused_step_enabled() -> bool:
    """``MXNET_FUSED_STEP=0`` restores the phase-by-phase step (read per
    call)."""
    return os.environ.get("MXNET_FUSED_STEP", "1") != "0"


class FusedStep:
    """The step of one ``(Trainer, loss_fn)`` pair, made and cached by
    ``Trainer.fused_step``.  ``loss_fn(*batch)`` is NDArray-level code
    returning the per-sample loss or ``(loss, *extras)``."""

    def __init__(self, trainer, loss_fn, train_mode=True):
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._train_mode = bool(train_mode)
        self._built = False
        self._generation = None
        self._train_idx: list = []
        self._train_params: list = []
        self._frozen_params: list = []
        self._mp_flags: list = []
        self._pure = None
        self._programs: dict = {}
        self._pool = None
        self._hyper = None
        self._accum = None
        self._accum_key = None      # the ring's memory-ledger key
        self._legacy_accum = None

    # ------------------------------------------------------------------ #
    def _build(self, nd_batch):
        from .. import autograd
        from .block import _no_hybrid
        from .parameter import generation

        tr = self._trainer
        if any(p._data is None for p in tr._params):
            # the deferred shapes, by one imperative forward
            with autograd.pause(train_mode=False), _no_hybrid():
                self._loss_fn(*nd_batch)
        self._train_idx, self._train_params = [], []
        self._frozen_params = []
        for i, p in enumerate(tr._params):
            if p._data is None:
                raise MXNetError(
                    f"fused_step: parameter {p.name} is not initialized "
                    "after one forward; initialize() the block first")
            if p.grad_req == "null":
                self._frozen_params.append(p)
            else:
                tr._ensure_state(i)
                self._train_idx.append(i)
                self._train_params.append(p)
        opt = tr._optimizer
        self._mp_flags = [opt._use_mp(tr._params[i]._data._data,
                                      tr._states[i])
                          for i in self._train_idx]
        self._pure = autograd.trace_value_and_grad(
            self._loss_fn, self._train_params, self._frozen_params,
            train_mode=self._train_mode)
        device = self._train_params[0]._data._data.device \
            if self._train_params else torch.device("cpu")
        self._device = device
        self._hyper = torch.zeros(3 * len(self._train_idx) + 2,
                                  device=device)
        self._programs = {}
        if self._accum is not None and (
                len(self._accum) != len(self._train_params) or any(
                    a.shape != p._data._data.shape or
                    a.dtype != p._data._data.dtype or
                    a.device != p._data._data.device
                    for a, p in zip(self._accum, self._train_params))):
            if tr._window_pos != 0:
                raise MXNetError(
                    "fused_step: the parameters were replaced mid-"
                    "accumulation window with other shapes, dtypes or "
                    "devices; finish the window first")
            self._accum = None
        self._generation = generation()
        self._built = True

    # ------------------------------------------------------------------ #
    def _program(self, phase, args):
        from .block import _GraphProgram

        tr = self._trainer
        opt = tr._optimizer
        key = (phase, tuple((tuple(a.shape), a.dtype, a.device)
                            for a in args),
               self._train_mode, tr._update_interval > 1, opt._hyper_key(),
               opt.clip_gradient is not None)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        if self._device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        pure = self._pure
        static = [torch.empty_like(a) for a in args]
        ws = [p._data._data for p in self._train_params]
        frozen = [p._data._data for p in self._frozen_params]
        accum = self._accum if tr._update_interval > 1 else None
        states = [tr._states[i] for i in self._train_idx]
        mp_flags = list(self._mp_flags)
        n = len(ws)
        hyper = self._hyper

        if phase == "micro":
            def fn():
                outs, grads, _ = pure(ws, frozen, *static)
                with torch.no_grad():
                    for a, g in zip(accum, grads):
                        a.add_(g.to(a.dtype))
                return list(outs)
        else:
            def fn():
                outs, grads, _ = pure(ws, frozen, *static)
                with torch.no_grad():
                    if accum is not None:
                        totals = [a.add_(g.to(a.dtype))
                                  for a, g in zip(accum, grads)]
                    else:
                        totals = grads
                    opt.fused_step_apply(ws, totals, states, mp_flags,
                                         hyper[:n], hyper[n:2 * n],
                                         hyper[2 * n:3 * n], hyper[3 * n])
                    if accum is not None:
                        for a in accum:
                            a.zero_()
                return list(outs)

        prog = self._programs[key] = telemetry.instrument_program(
            _GraphProgram(fn, self._device, self._pool, static,
                          key=hyper[3 * n + 1:].view(torch.int32)),
            "gluon.fused_step", key=(phase, key[1]),
            fields={"phase": phase})
        step_counters["compiles"] += 1
        return prog

    def _account_ring(self):
        """The accumulator ring in the memory ledger, one entry a fused
        step (a trainer that drives several loss functions has a ring
        for each)."""
        from ..telemetry.memory import ACCOUNTANT

        self._accum_key = f"{self._trainer._mem_label}:fs{id(self):x}"
        ACCOUNTANT.set("train.grad_accum", self._accum_key, self._accum)

    def release_accounting(self):
        """Drop this step's ``train.grad_accum`` entry (the trainer's
        cache evicted it, or the trainer is released); a deferred drop,
        as ``Trainer.release_accounting``'s."""
        if self._accum_key is not None:
            from ..telemetry.memory import ACCOUNTANT

            ACCOUNTANT.drop_deferred("train.grad_accum", self._accum_key)
            self._accum_key = None

    def launches(self):
        """Kernel launches of this step's replays, by kernel: each
        program's launches a replay times its replays (the wrappers'
        counters saw the warm-up and capture calls themselves)."""
        out: dict = {}
        for prog in self._programs.values():
            for k, n in prog.launches.items():
                out[k] = out.get(k, 0) + n * prog.replays
        return out

    # ------------------------------------------------------------------ #
    def __call__(self, batch, batch_size=None):
        from .. import random as _random
        from ..ndarray.ndarray import NDArray, array
        from .parameter import generation

        tr = self._trainer
        nd_batch = [b if isinstance(b, NDArray) else array(b)
                    for b in batch]
        if batch_size is None:
            batch_size = nd_batch[0].shape[0] if nd_batch[0].shape else 1
        if not (fused_step_enabled() and tr._optimizer._fusable) or \
                tr._uses_store():
            # a kvstore's reduction or its optimizer runs between the
            # phases: the phase-by-phase step, same semantics
            return self._legacy(nd_batch, batch_size)
        if not self._built or self._generation != generation():
            self._build(nd_batch)
            tr._account_params()
        args = [b._data for b in nd_batch]
        N = tr._update_interval
        if N > 1 and self._accum is None:
            adopted = self._adopt_pending_accum(tr)
            self._accum = adopted if adopted is not None else [
                torch.zeros_like(p._data._data) for p in self._train_params]
            self._account_ring()
        tele = _instruments()
        tr._window_pos += 1
        key = [_random.next_key()]
        if tr._window_pos < N:
            _write(self._hyper[-1:], [], key)
            prog = self._program("micro", args)
            step_counters["micro_dispatches"] += 1
            phase = "micro"
        else:
            tr._window_pos = 0
            opt = tr._optimizer
            lrs, wds, ts = [], [], []
            for i in self._train_idx:
                opt._update_count(i)
                lrs.append(opt._get_lr(i))
                wds.append(opt._get_wd(i))
                ts.append(opt._index_update_count[i])
            _write(self._hyper, lrs + wds + ts +
                   [tr._scale / (float(batch_size) * N)], key)
            prog = self._program("apply", args)
            step_counters["apply_dispatches"] += 1
            phase = "apply"
        t0 = time.perf_counter()
        with telemetry.annotation(f"mx:fused_step:{phase}"):
            for s, a in zip(prog.inputs, args):
                s.copy_(a)
            outs = prog()
        tele["lat_" + phase].observe(time.perf_counter() - t0)
        tele["d_" + phase].inc()
        tele["window"].set(tr._window_pos)
        step_counters["dispatches"] += 1
        nd = [NDArray(o) for o in outs]
        return tuple(nd) if self._pure.out_struct.get("is_seq") else nd[0]

    def _adopt_pending_accum(self, tr):
        """A ring that an ``mx.checkpoint`` restore staged on the trainer
        (``_pending_accum``): the first whose shapes and dtypes match
        this step's parameters, placed on their device, resumes the
        window where the save left it.  A restored mid-window position
        with no matching ring raises: resuming from a zero ring would not
        be the saved run."""
        pending = tr._pending_accum
        if pending is None:
            return None
        like = [p._data._data for p in self._train_params]
        for i, ring in enumerate(pending):
            if len(ring) == len(like) and all(
                    tuple(r.shape) == tuple(w.shape) and r.dtype == w.dtype
                    for r, w in zip(ring, like)):
                pending.pop(i)
                return [r.to(w.device).clone() for r, w in zip(ring, like)]
        if tr._window_pos != 0:
            raise MXNetError(
                "fused_step: the trainer was restored mid-accumulation "
                f"window (micro-batch {tr._window_pos}/"
                f"{tr._update_interval}) but no saved accumulator ring "
                "matches this step's parameters")
        return None

    # ------------------------------------------------------------------ #
    def _legacy(self, nd_batch, batch_size):
        """The phase-by-phase step: record, backward, ``Trainer.step``,
        bit for bit the loop a user writes.  With ``N > 1`` the ``'write'``
        gradients accumulate here across the window (``'add'`` ones in
        their buffers), and ``step`` applies at the boundary."""
        from .. import autograd

        tr = self._trainer
        step_counters["legacy_steps"] += 1
        _instruments()["d_legacy"].inc()
        with autograd.record(train_mode=self._train_mode):
            out = self._loss_fn(*nd_batch)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        autograd.backward([loss])
        N = tr._update_interval
        if N > 1:
            live = [p for p in tr._params
                    if p.grad_req == "write" and p._data is not None]
            now = [p._data._grad_buffer()._data for p in live]
            if tr._window_pos == 0 or self._legacy_accum is None:
                self._legacy_accum = now
            else:
                self._legacy_accum = [a + g for a, g in
                                      zip(self._legacy_accum, now)]
            if tr._window_pos + 1 >= N:
                for p, a in zip(live, self._legacy_accum):
                    p._data._grad_buffer()._rebind(a)
                self._legacy_accum = None
        tr._accum_managed = True
        try:
            tr.step(batch_size)
        finally:
            tr._accum_managed = False
        return out
