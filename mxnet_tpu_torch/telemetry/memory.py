"""Memory observability — the memory axis of ``mx.telemetry``, port of
``mxnet_tpu/telemetry/memory.py``.

- **live accounting** (:data:`ACCOUNTANT`): a process-wide ledger of
  device-resident allocations BY SUBSYSTEM (``serve.kv_pool``, ...),
  exported as ``device_bytes{subsystem,device}`` registry gauges and
  ``device_memory`` events, reconcilable against the CUDA caching
  allocator's own count of allocated bytes (:func:`reconcile`).
- **budget arithmetic** (:func:`parse_bytes` / :func:`format_bytes`):
  the ``MXNET_SERVE_HBM_BUDGET`` / ``DecodeServer(hbm_budget=)``
  enforcement in ``mxnet_tpu_torch.serve`` uses these.

The reference's per-executable analysis (``memory_analysis``) reads
XLA's buffer assignment of a compiled program; a CUDA graph has no such
report, so here it raises ``MXNetError`` saying so.

Reconcile caveats: the accountant stores BYTE COUNTS, not tensor
references, so registering cannot pin memory, but a subsystem that frees
memory without ``drop()`` leaves a stale entry (``reconcile()`` then
reports ``delta < 0``).  The allocator's count holds everything the
ledger was never told about (weights, caches, graph pools), so
``accounted <= live`` per device is the healthy state and the coverage
ratio — not a zero delta — is the signal.
"""
from __future__ import annotations

import os
import threading
from collections import deque

from . import events as _events
from .registry import REGISTRY

__all__ = ["mem_enabled", "parse_bytes", "format_bytes", "nbytes_of",
           "per_device_bytes", "live_device_bytes", "memory_analysis",
           "MemoryAccountant", "ACCOUNTANT", "reconcile"]


def mem_enabled():
    """``MXNET_TELEMETRY_MEM=1``: the reference's switch for memory
    fields on compile events (read per call).  Capture events carry no
    memory fields here (see :func:`memory_analysis`)."""
    return os.environ.get("MXNET_TELEMETRY_MEM", "0") == "1"


# --------------------------------------------------------------------- #
# byte arithmetic
# --------------------------------------------------------------------- #

_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(raw, what="byte size"):
    """``int`` bytes from an int or a ``"512M"``-style string (K/M/G/T
    suffixes, powers of 1024).  Raises ``MXNetError`` naming ``what``
    on anything else."""
    from ..base import MXNetError

    if isinstance(raw, bool):
        raise MXNetError(f"{what}: expected bytes, got {raw!r}")
    if isinstance(raw, (int, float)):
        try:
            n = int(raw)
        except (ValueError, OverflowError):   # float('inf')/nan
            raise MXNetError(
                f"{what}: expected bytes, got {raw!r}") from None
    else:
        s = str(raw).strip()
        mult = 1
        if s and s[-1].lower() in _SUFFIXES:
            mult = _SUFFIXES[s[-1].lower()]
            s = s[:-1]
        try:
            n = int(float(s) * mult)
        except (ValueError, OverflowError):   # "lots" / "1e999"
            raise MXNetError(
                f"{what}: expected bytes (int, optionally with a "
                f"K/M/G/T suffix), got {raw!r}") from None
    if n < 0:
        raise MXNetError(f"{what}: bytes must be >= 0, got {raw!r}")
    return n


def format_bytes(n):
    """Human-readable bytes (``"1.50 GiB"``) for error messages and
    report tables."""
    n = int(n)
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20),
                      ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


# --------------------------------------------------------------------- #
# byte walks over containers of tensors
# --------------------------------------------------------------------- #

def _leaves(tree):
    """Array leaves of a tree that may mix torch tensors, numpy arrays,
    ``NDArray`` wrappers and plain containers."""
    if tree is None:
        return
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
        return
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
        return
    inner = getattr(tree, "_data", None)   # NDArray wrapper
    if inner is not None and hasattr(inner, "nbytes"):
        yield inner
        return
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        yield tree


def nbytes_of(tree):
    """Total logical bytes of every array leaf in ``tree`` (shape x
    itemsize — metadata only, never a device sync)."""
    return sum(int(x.nbytes) for x in _leaves(tree))


def _devstr(dev):
    """``cuda:0`` / ``cpu:0`` for a torch device."""
    return f"{dev.type}:{0 if dev.index is None else dev.index}"


def per_device_bytes(tree):
    """``{device: bytes}`` for the array leaves of ``tree``: a torch
    tensor is charged to its device (``cuda:N`` or ``cpu:0``), host
    numpy lands under ``"host:0"``."""
    out = {}
    for x in _leaves(tree):
        dev = getattr(x, "device", None)
        k = _devstr(dev) if hasattr(dev, "type") else "host:0"
        out[k] = out.get(k, 0) + int(x.nbytes)
    return out


def live_device_bytes():
    """``{device: bytes}`` the CUDA caching allocator reports allocated
    on each card (``torch.cuda.memory_stats(dev)["allocated_bytes.all.
    current"]``): the ground truth this process can see.  ``{}`` without
    a card (the CPU has no such count)."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            continue
        out[f"cuda:{i}"] = int(stats.get("allocated_bytes.all.current", 0))
    return out


# --------------------------------------------------------------------- #
# per-executable analysis
# --------------------------------------------------------------------- #

def memory_analysis(compiled):
    """The reference reads XLA's buffer-assignment bytes of one compiled
    executable here; a CUDA graph offers no such analysis, so this
    raises ``MXNetError`` (read :func:`live_device_bytes` or a capture's
    pool through the allocator instead)."""
    from ..base import MXNetError

    raise MXNetError(
        "memory_analysis reads XLA's compiled-executable memory "
        "analysis, which has no counterpart for a CUDA graph: use "
        "telemetry.live_device_bytes() or torch.cuda.memory_stats()")


# --------------------------------------------------------------------- #
# live accounting
# --------------------------------------------------------------------- #

class MemoryAccountant:
    """Process-wide ledger of device-resident allocations by subsystem.

    ``set(subsystem, key, tree)`` (re)registers one allocation — the
    bytes are computed per device HERE and only the numbers are kept,
    never tensor references (registration cannot pin memory).  Each
    mutation updates the ``device_bytes{subsystem,device}`` registry
    gauge and, when the numbers actually changed, emits one
    ``device_memory`` event."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}      # (subsystem, key) -> {device: bytes}
        # finalizer-side drop queue: __del__ paths must never take
        # _lock (a collection can run a finalizer inside a thread that
        # already holds it), so they append here (deque.append is
        # atomic) and the entry is retired on the next mutation or query
        self._deferred = deque()

    # -- mutation -------------------------------------------------------- #
    def set(self, subsystem, key, tree=None, per_device=None):
        """Register/update allocation ``key`` of ``subsystem``: bytes
        from the array leaves of ``tree``, or an explicit
        ``per_device={device: bytes}`` mapping."""
        pd = dict(per_device) if per_device is not None \
            else per_device_bytes(tree)
        ekey = (str(subsystem), str(key))
        self._drain_deferred()
        with self._lock:
            old = self._entries.get(ekey)
            if old == pd:
                return
            self._entries[ekey] = pd
            touched = set(pd) | set(old or ())
            totals = self._totals_locked(str(subsystem), touched)
            # published under the lock, so two mutations of one
            # subsystem land their gauge totals in the order computed
            self._publish(str(subsystem), str(key), pd, totals)

    def drop(self, subsystem, key):
        """Forget allocation ``key`` (idempotent) — call when the
        memory is actually released.  Not safe from ``__del__``
        finalizers — those use :meth:`drop_deferred`."""
        ekey = (str(subsystem), str(key))
        self._drain_deferred()
        with self._lock:
            old = self._entries.pop(ekey, None)
            if not old:
                return
            totals = self._totals_locked(str(subsystem), set(old))
            self._publish(str(subsystem), str(key),
                          {d: 0 for d in old}, totals)

    def drop_deferred(self, subsystem, key):
        """Lock-free :meth:`drop` for garbage-collection finalizers: the
        pair is queued atomically and retired inside the next
        ``set``/``drop``/query on a normal thread."""
        self._deferred.append((str(subsystem), str(key)))

    def _drain_deferred(self):
        while True:
            try:
                sub, key = self._deferred.popleft()
            except IndexError:
                return
            with self._lock:
                old = self._entries.pop((sub, key), None)
                if not old:
                    continue
                totals = self._totals_locked(sub, set(old))
                self._publish(sub, key, {d: 0 for d in old}, totals)

    def _totals_locked(self, subsystem, devices):
        totals = {d: 0 for d in devices}
        for (sub, _k), pd in self._entries.items():
            if sub != subsystem:
                continue
            for d, b in pd.items():
                if d in totals:
                    totals[d] += b
        return totals

    def _publish(self, subsystem, key, pd, totals):
        for dev, total in totals.items():
            REGISTRY.gauge("device_bytes", subsystem=subsystem,
                           device=dev).set(total)
            _events.emit("device_memory", subsystem=subsystem, key=key,
                         device=dev, bytes=pd.get(dev, 0),
                         subsystem_bytes=total)

    # -- queries --------------------------------------------------------- #
    def bytes(self, subsystem=None, key=None, device=None):
        """Accounted bytes, filtered by any of subsystem/key/device."""
        total = 0
        self._drain_deferred()
        with self._lock:
            for (sub, k), pd in self._entries.items():
                if subsystem is not None and sub != str(subsystem):
                    continue
                if key is not None and k != str(key):
                    continue
                for d, b in pd.items():
                    if device is not None and d != str(device):
                        continue
                    total += b
        return total

    def snapshot(self):
        """``{subsystem: {device: bytes}}`` over every live entry."""
        out = {}
        self._drain_deferred()
        with self._lock:
            for (sub, _k), pd in self._entries.items():
                dst = out.setdefault(sub, {})
                for d, b in pd.items():
                    dst[d] = dst.get(d, 0) + b
        return out

    def reconcile(self):
        """Per-device ``{device: {accounted, live, delta, coverage}}``
        against :func:`live_device_bytes`.  ``delta = live - accounted``;
        healthy subsystems keep ``delta >= 0``, a NEGATIVE delta means a
        stale entry whose memory is gone."""
        live = live_device_bytes()
        accounted = {}
        self._drain_deferred()
        with self._lock:
            for pd in self._entries.values():
                for d, b in pd.items():
                    accounted[d] = accounted.get(d, 0) + b
        out = {}
        for dev in set(live) | set(accounted):
            a, l = accounted.get(dev, 0), live.get(dev, 0)
            out[dev] = {"accounted": a, "live": l, "delta": l - a,
                        "coverage": (a / l) if l else None}
        return out


ACCOUNTANT = MemoryAccountant()


def reconcile():
    """Module-level shortcut for ``ACCOUNTANT.reconcile()``."""
    return ACCOUNTANT.reconcile()
