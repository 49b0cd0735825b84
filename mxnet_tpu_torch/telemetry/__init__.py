"""``mx.telemetry`` — runtime telemetry, port of
``mxnet_tpu/telemetry``:

- **metrics registry** (:mod:`.registry`): thread-safe counters /
  gauges / fixed-bucket histograms, exported on demand via
  :func:`snapshot` or :func:`render_prometheus`.
- **event log** (:mod:`.events`): structured ``compile`` / serve-span /
  bench events in a bounded ring, fanned out to JSONL sinks
  (``MXNET_TELEMETRY_JSONL=path`` or :func:`add_jsonl_sink`).
- **capture watch** (:func:`instrument_program`, also under the
  reference's name :func:`instrument_jit`): every CUDA-graph capture of
  a watched program emits a ``compile`` event.
- **device-timeline bridge** (:func:`annotation` / :func:`span`):
  phases appear as ``torch.profiler.record_function`` ranges while a
  profiler is recording, and cost a no-op context otherwise.
- **memory axis** (:mod:`.memory`): the process-wide :data:`ACCOUNTANT`
  ledger of device-resident allocations by subsystem, reconcilable
  against the CUDA allocator's count, and the byte arithmetic behind
  ``MXNET_SERVE_HBM_BUDGET``.
- **fault injection** (:mod:`.faults`): env-armed failures
  (``MXNET_FAULT_INJECT=site:kind:after_n``) at named sites of the
  serve scheduler.

``MXNET_TELEMETRY=0`` disables event emission and the capture watch
(the registry stays live — ``DecodeServer.counters`` is a view over
it).
"""
from __future__ import annotations

import contextlib
import time

from . import memory
from .compile import instrument_jit, instrument_program
from .events import (JsonlSink, add_jsonl_sink, add_sink, clear_events,
                     emit, events, remove_sink, telemetry_enabled)
from .faults import fault_point, parse_fault_spec, reset_faults
from .memory import (ACCOUNTANT, MemoryAccountant, format_bytes,
                     live_device_bytes, mem_enabled, memory_analysis,
                     nbytes_of, parse_bytes, per_device_bytes, reconcile)
from .registry import (DEFAULT_LATENCY_BUCKETS, REGISTRY, Counter, Gauge,
                       Histogram, Registry, counter, gauge, histogram,
                       render_prometheus, reset_metrics, snapshot)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "render_prometheus",
    "reset_metrics", "DEFAULT_LATENCY_BUCKETS",
    "emit", "events", "clear_events", "add_sink", "remove_sink",
    "add_jsonl_sink", "JsonlSink", "telemetry_enabled",
    "fault_point", "parse_fault_spec", "reset_faults",
    "instrument_program", "instrument_jit", "annotation", "span",
    "memory", "ACCOUNTANT", "MemoryAccountant", "memory_analysis",
    "mem_enabled", "nbytes_of", "per_device_bytes", "live_device_bytes",
    "parse_bytes", "format_bytes", "reconcile",
]


def annotation(name):
    """A ``torch.profiler.record_function`` range while a profiler is
    recording, else a free no-op."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name, hist=None, **labels):
    """Time a phase into histogram ``hist`` (default
    ``f"{name}_seconds"``) and bridge it to the device timeline via
    :func:`annotation`."""
    h = REGISTRY.histogram(hist or f"{name}_seconds", **labels)
    t0 = time.perf_counter()
    with annotation(name):
        yield h
    h.observe(time.perf_counter() - t0)
