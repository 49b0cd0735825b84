"""``mx.profiler`` — the profiling facade, port of ``mxnet_tpu/profiler.py``.

Reference surface (``python/mxnet/profiler.py``): ``set_config``,
``start``/``stop``/``pause``/``resume``/``dump``, the per-op aggregate
table (``dumps(reset)``), ``set_state``/``state`` and the user domains
``Task``/``Frame``/``Counter``/``Marker``/``Scope``/``Domain``.

- Device tracing is ``torch.profiler.profile`` with CPU and, where the
  card is there, CUDA activities (the reference wraps ``jax.profiler``):
  ``start`` opens a window, ``stop`` closes it, ``dump`` writes the
  aggregate table to ``filename`` and the window's Chrome trace beside
  it.
- Host per-op aggregate stats: ``ops.registry.invoke`` times each
  ``mx.nd`` op into the table while profiling runs with
  ``aggregate_stats`` (``_hook``).  ``pause`` keeps the table, ``resume``
  adds to it.
- ``Task``, ``Frame`` and ``Scope`` are ``torch.profiler.record_function``
  ranges, so they appear on the timeline; ``Counter`` is a telemetry
  gauge ``profiler_counter{counter=}`` and ``Marker`` a telemetry event
  plus a zero-length range, as in the reference.
- While a window is open each ``mx.nd``/``mx.np`` op runs inside a
  range named after it and its caller's line (``_run_op``).
- ``device_dumps(by="tf_op"|"name"|"category"|"source")`` aggregates
  the last window's device kernels, copies and sets (the host's
  operators when it traced the CPU alone) through the trace parser
  ``profiler_trace``, the counterpart of the reference's
  ``profiler_xla.py``; ``"tf_op"``, the op that launched each kernel,
  is the default, as in the reference.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time
from collections import defaultdict

from .base import MXNetError

__all__ = ["set_config", "profiler_set_config", "start", "stop", "pause",
           "resume", "dump", "dumps", "device_dumps", "set_state", "state",
           "Task", "Frame", "Counter", "Marker", "Scope", "Domain",
           "TraceAnnotation"]

_lock = threading.Lock()
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": True,
    "continuous_dump": False,
}
# prof: the open torch.profiler window; last: the last closed one
_state = {"running": False, "trace_dir": None, "op_stats": None,
          "paused": False, "prof": None, "last": None}


def set_config(**kwargs):
    """``mx.profiler.set_config(profile_all=True, filename='prof.json')``.
    ``filename`` names the aggregate table's JSON file; the Chrome trace
    goes to ``<filename without .json>_trace/trace.json``.  Unknown keys
    raise ``MXNetError`` naming them."""
    unknown = sorted(set(kwargs) - set(_config))
    if unknown:
        raise MXNetError(
            f"profiler.set_config: unknown config key(s) {unknown}; "
            f"known keys: {sorted(_config)}")
    _config.update(kwargs)


profiler_set_config = set_config


class _OpStats:
    """Aggregate per-op host stats (the reference's aggregate table):
    calls, total, min and max seconds by op name."""

    def __init__(self):
        self.times = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])

    def record(self, name, dt):
        t = self.times[name]
        t[0] += 1
        t[1] += dt
        t[2] = min(t[2], dt)
        t[3] = max(t[3], dt)

    def table(self):
        lines = [f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}"
                 f"{'Min(ms)':>10}{'Max(ms)':>10}", "-" * 80]
        for name, (n, tot, mn, mx) in sorted(
                self.times.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<40}{n:>8}{tot * 1e3:>12.3f}"
                         f"{mn * 1e3:>10.3f}{mx * 1e3:>10.3f}")
        return "\n".join(lines)


def _hook(name, dt):
    # under the lock: dumps(reset=True) swaps the table while ops record
    with _lock:
        st = _state["op_stats"]
        if st is not None:
            st.record(name, dt)


def _run_op(opref, tensors, kwargs, recording):
    """One op of ``invoke`` while the profiler runs: inside a
    ``record_function`` range ``mx.op:<op>|<file>:<line>`` (the trace
    parser's ``tf_op`` and ``source``), its host time into the aggregate
    table with ``aggregate_stats``."""
    import torch

    from .profiler_trace import OP_RANGE, caller_source

    t0 = time.perf_counter()
    with torch.profiler.record_function(
            f"{OP_RANGE}{opref.name}|{caller_source()}"), \
            torch.enable_grad() if recording else torch.no_grad():
        results = opref.fn(*tensors, **kwargs)
    if _config["aggregate_stats"]:
        _hook(opref.name, time.perf_counter() - t0)
    return results


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start():
    """Start profiling: a device-trace window and the host op stats."""
    import sys

    import torch

    from .ops import registry as _registry
    _registry._profiler = sys.modules[__name__]
    with _lock:
        if _state["running"]:
            return
        trace_dir = _config["filename"]
        if trace_dir.endswith(".json"):
            trace_dir = trace_dir[:-5]
        _state["trace_dir"] = trace_dir + "_trace"
        prof = torch.profiler.profile(
            activities=_activities(),
            profile_memory=bool(_config["profile_memory"]))
        prof.__enter__()
        _state["prof"] = prof
        _drop_session()
        _state["running"] = True
        if _state["op_stats"] is None or not _state["paused"]:
            _state["op_stats"] = _OpStats()
        _state["paused"] = False


def stop():
    """Close the trace window (its events stay for ``device_dumps`` and
    ``dump``)."""
    with _lock:
        if not _state["running"]:
            return
        prof = _state["prof"]
        _state["prof"] = None
        _state["running"] = False
    prof.__exit__(None, None, None)
    _state["last"] = prof


def pause(profile_process="worker"):
    """Suspend collection without resetting the aggregate table."""
    with _lock:
        if not _state["running"]:
            return
        _state["paused"] = True
    stop()


def resume(profile_process="worker"):
    start()


def dump(finished=True, profile_process="worker"):
    """Write the aggregate table as Chrome-trace JSON to ``filename`` and
    the last window's trace to ``<trace dir>/trace.json``."""
    st = _state["op_stats"]
    if st is None:
        return
    out = {"traceEvents": [
        {"name": name, "ph": "X", "ts": 0, "dur": v[1] * 1e6,
         "pid": 0, "tid": 0, "args": {"calls": v[0]}}
        for name, v in st.times.items()]}
    fname = _config["filename"]
    if not fname.endswith(".json"):
        fname += ".json"
    with open(fname, "w") as f:
        json.dump(out, f)
    if _state["last"] is not None and _state["trace_dir"]:
        os.makedirs(_state["trace_dir"], exist_ok=True)
        _state["last"].export_chrome_trace(
            os.path.join(_state["trace_dir"], "trace.json"))


def dumps(reset=False):
    """The aggregate stats table as a string (the reference's
    ``MXAggregateProfileStatsPrint``)."""
    with _lock:
        st = _state["op_stats"]
        s = st.table() if st else ""
        if reset and st:
            _state["op_stats"] = _OpStats()
    return s


def device_events():
    """``(name, microseconds)`` of each device record of the last closed
    window (``device_records``), under its kernel's full name."""
    return [(r["long_name"], r["dur_us"]) for r in device_records()]


def _drop_session():
    """Forget the exported trace of the last window (a new one opens)."""
    d = _state.pop("session", None)
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)


def device_records():
    """The last window's device records (``profiler_trace.parse_trace``
    of its Chrome trace, exported once a window into a temporary
    directory)."""
    from . import profiler_trace

    if _state["last"] is None:
        return []
    if _state.get("session") is None:
        _state["session"] = profiler_trace.export_trace(_state["last"])
    return profiler_trace.parse_trace(_state["session"])


def device_dumps(by="tf_op", peak_tflops=None, limit=30):
    """Per-kernel device-time table of the last ``start()``/``stop()``
    window (``profiler_trace``): by ``"tf_op"``, the registry op (or the
    port's annotation around a graph replay) that launched each kernel;
    ``"name"``, the kernel; ``"category"`` (copy, attention, matmul,
    convolution, reduction, elementwise, other); ``"source"``, the
    user's file:line that called the op.  A window that traced no
    device tabulates the host's top-level operators."""
    from . import profiler_trace

    if by not in ("tf_op", "name", "category", "source"):
        raise ValueError(f"by={by!r}: expected one of "
                         "'tf_op', 'name', 'category', 'source'")
    records = device_records()
    if not records:
        return ""
    return profiler_trace.format_table(
        profiler_trace.aggregate(records, by=by), peak_tflops=peak_tflops,
        limit=limit)


def set_state(state="stop", profile_process="worker"):
    if state in ("run", "start"):
        start()
    else:
        stop()


def state():
    return "run" if _state["running"] else "stop"


# --------------------------------------------------------------------------- #
# user annotation domains
# --------------------------------------------------------------------------- #

def TraceAnnotation(name):
    """A ``torch.profiler.record_function`` range named ``name`` (the
    reference's ``jax.profiler.TraceAnnotation``)."""
    import torch

    return torch.profiler.record_function(name)


class Domain:
    def __init__(self, name):
        self.name = name


def _qualified(domain, name):
    return getattr(domain, "name", "") + name if domain is not None \
        else name


class Scope:
    """``with mx.profiler.Scope('name'):`` — a range on the timeline."""

    def __init__(self, name="<unk>"):
        self._ann = TraceAnnotation(name)

    def __enter__(self):
        self._ann.__enter__()
        return self

    def __exit__(self, *a):
        self._ann.__exit__(*a)


class Task:
    """A named range with explicit start/stop (``ProfileTask``)."""

    def __init__(self, domain=None, name="task"):
        self.name = _qualified(domain, name)
        self._ann = None

    def start(self):
        self._ann = TraceAnnotation(self.name)
        self._ann.__enter__()

    def stop(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None


Frame = Task


class Counter:
    """A numeric counter (``ProfileCounter``) kept in the telemetry gauge
    ``profiler_counter{counter=}``: two counters of one (domain +) name
    share it, and a new one does not reset it."""

    def __init__(self, domain=None, name="counter", value=None):
        from . import telemetry
        self.name = _qualified(domain, name)
        self._gauge = telemetry.gauge("profiler_counter", counter=self.name)
        if value is not None:
            self.set_value(value)

    @property
    def value(self):
        return self._gauge.value

    @value.setter
    def value(self, v):
        self._gauge.set(v)

    def set_value(self, value):
        self._gauge.set(value)

    def increment(self, delta=1):
        self._gauge.add(delta)

    def decrement(self, delta=1):
        self._gauge.add(-delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    """An instant event (``ProfileMarker``): a telemetry ``marker``
    event and a zero-length range on the timeline."""

    def __init__(self, domain=None, name="marker"):
        self.name = _qualified(domain, name)

    def mark(self, scope="process"):
        from . import telemetry
        telemetry.emit("marker", name=self.name, scope=scope)
        with TraceAnnotation(f"marker:{self.name}"):
            pass


atexit.register(stop)
