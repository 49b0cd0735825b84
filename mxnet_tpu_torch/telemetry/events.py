"""Structured runtime event log: capture events, serve request spans,
bench rows — one stream, one schema (port of
``mxnet_tpu/telemetry/events.py``).

Every event is a flat dict ``{"ts": epoch_seconds, "kind": str, ...}``.
Events always land in a bounded in-process ring (queryable via
:func:`events`), and fan out to any attached sinks — the JSONL sink
(:func:`add_jsonl_sink`, or ``MXNET_TELEMETRY_JSONL=path`` to attach
one at first emit) writes one JSON object per line, the reference's
schema.  ``MXNET_TELEMETRY=0``
disables emission entirely (the enabled check is one dict lookup).

Emission cost: one dict build + deque append under a lock; sinks run
outside the lock on the emitting thread.  A sink that raises is dropped
(with one warning) — a broken exporter must not take down serving.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import deque

__all__ = ["emit", "events", "clear_events", "add_sink", "remove_sink",
           "add_jsonl_sink", "JsonlSink", "telemetry_enabled"]

_lock = threading.Lock()
_ring = None            # created lazily: capacity from env
_sinks = []
_env_sink_checked = False


def telemetry_enabled():
    """``MXNET_TELEMETRY=0`` turns event emission and the compile watch
    off (read per call so tests can toggle it)."""
    return os.environ.get("MXNET_TELEMETRY", "1") != "0"


def _ring_capacity():
    raw = os.environ.get("MXNET_TELEMETRY_EVENTS", "4096")
    try:
        return max(int(raw), 0)
    except ValueError:
        return 4096


def _ensure_ring_locked():
    global _ring
    if _ring is None:
        _ring = deque(maxlen=_ring_capacity())


def _attach_env_sink():
    """One-time ``MXNET_TELEMETRY_JSONL`` auto-attach (first emit).
    The sink is opened OUTSIDE the lock; registration (and the checked
    flag) flips under it — a lost race closes the duplicate."""
    global _env_sink_checked
    path = os.environ.get("MXNET_TELEMETRY_JSONL")
    sink = None
    if path:
        try:
            sink = JsonlSink(path)
        except OSError as e:
            warnings.warn(
                f"MXNET_TELEMETRY_JSONL={path!r}: {e!r} — JSONL "
                "sink not attached")
    with _lock:
        if _env_sink_checked:
            lost_race = sink
            sink = None
        else:
            _env_sink_checked = True
            if sink is not None:
                _sinks.append(sink)
            lost_race = None
    if lost_race is not None:
        lost_race.close()


def _rank_tag():
    """The pod rank this process was launched as (``MXNET_WORKER_ID``,
    a launcher exports), or None single-process.  Read
    from the environment per emit — one dict lookup, same cost
    discipline as :func:`telemetry_enabled` — so merged per-rank
    recordings (``telemetry_report --pod``) can attribute every event
    to its host."""
    raw = os.environ.get("MXNET_WORKER_ID")
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return raw


def emit(kind, **fields):
    """Record one event; returns the event dict (None when disabled).
    Pod runs add a ``rank`` field (see :func:`_rank_tag`); an explicit
    ``rank=`` kwarg wins."""
    if not telemetry_enabled():
        return None
    if not _env_sink_checked:
        _attach_env_sink()
    ev = {"ts": round(time.time(), 6), "kind": str(kind)}
    rank = _rank_tag()
    if rank is not None:
        ev["rank"] = rank
    ev.update(fields)
    with _lock:
        _ensure_ring_locked()
        _ring.append(ev)
        sinks = tuple(_sinks)
    for s in sinks:
        try:
            s(ev)
        except Exception as e:
            warnings.warn(f"telemetry sink {s!r} raised {e!r} — "
                          "sink dropped")
            remove_sink(s)
    return ev


def events(kind=None):
    """Snapshot of the in-process ring, oldest first, optionally
    filtered by ``kind``."""
    with _lock:
        snap = list(_ring) if _ring is not None else []
    if kind is None:
        return snap
    return [e for e in snap if e.get("kind") == kind]


def clear_events():
    """Drop the ring (capacity re-read from the environment) — test
    isolation helper.  Attached sinks stay attached."""
    global _ring
    with _lock:
        _ring = deque(maxlen=_ring_capacity())


def add_sink(sink):
    """Attach a callable ``sink(event_dict)``; returns it for
    :func:`remove_sink`."""
    with _lock:
        _ensure_ring_locked()
        _sinks.append(sink)
    return sink


def remove_sink(sink):
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)
    close = getattr(sink, "close", None)
    if callable(close):
        try:
            close()
        except OSError:
            pass


def _jsonable(o):
    # numpy scalars and one-element torch tensors (``Tensor.item``)
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(o)


class JsonlSink:
    """One JSON object per line, flushed per event (crash-safe streams
    beat buffered throughput for telemetry)."""

    def __init__(self, path):
        self._f = open(path, "a", encoding="utf-8")
        self._wlock = threading.Lock()

    def __call__(self, ev):
        line = json.dumps(ev, default=_jsonable)
        with self._wlock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._wlock:
            if not self._f.closed:
                self._f.close()

    def __repr__(self):
        name = getattr(self._f, "name", "?")
        return f"JsonlSink({name!r})"


def add_jsonl_sink(path):
    """Attach a :class:`JsonlSink` writing to ``path`` (append mode)."""
    return add_sink(JsonlSink(path))
