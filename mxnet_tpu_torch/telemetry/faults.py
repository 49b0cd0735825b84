"""Deterministic fault injection (``MXNET_FAULT_INJECT``), port of
``mxnet_tpu/telemetry/faults.py``.

The recovery paths a server promises — a scheduler whose death fails
every in-flight stream instead of hanging consumers, a watchdog that
turns a wedged dispatch into an error — are exactly the paths ordinary
tests never execute.  This module makes them executable on the CPU,
deterministically: named injection sites are threaded through the
serve scheduler (``serve.pump``, ``serve.admit``, ``serve.chunk``,
``serve.verify``, ``serve.step``), and an env spec arms them.

Spec grammar (comma-separated rules)::

    MXNET_FAULT_INJECT=site:kind:after_n[:arg][,site:kind:after_n...]

Each rule fires EXACTLY ONCE, on the ``after_n``-th hit of its site
(site hit counts are process-wide and shared by all rules).  Kinds:

- ``raise`` — raise ``MXNetError`` naming the site (the injected
  error every recovery path must surface, not swallow).
- ``delay`` — sleep ``arg`` seconds (default 0.05) and continue.
- ``hang``  — sleep ``arg`` seconds (default 3600): a wedged rank /
  dispatch, from the watchdogs' point of view.
- ``kill``  — ``os.kill(os.getpid(), arg or SIGKILL)``: hard process
  death, no cleanup, no exit handlers — what a preempted host or an
  OOM-killed rank looks like to its peers.

Zero overhead when unset: :func:`fault_point` is one ``os.environ``
dict lookup and a return — the same gate discipline as
``MXNET_TELEMETRY=0``.  When a rule fires, a ``fault_injected`` event
and a ``faults_injected_total{site,kind}`` counter are recorded first
(for ``raise``/``delay``/``hang``; ``kill`` dies too hard to flush),
so a recorded JSONL names every injected fault next to the failure it
caused.

Rank scoping: the spec is plain env, so per-rank faults in a
launched job are set by the rank itself (branch on
``MXNET_WORKER_ID`` before the first ``fault_point`` runs) — the
harness stays a pure site/count matcher.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from collections import namedtuple

from ..base import MXNetError

__all__ = ["fault_point", "parse_fault_spec", "reset_faults",
           "FaultRule"]

FaultRule = namedtuple("FaultRule", ("site", "kind", "after_n", "arg"))

_KINDS = ("raise", "delay", "hang", "kill")

_lock = threading.Lock()
_state = {"raw": None, "rules": ()}   # parsed spec, cached on the raw
_hits: dict = {}                      # site -> process-wide hit count
_fired: set = set()                   # rule indices already triggered


def parse_fault_spec(raw):
    """``site:kind:after_n[:arg]`` rules, comma-separated.  A malformed
    spec is a loud configuration error at the first armed site, not a
    silently inert chaos run."""
    rules = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (3, 4):
            raise MXNetError(
                f"MXNET_FAULT_INJECT rule {part!r}: expected "
                "site:kind:after_n[:arg]")
        site, kind = fields[0], fields[1]
        if not site or kind not in _KINDS:
            raise MXNetError(
                f"MXNET_FAULT_INJECT rule {part!r}: kind must be one "
                f"of {'/'.join(_KINDS)}")
        try:
            after_n = int(fields[2])
            arg = float(fields[3]) if len(fields) == 4 else None
        except ValueError:
            raise MXNetError(
                f"MXNET_FAULT_INJECT rule {part!r}: after_n must be "
                "an integer (and arg a number)")
        if after_n < 1:
            raise MXNetError(
                f"MXNET_FAULT_INJECT rule {part!r}: after_n must be "
                ">= 1")
        rules.append(FaultRule(site, kind, after_n, arg))
    return tuple(rules)


def reset_faults():
    """Zero the site hit counts and re-arm every rule (test isolation:
    the spec cache is also dropped, so a monkeypatched env re-parses)."""
    with _lock:
        _hits.clear()
        _fired.clear()
        _state["raw"] = None
        _state["rules"] = ()


def _trigger(rule, context):
    from .events import emit
    from .registry import counter

    # context keys that would collide with emit()'s own parameter or
    # the event schema's reserved fields are prefixed, not fatal — a
    # sloppy call-site kwarg must not turn an armed fault into a
    # TypeError that masks the injection
    context = {(f"ctx_{k}" if k in ("kind", "ts", "site", "fault_kind",
                                    "after_n", "arg") else k): v
               for k, v in context.items()}
    emit("fault_injected", site=rule.site, fault_kind=rule.kind,
         after_n=rule.after_n, arg=rule.arg, **context)
    counter("faults_injected_total", site=rule.site,
            kind=rule.kind).inc()
    if rule.kind == "raise":
        raise MXNetError(
            f"injected fault at {rule.site} "
            f"(MXNET_FAULT_INJECT, hit {rule.after_n})")
    if rule.kind == "delay":
        time.sleep(rule.arg if rule.arg is not None else 0.05)
    elif rule.kind == "hang":
        time.sleep(rule.arg if rule.arg is not None else 3600.0)
    elif rule.kind == "kill":
        sig = int(rule.arg) if rule.arg is not None else signal.SIGKILL
        os.kill(os.getpid(), sig)
        time.sleep(5.0)   # SIGKILL delivery is not synchronous


def fault_point(site, **context):
    """One named injection site.  Free when ``MXNET_FAULT_INJECT`` is
    unset (one env dict lookup); otherwise counts the hit and fires any
    armed rule for ``site``.  ``context`` fields land on the
    ``fault_injected`` event."""
    raw = os.environ.get("MXNET_FAULT_INJECT")
    if not raw:
        if _state["raw"] is not None:
            # spec was unset: drop the cache, so re-arming the SAME
            # spec later re-fires instead of inheriting a stale
            # fired-set (a silently inert chaos run)
            reset_faults()
        return
    with _lock:
        if raw != _state["raw"]:
            _state["rules"] = parse_fault_spec(raw)
            _state["raw"] = raw
            _hits.clear()
            _fired.clear()
        n = _hits[site] = _hits.get(site, 0) + 1
        due = [(i, r) for i, r in enumerate(_state["rules"])
               if r.site == site and r.after_n == n and i not in _fired]
        for i, _ in due:
            _fired.add(i)
    for _, rule in due:
        _trigger(rule, context)
