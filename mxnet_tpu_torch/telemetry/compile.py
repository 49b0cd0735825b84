"""Capture watch: turn every CUDA-graph capture of a program into a
queryable ``compile`` event (the port's counterpart of the reference's
compile/retrace watch, ``mxnet_tpu/telemetry/compile.py``).

``instrument_program(prog, site, key, fields)`` watches a
``gluon.block._GraphProgram``: on the card each capture (the program's
second call) emits one ``compile`` event carrying the site, the
producer's key, the capture's seconds (``prog.capture_s``) and the
kernel nodes one replay launches (the watch keeps the graph's nodes for
``debug_dump``) and the seconds their count took (``count_s``); on the
CPU, where nothing is captured, the program's
first call is its "compile" and the event carries that call's seconds
and no node count.  The registry mirrors the stream:
``compiles_total{site=}``.  ``MXNET_TELEMETRY=0`` leaves the program
unwatched.  ``instrument_jit`` is the same function under the
reference's name.
"""
from __future__ import annotations

import time

from . import events
from .registry import REGISTRY

__all__ = ["instrument_program", "instrument_jit"]


def instrument_program(prog, site, key=None, fields=None):
    """Watch ``prog`` (a ``_GraphProgram``) so that each capture emits a
    ``compile`` event; returns ``prog`` itself.  ``fields`` are merged
    into every event of this program."""
    if not events.telemetry_enabled():
        return prog
    prog.watch = _CaptureWatch(site, key, fields)
    if prog.on_card:
        prog.debug = True       # keep the nodes: the event counts them
    return prog


instrument_jit = instrument_program


class _CaptureWatch:
    __slots__ = ("site", "key", "fields", "events")

    def __init__(self, site, key, fields):
        self.site = site
        self.key = key
        self.fields = dict(fields) if fields else {}
        self.events = 0

    def first_call(self, prog):
        """The CPU's "compile": time the program's first call."""
        t0 = time.perf_counter()
        outs = prog.run()
        self.record(time.perf_counter() - t0, None)
        return outs

    def captured(self, prog):
        """A capture of ``prog`` on the card just kept its graph."""
        nodes = None
        t0 = time.perf_counter()
        if prog.graph_debug:
            try:
                nodes = sum(prog.kernel_nodes().values())
            except Exception:       # a dump the graph cannot give
                nodes = None
        self.record(prog.capture_s, nodes, time.perf_counter() - t0)

    def record(self, seconds, nodes, count_s=0.0):
        self.events += 1
        ev = dict(self.fields)
        ev["site"] = self.site
        if self.key is not None:
            ev["key"] = str(self.key)
        ev["seconds"] = round(float(seconds), 6)
        ev["kernel_nodes"] = nodes
        ev["count_s"] = round(float(count_s), 6)    # counting the nodes
        ev["captures"] = self.events
        REGISTRY.counter("compiles_total", site=self.site).inc()
        events.emit("compile", **ev)
