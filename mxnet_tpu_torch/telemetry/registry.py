"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms (port of ``mxnet_tpu/telemetry/registry.py``, pure Python,
the same names and semantics).

Design constraints: always on, always cheap, thread-safe.
Recording is one small lock + integer/float arithmetic — no allocation,
no formatting, no I/O — so hot paths (one observe per decode step /
train step) pay well under a microsecond.  Exporting is pull-based:
``snapshot()`` (structured dict) and ``render_prometheus()`` (text
exposition format) walk the instruments on demand; nothing is paid at
record time for an exporter that is never called.

Callers on hot paths should hold the instrument object (returned by
:func:`counter`/:func:`gauge`/:func:`histogram`) instead of re-looking
it up per event — the lookup is a dict get, the hold is free.
"""
from __future__ import annotations

import bisect
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "snapshot",
           "render_prometheus", "reset_metrics",
           "DEFAULT_LATENCY_BUCKETS"]

# seconds-scale latency buckets: 100 us .. 60 s (plus the implicit +Inf
# overflow bucket) — wide enough for CPU decode steps and card
# train steps alike
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter (a view write through ``_assign`` — the dict
    compatibility shim ``DecodeServer.counters`` uses for resets — is
    the one sanctioned non-monotonic mutation)."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "_n")

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n=1):
        with self._lock:
            self._n += n

    def _assign(self, n):
        """Set the count outright (counter-view resets only)."""
        with self._lock:
            self._n = n

    @property
    def value(self):
        return self._n

    def _render(self):
        return [("", self._n)]


class Gauge:
    """Last-write-wins numeric value (occupancy, ring depth, window
    position)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "_v")

    def __init__(self, name, labels=()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v):
        with self._lock:
            self._v = v

    def add(self, n=1):
        with self._lock:
            self._v += n

    def _assign(self, v):
        with self._lock:
            self._v = v

    @property
    def value(self):
        return self._v

    def _render(self):
        return [("", self._v)]


class Histogram:
    """Fixed-bucket histogram: cumulative-on-render bucket counts plus
    sum/count/min/max.  ``observe`` is a bisect + four in-place updates
    under one lock; quantiles are estimated at read time by linear
    interpolation inside the winning bucket (clamped to the observed
    min/max so tails don't report bucket edges no sample reached)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "buckets", "_lock", "_counts",
                 "_sum", "_count", "_min", "_max")

    def __init__(self, name, labels=(), buckets=None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_LATENCY_BUCKETS))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def _assign(self, _v):
        """Reset (the only assignment a histogram supports)."""
        with self._lock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Bucket-interpolated quantile in [0, 1]; None when empty."""
        with self._lock:
            total = self._count
            if not total:
                return None
            counts = list(self._counts)
            lo_all, hi_all = self._min, self._max
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= rank and c:
                lo = self.buckets[i - 1] if i > 0 else lo_all
                hi = self.buckets[i] if i < len(self.buckets) else hi_all
                frac = (rank - seen) / c
                v = lo + (hi - lo) * frac
                return min(max(v, lo_all), hi_all)
            seen += c
        return hi_all

    def summary(self):
        """Structured snapshot: count/sum/mean/min/max/p50/p99."""
        with self._lock:
            n, s = self._count, self._sum
            lo, hi = self._min, self._max
        return {
            "count": n,
            "sum": s,
            "mean": s / n if n else None,
            "min": lo,
            "max": hi,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }

    def _render(self):
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append((f'le="{b:g}"', cum))
        out.append(('le="+Inf"', cum + counts[-1]))
        return [("bucket", out), ("sum", s), ("count", n)]


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Name+labels -> instrument table.  Get-or-create is double-checked
    under the lock; the steady-state lookup is one dict get."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    # -- get-or-create ------------------------------------------------- #
    def _get(self, cls, name, labels, **kw):
        # keyed WITHOUT kind, so re-requesting a name+labels as a
        # different instrument kind is a caller error (one exposition
        # series per name), not a silent second metric
        key = (name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"telemetry metric {name!r}{dict(labels)} already "
                f"registered as a {m.kind}, requested as a {cls.kind}")
        return m

    def counter(self, name, **labels) -> Counter:
        return self._get(Counter, name, _label_key(labels))

    def gauge(self, name, **labels) -> Gauge:
        return self._get(Gauge, name, _label_key(labels))

    def histogram(self, name, buckets=None, **labels) -> Histogram:
        return self._get(Histogram, name, _label_key(labels),
                         buckets=buckets)

    # -- exporters ------------------------------------------------------ #
    def _instruments(self):
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self):
        """``{name: [{labels, kind, value-or-summary}, ...]}``."""
        out = {}
        for m in self._instruments():
            row = {"labels": dict(m.labels), "kind": m.kind}
            if m.kind == "histogram":
                row.update(m.summary())
            else:
                row["value"] = m.value
            out.setdefault(m.name, []).append(row)
        return out

    def render_prometheus(self):
        """Prometheus text exposition format (one snapshot, no HTTP
        server — scrape adapters write this string wherever they like)."""
        by_name = {}
        for m in self._instruments():
            # grouped by (kind, name): a TYPE header never covers a
            # sample of another kind
            by_name.setdefault((m.kind, m.name), []).append(m)
        lines = []
        for kind, name in sorted(by_name):
            ms = by_name[(kind, name)]
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            for m in ms:
                base = ",".join(f'{_prom_name(k)}="{_prom_escape(v)}"'
                                for k, v in m.labels)
                if m.kind != "histogram":
                    lines.append(
                        f"{pname}{{{base}}} {m.value:g}" if base
                        else f"{pname} {m.value:g}")
                    continue
                for part, val in m._render():
                    if part == "bucket":
                        for le, cum in val:
                            lab = f"{base},{le}" if base else le
                            lines.append(f"{pname}_bucket{{{lab}}} {cum}")
                    else:
                        lines.append(
                            f"{pname}_{part}{{{base}}} {val:g}" if base
                            else f"{pname}_{part} {val:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset_metrics(self):
        """Zero every instrument's value (instruments stay registered —
        cached references in hot paths remain valid)."""
        for m in self._instruments():
            m._assign(0)


def _prom_name(name):
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_escape(value):
    """Label VALUES per the Prometheus text exposition format: inside
    the double quotes, backslash, double-quote and line-feed must be
    escaped (``\\\\``, ``\\"``, ``\\n``) — a hostile label value (a
    file path, an error string) must not break the scrape."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


REGISTRY = Registry()


def counter(name, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name, buckets=None, **labels) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, **labels)


def snapshot():
    return REGISTRY.snapshot()


def render_prometheus():
    return REGISTRY.render_prometheus()


def reset_metrics():
    REGISTRY.reset_metrics()
