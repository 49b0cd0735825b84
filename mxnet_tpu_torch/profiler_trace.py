"""Per-kernel device profiling: the aggregate table inside a step.

Port of ``mxnet_tpu/profiler_xla.py``, under its own name because it
parses no XLA: it reads the Chrome trace that ``torch.profiler`` writes
for a ``mx.profiler.start()``/``stop()`` window and gives each device
kernel, copy and set of the window one record with the reference's keys
(``name``, ``category``, ``tf_op``, ``source``, ``long_name``,
``dur_us``, ``flops``, ``bytes``).  A kernel's ``name`` is its trace
name without the return type and anonymous namespaces (``short_name``),
so a table's key keeps the kernel's own name; ``long_name`` is the
trace's.

Provenance, the reference's ``tf_op``: while the profiler runs,
``ops.registry.invoke`` opens a ``record_function`` range named
``mx.op:<op>|<file>:<line>`` around each op (the file and line of the
first caller outside ``mxnet_tpu_torch`` and ``torch``), and the port's
annotations (``mx:fused_step:micro``/``apply``, ``mx:cached_op:<block>``)
are ranges too.  A kernel is linked through its correlation id to the
host call that launched it (``cudaLaunchKernel``, a copy, a
``cudaGraphLaunch``); its ``tf_op`` is the innermost such range around
that call, and its ``source`` the file:line of that op.  A kernel
launched by the autograd engine takes the op of its node's forward: the
backward's ``autograd::engine::evaluate_function`` range carries the
forward op's sequence number, and the forward op lies in the range of
the op that made it, so flash attention's backward kernels read
``flash_attention``.
A CUDA-graph replay's kernels carry the replay's correlation, so their
``tf_op`` is the annotation around the replay.

A window that traced no device (the CPU) gives the host's top-level
``aten::`` operators instead, with the same provenance.  ``flops`` and
``bytes`` are 0: the trace gives neither for a kernel, so
``format_table`` prints 0 TFLOP/s and GB/s, as the reference does for an
op without ``model_flops``.

``count_hlo_ops`` is the reference's HLO-text counter, copied unchanged;
``hlo_op_count(fn, *args)`` is the port's count of dispatched device
ops: the kernel nodes of one CUDA-graph capture of ``fn`` (of the graph
itself when ``fn`` is a captured ``_GraphProgram``), or on the CPU the
top-level ``aten::`` operators one call dispatches.

Usage::

    rows = aggregate(profile_fn(step, x), by="tf_op")
    print(format_table(rows))

or ``mx.profiler.device_dumps(by="tf_op")`` after a window.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import shutil
import sys
import tempfile
from collections import defaultdict

from .base import MXNetError

__all__ = ["parse_trace", "aggregate", "format_table", "profile_fn",
           "latest_session", "count_hlo_ops", "hlo_op_count"]

OP_RANGE = "mx.op:"        # invoke's ranges: mx.op:<op>|<file>:<line>
ANNOTATION = "mx:"         # the port's annotations (fused step, programs)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# frames of these packages are not the caller's source line
_SKIP = ("mxnet_tpu_torch" + os.sep, "torch" + os.sep)

_CATEGORIES = (("copy", ("memcpy", "memset", "copy")),
               ("attention", ("flash_",)),
               ("matmul", ("gemm", "xmma", "cutlass", "matmul", "mma")),
               ("convolution", ("conv", "cudnn")),
               ("reduction", ("reduce", "norm", "softmax")),
               ("elementwise", ("elementwise", "vectorized", "unrolled")))


def category(name):
    """A kernel's category from its name: copy, attention, matmul,
    convolution, reduction, elementwise or other."""
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def short_name(long_name):
    """A kernel's name without its return type and anonymous namespaces:
    ``void (anonymous namespace)::flash_fwd_mma_kernel<...>(...)`` reads
    ``flash_fwd_mma_kernel<...>(...)``, so a table's cut key keeps the
    kernel's own name."""
    if long_name.startswith("void "):
        long_name = long_name[5:]
    return long_name.replace("(anonymous namespace)::", "")


def _internal(path):
    return any(os.sep + p in path or path.startswith(p) for p in _SKIP)


def caller_source():
    """``file:line`` of the first frame outside ``mxnet_tpu_torch`` and
    ``torch`` (the user's call of an op, not ``nn.Module``'s dispatch);
    read by ``invoke`` only while profiling."""
    f = sys._getframe(1)
    while f is not None and _internal(f.f_code.co_filename):
        f = f.f_back
    if f is None:
        return ""
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _trace_files(path):
    return sorted(glob.glob(os.path.join(path, "*.json")) +
                  glob.glob(os.path.join(path, "*.json.gz")))


def latest_session(trace_dir):
    """The newest profile session under ``trace_dir``: ``trace_dir``
    itself if it holds a trace, else its newest subdirectory that does
    (``export_trace`` writes one a window)."""
    if _trace_files(trace_dir):
        return trace_dir
    sessions = sorted(d for d in glob.glob(os.path.join(trace_dir, "*"))
                      if os.path.isdir(d) and _trace_files(d))
    if not sessions:
        raise FileNotFoundError(f"no profile sessions under {trace_dir}")
    return sessions[-1]


def export_trace(prof, trace_dir=None):
    """Write a closed ``torch.profiler`` window's Chrome trace as a new
    session under ``trace_dir`` (a new temporary directory by default);
    returns ``trace_dir``."""
    if trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="mx_prof_")
    n = len(glob.glob(os.path.join(trace_dir, "session_*")))
    session = os.path.join(trace_dir, f"session_{n:06d}")
    os.makedirs(session, exist_ok=True)
    prof.export_chrome_trace(os.path.join(session, "trace.json"))
    return trace_dir


def _load(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


class _Ranges:
    """Ranges of one host thread, innermost-first lookup by time."""

    def __init__(self):
        self.items = []         # (ts, end, payload)

    def add(self, ts, dur, payload):
        self.items.append((ts, ts + dur, payload))

    def freeze(self):
        self.items.sort(key=lambda r: r[0])
        self.starts = [r[0] for r in self.items]

    def innermost(self, t):
        """The latest-starting range around ``t`` (ranges nest)."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            ts, end, payload = self.items[i]
            if end >= t:
                return payload
            i -= 1
        return None


def _split_range(name):
    """(tf_op, source) of a range name."""
    if name.startswith(OP_RANGE):
        op, _, src = name[len(OP_RANGE):].partition("|")
        return op, src
    return name, ""


def _parse_events(events):
    ranges = defaultdict(_Ranges)       # (pid, tid) -> mx ranges
    backward = defaultdict(_Ranges)     # (pid, tid) -> evaluate_function
    forward = defaultdict(list)         # seq -> [(ts, pid, tid)]
    launches = {}                       # correlation -> (pid, tid, ts)
    device, host_ops = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        name = e.get("name", "")
        args = e.get("args") or {}
        where = (e.get("pid"), e.get("tid"))
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (where, ts)
        elif cat == "user_annotation":
            if name.startswith(OP_RANGE) or name.startswith(ANNOTATION):
                ranges[where].add(ts, dur, _split_range(name))
        elif cat == "cpu_op":
            seq = args.get("Sequence number")
            if name.startswith("autograd::engine::evaluate_function"):
                if seq is not None:
                    backward[where].add(ts, dur, seq)
            elif seq is not None and not args.get("Fwd thread id"):
                forward[seq].append((ts, where))
            if name.startswith("aten::"):
                host_ops.append(e)
    for r in list(ranges.values()) + list(backward.values()):
        r.freeze()
    return ranges, backward, forward, launches, device, host_ops


def _provenance(where, t, ranges, backward, forward):
    """(tf_op, source) of a host call on thread ``where`` at ``t``."""
    r = ranges.get(where)
    hit = r.innermost(t) if r is not None else None
    if hit is not None:
        return hit
    b = backward.get(where)
    seq = b.innermost(t) if b is not None else None
    if seq is not None:
        # the forward op of this node: the latest with its number that
        # started before the backward
        cands = [(ts, w) for ts, w in forward.get(seq, ()) if ts <= t]
        if cands:
            ts, w = max(cands, key=lambda c: c[0])
            r = ranges.get(w)
            hit = r.innermost(ts) if r is not None else None
            if hit is not None:
                return hit
    return "", ""


def _top_level(host_ops):
    """The ``aten::`` operators not nested in another on their thread."""
    by_thread = defaultdict(list)
    for e in host_ops:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        end = -1.0
        for e in evs:
            ts = float(e["ts"])
            if ts >= end:
                out.append(e)
                end = ts + float(e.get("dur", 0.0))
    return out


def parse_trace(trace_dir):
    """The device records of the newest session under ``trace_dir``: one
    dict a kernel, copy or set (``name``, ``category``, ``tf_op``,
    ``source``, ``long_name``, ``dur_us``, ``flops``, ``bytes``); for a
    window that traced no device, one a top-level host ``aten::``
    operator."""
    session = latest_session(trace_dir)
    records = []
    for path in _trace_files(session):
        ranges, backward, forward, launches, device, host_ops = \
            _parse_events(_load(path))
        if device:
            for e in device:
                args = e.get("args") or {}
                hit = launches.get(args.get("correlation"))
                tf_op, source = ("", "") if hit is None else _provenance(
                    hit[0], hit[1], ranges, backward, forward)
                name = e.get("name", "?")
                cat = e.get("cat")
                records.append({
                    "name": short_name(name),
                    "category": "copy" if cat != "kernel"
                    else category(name),
                    "tf_op": tf_op, "source": source, "long_name": name,
                    "dur_us": float(e.get("dur", 0.0)),
                    "flops": 0, "bytes": int(args.get("bytes", 0) or 0)
                    if cat != "kernel" else 0})
        else:
            for e in _top_level(host_ops):
                where = (e.get("pid"), e.get("tid"))
                tf_op, source = _provenance(where, float(e["ts"]), ranges,
                                            backward, forward)
                records.append({
                    "name": e["name"], "category": "host",
                    "tf_op": tf_op, "source": source,
                    "long_name": e["name"],
                    "dur_us": float(e.get("dur", 0.0)),
                    "flops": 0, "bytes": 0})
    return records


def aggregate(records, by="category"):
    """Group records by ``category`` | ``name`` | ``tf_op`` | ``source``.

    Returns rows sorted by total time desc: dicts with ``key``, ``calls``,
    ``dur_us``, ``flops``, ``bytes``, ``tflops`` (achieved), ``gbps``
    (achieved memory bandwidth), ``pct`` of total device time.
    """
    groups = defaultdict(lambda: [0, 0.0, 0, 0])
    for r in records:
        k = r[by] or "<none>"
        g = groups[k]
        g[0] += 1
        g[1] += r["dur_us"]
        g[2] += r["flops"]
        g[3] += r["bytes"]
    total = sum(g[1] for g in groups.values()) or 1.0
    rows = []
    for k, (n, dur, fl, by_) in groups.items():
        rows.append({
            "key": k, "calls": n, "dur_us": dur, "flops": fl, "bytes": by_,
            "tflops": fl / dur / 1e6 if dur else 0.0,
            "gbps": by_ / dur / 1e3 if dur else 0.0,
            "pct": 100.0 * dur / total,
        })
    rows.sort(key=lambda r: -r["dur_us"])
    return rows


def format_table(rows, peak_tflops=None, limit=30):
    """Render aggregate rows as the reference-style per-op stats table."""
    lines = [f"{'Op':<44}{'Calls':>6}{'Time(us)':>11}{'%':>6}"
             f"{'TFLOP/s':>9}{'GB/s':>8}" +
             ("{:>6}".format("MFU%") if peak_tflops else ""),
             "-" * (84 + (6 if peak_tflops else 0))]
    for r in rows[:limit]:
        line = (f"{r['key'][:43]:<44}{r['calls']:>6}{r['dur_us']:>11.1f}"
                f"{r['pct']:>6.1f}{r['tflops']:>9.1f}{r['gbps']:>8.0f}")
        if peak_tflops:
            line += f"{100 * r['tflops'] / peak_tflops:>6.1f}"
        lines.append(line)
    tot = sum(r["dur_us"] for r in rows)
    lines.append(f"{'TOTAL':<44}{sum(r['calls'] for r in rows):>6}"
                 f"{tot:>11.1f}{100.0:>6.1f}")
    return "\n".join(lines)


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_fn(fn, *args, trace_dir=None, iters=2, warmup=True):
    """Trace ``fn(*args)`` and return its records, per call.

    One warm-up call (a hybridized block's or a fused step's capture),
    then ``iters`` calls in one ``mx.profiler`` window closed by a
    synchronization of the card; every duration is divided by
    ``iters``.  The trace is written under ``trace_dir`` (by default a
    temporary directory, removed after parsing).  Refused inside a
    running ``mx.profiler`` window."""
    from . import profiler

    if profiler.state() == "run":
        raise MXNetError("profile_fn: an mx.profiler window is already "
                         "running; stop() it first")
    if warmup:
        fn(*args)
        _sync()
    profiler.start()
    try:
        for _ in range(iters):
            fn(*args)
        _sync()
    finally:
        profiler.stop()
    d = export_trace(profiler._state["last"], trace_dir)
    try:
        records = parse_trace(d)
    finally:
        if trace_dir is None:
            shutil.rmtree(d, ignore_errors=True)
    for r in records:
        r["dur_us"] /= iters
    return records


# ----------------------------------------------------------------------- #
# static HLO op counting — the sequencer-overhead metric
# ----------------------------------------------------------------------- #
# instructions that exist in the HLO text but are not dispatched ops:
# parameters/constants are materialized buffers, tuple plumbing is free,
# bitcast is a layout annotation
_NON_EXEC_OPS = frozenset(
    ("parameter", "constant", "tuple", "get-tuple-element", "bitcast"))
# computation params and instruction result types may be tuples with
# internal spaces/parens — "(s32[], f32[2,4]{1,0})" — hence the loose
# ".*) ->" header match and the explicit tuple-type alternative
_COMP_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->")
_CALLED_COMP = re.compile(r"(?:calls=|to_apply=)%?([\w.\-]+)")
_INSTR = re.compile(
    r"^\s+(?:ROOT\s+)?%?[\w.\-]+\s+=\s+(?:\([^)]*\)|\S+)\s+([\w\-]+)\(")


def count_hlo_ops(hlo_text):
    """Count the sequencer-visible instructions in optimized HLO text.

    Convention (matches how the device trace counts executed ops):

    - fusion bodies (``calls=``) and reduce/scatter/sort combinators
      (``to_apply=``) execute as part of ONE instruction in their caller
      — their inner instructions are not counted;
    - ``while`` bodies/conditions ARE counted, ONCE — a body that runs NL
      times still costs one body's worth of *distinct* program ops, which
      is exactly the collapse a stacked-layer ``lax.scan`` buys over an
      unrolled layer stack;
    - parameters, constants, and tuple/get-tuple-element/bitcast plumbing
      are free (no dispatched kernel).
    """
    excluded = set(_CALLED_COMP.findall(hlo_text))
    n = 0
    current = None
    for line in hlo_text.splitlines():
        m = _COMP_HEADER.match(line)
        if m:
            current = m.group(2)
            continue
        if line.startswith("}"):
            current = None
            continue
        if current is None or current in excluded:
            continue
        m = _INSTR.match(line)
        if m and m.group(1) not in _NON_EXEC_OPS:
            n += 1
    return n


def _tensor_list(out):
    import torch

    from .ndarray.ndarray import NDArray

    if isinstance(out, NDArray):
        return [out._data]
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensor_list(o)]
    return []


def _first_device(args):
    """The device of the first tensor argument, else the current
    context's (``gpu(0)``: raises without CUDA outside ``mx.cpu()``)."""
    for t in _tensor_list(list(args)):
        return t.device
    from .context import current_context
    return current_context().torch_device()


def hlo_op_count(fn, *args, **kwargs):
    """The device ops one call of ``fn(*args, **kwargs)`` dispatches.

    On the card: the kernel nodes of a CUDA-graph capture of the call
    (after one eager warm-up call; the capture is never replayed), or of
    ``fn``'s own graph when ``fn`` is a captured ``_GraphProgram`` (a
    hybridized block's or a fused step's program).  On the CPU: the
    top-level ``aten::`` operators one call runs (a torch.profiler
    window around it)."""
    import torch

    from .gluon.block import _GraphProgram

    if isinstance(fn, _GraphProgram):
        if not fn.on_card:
            raise MXNetError("hlo_op_count: a program on the CPU has no "
                             "graph; pass its function instead")
        return sum(fn.kernel_nodes().values())
    device = _first_device(args)
    if device.type == "cuda":
        prog = _GraphProgram(lambda: _tensor_list(fn(*args, **kwargs)),
                             device, None, [])
        prog()              # the eager warm-up, on the capture's stream
        return sum(prog.kernel_nodes().values())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(*args, **kwargs)
    d = export_trace(prof)
    try:
        events = _load(os.path.join(latest_session(d), "trace.json"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ops = [e for e in events if e.get("ph") == "X" and
           e.get("cat") == "cpu_op" and e.get("name", "").startswith("aten::")]
    return len(_top_level(ops))
