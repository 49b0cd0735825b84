"""Weight-only int8 matvec for decode (kernel K4).

Port of ``mxnet_tpu/ops/q8_matvec.py``.  ``q8_matvec`` computes
``(x @ wt) * s + bias`` in f32 from int8 codes; on a CUDA tensor it
launches the hand-written kernel ``csrc/q8_matvec.cu`` (which says what
bounds it and how) with the grid ``plan`` chooses, on a CPU tensor it
runs ``q8_matvec_plain``.  It never falls back from the card to the
plain version: what the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["q8_matvec", "q8_matvec_plain", "plan"]

SMS = 132                   # streaming multiprocessors of an H100 SXM
_TN = 128                   # output columns a unit (csrc kTN)
_XS_FLOATS = 8192           # shared f32 slots for a slice's x rows
_STEP = 16                  # K rows a slice step (csrc block_work)
_SMS: dict = {}             # device -> SM count
_LAUNCHES: dict = {}        # (B, K, O, device, stream) -> _Launch


def q8_matvec_plain(x, wt, s, bias=None):
    """The plain PyTorch version: the same arithmetic in f32 — int8 codes
    upcast, an f32 product, the per-channel scale, then the bias."""
    y = torch.matmul(x.float(), wt.float()) * s
    if bias is not None:
        y = y + bias.float()
    return y


def plan(B: int, K: int, O: int, sms: int = SMS):
    """The launch plan of K4: ``(rows, blocks, slices)``.

    - ``rows``: the row bucket (1, 2, 4 or 8), the kernel's template
      argument; B > 8 runs in ``ceil(B / 8)`` row groups;
    - a unit is (row group, 128-column tile); the K axis of every unit is
      cut into ``slices`` on 16-row steps, as few as put a block on every
      SM (``blocks = units * slices >= sms``), but at least as many as
      keep a slice's f32 x rows within the FMA path's 32 KB of shared
      memory, and at most one a step.  More slices than that were slower
      on an H100: each adds a partial to the unit's final sum.

    The last slice of a unit to finish sums the partials in slice order,
    so the plan fixes the summation order."""
    rows = next(r for r in (1, 2, 4, 8) if r >= min(B, 8))
    units = max(1, -(-O // _TN) * -(-B // rows))
    steps = max(1, -(-K // _STEP))
    slices = max(-(-sms // units), -(-steps * _STEP * rows // _XS_FLOATS))
    slices = min(slices, steps)
    return rows, units * slices, slices


class _Launch:
    """The plan of one (B, K, O) on one stream and its scratch: the
    slices' partials and the units' tickets (zero, and left zero by every
    launch: the last slice of a unit resets its own).  Launches on one
    stream run in order, so they share it."""

    def __init__(self, B, K, O, device):
        self.rows, self.blocks, self.slices = plan(B, K, O, _sms(device))
        units = -(-O // _TN) * -(-B // self.rows)
        self.part = torch.empty(
            (self.slices, units, self.rows * _TN) if self.slices > 1
            else (0,), dtype=torch.float32, device=device)
        self.tickets = torch.zeros((units,), dtype=torch.int32,
                                   device=device)
        self.part_ptr = self.part.data_ptr()
        self.ticket_ptr = self.tickets.data_ptr()


def _check(x, wt, s, bias):
    if x.dim() != 2 or wt.dim() != 2 or x.shape[1] != wt.shape[0]:
        raise MXNetError(f"q8_matvec: x {tuple(x.shape)} and wt "
                         f"{tuple(wt.shape)} do not form (B,K) @ (K,O)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise MXNetError(f"q8_matvec: x must be bf16 or f32, got {x.dtype}")
    O = wt.shape[1]
    if wt.dtype != torch.int8:
        raise MXNetError(f"q8_matvec: wt must be int8, got {wt.dtype}")
    dev = x.device
    for name, t in (("x", x), ("wt", wt), ("s", s), ("bias", bias)):
        if t is None:
            continue
        if name in ("s", "bias") and (t.dtype != torch.float32 or
                                      t.shape != (O,)):
            raise MXNetError(f"q8_matvec: {name} must be f32 of shape "
                             f"({O},), got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise MXNetError(f"q8_matvec: {name} on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise MXNetError(f"q8_matvec: {name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The library of the kernel and its typed C entry point."""
    lib = _build.load("q8_matvec")
    fn = lib.q8_matvec_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _sms(device):
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def q8_matvec(x, wt, s, bias=None):
    """``(x @ wt) * s + bias`` with int8 weights.

    - ``x`` (B, K) bf16/f32 — the decode batch;
    - ``wt`` (K, O) int8 codes, pre-transposed at quantization time;
    - ``s`` (O,) f32 per-output-channel scales; ``bias`` (O,) f32 or None.

    Returns (B, O) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``q8_matvec.launches`` counts launches)."""
    _check(x, wt, s, bias)
    dev = x.device
    if dev.type == "cpu":
        return q8_matvec_plain(x, wt, s, bias)
    if dev.type != "cuda":
        raise MXNetError(f"q8_matvec: unsupported device {dev}")
    B, K = x.shape
    O = wt.shape[1]
    out = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B == 0 or O == 0:
        return out
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (B, K, O, dev, stream)
    ln = _LAUNCHES.get(key)
    if ln is None:
        ln = _LAUNCHES[key] = _Launch(B, K, O, dev)
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), wt.data_ptr(),
            s.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), ln.part_ptr, ln.ticket_ptr, B, K, O, ln.rows,
            ln.blocks, stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:                       # the stream's device must be current
        with torch.cuda.device(dev):
            err = fn(*args)
    _build.check(lib, err, "q8_matvec")
    q8_matvec.last_plan = (ln.rows, ln.blocks, ln.slices)
    q8_matvec.launches += 1
    return out


q8_matvec.launches = 0
q8_matvec.last_plan = None
