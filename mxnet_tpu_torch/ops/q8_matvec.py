"""Weight-only int8 matvec for decode (kernel K4).

Port of ``mxnet_tpu/ops/q8_matvec.py``.  ``q8_matvec`` computes
``(x @ wt) * s + bias`` in f32 from int8 codes; on a CUDA tensor it
launches the hand-written kernel ``csrc/q8_matvec.cu`` (which says what
bounds it and how), on a CPU tensor it runs ``q8_matvec_plain``.  It
never falls back from the card to the plain version: what the kernel
does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["q8_matvec", "q8_matvec_plain"]


def q8_matvec_plain(x, wt, s, bias=None):
    """The plain PyTorch version: the same arithmetic in f32 — int8 codes
    upcast, an f32 product, the per-channel scale, then the bias."""
    y = torch.matmul(x.float(), wt.float()) * s
    if bias is not None:
        y = y + bias.float()
    return y


def _check(x, wt, s, bias):
    if x.dim() != 2 or wt.dim() != 2 or x.shape[1] != wt.shape[0]:
        raise MXNetError(f"q8_matvec: x {tuple(x.shape)} and wt "
                         f"{tuple(wt.shape)} do not form (B,K) @ (K,O)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise MXNetError(f"q8_matvec: x must be bf16 or f32, got {x.dtype}")
    O = wt.shape[1]
    if wt.dtype != torch.int8:
        raise MXNetError(f"q8_matvec: wt must be int8, got {wt.dtype}")
    for name, t in (("s", s), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or
                              tuple(t.shape) != (O,)):
            raise MXNetError(f"q8_matvec: {name} must be f32 of shape "
                             f"({O},), got {t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), ("wt", wt), ("s", s), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise MXNetError(f"q8_matvec: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"q8_matvec: {name} must be contiguous")


def _launcher():
    """The library of the kernel and its typed C entry point."""
    lib = _build.load("q8_matvec")
    fn = lib.q8_matvec_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def q8_matvec(x, wt, s, bias=None):
    """``(x @ wt) * s + bias`` with int8 weights.

    - ``x`` (B, K) bf16/f32 — the decode batch;
    - ``wt`` (K, O) int8 codes, pre-transposed at quantization time;
    - ``s`` (O,) f32 per-output-channel scales; ``bias`` (O,) f32 or None.

    Returns (B, O) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``q8_matvec.launches`` counts launches)."""
    _check(x, wt, s, bias)
    if x.device.type == "cpu":
        return q8_matvec_plain(x, wt, s, bias)
    if x.device.type != "cuda":
        raise MXNetError(f"q8_matvec: unsupported device {x.device}")
    B, K = x.shape
    O = wt.shape[1]
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0 or O == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 wt.data_ptr(), s.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 B, K, O, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "q8_matvec")
    q8_matvec.launches += 1
    return out


q8_matvec.launches = 0
