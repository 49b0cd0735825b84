"""Fused backward of 1x1 stride-1 NHWC convolutions (kernel K6).

Port of ``mxnet_tpu/ops/conv_fused.py``.  A 1x1 stride-1 convolution in
NHWC is a (P, Ci) x (Ci, Co) product over the flattened batch and
spatial axis P, so its whole backward is two products that share ``dy``:

    dx = dy @ W         rounded once to x's dtype
    dW = dy^T @ x       summed in f32

``conv1x1_bwd_pair`` computes both while reading ``dy`` once: on a CUDA
tensor it launches ``csrc/conv1x1_bwd.cu`` (which says what bounds it
and how), on a CPU tensor it runs ``conv1x1_bwd_pair_plain``; on the card
it never falls back to the plain version.  ``conv1x1_nhwc`` is the
convolution whose backward is that pair; ``ops.nn.convolution`` routes an
NHWC 1x1 stride-1 convolution there when ``fused_bwd_supported`` admits
it.

Off by default, as in the reference: ``fused_bwd_supported`` returns
False unless ``MXNET_FUSED_CONV_BWD=1``, read at call time.  The switch
is the reference's (kept so that the two packages route the same
convolutions); whether the fused pass pays on the card is measured by
``chip_smoke.py`` with the switch on and off.  The gate keeps the
reference's shape clauses and replaces its TPU clauses (the backend, the
multi-chip mesh, the VMEM tile budget) with the kernel's own limits: bf16
or f32, and at most ``MAX_CO`` output channels (the f32 kernel's chunk
partial of dW lives in shared memory; the bf16 kernel has no such limit,
and the gate keeps one bound for both dtypes).
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["conv1x1_nhwc", "conv1x1_bwd_pair", "conv1x1_bwd_pair_plain",
           "fused_bwd_supported", "plan", "MAX_CO"]

MAX_CO = 4096               # output channels: a Co x 8 f32 partial <= 128 KB
_PARTIAL_BYTES = 128 * 1024
_TP = 64                    # f32: P rows per tile (csrc/conv1x1_bwd.cu kTP)
_TO = 32                    # f32: output channels per slab (kTO)
_TARGET_BLOCKS = 2 * 132    # f32: two blocks' worth per SM of an H100
_BK = 64                    # bf16: depth of a streamed slab (kBK)
_SPLIT_ROWS = 2048          # bf16: about this many P rows a dW split
_DTYPES = (torch.bfloat16, torch.float32)


def fused_bwd_supported(shape_in, w_shape, stride, dilate, groups,
                        itemsize: int = 2, dtype=None) -> bool:
    """True when K6 serves this convolution's backward: the switch is on,
    NHWC 2-D input, 1x1 kernel, unit stride and dilation, one group,
    ``c == ci``, bf16 or f32 (``itemsize`` 2 or 4, and ``dtype`` when
    given), and at most ``MAX_CO`` output channels."""
    if os.environ.get("MXNET_FUSED_CONV_BWD", "0") != "1":
        return False
    if len(shape_in) != 4 or groups != 1:
        return False
    co, ci, kh, kw = w_shape
    if (kh, kw) != (1, 1) or tuple(stride) != (1, 1) or \
            tuple(dilate) != (1, 1):
        return False
    c = shape_in[3]
    if c != ci:
        return False
    if itemsize not in (2, 4) or (dtype is not None and dtype not in _DTYPES):
        return False
    return 1 <= co <= MAX_CO


def plan(p: int, ci: int, co: int, dtype=torch.float32):
    """The launch plan of K6: ``(tc, rows_per_chunk, nchunks)``.

    bf16 (the tensor-core kernel): ``tc`` is the column tile of both
    GEMMs, 128, or 64 when Ci <= 64; dW is split over P into ``nchunks``
    splits of ``rows_per_chunk`` rows (a multiple of 64, about 2048), so
    that the split-K dW tiles fill the card beside the dx tiles.

    f32: ``tc`` is the Ci tile, the widest of 64/32/16/8 whose ``Co x
    tc`` f32 dW partial fits 128 KB of shared memory, and no wider than
    Ci needs.  The chunks of 64-row P tiles fill about two blocks per SM,
    each holding at least one tile."""
    if dtype == torch.bfloat16:
        nsplit = max(1, -(-p // _SPLIT_ROWS))
        rows = -(-(-(-p // nsplit)) // _BK) * _BK
        return (64 if ci <= 64 else 128), rows, -(-p // rows)
    co_pad = -(-co // _TO) * _TO
    tc = 64
    while tc > 8 and (co_pad * tc * 4 > _PARTIAL_BYTES or tc >= 2 * ci):
        tc //= 2
    if co_pad * tc * 4 > _PARTIAL_BYTES:
        raise MXNetError(f"conv1x1_bwd_pair: {co} output channels > "
                         f"{MAX_CO}")
    ntp = -(-p // _TP)
    ctiles = -(-ci // tc)
    nchunks = min(max(1, -(-_TARGET_BLOCKS // ctiles)), ntp)
    per = -(-ntp // nchunks)
    return tc, per * _TP, -(-ntp // per)


def conv1x1_bwd_pair_plain(dy2, x2, w2):
    """The plain PyTorch version: ``dx = dy @ W`` in f32 rounded to x's
    dtype, ``dW = dy^T @ x`` in f32."""
    dx = (dy2.float() @ w2.float()).to(x2.dtype)
    dw = dy2.float().t() @ x2.float()
    return dx, dw


def _check(dy2, x2, w2):
    if dy2.dim() != 2 or x2.dim() != 2 or w2.dim() != 2:
        raise MXNetError("conv1x1_bwd_pair: dy, x and w must be 2-D")
    p, co = dy2.shape
    ci = x2.shape[1]
    if x2.shape[0] != p or tuple(w2.shape) != (co, ci):
        raise MXNetError(f"conv1x1_bwd_pair: dy {tuple(dy2.shape)}, x "
                         f"{tuple(x2.shape)} and w {tuple(w2.shape)} do "
                         "not form (P, Co), (P, Ci), (Co, Ci)")
    if x2.dtype not in _DTYPES or dy2.dtype != x2.dtype or \
            w2.dtype != x2.dtype:
        raise MXNetError(f"conv1x1_bwd_pair: dy, x and w must share one "
                         f"dtype, bf16 or f32; got {dy2.dtype}, "
                         f"{x2.dtype}, {w2.dtype}")
    for name, t in (("dy", dy2), ("x", x2), ("w", w2)):
        if t.device != x2.device:
            raise MXNetError(f"conv1x1_bwd_pair: {name} on {t.device}, x "
                             f"on {x2.device}")
        if not t.is_contiguous():
            raise MXNetError(f"conv1x1_bwd_pair: {name} must be "
                             "contiguous")


def _launcher():
    lib = _build.load("conv1x1_bwd")
    fn = lib.conv1x1_bwd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def conv1x1_bwd_pair(dy2, x2, w2):
    """``dy2`` (P, Co), ``x2`` (P, Ci), ``w2`` (Co, Ci), one dtype (bf16
    or f32), contiguous -> ``(dx (P, Ci) in x's dtype, dW (Co, Ci)
    f32)``.  CPU tensors take the plain version; CUDA tensors launch K6
    (``conv1x1_bwd_pair.launches`` counts launches)."""
    _check(dy2, x2, w2)
    if x2.device.type == "cpu":
        return conv1x1_bwd_pair_plain(dy2, x2, w2)
    if x2.device.type != "cuda":
        raise MXNetError(f"conv1x1_bwd_pair: unsupported device "
                         f"{x2.device}")
    p, co = dy2.shape
    ci = x2.shape[1]
    dx = torch.empty_like(x2)
    dw = torch.empty((co, ci), dtype=torch.float32, device=x2.device)
    if p == 0 or ci == 0 or co == 0:
        return dx, dw.zero_()
    tc, rows, nchunks = plan(p, ci, co, x2.dtype)
    part = torch.empty((nchunks, co, ci) if nchunks > 1 else (0,),
                       dtype=torch.float32, device=x2.device)
    vec = 0
    for bit, t, ld in ((1, x2, ci), (2, dy2, co), (4, w2, ci)):
        if ld % 8 == 0 and t.data_ptr() % 16 == 0:
            vec |= bit
    lib, fn = _launcher()
    with torch.cuda.device(x2.device):
        err = fn(dy2.data_ptr(), x2.data_ptr(), w2.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(),
                 int(x2.dtype == torch.bfloat16), p, ci, co, tc, rows,
                 nchunks, vec,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(lib, err, "conv1x1_bwd_pair")
    conv1x1_bwd_pair.launches += 1
    return dx, dw


conv1x1_bwd_pair.launches = 0


class _Conv1x1NHWC(torch.autograd.Function):
    """Forward: the plain (P, Ci) x (Ci, Co) product (a library GEMM, as
    the reference leaves its forward to XLA).  Backward: K6."""

    @staticmethod
    def forward(ctx, x, w):
        n, h, w_sp, ci = x.shape
        co = w.shape[0]
        ctx.save_for_backward(x, w)
        y = torch.matmul(x.reshape(-1, ci), w.reshape(co, ci).t())
        return y.reshape(n, h, w_sp, co)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ci = x.shape[3]
        co = w.shape[0]
        dx2, dw2 = conv1x1_bwd_pair(dy.reshape(-1, co).contiguous(),
                                    x.reshape(-1, ci).contiguous(),
                                    w.reshape(co, ci).contiguous())
        return dx2.reshape(x.shape), dw2.to(w.dtype).reshape(w.shape)


def conv1x1_nhwc(x, w):
    """1x1 stride-1 NHWC convolution whose backward is K6: ``x`` (N, H,
    W, Ci), ``w`` (Co, Ci, 1, 1) OIHW (the layout-invariant parameters of
    ``ops.nn.convolution``).  Returns (N, H, W, Co)."""
    return _Conv1x1NHWC.apply(x, w)
