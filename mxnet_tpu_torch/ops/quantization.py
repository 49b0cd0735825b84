"""The int8 quantization ops and the KL calibration.

Port of ``mxnet_tpu/ops/quantization.py``: ``quantize_v2`` (f32 -> int8
with a symmetric scale ``127 / amax``, in f32 as the reference rounds
it), ``dequantize``, ``requantize`` (an int32 accumulator -> int8 in a new
range), and the int8 products with int32 sums, ``quantized_matmul_int8``
and ``quantized_conv_int8``; ``optimal_threshold_kl`` is the host-side
calibration, numpy as in the reference.

The reference sums int8 products in int32 (``preferred_element_type``).
PyTorch has no such product on the card (and on the CPU an int8 matmul
returns int8 and wraps), so the port multiplies in float64 and rounds to
int32: every partial sum is an integer below 2**53 while ``K * 128**2 <
2**53`` (K < 5.5e11), so each is exact whatever the summation order, and
the result equals the int32 sum.  These are plain products that the JAX
package leaves to XLA outside any Pallas kernel, so ``torch.matmul`` and
``F.conv2d`` compute them here.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from .nn import _fdiv, _full
from .registry import op

__all__ = ["quantize_v2", "dequantize", "requantize",
           "quantized_matmul_int8", "quantized_conv_int8",
           "optimal_threshold_kl"]


def _to_int8(x, scale):
    return torch.round(x * scale).clamp(-127, 127).to(torch.int8)


@op("_contrib_quantize_v2", differentiable=False, wrap=False)
def quantize_v2(data, *, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """f32 -> (int8 codes, -amax (1,), amax (1,)), ``amax`` the calibrated
    range's largest magnitude, else the data's."""
    if min_calib_range is None or max_calib_range is None:
        mx_abs = data.abs().max()
        min_r, max_r = -mx_abs, mx_abs
    else:
        min_r = _full(min_calib_range, data, torch.float32)
        max_r = _full(max_calib_range, data, torch.float32)
    amax = torch.maximum(min_r.abs(), max_r.abs())
    scale = _full(127.0, amax) / amax.clamp_min(1e-12)
    return _to_int8(data, scale), (-amax).reshape(1), amax.reshape(1)


@op("_contrib_dequantize", differentiable=False, wrap=False)
def dequantize(data, min_range, max_range, *, out_type="float32"):
    amax = torch.maximum(min_range.abs(), max_range.abs())[0]
    return data.float() * _fdiv(amax, 127.0)


@op("_contrib_requantize", differentiable=False, wrap=False)
def requantize(data, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator (of two 127-scaled int8 operands) -> (int8, -amax,
    amax) in the calibrated range, else in the data's own."""
    in_amax = torch.maximum(min_range.abs(), max_range.abs())[0]
    real = data.float() * _fdiv(in_amax, 127.0 * 127.0)
    if min_calib_range is not None and max_calib_range is not None:
        bound = max(abs(min_calib_range), abs(max_calib_range))
        out_amax = _full(bound, real)
        scale = _full(127.0, real) / _full(max(bound, 1e-12), real)
    else:
        out_amax = real.abs().max()
        scale = _full(127.0, real) / out_amax.clamp_min(1e-12)
    a = out_amax.reshape(1)
    return _to_int8(real, scale), -a, a


@op("quantized_matmul_int8", differentiable=False, wrap=False)
def quantized_matmul_int8(qa, qb, *, transpose_b=False):
    """int8 (..., K) x int8 (K, ...) -> int32 (exact: see the module)."""
    b = qb.t() if transpose_b else qb
    out = torch.tensordot(qa.double(), b.double(), dims=([qa.dim() - 1],
                                                         [0]))
    return torch.round(out).to(torch.int32)


@op("quantized_conv_int8", differentiable=False, wrap=False)
def quantized_conv_int8(qx, qw, *, stride=(1, 1), pad=(0, 0),
                        dilate=(1, 1), num_group=1):
    """int8 NCHW x OIHW convolution -> int32 (exact: see the module)."""
    out = F.conv2d(qx.double(), qw.double(), stride=tuple(stride),
                   padding=tuple(pad), dilation=tuple(dilate),
                   groups=num_group)
    return torch.round(out).to(torch.int32)


def optimal_threshold_kl(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence calibration (the reference's ``_get_optimal_threshold``):
    the clip threshold whose quantized distribution diverges least from
    the observed one.  Host-side numpy."""
    hist = onp.asarray(hist, dtype=onp.float64)
    num_bins = hist.size
    zero_bin = num_bins // 2
    thresholds = []
    divergences = []
    for i in range(num_quantized_bins // 2, zero_bin + 1):
        lo, hi = zero_bin - i, zero_bin + i + 1
        p = hist[lo:hi].copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        factor = p.size / num_quantized_bins
        # the quantized bins' bounds (Python's and NumPy's rounding are
        # both half to even), each bin's sum and non-zero count from
        # prefix sums: every count is an integer, so the sums are exact
        # and ``q`` is the reference's loop's bit for bit
        bounds = onp.round(onp.arange(num_quantized_bins + 1) * factor) \
            .astype(onp.int64)
        nonzero = p != 0
        sums = onp.concatenate(([0.0], onp.cumsum(p)))
        counts = onp.concatenate(([0], onp.cumsum(nonzero)))
        nz = counts[bounds[1:]] - counts[bounds[:-1]]
        means = (sums[bounds[1:]] - sums[bounds[:-1]]) / onp.maximum(nz, 1)
        q = onp.where(nonzero, onp.repeat(means, onp.diff(bounds)), 0.0)
        p_sum, q_sum = p.sum(), q.sum()
        if p_sum == 0 or q_sum == 0:
            continue
        pn, qn = p / p_sum, q / q_sum
        mask = (pn > 0) & (qn > 0)
        kl = (pn[mask] * onp.log(pn[mask] / qn[mask])).sum()
        thresholds.append(hist_edges[hi] if hi < hist_edges.size
                          else hist_edges[-1])
        divergences.append(kl)
    if not thresholds:
        return float(abs(hist_edges).max())
    return float(thresholds[int(onp.argmin(divergences))])
