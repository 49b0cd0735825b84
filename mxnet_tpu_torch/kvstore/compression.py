"""Gradient compression with an error-feedback residual.

Port of ``mxnet_tpu/kvstore/compression.py`` (reference
``GradientCompression``, ``src/kvstore/gradient_compression.cc``).
``2bit`` quantizes each element to {-t, 0, +t} and ``1bit`` to {-t, +t};
the quantization error stays in a residual a key and is added to that
key's next gradient.  Comparisons, the quantized values and the
residual are computed in the gradient's dtype, as the reference's are.
"""
from __future__ import annotations

import torch

from ..base import MXNetError


class GradientCompression:
    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002
        if type not in ("2bit", "1bit"):
            raise MXNetError(f"unsupported compression type {type!r}")
        self.type = type
        self.threshold = float(threshold)
        if self.type == "2bit" and self.threshold <= 0:
            raise MXNetError("2bit compression needs threshold > 0")
        self._residual = {}

    def compress(self, key, grad):
        """The quantized gradient (same shape and dtype); the key's
        residual becomes the quantization error."""
        r = self._residual.get(key)
        g = grad + r if r is not None else grad
        t = torch.full((), self.threshold, dtype=g.dtype, device=g.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        if self.type == "2bit":
            q = torch.where(g >= t, t, torch.where(g <= -t, -t, zero))
        else:
            q = torch.where(g >= zero, t, -t)
        self._residual[key] = g - q
        return q.to(grad.dtype)

    def decompress(self, key, q):
        return q  # the values are in gradient units already

    def reset(self):
        self._residual.clear()
