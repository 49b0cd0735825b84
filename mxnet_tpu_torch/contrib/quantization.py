"""Post-training int8 quantization: ``quantize_net``.

Port of ``mxnet_tpu/contrib/quantization.py`` (the reference's
``python/mxnet/contrib/quantization.py``): calibration batches run
through the f32 net while forward pre-hooks collect each ``Dense`` and
``Conv2D`` input's range (``naive``: the largest magnitude; ``entropy``:
a histogram, thresholded by ``ops.quantization.optimal_threshold_kl``),
then those layers are replaced by :class:`QuantizedDense` and
:class:`QuantizedConv2D` (NCHW, as the reference's): weights quantized
once to int8 (per output channel for a convolution), activations
quantized with the calibrated range by ``_contrib_quantize_v2``, int8 x
int8 products with int32 sums (``quantized_matmul_int8``/
``quantized_conv_int8``, exact sums through float64), the
output dequantized to f32.  The quantized layers live on the device of
the weights they replace.  The reference computes these products with
``lax`` outside any Pallas kernel, so they are plain PyTorch here too.

The naive collector reduces each input's magnitude on its device (one
scalar read a layer and batch); the entropy collector reads the input to
the host for its histogram, as the reference's does.
"""
from __future__ import annotations

import logging

import numpy as onp
import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray
from ..ops.quantization import optimal_threshold_kl

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv2D",
           "LayerOutputCollector"]


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


class LayerOutputCollector:
    """Per-layer input statistics from forward pre-hooks (reference
    ``_LayerOutputCollector`` / ``_LayerOutputMinMaxCollector``)."""

    def __init__(self, mode="naive", num_bins=8001):
        if mode not in ("naive", "entropy"):
            raise MXNetError("calib_mode must be 'naive' or 'entropy'")
        self.mode = mode
        self.num_bins = num_bins
        self.stats = {}  # layer name -> dict

    def hook(self, name):
        def _pre_hook(block, inputs):
            x = _tensor(inputs[0])
            if isinstance(x, torch.Tensor):
                amax = float(x.detach().abs().max())
            else:
                amax = float(onp.abs(onp.asarray(x)).max())
            st = self.stats.setdefault(
                name, {"amax": 0.0, "hist": None, "edges": None})
            grew = amax > st["amax"]
            st["amax"] = max(st["amax"], amax)
            if self.mode == "entropy":
                arr = x.detach().float().cpu().numpy() \
                    if isinstance(x, torch.Tensor) else onp.asarray(x)
                rng = (-st["amax"] - 1e-12, st["amax"] + 1e-12)
                hist, edges = onp.histogram(arr, bins=self.num_bins,
                                            range=rng)
                hist = hist.astype(onp.float64)
                if st["hist"] is None:
                    st["hist"], st["edges"] = hist, edges
                elif grew:
                    # the range widened: re-bin the accumulated histogram
                    # onto the new edges (old bin centres carry old counts)
                    centers = (st["edges"][:-1] + st["edges"][1:]) / 2
                    rebinned, _ = onp.histogram(centers, bins=self.num_bins,
                                                range=rng,
                                                weights=st["hist"])
                    st["hist"] = rebinned + hist
                    st["edges"] = edges
                else:
                    st["hist"] += hist
        return _pre_hook

    def threshold(self, name):
        st = self.stats[name]
        if self.mode == "entropy" and st["hist"] is not None:
            return optimal_threshold_kl(st["hist"], st["edges"])
        return st["amax"]


class QuantizedDense(HybridBlock):
    """INT8 Dense: int8 weights (quantized once), the input quantized with
    its calibrated range, int32 sums, f32 output."""

    def __init__(self, dense: nn.Dense, input_threshold: float, **kwargs):
        super().__init__(**kwargs)
        w = dense.weight.data()
        w_np = w.asnumpy()
        self._w_amax = float(onp.abs(w_np).max()) or 1e-12
        qw = onp.clip(onp.round(w_np * (127.0 / self._w_amax)),
                      -127, 127).astype(onp.int8)
        self._qweight = nd.array(qw, ctx=w.context, dtype="int8")
        self._bias = dense.bias.data() if dense.bias is not None else None
        self._x_amax = float(input_threshold) or 1e-12
        self._units = dense._units
        self._flatten = dense._flatten
        self._act = dense.act   # the fused activation, if any

    def hybrid_forward(self, F, x):
        if self._flatten and x.ndim > 2:
            x = x.reshape((x.shape[0], -1))
        # quantize_v2's symmetric int8, with the calibrated range
        qx, _, _ = F._contrib_quantize_v2(x, min_calib_range=-self._x_amax,
                                          max_calib_range=self._x_amax)
        acc = F.quantized_matmul_int8(qx, self._qweight, transpose_b=True)
        out = acc.astype("float32") * (self._x_amax * self._w_amax /
                                       (127.0 * 127.0))
        if self._bias is not None:
            out = out + self._bias
        if self._act is not None:
            out = self._act(out)
        return out

    def __repr__(self):
        return f"QuantizedDense({self._units}, int8)"


class QuantizedConv2D(HybridBlock):
    """INT8 Conv2D (NCHW): per-output-channel int8 weights, the input's
    calibrated range, int32 sums (reference ``_contrib_quantized_conv``)."""

    def __init__(self, conv: nn.Conv2D, input_threshold: float, **kwargs):
        super().__init__(**kwargs)
        if conv._layout != "NCHW":
            raise MXNetError(f"QuantizedConv2D: layout {conv._layout} is "
                             "not NCHW, the reference's only one")
        w = conv.weight.data()
        w_np = w.asnumpy()                              # (O, I, kh, kw)
        o = w_np.shape[0]
        w_amax = onp.abs(w_np).reshape(o, -1).max(axis=1)
        w_amax = onp.where(w_amax > 0, w_amax, 1e-12)
        qw = onp.clip(onp.round(w_np * (127.0 / w_amax)[:, None, None,
                                                        None]),
                      -127, 127).astype(onp.int8)
        self._qweight = nd.array(qw, ctx=w.context, dtype="int8")
        self._w_amax = nd.array(w_amax.astype(onp.float32), ctx=w.context)
        self._bias = conv.bias.data() if conv.bias is not None else None
        self._x_amax = float(input_threshold) or 1e-12
        self._stride = conv._stride
        self._pad = conv._pad
        self._dilate = conv._dilate
        self._groups = conv._groups
        self._channels = conv._channels
        self._act = conv.act

    def hybrid_forward(self, F, x):
        qx, _, _ = F._contrib_quantize_v2(x, min_calib_range=-self._x_amax,
                                          max_calib_range=self._x_amax)
        acc = F.quantized_conv_int8(qx, self._qweight, stride=self._stride,
                                    pad=self._pad, dilate=self._dilate,
                                    num_group=self._groups)
        scale = self._w_amax.reshape((1, -1, 1, 1)) * \
            (self._x_amax / (127.0 * 127.0))
        out = acc.astype("float32") * scale
        if self._bias is not None:
            out = out + self._bias.reshape((1, -1, 1, 1))
        if self._act is not None:
            out = self._act(out)
        return out

    def __repr__(self):
        return f"QuantizedConv2D({self._channels}, int8, per-channel)"


def _walk_replace(block, collector, exclude):
    for name, child in list(block._children.items()):
        path = child.name
        quantizable = isinstance(child, (nn.Dense, nn.Conv2D))
        if quantizable and path not in exclude \
                and path in collector.stats:
            if isinstance(child, nn.Dense):
                q = QuantizedDense(child, collector.threshold(path))
            else:
                q = QuantizedConv2D(child, collector.threshold(path))
            block._modules[name] = q
            # an attribute alias kept outside the module table
            for attr, val in list(block.__dict__.items()):
                if val is child:
                    object.__setattr__(block, attr, q)
        else:
            _walk_replace(child, collector, exclude)


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=None, logger=logging):
    """Quantize a Gluon net after training (reference ``quantize_net``).

    ``calib_data``: an iterable of input batches (NDArrays or ``(x, y)``
    tuples).  Returns the net with its ``Dense``/``Conv2D`` layers
    replaced by their int8 counterparts (those named in
    ``exclude_layers`` kept)."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported")
    if calib_data is None:
        raise MXNetError("quantize_net requires calibration data")
    exclude = set(exclude_layers or [])
    collector = LayerOutputCollector(mode=calib_mode)

    hooks = []
    hybrid_state = []   # (block, was_active): a replayed graph would not
    # fire its children's hooks, so calibration runs imperatively

    def attach(block):
        if isinstance(block, HybridBlock):
            hybrid_state.append((block, block._active))
            block._active = False
            block._cached_op = None
        for child in block._children.values():
            if isinstance(child, (nn.Dense, nn.Conv2D)):
                hooks.append(child.register_forward_pre_hook(
                    collector.hook(child.name)))
            attach(child)

    attach(network)
    try:
        for i, batch in enumerate(calib_data):
            if num_calib_batches is not None and i >= num_calib_batches:
                break
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            network(x)
    finally:
        for h in hooks:
            h.detach()
        for block, was_active in hybrid_state:
            block._active = was_active
            block._cached_op = None  # a stale f32 program must not survive
    _walk_replace(network, collector, exclude)
    logger.info("quantize_net: %d layers calibrated (%s mode)",
                len(collector.stats), calib_mode)
    return network
