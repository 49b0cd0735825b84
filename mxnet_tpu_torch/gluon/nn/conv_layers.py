"""Convolution and pooling layers.

Port of ``mxnet_tpu/gluon/nn/conv_layers.py`` for 2-D: ``Conv2D``,
``MaxPool2D``, ``AvgPool2D``, ``GlobalMaxPool2D``, ``GlobalAvgPool2D``.
Weights are OIHW in every layout, as in the reference, so the same
parameters serve ``layout="NCHW"`` and ``"NHWC"``.  ``in_channels=0``
infers the input channels from the first input.  ``ops.nn.convolution``
decides per call whether an NHWC 1x1 convolution takes the fused
backward (K6).
"""
from __future__ import annotations

from ...ops.nn import convolution, pooling
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class Conv2D(HybridBlock):
    """``act(conv(x, W) + b)``; ``device`` as in ``Dense``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None, device=None, dtype=None):
        super().__init__(prefix=prefix, params=params)
        self._channels, self._in_channels = channels, in_channels
        self._kernel = _tuple(kernel_size, 2)
        self._stride = _tuple(strides, 2)
        self._pad = _tuple(padding, 2)
        self._dilate = _tuple(dilation, 2)
        self._groups, self._layout = groups, layout
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups) +
                self._kernel, dtype=dtype, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation) if activation else None
        self._place(device)

    def infer_shape(self, x, *args):
        c_axis = 1 if self._layout[1] == "C" else x.dim() - 1
        self._in_channels = x.shape[c_axis]
        self.weight.shape = (self._channels,
                             self._in_channels // self._groups) + \
            self._kernel

    def forward(self, x):
        p = self._parameters
        bias = p.get("bias")
        out = convolution(x, p["weight"], bias, kernel=self._kernel,
                          stride=self._stride, dilate=self._dilate,
                          pad=self._pad, num_filter=self._channels,
                          num_group=self._groups, no_bias=bias is None,
                          layout=self._layout)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._in_channels or None} -> {self._channels}, "
                f"kernel_size={self._kernel}, stride={self._stride}, "
                f"padding={self._pad}, layout={self._layout}")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None):
        super().__init__()
        self._kernel = pool_size
        self._stride = _tuple(strides if strides is not None else pool_size,
                              len(pool_size))
        self._pad = _tuple(padding, len(pool_size))
        self._global = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad

    def forward(self, x):
        kw = {}
        if self._count_include_pad is not None:
            kw["count_include_pad"] = self._count_include_pad
        return pooling(x, kernel=self._kernel, stride=self._stride,
                       pad=self._pad, pool_type=self._pool_type,
                       global_pool=self._global, layout=self._layout,
                       pooling_convention=self._convention, **kw)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, False, True, "max", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, False, True, "avg", layout)
