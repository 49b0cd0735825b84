"""Convolution and pooling layers.

Port of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv2D``, ``MaxPool2D``,
``AvgPool2D``, ``GlobalMaxPool2D`` and ``GlobalAvgPool2D`` with a
``forward`` on tensors (the ResNet paths) and the reference's
``hybrid_forward``, which a symbol capture runs; ``Conv1D``, ``Conv3D``,
``Conv{1,2,3}DTranspose``, the 1-D and 3-D pools and ``ReflectionPad2D``
written with ``hybrid_forward`` over ``mx.nd`` as the reference writes
them.  Weights are OI+spatial in every layout (a transposed
convolution's (in, out / groups)+spatial), as in the reference, so the
same parameters serve ``layout="NCHW"`` and ``"NHWC"``.
``in_channels=0`` infers the input channels from the first input.
``ops.nn.convolution`` decides per call whether an NHWC 1x1 convolution
takes the fused backward (K6).
"""
from __future__ import annotations

from ...amp.amp import layer_cast
from ...ops.nn import convolution, pooling
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class Conv2D(HybridBlock):
    """``act(conv(x, W) + b)``; ``device`` as in ``Dense``."""

    _capture_runs = "hybrid_forward"

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
        c_axis = 1 if self._layout[1] == "C" else len(x.shape) - 1
        self._in_channels = x.shape[c_axis]
        self.weight.shape = (self._channels,
                             self._in_channels // self._groups) + \
            self._kernel

    def forward(self, x):
        p = self._parameters
        # the reference's F.Convolution, cast as amp.init says
        x, weight, bias = layer_cast("Convolution", x, p["weight"],
                                     p.get("bias"))
        out = convolution(x, weight, bias, kernel=self._kernel,
                          stride=self._stride, dilate=self._dilate,
                          pad=self._pad, num_filter=self._channels,
                          num_group=self._groups, no_bias=bias is None,
                          layout=self._layout)
        return self.act(out) if self.act is not None else out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._stride, dilate=self._dilate,
                            pad=self._pad, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None,
                            layout=self._layout)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._in_channels or None} -> {self._channels}, "
                f"kernel_size={self._kernel}, stride={self._stride}, "
                f"padding={self._pad}, layout={self._layout}")


class _Conv(HybridBlock):
    """The reference's ``_Conv``: ``F.Convolution`` or ``F.Deconvolution``
    at the kernel's rank, then the activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None, device=None, dtype=None):
        super().__init__(prefix=prefix, params=params)
        ndim = len(kernel_size)
        self._channels, self._in_channels = channels, in_channels
        self._kernel = kernel_size
        self._stride = _tuple(strides, ndim)
        self._pad = _tuple(padding, ndim)
        self._dilate = _tuple(dilation, ndim)
        self._groups, self._layout = groups, layout
        self._op_name, self._adj = op_name, adj
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                dtype=dtype, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation) if activation else None
        self._place(device)

    def _weight_shape(self, in_channels):
        if self._op_name == "Convolution":
            return (self._channels, in_channels // self._groups) + \
                self._kernel
        return (in_channels, self._channels // self._groups) + self._kernel

    def infer_shape(self, x, *args):
        c_axis = 1 if self._layout[1] == "C" else len(self._layout) - 1
        self._in_channels = x.shape[c_axis]
        self.weight.shape = self._weight_shape(self._in_channels)

    def hybrid_forward(self, F, x, weight, bias=None):
        kw = dict(kernel=self._kernel, stride=self._stride,
                  dilate=self._dilate, pad=self._pad,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=bias is None, layout=self._layout)
        if self._op_name == "Convolution":
            out = F.Convolution(x, weight, bias, **kw)
        else:
            out = F.Deconvolution(x, weight, bias, adj=self._adj or (), **kw)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return (f"{type(self).__name__}({self._in_channels or None} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._stride}, padding={self._pad})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _ConvTranspose(_Conv):
    def __init__(self, ndim, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        super().__init__(channels, _tuple(kernel_size, ndim), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tuple(output_padding, ndim), **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class _Pooling(HybridBlock):
    _capture_runs = "hybrid_forward"

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

    def _kwargs(self):
        kw = dict(kernel=self._kernel, stride=self._stride, pad=self._pad,
                  pool_type=self._pool_type, global_pool=self._global,
                  layout=self._layout, pooling_convention=self._convention)
        if self._count_include_pad is not None:
            kw["count_include_pad"] = self._count_include_pad
        return kw

    def forward(self, x):
        return pooling(x, **self._kwargs())

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs())


class _HybridPooling(_Pooling):
    """The 1-D and 3-D pools: ``F.Pooling`` in ``hybrid_forward``."""

    forward = HybridBlock.forward

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._stride}, padding={self._pad})")


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


class MaxPool1D(_HybridPooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout)


class MaxPool3D(_HybridPooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout)


class AvgPool1D(_HybridPooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class AvgPool3D(_HybridPooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class GlobalMaxPool1D(_HybridPooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, False, True, "max", layout)


class GlobalMaxPool3D(_HybridPooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, False, True, "max", layout)


class GlobalAvgPool1D(_HybridPooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, False, True, "avg", layout)


class GlobalAvgPool3D(_HybridPooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, False, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of an NCHW input: ``padding`` an int (each side
    of H and W) or the 8 pad widths of ``F.pad``.  (The reference passes
    ``F.pad`` pairs, which its ``pad`` reads as a flat tuple and
    refuses; the port passes the flat tuple.)"""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
