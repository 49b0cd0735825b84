"""Convolutional RNN, LSTM and GRU cells in 1, 2 and 3 dimensions (Shi
et al. 2015's ConvLSTM), port of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``: the recurrence of
``gluon.rnn``'s cells with convolutions for the input-to-hidden and
hidden-to-hidden products (``F.Convolution``, ``ops/nn.py::convolution``:
cuDNN on the card), over the port's ``RecurrentCell``.  ``input_shape``
is (C, *spatial) and is needed up front, as in the reference: the
state's shape depends on it.  The gate orders are the reference's (LSTM:
i, f, g, o; GRU: reset, update, new).  The parameters are created at
once on the current context.
"""
from __future__ import annotations

from ....base import MXNetError
from ...rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(x, n):
    return (x,) * n if isinstance(x, int) else tuple(x)


class _BaseConvRNNCell(RecurrentCell):
    """The parameters and the two convolutions shared by the cells."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, conv_layout="NCHW", activation="tanh",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._dims = dims
        self._activation = activation
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h_kernel dims must be odd (so the "
                                 "state keeps its spatial shape)")
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._i2h_dilate = _tuple(i2h_dilate, dims)
        self._h2h_dilate = _tuple(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_c = self._input_shape[0]
        ng = self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(ng * hidden_channels, in_c) + self._i2h_kernel,
                init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(ng * hidden_channels, hidden_channels)
                + self._h2h_kernel,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_channels,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_channels,),
                init=h2h_bias_initializer)
        # the state's spatial shape: that of the i2h convolution's output
        spatial = []
        for i, s in enumerate(self._input_shape[1:]):
            k = self._i2h_kernel[i]
            d = self._i2h_dilate[i]
            p = self._i2h_pad[i]
            spatial.append((s + 2 * p - d * (k - 1) - 1) + 1)
        self._state_shape = (hidden_channels,) + tuple(spatial)
        self._place(None)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[3 - self._dims:]}]

    def _conv(self, F, x, weight, bias, pad, dilate):
        return F.Convolution(x, weight, bias,
                             kernel=weight.shape[2:],
                             num_filter=weight.shape[0],
                             pad=pad, dilate=dilate)

    def _gates(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        i2h = self._conv(F, x, i2h_weight, i2h_bias, self._i2h_pad,
                         self._i2h_dilate)
        h2h = self._conv(F, h, h2h_weight, h2h_bias, self._h2h_pad,
                         self._h2h_dilate)
        return i2h, h2h

    def _act(self, F, x):
        return F.Activation(x, act_type=self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    _num_gates = 1

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._gates(F, x, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_gates = 4

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape
        return [{"shape": shape, "__layout__": "NCHW"},
                {"shape": shape, "__layout__": "NCHW"}]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h, c = states
        i2h, h2h = self._gates(F, x, h, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        i = F.sigmoid(slices[0])
        f = F.sigmoid(slices[1])
        g = self._act(F, slices[2])
        o = F.sigmoid(slices[3])
        next_c = f * c + i * g
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_gates = 3

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = states[0]
        i2h, h2h = self._gates(F, x, h, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_s = F.split(i2h, num_outputs=3, axis=1)
        h2h_s = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_s[0] + h2h_s[0])
        update = F.sigmoid(i2h_s[1] + h2h_s[1])
        new = self._act(F, i2h_s[2] + reset * h2h_s[2])
        next_h = (1.0 - update) * new + update * h
        return next_h, [next_h]


def _make(base, dims, name):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 **kwargs):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, dims=dims, **kwargs)
    return type(name, (base,), {"__init__": __init__,
                                "__module__": __name__})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
