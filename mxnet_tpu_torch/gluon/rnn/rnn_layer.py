"""Fused recurrent layers: RNN / LSTM / GRU.

Port of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: layers over the fused op
``ops.rnn.fused_rnn``, with the reference's parameter names
``{l|r}{layer}_{i2h|h2h}_{weight|bias}`` (so ``LSTM(...).l0_i2h_weight``
and ``LSTMCell.i2h_weight`` interchange), layouts ``TNC``/``NTC``,
``bidirectional``, the input size inferred from the first input when it
is 0, ``begin_state``, and the new states returned when states are
passed in.  As ``gluon.nn``'s layers, a layer whose sizes are all known
creates its parameters at once, on ``device`` (a port extension) or the
current context.  The forward runs on tensors (``states`` as tensors or
NDArrays); inter-layer dropout applies in training mode
(``autograd.is_training()`` in a call made with NDArrays).  A symbol
capture (``export``) runs the reference's ``hybrid_forward`` instead: zero
states from ``F.zeros`` (constants of the graph, as in the reference's
export) and one ``F.fused_rnn`` node.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops.rnn import _GATES, fused_rnn
from ..block import HybridBlock, _tensors

__all__ = ["RNN", "LSTM", "GRU"]

_KINDS = ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")


class _RNNLayer(HybridBlock):
    _capture_runs = "hybrid_forward"

    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}; expected TNC or NTC")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        ng = _GATES[mode]
        inits = dict(zip(_KINDS, (i2h_weight_initializer,
                                  h2h_weight_initializer,
                                  i2h_bias_initializer,
                                  h2h_bias_initializer)))
        with self.name_scope():
            for layer in range(num_layers):
                in_size = input_size if layer == 0 \
                    else hidden_size * self._dir
                for dname in ["l", "r"][:self._dir]:
                    for kind, shape in zip(_KINDS, (
                            (ng * hidden_size, in_size),
                            (ng * hidden_size, hidden_size),
                            (ng * hidden_size,), (ng * hidden_size,))):
                        name = f"{dname}{layer}_{kind}"
                        setattr(self, name, self.params.get(
                            name, shape=shape, dtype=dtype,
                            init=inits[kind], allow_deferred_init=True))
        self._place(device)

    def infer_shape(self, x, *args):
        ng = _GATES[self._mode]
        for d in ["l", "r"][:self._dir]:
            p = getattr(self, f"{d}0_i2h_weight")
            if p.shape[-1] == 0:
                p.shape = (ng * self._hidden_size, x.shape[-1])

    def state_info(self, batch_size=0):
        n = self._num_layers * self._dir
        info = {"shape": (n, batch_size, self._hidden_size)}
        return [dict(info), dict(info)] if self._mode == "lstm" \
            else [info]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F
        if func is None:
            func = F.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def __call__(self, x, states=None, **kwargs):
        return super().__call__(x, *([states] if states is not None else []),
                                **kwargs)

    def _fused(self, fn, x, states, weights, return_states):
        """``fn`` (``fused_rnn`` on tensors or ``F.fused_rnn``) over the
        input, the states and the weights in the op's order."""
        arrays = [x] + list(states) + [
            weights[f"{d}{layer}_{kind}"] for layer in range(self._num_layers)
            for d in ["l", "r"][:self._dir] for kind in _KINDS]
        out = fn(*arrays, mode=self._mode, num_layers=self._num_layers,
                 bidirectional=self._dir == 2, dropout=self._dropout,
                 training=self._is_training(), layout=self._layout)
        output, new_states = out[0], list(out[1:])
        return (output, new_states) if return_states else output

    def forward(self, x, states=None):
        return_states = states is not None
        if states is None:
            batch = x.shape[self._layout.find("N")]
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(batch)]
        states = _tensors(states)
        if isinstance(states, torch.Tensor):
            states = [states]
        return self._fused(fused_rnn, x, states, self._parameters,
                           return_states)

    def hybrid_forward(self, F, x, *args, **params):
        states = args[0] if args else None
        return_states = states is not None
        if states is None:
            states = self.begin_state(x.shape[self._layout.find("N")],
                                      ctx=x.context, dtype=x.dtype)
        if isinstance(states, F.NDArray):
            states = [states]
        return self._fused(F.fused_rnn, x, states, params, return_states)

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, layout={self._layout}"
                f"{', bidirectional' if self._dir == 2 else ''})")


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (the fused op, mode='lstm')."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (the fused op, mode='gru')."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)
