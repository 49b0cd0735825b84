"""Gluon RNN package (port of ``mxnet_tpu/gluon/rnn/``): the fused
``RNN``/``LSTM``/``GRU`` layers over ``ops.rnn.fused_rnn`` and the
unrolled cells and their wrappers, with the same gate math, so ``unroll``
equals the fused layer."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell"]
