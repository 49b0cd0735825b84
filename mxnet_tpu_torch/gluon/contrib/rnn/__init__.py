"""Contrib recurrent cells (``mxnet_tpu/gluon/contrib/rnn``)."""
from .conv_rnn_cell import (Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
                            Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
                            Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
from .rnn_cell import VariationalDropoutCell
