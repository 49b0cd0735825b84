"""Gluon contrib of the port (``mxnet_tpu/gluon/contrib``): the contrib
layers (``nn``), the convolutional recurrent cells and the variational
dropout wrapper (``rnn``), and the ``Estimator`` fit loop with its event
handlers (``estimator``)."""
from . import nn
from . import rnn
from . import estimator
