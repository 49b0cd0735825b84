"""Gluon layers of the port (``mxnet_tpu/gluon/nn``): blocks whose
parameters are Gluon ``Parameter``s, created on the current context
(``gpu(0)``) or on ``device=``, or at the first forward when a size is
left to be inferred."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Flatten,
                           HybridSequential, Sequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)
from ..block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "BatchNorm", "Activation", "Flatten", "Conv2D",
           "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D"]
