"""Gluon layers of the port (``mxnet_tpu/gluon/nn``): ``nn.Module``s
created on ``cuda:0`` unless built with ``device="cpu"``."""
from .basic_layers import (Activation, BatchNorm, Dense, Flatten,
                           HybridSequential)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)
from ..block import HybridBlock

__all__ = ["HybridBlock", "HybridSequential", "Dense", "BatchNorm",
           "Activation", "Flatten", "Conv2D", "MaxPool2D", "AvgPool2D",
           "GlobalMaxPool2D", "GlobalAvgPool2D"]
