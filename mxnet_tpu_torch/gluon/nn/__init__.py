"""Gluon layers of the port (``mxnet_tpu/gluon/nn``): blocks whose
parameters are Gluon ``Parameter``s, created on the current context
(``gpu(0)``) or on ``device=``, or at the first forward when a size is
left to be inferred."""
from .basic_layers import (ELU, GELU, SELU, Activation, BatchNorm, Dense,
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridLambda, HybridSequential, InstanceNorm,
                           Lambda, LayerNorm, LeakyReLU, PReLU, RMSNorm,
                           Sequential, Swish, SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)
from ..block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "BatchNorm", "SyncBatchNorm", "LayerNorm",
           "RMSNorm", "InstanceNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "GELU", "Swish", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "ReflectionPad2D"]
