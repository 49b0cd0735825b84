"""Contrib layers (``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, PixelShuffle1D, PixelShuffle2D,
                           PixelShuffle3D)
from ...nn import SyncBatchNorm  # the reference exposes it here too
