"""Contrib layers, port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``:
``Concurrent``/``HybridConcurrent`` (children on one input, outputs
concatenated on ``axis``), ``Identity``, ``SparseEmbedding`` and
``PixelShuffle{1,2,3}D``.

``SparseEmbedding``'s weight has a row-sparse gradient: ``weight.grad()``
is a ``RowSparseNDArray`` (``ndarray/sparse.py``) of the rows the batch
looked up.  The trainers apply it dense, as the reference does (its
gradients are dense too).
"""
from __future__ import annotations

from ...block import HybridBlock, _nd_call
from ...nn import Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D"]


def _concurrent(block, x):
    """The children's outputs joined by ``F.concat`` on ``block.axis``,
    as the reference's (so a symbol capture records a ``concat`` node)."""
    from .... import ndarray as F

    outs = [child(x) for child in block._children.values()]
    return _nd_call(block, lambda *o: F.concat(*o, dim=block.axis), outs,
                    {})


class Concurrent(Sequential):
    """Run the children on the same input, concatenate their outputs on
    ``axis``."""

    _capture_runs = "forward"

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concurrent(self, x)


class HybridConcurrent(HybridSequential):
    _capture_runs = "forward"

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concurrent(self, x)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Embedding):
    """``Embedding`` whose weight's gradient is row-sparse."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)
        self.weight._grad_stype = "row_sparse"


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor,) * ndim
        self._factor = tuple(int(f) for f in factor)
        self._ndim = ndim

    def __repr__(self):
        return f"{type(self).__name__}(factor={self._factor})"


class PixelShuffle1D(_PixelShuffle):
    """(N, C*f, W) -> (N, C, W*f)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)

    def hybrid_forward(self, F, x):
        f, = self._factor
        n, cf, w = x.shape
        x = x.reshape((n, cf // f, f, w))
        x = F.transpose(x, axes=(0, 1, 3, 2))
        return x.reshape((n, cf // f, w * f))


class PixelShuffle2D(_PixelShuffle):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factor
        n, c, h, w = x.shape
        co = c // (f1 * f2)
        x = x.reshape((n, co, f1, f2, h, w))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return x.reshape((n, co, h * f1, w * f2))


class PixelShuffle3D(_PixelShuffle):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factor
        n, c, d, h, w = x.shape
        co = c // (f1 * f2 * f3)
        x = x.reshape((n, co, f1, f2, f3, d, h, w))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return x.reshape((n, co, d * f1, h * f2, w * f3))
