"""Foundation: the framework's error type.

The port keeps its own copy of ``MXNetError`` so that it imports nothing
of the JAX package (``mxnet_tpu/base.py`` holds the reference one).
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference anchor: ``MXGetLastError``
    / python ``MXNetError``)."""
