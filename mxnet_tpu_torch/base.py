"""Foundation: the framework's error type and dtype names.

The port keeps its own copy of ``MXNetError`` so that it imports nothing
of the JAX package (``mxnet_tpu/base.py`` holds the reference one).
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


class MXNetError(RuntimeError):
    """Error raised by the framework (reference anchor: ``MXGetLastError``
    / python ``MXNetError``)."""


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a dtype name ("bfloat16") or
    None (float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]
