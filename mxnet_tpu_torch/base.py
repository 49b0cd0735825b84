"""Foundation: the framework's error type and dtype names.

The port keeps its own copy of ``MXNetError`` so that it imports nothing
of the JAX package (``mxnet_tpu/base.py`` holds the reference one).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "dtype_name", "numeric_types"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}

numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Error raised by the framework (reference anchor: ``MXGetLastError``
    / python ``MXNetError``)."""


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a dtype name ("bfloat16"), a
    numpy dtype or None (float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, type) or isinstance(dtype, np.dtype):
        dtype = np.dtype(dtype).name
    name = str(dtype).replace("torch.", "")
    name = {"bool_": "bool", "float": "float32", "int": "int64"}.get(
        name, name)
    if name not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    """The framework's name of a torch dtype ("bfloat16", "int32")."""
    if dtype not in _NAMES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _NAMES[dtype]
