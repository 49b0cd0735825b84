"""Foundation: the framework's error type, dtype names and the
environment-variable config.

The port keeps its own copy of ``MXNetError``, the type tuples and the
``MXNET_*`` registry (``register_env``/``get_env``/``env_truthy``) so
that it imports nothing of the JAX package (``mxnet_tpu/base.py`` holds
the reference ones).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "dtype_name", "numeric_types",
           "integer_types", "string_types", "mx_real_t", "register_env",
           "WIDE_UNSIGNED", "int_result_type",
           "get_env", "env_truthy", "parse_seconds", "is_naive_engine"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
           "uint16": torch.uint16, "uint32": torch.uint32,
           "uint64": torch.uint64,
           "complex64": torch.complex64, "complex128": torch.complex128}
_NAMES = {v: k for k, v in _DTYPES.items()}

numeric_types = (float, int, np.generic)
integer_types = (int, np.integer)
string_types = (str,)
mx_real_t = np.float32


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


# torch keeps these types but computes almost nothing in them
WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
_UNSIGNED = (torch.uint8,) + WIDE_UNSIGNED


def int_result_type(dtypes):
    """JAX's promotion of integer types, 64-bit types as 32-bit: mixed
    signedness takes a signed type wider than the unsigned one (int32 +
    uint32 is int32), and ``None`` for no integer type."""
    u = i = 0
    for d in dtypes:
        if d in _UNSIGNED:
            u = max(u, torch.iinfo(d).bits)
        elif d != torch.bool and not (d.is_floating_point or d.is_complex):
            i = max(i, torch.iinfo(d).bits)
    if not (u or i):
        return None
    bits = u if not i else (i if i > u else 2 * u)
    return getattr(torch, f"{'u' if u and not i else ''}int{min(bits, 32)}")


def dtype_name(dtype) -> str:
    """The framework's name of a torch dtype ("bfloat16", "int32")."""
    if dtype not in _NAMES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _NAMES[dtype]


# the ``MXNET_*`` variables' defaults (reference ``dmlc::GetEnv`` at the
# point of use); read lazily, so a test may set ``os.environ``
_ENV_REGISTRY: dict = {}
_env_lock = threading.Lock()


def register_env(name: str, default: Any, doc: str = "") -> None:
    """Record ``name``'s default (and what it does) for ``get_env``."""
    with _env_lock:
        _ENV_REGISTRY[name] = (default, doc)


def get_env(name: str, default: Any = None, typ: Optional[Callable] = None):
    """An environment variable parsed by ``typ`` (by default the type of
    ``default``, or of the registered default); unset or unparsable, the
    default.  A ``bool`` is true for ``1``/``true``/``yes``/``on``."""
    if default is None and name in _ENV_REGISTRY:
        default = _ENV_REGISTRY[name][0]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is None and default is not None:
        typ = type(default)
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if typ is not None:
        try:
            return typ(raw)
        except (TypeError, ValueError):
            return default
    return raw


def env_truthy(name: str, default: bool = False) -> bool:
    return bool(get_env(name, default, bool))


def parse_seconds(var, raw):
    """A seconds knob from the environment: ``None`` when unset, a float
    otherwise; a malformed value raises ``MXNetError`` naming ``var``
    (reference ``base.parse_seconds``)."""
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise MXNetError(f"{var}={raw!r}: expected seconds (a number)")


def is_naive_engine() -> bool:
    """``MXNET_ENGINE_TYPE=NaiveEngine``: every op waits for its result
    (the reference's synchronous debugging engine, ``base.
    is_naive_engine``); read at each call, so a test may set it."""
    return os.environ.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
