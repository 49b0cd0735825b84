"""Device contexts: ``Context``, ``cpu()``, ``gpu(i)`` and the default
context stack.

Counterpart of ``mxnet_tpu/context.py``.  A ``Context`` names a torch
device: ``gpu(i)`` is ``cuda:i`` and ``cpu()`` the host.  The port's rule
holds here as in ``device.resolve_device``: the default context is
``gpu(0)``, and without CUDA ``gpu(i)``, the default context and every
array made on them raise ``MXNetError``; the host is reached only by
asking for it (``mx.cpu()``, ``with mx.cpu():``).  There is no quiet
degrade to the host as in the reference, and ``tpu()`` raises: this
build targets the card.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError
from .device import resolve_device

__all__ = ["Context", "cpu", "gpu", "tpu", "num_gpus", "current_context",
           "gpu_memory_info"]


class Context:
    """A device context: ``device_type`` is ``"cpu"`` or ``"gpu"``."""

    _default_ctx = threading.local()

    devtype2id = {"cpu": 1, "gpu": 2}
    devid2type = {v: k for k, v in devtype2id.items()}

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "tpu":
            tpu(device_id)
        if device_type not in self.devtype2id:
            raise MXNetError(f"unknown device type {device_type}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self) -> int:
        return self.devtype2id[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def torch_device(self) -> torch.device:
        """The torch device of this context; a GPU context raises
        ``MXNetError`` on a host without CUDA or past the last card."""
        if self.device_type == "cpu":
            return resolve_device("cpu")
        dev = resolve_device(f"cuda:{self.device_id}")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"context {self} out of range: "
                             f"{torch.cuda.device_count()} card(s) visible")
        return dev

    # -- default-context stack ------------------------------------------- #
    @classmethod
    def default_ctx(cls) -> "Context":
        ctx = getattr(cls._default_ctx, "value", None)
        return ctx if ctx is not None else gpu(0)

    def __enter__(self):
        stack = getattr(Context._default_ctx, "stack", None)
        if stack is None:
            stack = Context._default_ctx.stack = []
        stack.append(getattr(Context._default_ctx, "value", None))
        Context._default_ctx.value = self
        return self

    def __exit__(self, *args):
        Context._default_ctx.value = Context._default_ctx.stack.pop()

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this card
        (reference ``Context.empty_cache``)."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device()):
                torch.cuda.empty_cache()


def from_torch_device(dev: torch.device) -> Context:
    """The context of a tensor's device."""
    if dev.type == "cuda":
        return Context("gpu", 0 if dev.index is None else dev.index)
    if dev.type == "cpu":
        return Context("cpu", 0)
    raise MXNetError(f"unsupported device {dev}")


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """The ``device_id``-th card; raises ``MXNetError`` on a host without
    CUDA."""
    ctx = Context("gpu", device_id)
    ctx.torch_device()
    return ctx


def tpu(device_id: int = 0):
    raise MXNetError(
        "mx.tpu() has no device in mxnet_tpu_torch, which targets NVIDIA "
        "cards: use mx.gpu() (or mx.cpu() for the host)")


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    return Context.default_ctx()


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of the card's memory (reference
    ``mx.context.gpu_memory_info``), from ``torch.cuda.mem_get_info``."""
    dev = gpu(device_id).torch_device()
    return torch.cuda.mem_get_info(dev)
