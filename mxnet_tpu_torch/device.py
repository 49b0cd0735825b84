"""Device placement: every entry point of the port runs on the card
unless the caller names the CPU.

Counterpart of ``mxnet_tpu/context.py``.  There is no silent CPU
fallback: without CUDA, a call that does not ask for ``"cpu"`` raises,
so a run that was meant for the card can never quietly measure the host.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``.  A CUDA device raises ``MXNetError``
    when this host has no CUDA; ``"cpu"`` (or a CPU ``torch.device``) is
    the only way onto the host."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            f"device {dev} requested but CUDA is not available on this "
            "host; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
