"""The base of the port's Gluon layers.

Counterpart of ``mxnet_tpu/gluon/block.py`` for the layers of
``gluon.nn``: a ``HybridBlock`` is an ``nn.Module`` whose parameters live
on the card unless it was built with ``device="cpu"``.  ``initialize``
fills them through ``initializer.initialize`` (the reference's name
rules and per-layer initializers, from one seeded generator), ``cast``
converts every parameter, running statistics included, as the
reference's ``Block.cast`` does.  Shapes are given when a layer is built:
the reference's deferred shape inference (``in_channels=0``) comes with
a later slice and raises here.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as _init
from ..base import MXNetError, torch_dtype

__all__ = ["HybridBlock", "deferred"]


def deferred(layer, what):
    return MXNetError(f"{layer}: {what}=0 asks for deferred shape "
                      "inference, which comes with a later slice of "
                      "mxnet_tpu_torch; pass the size explicitly")


class HybridBlock(nn.Module):
    """``nn.Module`` with the reference block's ``initialize`` and
    ``cast``.  ``_inits`` maps a parameter's attribute name to
    the initializer its layer was given for it."""

    def __init__(self):
        super().__init__()
        self._inits = {}

    def _param(self, name, shape, device, dtype, init=None,
               requires_grad=True):
        p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                         requires_grad=requires_grad)
        setattr(self, name, p)
        if init is not None:
            self._inits[name] = init
        return p

    def initialize(self, init=None, seed=0):
        """Fill every parameter (``initializer.initialize``); returns
        ``self``."""
        return _init.initialize(self, init, seed)

    def cast(self, dtype):
        """Convert every parameter to ``dtype`` (e.g. "bfloat16")."""
        return self.to(dtype=torch_dtype(dtype))
