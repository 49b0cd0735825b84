"""Carry weights from an ``mxnet_tpu`` GPT into the port.

``arrays`` is ``{name: numpy array}`` as ``net.collect_params()`` names
the reference's parameters (``gpt0_h0_attn_qkv_weight``,
``gpt0_lnf_gamma``, ...).  The model prefix is stripped and the (out, in)
layout kept, so no array is transposed.  Nothing here imports the JAX
package: the caller hands over plain arrays.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..base import MXNetError
from .gpt import GPT

__all__ = ["gpt_from_mxnet_tpu"]

_PREFIX = re.compile(r"^[a-z]+\d+_")
_SUBLAYER = {"ln1": "ln1", "ln2": "ln2", "attn_qkv": "attn.qkv",
             "attn_out": "attn.proj", "ffn_fc1": "ffn.fc1",
             "ffn_fc2": "ffn.fc2"}
_TOP = {"wte_weight": "wte.weight", "wpe_weight": "wpe.weight",
        "lnf_gamma": "ln_f.gamma", "lnf_beta": "ln_f.beta"}
_LAYER = re.compile(r"^h(\d+)_(.+)_(weight|bias|gamma|beta)$")


def _port_name(name: str) -> str:
    short = _PREFIX.sub("", name, count=1)
    if short in _TOP:
        return _TOP[short]
    m = _LAYER.match(short)
    if m and m.group(2) in _SUBLAYER:
        return f"blocks.{m.group(1)}.{_SUBLAYER[m.group(2)]}.{m.group(3)}"
    raise MXNetError(f"no port parameter for reference parameter {name!r}")


def gpt_from_mxnet_tpu(cfg, arrays, device=None, dtype=None) -> GPT:
    """A port ``GPT`` of config ``cfg`` holding the reference's weights."""
    model = GPT(cfg, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, arr in arrays.items():
            target = _port_name(name)
            p = params.get(target)
            if p is None:
                raise MXNetError(f"{name!r} maps to {target!r}, which the "
                                 "port model does not have")
            a = np.asarray(arr)
            if tuple(a.shape) != tuple(p.shape):
                raise MXNetError(f"{name!r}: shape {a.shape} != port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)))
            seen.add(target)
    missing = sorted(set(params) - seen)
    if missing:
        raise MXNetError(f"reference arrays lack port parameters {missing}")
    return model
