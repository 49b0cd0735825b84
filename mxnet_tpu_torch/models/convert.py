"""Carry weights between an ``mxnet_tpu`` GPT or BERT and the port.

``arrays`` is ``{name: numpy array}`` as ``net.collect_params()`` names
the reference's parameters (``gpt0_h0_attn_qkv_weight``,
``bertmodel0_layer0_ffn_fc1_bias``, ...).  The model prefix is stripped
and the (out, in) layout kept, so no array is transposed.
``arrays_from_port`` is the reverse map, so a test can compare trained
weights name by name.  Nothing here imports the JAX package: the caller
hands over plain arrays.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..base import MXNetError
from .bert import BERTModel
from .gpt import GPT

__all__ = ["gpt_from_mxnet_tpu", "bert_from_mxnet_tpu", "arrays_from_port"]

_PREFIX = re.compile(r"^[a-z]+\d+_")
_SUBLAYER = {"ln1": "ln1", "ln2": "ln2", "attn_qkv": "attn.qkv",
             "attn_out": "attn.proj", "ffn_fc1": "ffn.fc1",
             "ffn_fc2": "ffn.fc2"}
_KINDS = "weight|bias|gamma|beta"

# per model: reference names of the top-level parameters -> port names,
# the reference's layer prefix and the port's layer list
_GPT = dict(top={"wte_weight": "wte.weight", "wpe_weight": "wpe.weight",
                 "lnf_gamma": "ln_f.gamma", "lnf_beta": "ln_f.beta"},
            layer="h", blocks="blocks")
_BERT = dict(top={"word_weight": "word_embed.weight",
                  "type_weight": "token_type_embed.weight",
                  "pos_weight": "position_embed.weight",
                  "embln_gamma": "embed_ln.gamma",
                  "embln_beta": "embed_ln.beta",
                  "pooler_weight": "pooler.weight",
                  "pooler_bias": "pooler.bias",
                  "mlmd_weight": "mlm_dense.weight",
                  "mlmd_bias": "mlm_dense.bias",
                  "mlmln_gamma": "mlm_ln.gamma", "mlmln_beta": "mlm_ln.beta"},
             layer="layer", blocks="cells")


def _port_name(name: str, spec) -> str:
    short = _PREFIX.sub("", name, count=1)
    if short in spec["top"]:
        return spec["top"][short]
    m = re.match(rf"^{spec['layer']}(\d+)_(.+)_({_KINDS})$", short)
    if m and m.group(2) in _SUBLAYER:
        return (f"{spec['blocks']}.{m.group(1)}."
                f"{_SUBLAYER[m.group(2)]}.{m.group(3)}")
    raise MXNetError(f"no port parameter for reference parameter {name!r}")


def _ref_name(port: str, spec) -> str:
    """The reference's parameter name, prefix stripped, of port
    parameter ``port``."""
    for short, target in spec["top"].items():
        if target == port:
            return short
    m = re.match(rf"^{spec['blocks']}\.(\d+)\.(.+)\.({_KINDS})$", port)
    for ref, sub in _SUBLAYER.items():
        if m and m.group(2) == sub:
            return f"{spec['layer']}{m.group(1)}_{ref}_{m.group(3)}"
    raise MXNetError(f"no reference parameter for port parameter {port!r}")


def _spec(model):
    if isinstance(model, GPT):
        return _GPT
    if isinstance(model, BERTModel):
        return _BERT
    raise MXNetError(f"no weight map for {type(model).__name__}")


def _load(model, arrays):
    spec = _spec(model)
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, arr in arrays.items():
            target = _port_name(name, spec)
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


def gpt_from_mxnet_tpu(cfg, arrays, device=None, dtype=None) -> GPT:
    """A port ``GPT`` of config ``cfg`` holding the reference's weights."""
    return _load(GPT(cfg, device=device, dtype=dtype), arrays)


def bert_from_mxnet_tpu(cfg, arrays, use_pooler=True, use_mlm=True,
                        device=None, dtype=None) -> BERTModel:
    """A port ``BERTModel`` of config ``cfg`` holding the reference's
    weights."""
    return _load(BERTModel(cfg, use_pooler=use_pooler, use_mlm=use_mlm,
                           device=device, dtype=dtype), arrays)


def arrays_from_port(model, prefix="") -> dict:
    """``{prefix + reference name: f32 numpy array}`` of every parameter
    of a port GPT or BERT (``prefix`` is the reference model's, e.g.
    ``"gpt0_"``)."""
    spec = _spec(model)
    return {prefix + _ref_name(name, spec):
            p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}
