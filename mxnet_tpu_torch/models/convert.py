"""Carry weights between an ``mxnet_tpu`` GPT, BERT, Llama or Gluon
vision net (the ResNet family) and the port.

``arrays`` is ``{name: numpy array}`` as ``net.collect_params()`` names
the reference's parameters (``gpt0_h0_attn_qkv_weight``,
``bertmodel0_layer0_ffn_fc1_bias``, ``resnetv10_stage3_batchnorm7_
running_var``, ...).  The model prefix is stripped and the layouts kept
((out, in) and OIHW), so no array is transposed.  A net built from
``gluon`` blocks names its parameters as the reference does
(``Parameter.name``, from the same name scopes), so its arrays are
matched by that name, and a parameter whose shape waits on the first
forward takes the array's.  Running statistics are parameters in both
packages and are carried both ways.  ``arrays_from_port`` is the reverse
map, so a test can compare trained weights name by name.  Nothing here
imports the JAX package: the caller hands over plain arrays.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.block import Block
from ..gluon.model_zoo.vision import get_resnet
from .bert import BERTModel
from .gpt import GPT
from .llama import Llama

__all__ = ["gpt_from_mxnet_tpu", "bert_from_mxnet_tpu",
           "llama_from_mxnet_tpu", "resnet_from_mxnet_tpu",
           "load_mxnet_tpu_arrays", "arrays_from_port"]

_PREFIX = re.compile(r"^[a-z]+\d+_")
_SUBLAYER = {"ln1": "ln1", "ln2": "ln2", "attn_qkv": "attn.qkv",
             "attn_out": "attn.proj", "ffn_fc1": "ffn.fc1",
             "ffn_fc2": "ffn.fc2"}
_KINDS = "weight|bias|gamma|beta"

_LLAMA_SUBLAYER = {"rms1": "rms1", "rms2": "rms2", "attn_q": "attn.q_proj",
                   "attn_k": "attn.k_proj", "attn_v": "attn.v_proj",
                   "attn_o": "attn.o_proj", "mlp_gate": "mlp.gate",
                   "mlp_up": "mlp.up", "mlp_down": "mlp.down"}

# per model: reference names of the top-level parameters -> port names,
# the reference's layer prefix, the port's layer list and the sublayers
_GPT = dict(top={"wte_weight": "wte.weight", "wpe_weight": "wpe.weight",
                 "lnf_gamma": "ln_f.gamma", "lnf_beta": "ln_f.beta"},
            layer="h", blocks="blocks", sub=_SUBLAYER)
_LLAMA = dict(top={"wte_weight": "wte.weight", "rmsf_gamma": "ln_f.gamma",
                   "head_weight": "head.weight"},
              layer="h", blocks="blocks", sub=_LLAMA_SUBLAYER)
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
             layer="layer", blocks="cells", sub=_SUBLAYER)


def _ref_name(port: str, spec) -> str:
    """The reference's parameter name, prefix stripped, of port
    parameter ``port``."""
    for short, target in spec["top"].items():
        if target == port:
            return short
    m = re.match(rf"^{spec['blocks']}\.(\d+)\.(.+)\.({_KINDS})$", port)
    for ref, sub in spec["sub"].items():
        if m and m.group(2) == sub:
            return f"{spec['layer']}{m.group(1)}_{ref}_{m.group(3)}"
    raise MXNetError(f"no reference parameter for port parameter {port!r}")


def _spec(model):
    if isinstance(model, GPT):
        return _GPT
    if isinstance(model, BERTModel):
        return _BERT
    if isinstance(model, Llama):
        return _LLAMA
    raise MXNetError(f"no weight map for {type(model).__name__}")


def _gluon_names(model) -> dict:
    """``{structural name: reference name without the model prefix}`` of
    a net built from ``gluon`` blocks: each ``Parameter.name`` less the
    net's prefix."""
    cut = len(model.prefix)
    return {k: p.name[cut:] if p.name.startswith(model.prefix) else p.name
            for k, p in model._collect_params_with_prefix().items()}


def _names(model) -> dict:
    """``{port name: reference name without the model prefix}`` of every
    parameter of ``model``."""
    if isinstance(model, Block):
        return _gluon_names(model)
    spec = _spec(model)
    return {name: _ref_name(name, spec)
            for name, _ in model.named_parameters()}


def _load(model, arrays):
    to_port = {ref: port for port, ref in _names(model).items()}
    gluon = isinstance(model, Block)
    params = model._collect_params_with_prefix() if gluon else \
        dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, arr in arrays.items():
            target = to_port.get(_PREFIX.sub("", name, count=1))
            if target is None:
                raise MXNetError(f"no port parameter for reference "
                                 f"parameter {name!r}")
            p = params[target]
            a = np.asarray(arr)
            t = torch.from_numpy(a.astype(np.float32))
            if gluon:
                p._load_init(t)
            elif tuple(a.shape) != tuple(p.shape):
                raise MXNetError(f"{name!r}: shape {a.shape} != port "
                                 f"{tuple(p.shape)}")
            else:
                p.copy_(t)
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


def llama_from_mxnet_tpu(cfg, arrays, device=None, dtype=None) -> Llama:
    """A port ``Llama`` of config ``cfg`` holding the reference's
    weights."""
    return _load(Llama(cfg, device=device, dtype=dtype), arrays)


def resnet_from_mxnet_tpu(version, num_layers, arrays, **kwargs):
    """A port ``get_resnet(version, num_layers, **kwargs)`` holding the
    reference's weights and running statistics."""
    return _load(get_resnet(version, num_layers, **kwargs), arrays)


def load_mxnet_tpu_arrays(model, arrays):
    """Copy the reference's ``arrays`` into the port ``model`` (any of
    the nets above, e.g. a ResNet built from its classes); returns
    ``model``."""
    return _load(model, arrays)


def arrays_from_port(model, prefix="") -> dict:
    """``{prefix + reference name: f32 numpy array}`` of every parameter
    of a port GPT, BERT, Llama or ResNet, running statistics included
    (``prefix`` is the reference model's, e.g. ``"gpt0_"`` or
    ``"resnetv10_"``)."""
    names = _names(model)
    params = {k: p.data()._data for k, p in
              model._collect_params_with_prefix().items()} \
        if isinstance(model, Block) else dict(model.named_parameters())
    return {prefix + names[name]: p.detach().float().cpu().numpy()
            for name, p in params.items()}
