"""Checkpoint helpers shared by ``Module`` and the callbacks.

Port of ``mxnet_tpu/model.py`` (reference ``python/mxnet/model.py``):
``save_checkpoint``/``load_checkpoint`` write and read
``prefix-symbol.json`` and ``prefix-%04d.params``, the latter in the
reference's ``.params`` format (``ndarray/serialization.py``) with its
``arg:``/``aux:`` keys, so either package reads the other's checkpoints.
``_create_kvstore`` turns a kvstore argument into ``(store,
update_on_kvstore)`` as the reference's does (``MXNET_UPDATE_ON_KVSTORE``,
default 1); ``Module`` accepts the argument and leaves it unused, as the
reference's does.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

from .base import MXNetError, get_env, register_env
from .ndarray import serialization

register_env("MXNET_UPDATE_ON_KVSTORE", 1,
             "1: a store made by _create_kvstore runs the optimizer")


class _BatchEndParam(tuple):
    pass


BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """A kvstore argument (None, a type name or a ``KVStore``) as
    ``(store or None, update_on_kvstore)``: a local type on one device
    needs no store (reference ``_create_kvstore``)."""
    from .kvstore import KVStore, create as kv_create

    update_on_kvstore = bool(get_env("MXNET_UPDATE_ON_KVSTORE", typ=int))
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        kv = None if num_device == 1 and "dist" not in kvstore \
            else kv_create(kvstore)
    else:
        raise MXNetError(f"invalid kvstore {kvstore!r}")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (if a symbol is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json", remove_amp_cast=remove_amp_cast)
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    serialization.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_params_file(param_file, ctx=None):
    """Split a ``.params`` file into ``(arg_params, aux_params)``, on
    ``ctx`` (default the current context); a file of plain names (Gluon's
    ``save_parameters``) is all arguments."""
    loaded = serialization.load(param_file, ctx=ctx)
    if isinstance(loaded, list):
        raise MXNetError("params file has unnamed arrays; cannot map")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_params(prefix, epoch, ctx=None):
    """``(arg_params, aux_params)`` of ``prefix-%04d.params``."""
    return load_params_file(f"{prefix}-{epoch:04d}.params", ctx=ctx)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol or None, arg_params, aux_params)``."""
    sym_file = f"{prefix}-symbol.json"
    symbol = None
    if os.path.isfile(sym_file):
        from .symbol import load as sym_load
        symbol = sym_load(sym_file)
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    return symbol, arg_params, aux_params
