"""The store (see the package docstring).

Port of ``mxnet_tpu/kvstore/kvstore.py``.  Values are ``NDArray``s
(a value of a push may be a list: the per-device values, summed in
order).  The store keeps its own copy of each key's array.  A pull
writes into the given arrays in place, in their dtype, so a Gluon
parameter stays its module's tensor and a captured step keeps reading
it.
"""
from __future__ import annotations

import copy
import pickle
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..telemetry.faults import fault_point

__all__ = ["KVStore", "create"]

_KNOWN_TYPES = ("local", "device", "nccl", "tpu", "dist_sync", "dist_async",
                "dist_device_sync", "dist")


def create(name="local"):
    """A store of type ``name`` (one of the reference's eight); the
    ``dist`` types run with one worker."""
    if name not in _KNOWN_TYPES:
        raise MXNetError(f"unknown kvstore type {name}")
    if name == "dist_async":
        warnings.warn(
            "kvstore 'dist_async' runs with synchronous semantics: with one "
            "worker every push is applied before the next call (see "
            "PARITY.md)", UserWarning, stacklevel=2)
    return KVStore(name)


def _write(out, data):
    """``data`` into the array ``out``, in place, cast to its dtype and
    moved to its device."""
    dst = out._data
    if tuple(dst.shape) != tuple(data.shape):
        out._rebind(data.to(device=dst.device, dtype=dst.dtype).clone())
        return
    with torch.no_grad():
        dst.copy_(data)


def _outs(out):
    return out if isinstance(out, (list, tuple)) else [out]


class KVStore:
    """A store on one process (``create`` makes one)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store: dict = {}
        self._updater = None
        self._optimizer = None
        self._opt_states: dict = {}
        self._compression_params = None
        self._compression = None

    # -- identity ----------------------------------------------------------- #
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core API ----------------------------------------------------------- #
    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        key = str(key)
        if key in self._store:
            return
        v = value[0] if isinstance(value, (list, tuple)) else value
        self._store[key] = NDArray(v._data.detach().clone())
        if self._optimizer is not None:
            self._opt_states[key] = \
                self._optimizer.create_state_multi_precision(
                    key, self._store[key]._data)

    def _merge(self, value, key=None):
        """A value list summed in order on its first value's device, then
        compressed with the key's residual when compression is on."""
        if not isinstance(value, (list, tuple)):
            acc = value._data
        else:
            acc = value[0]._data
            for v in value[1:]:
                acc = acc + v._data.to(acc.device)
        if self._compression is not None and key is not None:
            acc = self._compression.compress(key, acc)
        return acc

    def _stored(self, key):
        if key not in self._store:
            raise MXNetError(f"kvstore key {key} not initialized")
        return self._store[key]

    def push(self, key, value, priority=0):
        fault_point("kvstore.push", store=self._kind)
        if isinstance(key, (list, tuple)):
            if self._optimizer is not None:
                # optimizer on the store, one wave for the whole push:
                # every key merged, then one grouped multi-tensor apply
                keys = [str(k) for k in key]
                weights = [self._stored(k)._data for k in keys]
                merged = [self._merge(v, k) for k, v in zip(keys, value)]
                self._optimizer.multi_update(
                    keys, weights, merged,
                    [self._opt_states[k] for k in keys])
                return
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        key = str(key)
        stored = self._stored(key)
        merged = self._merge(value, key)
        if self._optimizer is not None:
            self._optimizer.multi_update([key], [stored._data], [merged],
                                         [self._opt_states[key]])
        elif self._updater is not None:
            self._updater(key, NDArray(merged), stored)
        else:
            stored._rebind(stored._data + merged)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        fault_point("kvstore.pull", store=self._kind)
        if isinstance(key, (list, tuple)) and isinstance(out, (list, tuple)) \
                and len(key) == len(out) and isinstance(key[0], (str, int)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        src = self._stored(str(key))._data
        for o in _outs(out):
            _write(o, src)

    def pushpull(self, key, value, out=None, priority=0):
        """Push then pull (reference ``MXKVStorePushPull``); with neither
        an updater nor an optimizer it is an allreduce, ``out = sum of
        the values``, and the store keeps that sum."""
        fault_point("kvstore.pushpull", store=self._kind)
        if isinstance(key, (list, tuple)) and not isinstance(key, str):
            outs = out if out is not None else [None] * len(key)
            for k, v, o in zip(key, value, outs):
                self.pushpull(k, v, o, priority)
            return
        key = str(key)
        if self._optimizer is not None or self._updater is not None:
            self.push(key, value, priority)
            if out is not None:
                self.pull(key, out, priority)
            return
        merged = self._merge(value, key)
        if out is None:
            self._stored(key)._rebind(merged.clone())
            return
        for o in _outs(out):
            _write(o, merged)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (reference
        ``PullRowSparse``): the other rows of ``out`` become 0."""
        if row_ids is None:
            return self.pull(key, out, priority)
        src = self._stored(str(key))._data
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        for o, r in zip(_outs(out), rids):
            idx = r._data.to(device=src.device, dtype=torch.int64)
            full = torch.zeros_like(src)
            full[idx] = src[idx]
            _write(o, full)

    # -- updater / optimizer ------------------------------------------------ #
    def set_updater(self, updater):
        """``updater(key, recv, stored)`` runs at each push (reference
        ``KVStore.set_updater``)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store at push time (the
        reference's optimizer on the parameter server)."""
        self._optimizer = optimizer
        for key, w in self._store.items():
            self._opt_states[key] = \
                optimizer.create_state_multi_precision(key, w._data)

    @property
    def is_capable(self):
        return {"optimizer": True}

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Pickle the states as host arrays (bf16 by name, as the
        trainer's states files) and, with ``dump_optimizer``, the
        optimizer without its parameter table."""
        from ..ndarray.serialization import _as_file_array

        payload = {"states": {k: _as_file_array(v)
                              for k, v in self._opt_states.items()}}
        if dump_optimizer and self._optimizer is not None:
            opt = copy.copy(self._optimizer)
            opt.param_dict = {}
            payload["optimizer"] = opt
        with open(fname, "wb") as f:
            pickle.dump(payload, f, protocol=4)

    def load_optimizer_states(self, fname):
        """Read ``save_optimizer_states``'s file: each state is written in
        place into the state that exists (a captured step reads it); a
        dumped optimizer's settings and counts go into the store's
        optimizer, which keeps its parameter table."""
        from ..gluon.trainer import _copy_state
        from ..ndarray.serialization import load_states

        payload = load_states(fname)
        loaded = payload.get("optimizer")
        if loaded is not None:
            if self._optimizer is None:
                self._optimizer = loaded
            else:
                params = self._optimizer.param_dict
                self._optimizer.__dict__.update(loaded.__dict__)
                self._optimizer.param_dict = params
        for key, saved in payload["states"].items():
            if key in self._opt_states:
                _copy_state(self._opt_states[key], saved, f"state {key}")
            else:
                self._opt_states[key] = _tensors(saved, self._store.get(key))

    def set_gradient_compression(self, compression_params):
        """2-bit (or 1-bit) compression with an error-feedback residual on
        every pushed value (reference ``GradientCompression``)."""
        from .compression import GradientCompression

        self._compression_params = compression_params
        params = dict(compression_params or {})
        self._compression = GradientCompression(
            type=params.get("type", "2bit"),
            threshold=float(params.get("threshold", 0.5)))

    def barrier(self):
        """Wait for the card's work (one worker: nothing to meet)."""
        from ..ndarray.ndarray import waitall

        waitall()

    def _wait(self, keys):
        for k in (keys if isinstance(keys, (list, tuple)) else [keys]):
            self._store[str(k)].wait_to_read()


def _tensors(saved, like):
    """A loaded state (numpy arrays or tensors in its nesting) as tensors
    on ``like``'s device."""
    if saved is None:
        return None
    if isinstance(saved, (list, tuple)):
        return type(saved)(_tensors(s, like) for s in saved)
    t = saved if isinstance(saved, torch.Tensor) else \
        torch.from_numpy(saved.copy())
    return t.to(like._data.device) if like is not None else t
