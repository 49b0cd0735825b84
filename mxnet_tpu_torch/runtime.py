"""``mx.runtime`` — what this install offers, as feature flags.

Port of ``mxnet_tpu/runtime.py`` (the reference's ``libinfo``): the
reference's feature names in its order, each probed for this install
once, at the first query.  ``CUDA`` and ``CUDNN`` are ``torch.cuda`` and
``torch.backends.cudnn``; ``TPU``, ``PALLAS`` and ``XLA`` are off (the
port has no TPU backend, and its kernels are CUDA C++); ``SPMD`` is the
one-card ``parallel.SPMDTrainer``; ``INT64_TENSOR_SIZE`` is on (torch
indexes with 64 bits); ``DIST_KVSTORE`` is ``torch.distributed``;
``OPENMP`` and ``MKLDNN``/``ONEDNN`` are what torch was built with;
``OPENCV`` is ``cv2``'s presence.
"""
from __future__ import annotations

from collections import OrderedDict

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _probe():
    import importlib.util as iu

    import torch

    feats = OrderedDict()

    def add(name, fn):
        try:
            feats[name] = bool(fn())
        except Exception:
            feats[name] = False

    add("TPU", lambda: False)
    add("CPU", lambda: True)
    add("CUDA", torch.cuda.is_available)
    add("CUDNN", lambda: torch.cuda.is_available()
        and torch.backends.cudnn.is_available())
    add("PALLAS", lambda: False)
    add("XLA", lambda: False)
    add("SPMD", lambda: True)
    add("INT64_TENSOR_SIZE", lambda: True)
    add("F16C", lambda: True)
    add("BLAS_OPEN", lambda: True)
    add("DIST_KVSTORE", lambda: torch.distributed.is_available())
    add("OPENMP", lambda: torch.backends.openmp.is_available())
    add("MKLDNN", lambda: torch.backends.mkldnn.is_available())
    add("ONEDNN", lambda: torch.backends.mkldnn.is_available())
    add("TENSORRT", lambda: False)
    add("OPENCV", lambda: iu.find_spec("cv2"))
    add("PROFILER", lambda: True)
    add("SIGNAL_HANDLER", lambda: True)
    add("DEBUG", lambda: False)
    return feats


class Features(dict):
    """``mx.runtime.Features()``: name -> ``Feature``."""

    _cache = None

    def __init__(self):
        if Features._cache is None:
            Features._cache = _probe()
        super().__init__({k: Feature(k, v)
                          for k, v in Features._cache.items()})

    def __repr__(self):
        return "[" + ", ".join(repr(v) for v in self.values()) + "]"

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"feature '{feature_name}' does not exist")
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
