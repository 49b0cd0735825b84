"""``mx.mod``: MXNet 1.x's Module API.

Port of ``mxnet_tpu/module/`` (reference ``python/mxnet/module/``):
``BaseModule`` (``fit``/``score``/``predict``), ``Module`` (a Symbol
bound through one ``Executor``) and ``BucketingModule`` (a Module per
bucket key, all sharing the default bucket's parameter arrays).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
