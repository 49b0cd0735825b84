"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``mxnet_tpu``.  Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a
kernel written by hand for ``sm_90a`` under ``csrc/`` (built at first
use by ``_build.py``).  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.

The first slice is serving: ``models.gpt`` + ``models.decoding`` +
``serve.DecodeServer`` with int8 weights (kernels ``q8_matvec`` and the
flash-attention forward).  The second is training: ``gluon`` (losses,
``Trainer``), ``optimizer``, ``parallel.SPMDTrainer``, ``random`` and
``models.bert``, with the flash-attention backward kernels behind a
``torch.autograd.Function``.  The third is the fused decode step
(``kv_generate(fused="on")``, one kernel launch per token).  The fourth
is vision training: ``gluon.nn`` convolution, pooling and BatchNorm
layers, ``initializer`` and the model zoo's ResNet family, with the
fused 1x1-convolution backward as a kernel.
"""
__version__ = "0.1.0"

from importlib import import_module as _imp

from .base import MXNetError
from .device import resolve_device

_SUBPACKAGES = ("ops", "models", "serve", "gluon", "optimizer", "parallel",
                "random", "initializer")

__all__ = ["MXNetError", "resolve_device", *_SUBPACKAGES]


def __getattr__(name):
    if name in _SUBPACKAGES:
        mod = _imp("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'mxnet_tpu_torch' has no attribute {name!r}")
