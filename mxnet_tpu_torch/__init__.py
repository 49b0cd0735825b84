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
fused 1x1-convolution backward as a kernel.  The fifth is the
imperative core: ``nd`` (``NDArray`` and the op registry), ``autograd``,
``context`` (``cpu()``, ``gpu()``), ``operator`` (custom ops) and ``rtc``
(CUDA kernels compiled at run time by NVRTC), so that ``import
mxnet_tpu_torch as mx`` reads like the reference's ``import mxnet_tpu as
mx``.  The tenth is Gluon's parameter layer: ``gluon.Parameter``,
``ParameterDict``, deferred initialization, ``collect_params()``,
``save_parameters``/``load_parameters`` and ``mx.init``, with NDArrays in
and out of every block, loss and ``gluon.Trainer``.
"""
__version__ = "0.1.0"

from importlib import import_module as _imp

from .base import MXNetError
from .device import resolve_device

_SUBPACKAGES = ("ops", "models", "serve", "gluon", "optimizer", "parallel",
                "random", "initializer", "ndarray", "autograd", "context",
                "operator", "rtc")
# names of the imperative core, taken from the module that holds them
_FROM = {"nd": ("ndarray", None), "init": ("initializer", None),
         "cpu": ("context", "cpu"),
         "gpu": ("context", "gpu"), "Context": ("context", "Context"),
         "current_context": ("context", "current_context"),
         "num_gpus": ("context", "num_gpus"),
         "lr_scheduler": ("optimizer.lr_scheduler", None)}

__all__ = ["MXNetError", "resolve_device", *_SUBPACKAGES, *_FROM]


def __getattr__(name):
    if name in _SUBPACKAGES:
        mod = _imp("." + name, __name__)
        globals()[name] = mod
        return mod
    if name in _FROM:
        mod_name, attr = _FROM[name]
        mod = _imp("." + mod_name, __name__)
        value = mod if attr is None else getattr(mod, attr)
        globals()[name] = value
        return value
    raise AttributeError(
        f"module 'mxnet_tpu_torch' has no attribute {name!r}")
