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
and out of every block, loss and ``gluon.Trainer``.  The sixteenth is
``telemetry`` (metrics, events, fault injection, memory accounting, the
capture watch) and the server's deadlines, cancellation, watchdog, HBM
budget and synchronous mode.  The eighteenth is data and I/O:
``gluon.data`` (datasets, samplers, batchify functions, the DataLoader
and its device ring), ``recordio``, ``io`` and ``image``.  The
twenty-second is the training run's services: ``checkpoint`` (atomic,
verified, asynchronous saves and bit-exact resume), ``amp`` (mixed
precision and the loss scaler), ``profiler`` and ``engine``, with
``nd.sparse``.  The twenty-third is vision breadth: the model zoo's
other families, the remaining initializers, ``metric`` and
``gluon.contrib`` (its layers, the convolutional recurrent cells and the
``Estimator`` with its event handlers).  The twenty-fourth is the
symbolic surface: ``sym`` (graphs, capture, the ``Executor``),
``HybridBlock.export`` and ``SymbolBlock.imports``, ``mod`` (MXNet
1.x's ``Module`` and ``BucketingModule``), ``model``, ``callback``,
``name`` (with ``AttrScope``), ``viz``, ``test_utils`` and
``predictor``.  The twenty-fifth is the NumPy interface: ``np`` (with
``np.linalg`` and ``np.random``), ``npx`` and ``util`` (``set_np``),
with ``runtime``, the trace parser ``profiler_trace`` behind
``profiler.device_dumps(by="tf_op")``, the trainer's memory ledger and
the fused step's telemetry, and ``contrib.quantization``'s
``quantize_net``.  The twenty-sixth is ``kv`` (``kvstore`` on one
process, with ``gluon.Trainer``'s ``update_on_kvstore``) and the C ABI
(``capi_shim`` and its embedded-CPython library, built by
``_build.capi_library()``).
"""
__version__ = "0.1.0"

from importlib import import_module as _imp

from .base import MXNetError
from .device import resolve_device

_SUBPACKAGES = ("ops", "models", "serve", "gluon", "optimizer", "parallel",
                "random", "initializer", "ndarray", "autograd", "context",
                "operator", "rtc", "telemetry", "io", "recordio", "image",
                "amp", "checkpoint", "engine", "profiler", "metric",
                "symbol", "module", "model", "callback", "name",
                "visualization", "test_utils", "predictor", "util",
                "runtime", "contrib", "profiler_trace", "base",
                "kvstore", "capi_shim")
# names of the imperative core, taken from the module that holds them
_FROM = {"nd": ("ndarray", None), "init": ("initializer", None),
         "cpu": ("context", "cpu"),
         "gpu": ("context", "gpu"), "Context": ("context", "Context"),
         "cpu_pinned": ("context", "cpu_pinned"),
         "cpu_shared": ("context", "cpu_shared"),
         "current_context": ("context", "current_context"),
         "num_gpus": ("context", "num_gpus"),
         "lr_scheduler": ("optimizer.lr_scheduler", None),
         "sym": ("symbol", None), "mod": ("module", None),
         "viz": ("visualization", None),
         "np": ("numpy", None), "npx": ("numpy_extension", None),
         "AttrScope": ("name", "AttrScope"), "kv": ("kvstore", None)}

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
