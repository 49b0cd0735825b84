"""Structure of the PyTorch port: it imports neither JAX, the JAX
package nor ``ml_dtypes`` (the card's machine has none), its entry
points refuse to run on a host without CUDA unless
asked for the CPU, and its kernels are built for sm_90a."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "decode_ab.py", REPO / "rtc_ab.py",
     REPO / "resnet_ab.py", REPO / "serve_grow_ab.py",
     REPO / "loader_ab.py",
     REPO / "tests" / "_torch_rtc_sources.py",
     REPO / "tests" / "_torch_nn_cases.py",
     REPO / "tests" / "_torch_hybrid_models.py",
     REPO / "tests" / "_torch_ssd_models.py",
     REPO / "tests" / "_torch_lstm_models.py",
     REPO / "tests" / "_torch_corpus_cases.py",
     REPO / "tests" / "_torch_draws.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from mxnet_tpu_torch import resolve_device
    from mxnet_tpu_torch.models import (BERTConfig, BERTModel, GPT, GPTConfig,
                                        Llama, LlamaConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        GPT(GPTConfig(num_layers=1, units=8, num_heads=2, hidden_size=8,
                      vocab_size=11, max_length=8))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        BERTModel(BERTConfig(num_layers=1, units=8, num_heads=2,
                             hidden_size=8, vocab_size=11, max_length=8))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Llama(LlamaConfig(num_layers=1, units=8, num_heads=2,
                          num_kv_heads=1, hidden_size=8, vocab_size=11,
                          max_length=8))
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model, get_resnet

    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_resnet(1, 50, classes=1000, layout="NHWC")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_model("resnet18_v1")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        nn.Conv2D(8, 3, in_channels=4)
    # the hybrid_forward layers create their known parameters at once too
    for make in (lambda: nn.LayerNorm(in_channels=4),
                 lambda: nn.Embedding(5, 3),
                 lambda: nn.Conv1D(4, 3, in_channels=2),
                 lambda: nn.Conv2DTranspose(4, 3, in_channels=2)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    import mxnet_tpu_torch as mx

    # the imperative core: the default context is gpu(0)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.zeros((2, 3))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.gpu()
    params = str(tmp_path / "a.params")
    mx.nd.save(params, [mx.nd.zeros((2,), ctx=mx.cpu())])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.load(params)
    assert mx.nd.load(params, ctx=mx.cpu())[0].context == mx.cpu()
    with pytest.raises(MXNetError, match="needs a CUDA card"):
        mx.rtc.CudaModule('extern "C" __global__ void k() {}')
    # the data slice: a loader or iterator meant for the card raises
    ds = mx.gluon.data.ArrayDataset(np.zeros((4, 2), np.float32))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.gluon.data.DataLoader(ds, batch_size=2, device=mx.Context("gpu"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        iter(mx.gluon.data.DataLoader(ds, batch_size=2))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.io.NDArrayIter(np.zeros((4, 2)), batch_size=2)
    with mx.cpu():
        inner = mx.io.NDArrayIter(np.zeros((4, 2)), batch_size=2)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.io.PrefetchingIter(inner, device=mx.Context("gpu"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mx.nd.array([1.0], ctx=mx.cpu_pinned())
    assert resolve_device("cpu").type == "cpu"
    assert mx.nd.zeros((2,), ctx=mx.cpu()).context == mx.cpu()
    # the sequence slice: the seq2seq model, the recurrent layers and
    # cells with known sizes, a layer's begin_state on the default context
    from mxnet_tpu_torch.models import Seq2SeqConfig

    for make in (lambda: Seq2SeqConfig(vocab_size=11, units=8,
                                       hidden_size=8, num_heads=2,
                                       num_enc_layers=1, num_dec_layers=1,
                                       max_length=8).make(),
                 lambda: mx.gluon.rnn.LSTM(4, input_size=3),
                 lambda: mx.gluon.rnn.GRUCell(4, input_size=3),
                 lambda: mx.gluon.rnn.LSTM(4).begin_state(2)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    # the training-runtime slice: sparse arrays on the default context
    for make in (lambda: mx.nd.sparse.zeros("csr", (2, 3)),
                 lambda: mx.nd.sparse.row_sparse_array(
                     (np.ones((1, 3), np.float32), [1]), shape=(4, 3)),
                 lambda: mx.nd.sparse.csr_matrix(np.eye(3, dtype=np.float32))):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    # the vision-breadth slice: a zoo net and the Estimator on the default
    # context
    with pytest.raises(MXNetError, match="CUDA is not available"):
        get_model("mobilenetv2_1.0")
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator

    with mx.cpu():
        small = nn.Dense(2, in_units=3)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Estimator(small, mx.gluon.loss.L2Loss())
    # the symbolic slice: a Module, an Executor, SymbolBlock.imports and a
    # Predictor on the default context
    graph = mx.sym.relu(mx.sym.var("data"))
    small.initialize(ctx=mx.cpu())
    small(mx.nd.zeros((1, 3), ctx=mx.cpu()))
    prefix = str(tmp_path / "small")
    small.export(prefix)
    for make in (lambda: mx.mod.Module(graph),
                 lambda: graph.bind(args={"data": np.zeros(2)}),
                 lambda: graph.simple_bind(data=(2,)),
                 lambda: mx.gluon.SymbolBlock.imports(
                     prefix + "-symbol.json", ["data"],
                     prefix + "-0000.params"),
                 lambda: mx.predictor.Predictor(
                     prefix + "-symbol.json", prefix + "-0000.params",
                     {"data": (1, 3)}),
                 lambda: mx.predictor.Predictor.load_compiled(prefix)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    # given the CPU, each runs there
    assert mx.mod.Module(graph, context=mx.cpu())._context == mx.cpu()
    assert graph.bind(mx.cpu(), args={"data": np.zeros(2)})._ctx == mx.cpu()


def test_new_modules_are_covered():
    """The structure checks above reach the fused decode, the vision,
    the imperative, the fused-train-step, the telemetry, the data, the
    detection and the sequence slices' modules and kernel sources."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"mxnet_tpu_torch/context.py",
            "mxnet_tpu_torch/ndarray/ndarray.py",
            "mxnet_tpu_torch/ndarray/serialization.py",
            "mxnet_tpu_torch/ndarray/__init__.py",
            "mxnet_tpu_torch/ops/registry.py",
            "mxnet_tpu_torch/ops/defs.py",
            "mxnet_tpu_torch/autograd.py",
            "mxnet_tpu_torch/operator.py",
            "mxnet_tpu_torch/rtc.py",
            "tests/_torch_rtc_sources.py"} <= names
    assert {"mxnet_tpu_torch/ops/decode_fused.py",
            "mxnet_tpu_torch/models/llama.py",
            "mxnet_tpu_torch/ops/conv_fused.py",
            "mxnet_tpu_torch/initializer.py",
            "mxnet_tpu_torch/gluon/block.py",
            "mxnet_tpu_torch/gluon/nn/basic_layers.py",
            "mxnet_tpu_torch/gluon/nn/conv_layers.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py"} <= names
    assert {"mxnet_tpu_torch/gluon/fused_step.py",
            "mxnet_tpu_torch/optimizer/lr_scheduler.py"} <= names
    assert {"mxnet_tpu_torch/telemetry/__init__.py",
            "mxnet_tpu_torch/telemetry/registry.py",
            "mxnet_tpu_torch/telemetry/events.py",
            "mxnet_tpu_torch/telemetry/faults.py",
            "mxnet_tpu_torch/telemetry/memory.py",
            "mxnet_tpu_torch/telemetry/compile.py",
            "mxnet_tpu_torch/serve/schema.py"} <= names
    # the data and I/O slice
    assert {"mxnet_tpu_torch/recordio.py",
            "mxnet_tpu_torch/io/__init__.py",
            "mxnet_tpu_torch/io/io.py",
            "mxnet_tpu_torch/image/__init__.py",
            "mxnet_tpu_torch/image/image.py",
            "mxnet_tpu_torch/image/detection.py",
            "mxnet_tpu_torch/gluon/data/__init__.py",
            "mxnet_tpu_torch/gluon/data/dataset.py",
            "mxnet_tpu_torch/gluon/data/sampler.py",
            "mxnet_tpu_torch/gluon/data/batchify.py",
            "mxnet_tpu_torch/gluon/data/dataloader.py",
            "mxnet_tpu_torch/gluon/data/vision/__init__.py",
            "mxnet_tpu_torch/gluon/data/vision/datasets.py",
            "mxnet_tpu_torch/gluon/data/vision/transforms.py"} <= names
    # the detection, image and quantization slice
    assert {"mxnet_tpu_torch/ops/box_nms.py",
            "mxnet_tpu_torch/ops/image_ops.py",
            "mxnet_tpu_torch/ops/quantization.py",
            "mxnet_tpu_torch/ndarray/contrib.py",
            "tests/_torch_ssd_models.py"} <= names
    # the sequence slice
    assert {"mxnet_tpu_torch/ops/rnn.py",
            "mxnet_tpu_torch/ops/linalg.py",
            "mxnet_tpu_torch/ops/legacy.py",
            "mxnet_tpu_torch/gluon/rnn/__init__.py",
            "mxnet_tpu_torch/gluon/rnn/rnn_cell.py",
            "mxnet_tpu_torch/gluon/rnn/rnn_layer.py",
            "mxnet_tpu_torch/models/seq2seq.py",
            "tests/_torch_lstm_models.py"} <= names
    # the op-corpus slice
    assert {"mxnet_tpu_torch/random.py",
            "mxnet_tpu_torch/ops/extended.py",
            "mxnet_tpu_torch/ops/optimizer_ops.py",
            "mxnet_tpu_torch/ops/samplers.py",
            "tests/_torch_corpus_cases.py",
            "tests/_torch_draws.py"} <= names
    # the training-runtime slice
    assert {"mxnet_tpu_torch/checkpoint.py",
            "mxnet_tpu_torch/engine.py",
            "mxnet_tpu_torch/profiler.py",
            "mxnet_tpu_torch/amp/__init__.py",
            "mxnet_tpu_torch/amp/amp.py",
            "mxnet_tpu_torch/amp/lists.py",
            "mxnet_tpu_torch/amp/loss_scaler.py",
            "mxnet_tpu_torch/ndarray/sparse.py"} <= names
    # the vision-breadth slice
    assert {"mxnet_tpu_torch/metric.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/alexnet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/vgg.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/squeezenet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/densenet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/inception.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/mobilenet.py",
            "mxnet_tpu_torch/gluon/contrib/__init__.py",
            "mxnet_tpu_torch/gluon/contrib/nn/__init__.py",
            "mxnet_tpu_torch/gluon/contrib/nn/basic_layers.py",
            "mxnet_tpu_torch/gluon/contrib/rnn/__init__.py",
            "mxnet_tpu_torch/gluon/contrib/rnn/conv_rnn_cell.py",
            "mxnet_tpu_torch/gluon/contrib/rnn/rnn_cell.py",
            "mxnet_tpu_torch/gluon/contrib/estimator/__init__.py",
            "mxnet_tpu_torch/gluon/contrib/estimator/estimator.py",
            "mxnet_tpu_torch/gluon/contrib/estimator/event_handler.py"} \
        <= names
    # the symbolic slice
    assert {"mxnet_tpu_torch/symbol/__init__.py",
            "mxnet_tpu_torch/symbol/symbol.py",
            "mxnet_tpu_torch/module/__init__.py",
            "mxnet_tpu_torch/module/base_module.py",
            "mxnet_tpu_torch/module/module.py",
            "mxnet_tpu_torch/module/bucketing_module.py",
            "mxnet_tpu_torch/model.py",
            "mxnet_tpu_torch/callback.py",
            "mxnet_tpu_torch/name.py",
            "mxnet_tpu_torch/predictor.py",
            "mxnet_tpu_torch/visualization.py",
            "mxnet_tpu_torch/test_utils.py"} <= names
    assert {"decode_fused", "conv1x1_bwd", "box_nms"} <= set(_build.KERNELS)


def test_zoo_names_and_module_names_match_the_reference():
    """``get_model`` knows the reference's 34 names and no other, and
    the ported modules export the reference's ``__all__``."""
    import importlib

    import mxnet_tpu.gluon.model_zoo.vision as rvision
    from mxnet_tpu_torch.gluon.model_zoo import vision

    assert sorted(vision._models) == sorted(rvision._models)
    assert len(vision._models) == 34 and not hasattr(vision, "_LATER")
    zoo = "gluon.model_zoo.vision."
    for mod in ("metric", "initializer", "gluon.contrib.nn.basic_layers",
                "gluon.contrib.rnn.conv_rnn_cell",
                "gluon.contrib.rnn.rnn_cell", zoo + "alexnet", zoo + "vgg",
                zoo + "squeezenet", zoo + "densenet", zoo + "inception",
                zoo + "mobilenet"):
        ref = importlib.import_module("mxnet_tpu." + mod)
        port = importlib.import_module("mxnet_tpu_torch." + mod)
        assert list(port.__all__) == list(ref.__all__), mod
        assert all(hasattr(port, n) for n in port.__all__), mod
    # the symbolic slice: __all__ wherever both packages define one, and
    # the package's names for the new modules
    for mod in ("symbol", "symbol.symbol", "module", "module.module",
                "module.base_module", "module.bucketing_module", "model",
                "callback", "name", "visualization", "test_utils",
                "predictor"):
        ref = importlib.import_module("mxnet_tpu." + mod)
        port = importlib.import_module("mxnet_tpu_torch." + mod)
        if hasattr(ref, "__all__") and hasattr(port, "__all__"):
            assert list(port.__all__) == list(ref.__all__), mod
        public = [n for n in vars(ref) if not n.startswith("_")
                  and getattr(getattr(ref, n), "__module__", "").startswith(
                      "mxnet_tpu." + mod)]
        assert [n for n in public if not hasattr(port, n)] == [], mod
    import mxnet_tpu_torch as mx

    for name, mod in (("sym", "symbol"), ("symbol", "symbol"),
                      ("mod", "module"), ("module", "module"),
                      ("model", "model"), ("callback", "callback"),
                      ("name", "name"), ("viz", "visualization"),
                      ("visualization", "visualization"),
                      ("test_utils", "test_utils"),
                      ("predictor", "predictor")):
        assert getattr(mx, name) is importlib.import_module(
            "mxnet_tpu_torch." + mod)
    assert mx.AttrScope is importlib.import_module(
        "mxnet_tpu_torch.name").AttrScope
    # the reference's gluon.parameter names, params_swapped included
    import mxnet_tpu.gluon.parameter as rparam
    import mxnet_tpu_torch.gluon.parameter as pparam

    assert set(rparam.__all__) <= set(pparam.__all__)
    # the C ABI's shim, the kvstore and the models: __all__ where both
    # define one, and every public function or class of the reference;
    # the tensor-parallel rules are by design not ported (one card)
    by_design = {"gpt_tp_rules", "llama_tp_rules"}
    for mod in ("capi_shim", "kvstore", "kvstore.kvstore",
                "kvstore.compression", "models"):
        ref = importlib.import_module("mxnet_tpu." + mod)
        port = importlib.import_module("mxnet_tpu_torch." + mod)
        if hasattr(ref, "__all__"):
            want = [n for n in ref.__all__ if n not in by_design]
            assert [n for n in want if n not in port.__all__] == [], mod
        public = [n for n, v in vars(ref).items() if not n.startswith("_")
                  and n not in by_design and callable(v)
                  and getattr(v, "__module__", "").startswith(
                      "mxnet_tpu." + mod)]
        assert [n for n in public if not hasattr(port, n)] == [], mod
    assert mx.kv is mx.kvstore is importlib.import_module(
        "mxnet_tpu_torch.kvstore")
    import mxnet_tpu_torch.models as pmodels
    assert pmodels.gpt2_774m is pmodels.gpt2_large


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("csrc/q8_matvec.cu", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False)
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build._nvcc()


# the reference's aliases that name ops of the op-corpus slice
CORPUS_ALIASES = [
    "_ravel_multi_index", "_unravel_index", "_contrib_index_array",
    "_contrib_arange_like", "_contrib_allclose", "softmax_cross_entropy_mask",
    "random_uniform", "random_normal", "random_gamma", "random_exponential",
    "random_poisson", "random_negative_binomial",
    "random_generalized_negative_binomial", "random_randint", "multinomial",
    "interp"]


def test_registry_matches_the_reference_but_sparse():
    """Every op the reference registers is registered by the port, the
    three ``ndarray/sparse.py`` ops included (the name keeps the slice
    before they were ported), but ``ring_attention`` (left out, in
    ``NOT_PORTED``); every alias of the reference resolves in the port's
    registry and ``mx.nd``."""
    import mxnet_tpu.ndarray  # noqa: F401  (registers every op)
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.ndarray  # noqa: F401
    from mxnet_tpu.ops.registry import OPS as ROPS
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES
    from mxnet_tpu_torch.ops.registry import NOT_PORTED, OPS, get_op

    missing = set(ROPS) - set(OPS)
    assert missing == {"ring_attention"}
    assert set(NOT_PORTED) == {"ring_attention"}
    sparse_ops = {"_sparse_rowsparse_dot", "_sparse_rowsparse_dot_t",
                  "_sparse_segment_dot"}
    assert all(OPS[n].fn.__module__ == "mxnet_tpu_torch.ndarray.sparse"
               for n in sparse_ops)
    assert set(OPS) <= set(ROPS)
    assert set(CORPUS_ALIASES) <= set(RALIASES)
    for alias, target in RALIASES.items():
        if target in missing:
            continue
        assert get_op(alias) is OPS[target], alias
        assert callable(getattr(mx.nd, alias)), alias
