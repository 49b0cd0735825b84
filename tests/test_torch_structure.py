"""Structure of the PyTorch port: it imports neither JAX, the JAX
package nor ``ml_dtypes`` (the card's machine has none), its entry
points refuse to run on a host without CUDA unless
asked for the CPU, and its kernels are built for sm_90a."""
import ast
import pathlib

import pytest
import torch

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "decode_ab.py", REPO / "rtc_ab.py",
     REPO / "resnet_ab.py", REPO / "tests" / "_torch_rtc_sources.py"]
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
    assert resolve_device("cpu").type == "cpu"
    assert mx.nd.zeros((2,), ctx=mx.cpu()).context == mx.cpu()


def test_new_modules_are_covered():
    """The structure checks above reach the fused decode, the vision,
    the imperative and the fused-train-step slices' modules and kernel
    sources."""
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
    assert {"decode_fused", "conv1x1_bwd"} <= set(_build.KERNELS)


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
