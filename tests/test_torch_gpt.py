"""A full GPT forward in the PyTorch port against the JAX package, with
the weights carried over by ``gpt_from_mxnet_tpu`` (float32 on the CPU,
logits within 1e-4)."""
import numpy as onp
import pytest
import torch

from _torch_parity import LOGIT_TOL, jax_gpt, port_gpt
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(scope="module")
def pair():
    net = jax_gpt()
    return net, port_gpt(net)


@pytest.mark.parametrize("B,L", [(1, 7), (2, 33)])
def test_forward_matches_jax(pair, B, L):
    import mxnet_tpu as mx

    net, model = pair
    toks = onp.random.RandomState(L).randint(0, 97, (B, L))
    ref = net(mx.nd.array(toks, dtype="int32")).asnumpy()
    got = model(torch.as_tensor(toks))
    assert got.shape == (B, L, 97)
    onp.testing.assert_allclose(got.detach().numpy(), ref, **LOGIT_TOL)


def test_convert_carries_every_parameter(pair):
    net, model = pair
    for name, p in net.collect_params().items():
        assert name.startswith("gpt")
    n_ref = sum(int(onp.prod(p.shape)) for p in
                net.collect_params().values())
    assert n_ref == sum(p.numel() for p in model.parameters())
    wq = net.collect_params()
    key = next(k for k in wq if k.endswith("h1_attn_qkv_weight"))
    onp.testing.assert_array_equal(
        model.blocks[1].attn.qkv.weight.detach().numpy(),
        wq[key].data().asnumpy())


def test_convert_rejects_unknown_and_missing(pair):
    from mxnet_tpu_torch.models import gpt_from_mxnet_tpu

    net, model = pair
    arrays = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    with pytest.raises(MXNetError, match="no port parameter"):
        gpt_from_mxnet_tpu(model._cfg, {**arrays, "gpt0_h0_foo_weight":
                                        onp.zeros(1)}, device="cpu")
    arrays.pop(next(k for k in arrays if k.endswith("lnf_beta")))
    with pytest.raises(MXNetError, match="lack"):
        gpt_from_mxnet_tpu(model._cfg, arrays, device="cpu")
