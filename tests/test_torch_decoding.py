"""KV-cache decoding in the PyTorch port against the JAX package: greedy
``kv_generate`` is token-identical for native and int8 weights, and the
int8 quantization gives the same codes and scales."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, jax_gpt, port_gpt, rand, t


@pytest.fixture(scope="module")
def pair():
    net = jax_gpt()
    return net, port_gpt(net)


@pytest.mark.parametrize("weights", ["native", "int8"])
def test_greedy_kv_generate_token_identical(pair, weights):
    from mxnet_tpu.models import kv_generate as jgen
    from mxnet_tpu_torch.models import kv_generate

    net, model = pair
    prompt = onp.random.RandomState(1).randint(0, 97, (2, 6))
    ref = jgen(net, prompt, max_new_tokens=10, temperature=0.0,
               weights=weights)
    got = kv_generate(model, prompt, max_new_tokens=10, temperature=0.0,
                      weights=weights)
    onp.testing.assert_array_equal(got, ref)


def test_quantize_rows_and_head_match_jax():
    import jax.numpy as jnp
    from mxnet_tpu.models.decoding import _quantize_head as jqh
    from mxnet_tpu_torch.models.decoding import _quantize_head

    w = rand(3, 97, 32, scale=0.2)
    b = rand(4, 97)
    rq, rs, rb = jqh(jnp.asarray(w), jnp.asarray(b))
    q, s, bb = _quantize_head(t(w), t(b))
    assert q.dtype == torch.int8 and q.shape == (32, 128)
    onp.testing.assert_array_equal(q.numpy(), onp.asarray(rq))
    onp.testing.assert_array_equal(s.numpy(), onp.asarray(rs))
    onp.testing.assert_allclose(bb.numpy(), onp.asarray(rb), **KERNEL_TOL)


def test_prefill_logits_match_jax_forward(pair):
    """Ragged last-index gather of the batched prefill: each row's logits
    equal the full forward's logits at its own last real token."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    net, model = pair
    toks = onp.random.RandomState(2).randint(0, 97, (3, 12))
    last = onp.array([11, 4, 0])
    full = net(mx.nd.array(toks, dtype="int32")).asnumpy()
    logits, k, v = _DecodeEngine(model).prefill(torch.as_tensor(toks),
                                                torch.as_tensor(last))
    assert k.shape == (2, 3, 4, 12, 8) and v.shape == k.shape
    onp.testing.assert_allclose(logits.numpy(), full[onp.arange(3), last],
                                rtol=1e-4, atol=1e-4)


def test_int8_cache_rebuilds_after_weight_update(pair):
    from mxnet_tpu_torch.models.decoding import _q8_weights

    _, model = pair
    first = _q8_weights(model)
    assert _q8_weights(model) is first
    w = model.blocks[0].attn.qkv.weight
    with torch.no_grad():
        w.mul_(2.0)
    try:
        assert _q8_weights(model) is not first
    finally:
        with torch.no_grad():
            w.div_(2.0)
