"""The Llama family of the PyTorch port against the JAX package, f32 at
llama_tiny widths with grouped-query attention (4 heads, 2 KV heads):
``rms_norm`` against the reference op (1e-5), the forward logits
(1e-4), the weight map both ways, the batched prefill, and the unfused
``kv_generate`` (native and int8, batched and scan prefill) token for
token against the reference's ``stacked="off"`` arm."""
import numpy as onp
import pytest
import torch

from _torch_parity import (KERNEL_TOL, LOGIT_TOL, jax_llama, port_llama,
                           rand, t)
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(scope="module")
def pair():
    net = jax_llama()
    return net, port_llama(net)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import RMSNorm
    from mxnet_tpu_torch.ops.nn import rms_norm

    x = rand(1, 3, 5, 64, scale=2.0) + 0.3
    g = rand(2, 64) + 1.0
    jdt = getattr(jnp, dtype)
    ref = onp.asarray(RMSNorm(jnp.asarray(x, jdt), jnp.asarray(g, jdt),
                              eps=1e-6).astype(jnp.float32))
    got = rms_norm(t(x).to(getattr(torch, dtype)),
                   t(g).to(getattr(torch, dtype)), 1e-6).float().numpy()
    # bf16: both round one f32 value, so they agree to f32 noise
    onp.testing.assert_allclose(got, ref, **KERNEL_TOL)


def test_forward_logits_match_reference(pair):
    import mxnet_tpu as mx

    net, model = pair
    toks = onp.random.RandomState(0).randint(0, 97, (2, 9))
    ref = net(mx.nd.array(toks, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = model(torch.as_tensor(toks)).numpy()
    onp.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_weight_map_round_trips(pair):
    from mxnet_tpu_torch.models import arrays_from_port

    net, model = pair
    ref = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    # the reference names its blocks by a process-wide counter, so the
    # prefix depends on the Llama nets made before in this process
    got = arrays_from_port(model, prefix=net.prefix)
    assert sorted(got) == sorted(ref)
    for k in ref:
        onp.testing.assert_array_equal(got[k], ref[k])


def test_prefill_logits_match_forward(pair):
    import mxnet_tpu as mx
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    net, model = pair
    toks = onp.random.RandomState(2).randint(0, 97, (3, 12))
    last = onp.array([11, 4, 0])
    full = net(mx.nd.array(toks, dtype="int32")).asnumpy()
    logits, k, v = _DecodeEngine(model).prefill(torch.as_tensor(toks),
                                                torch.as_tensor(last))
    assert k.shape == (2, 3, 2, 12, 16) and v.shape == k.shape
    onp.testing.assert_allclose(logits.numpy(), full[onp.arange(3), last],
                                **LOGIT_TOL)


@pytest.mark.parametrize("prefill", ["batched", "scan"])
@pytest.mark.parametrize("weights", ["native", "int8"])
def test_unfused_kv_generate_token_identical(pair, weights, prefill):
    from mxnet_tpu.models import kv_generate as jgen
    from mxnet_tpu_torch.models import kv_generate

    net, model = pair
    prompt = onp.random.RandomState(1).randint(0, 97, (2, 6))
    kw = dict(max_new_tokens=8, temperature=0.0, weights=weights,
              prefill=prefill)
    ref = jgen(net, prompt, stacked="off", **kw)
    got = kv_generate(model, prompt, stacked="off", **kw)
    onp.testing.assert_array_equal(got, ref)


def test_sampled_stream_same_in_both_prefill_modes(pair):
    from mxnet_tpu_torch.models import kv_generate

    _, model = pair
    prompt = onp.random.RandomState(5).randint(0, 97, (1, 4))
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=8, seed=3)
    a = kv_generate(model, prompt, prefill="batched", **kw)
    b = kv_generate(model, prompt, prefill="scan", **kw)
    onp.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < 97)).all()


def test_bad_arguments_raise(pair):
    from mxnet_tpu_torch.models import kv_generate

    _, model = pair
    for kw in (dict(prefill="nope"), dict(fused="yes"),
               dict(stacked="maybe"), dict(weights="int4")):
        with pytest.raises(ValueError):
            kv_generate(model, onp.zeros((1, 3), onp.int64), 2, **kw)


def test_decode_server_refuses_llama(pair):
    """Since the fourteenth slice the server takes Llama (its greedy
    stream equals ``kv_generate``'s; tests/test_torch_serve_paged.py holds
    the rest against the JAX server); what it still refuses for Llama, as
    for GPT, is a later slice's feature."""
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    model = pair[1]
    with pytest.raises(MXNetError, match="not ported yet"):
        DecodeServer(model, step_timeout=5.0, autostart=False)
    srv = DecodeServer(model, max_total_len=32, pool_sizes=(1,),
                       autostart=False)
    p = onp.random.RandomState(3).randint(0, 97, (6,))
    s = srv.submit(p, max_new_tokens=4)
    while srv.pump():
        pass
    srv.close()
    assert s.tokens(5) == list(kv_generate(model, p[None], 4,
                                           temperature=0.0)[0, 6:])


def test_rope_matches_reference_at_row_offsets():
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import rope as jrope
    from mxnet_tpu_torch.ops.attention import rope

    x = rand(7, 3, 2, 1, 16)
    pos = onp.array([0, 5, 63])
    ref = onp.asarray(jrope(jnp.asarray(x), position_offset=jnp.asarray(pos)))
    got = rope(t(x), position_offset=torch.as_tensor(pos)).numpy()
    onp.testing.assert_allclose(got, ref, **KERNEL_TOL)
