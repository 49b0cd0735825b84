"""Shared helpers for the parity tests of the PyTorch port
(``tests/test_torch_*.py``): build a small GPT in the JAX package, carry
its weights into ``mxnet_tpu_torch`` through numpy, and hand both sides
the same seeded inputs.  Everything runs on the CPU in float32.

Tolerances (float32 on the CPU; the two sides sum in different orders):
kernels 1e-5 relative and absolute, logits 1e-4.
"""
import numpy as onp
import torch

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

# a sharper-than-default init: an untrained near-flat logit field makes
# greedy argmax a coin flip at 1-ulp noise, which is rounding-order
# sensitivity, not decoder behaviour (same choice as
# tests/test_decode_fused.py)
SMALL = dict(vocab_size=97, max_length=64, num_layers=2, units=32,
             num_heads=4, hidden_size=64)


def jax_gpt(init=0.15, **over):
    import mxnet_tpu as mx
    from mxnet_tpu.models import GPT, GPTConfig

    mx.random.seed(0)
    net = GPT(GPTConfig(**{**SMALL, **over}))
    net.initialize(mx.init.Normal(init))
    return net


def port_gpt(net):
    """The port's GPT holding ``net``'s weights, on the CPU."""
    from mxnet_tpu_torch.models import GPTConfig, gpt_from_mxnet_tpu

    c = net._cfg
    cfg = GPTConfig(vocab_size=c.vocab_size, max_length=c.max_length,
                    num_layers=c.num_layers, units=c.units,
                    num_heads=c.num_heads, hidden_size=c.hidden_size)
    arrays = {k: onp.asarray(p.data().asnumpy())
              for k, p in net.collect_params().items()}
    return gpt_from_mxnet_tpu(cfg, arrays, device="cpu")


def rand(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).standard_normal(shape)
            * scale).astype(onp.float32)


def t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


class LazyReference:
    """``mxnet_tpu`` imported at first use, so a test file that holds the
    port against it can also hold ``cuda``-marked tests that run on the
    card's machine, which has no JAX."""

    def __getattr__(self, name):
        import mxnet_tpu

        return getattr(mxnet_tpu, name)


def need_cuda():
    """Skip unless a card is present — decided inside the test, never at
    import or collection time."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py "
                    "or pytest -m cuda there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# llama_tiny widths with grouped-query attention (4 heads, 2 KV heads)
LLAMA_SMALL = dict(vocab_size=97, max_length=64, num_layers=2, units=64,
                   num_heads=4, num_kv_heads=2, hidden_size=128)


def jax_llama(init=0.15, **over):
    import mxnet_tpu as mx
    from mxnet_tpu.models import Llama, LlamaConfig

    mx.random.seed(0)
    net = Llama(LlamaConfig(**{**LLAMA_SMALL, **over}))
    net.initialize(mx.init.Normal(init))
    # materialize the deferred parameters with one forward
    net(mx.nd.array(onp.zeros((1, 2)), dtype="int32"))
    return net


def port_llama(net, dtype=None):
    """The port's Llama holding ``net``'s weights, on the CPU."""
    from mxnet_tpu_torch.models import LlamaConfig, llama_from_mxnet_tpu

    c = net._cfg
    cfg = LlamaConfig(vocab_size=c.vocab_size, max_length=c.max_length,
                      num_layers=c.num_layers, units=c.units,
                      num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                      hidden_size=c.hidden_size, rope_base=c.rope_base)
    arrays = {k: onp.asarray(p.data().asnumpy(), onp.float32)
              for k, p in net.collect_params().items()}
    return llama_from_mxnet_tpu(cfg, arrays, device="cpu", dtype=dtype)
