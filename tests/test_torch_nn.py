"""The PyTorch port's thin nn ops (``mxnet_tpu_torch/ops/nn.py``) against
the JAX package's ``Activation``, ``LayerNorm`` and ``FullyConnected``
in float32 at tolerance 1e-5 — in particular ``gelu`` is the tanh
approximation on both sides and ``erf_gelu`` the exact form."""
import numpy as onp
import pytest

from _torch_parity import KERNEL_TOL, rand, t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as pnn

ACTS = ["relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
        "mish", "gelu", "erf_gelu", "swish"]


def _np(a):
    return onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)


@pytest.mark.parametrize("act_type", ACTS)
def test_activation_matches_jax(act_type):
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import Activation

    x = rand(1, 4, 33, scale=3.0)
    ref = _np(Activation(jnp.asarray(x), act_type=act_type))
    onp.testing.assert_allclose(pnn.activation(t(x), act_type).numpy(), ref,
                                **KERNEL_TOL)


def test_activation_rejects_unknown():
    with pytest.raises(MXNetError, match="unknown act_type"):
        pnn.activation(t(rand(0, 2)), "nope")


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_and_fully_connected_match_jax(bias):
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import FullyConnected, LayerNorm

    x = rand(2, 3, 5, 24, scale=2.0) + 0.5
    gamma, beta = rand(3, 24) + 1.0, rand(4, 24)
    w, b = rand(5, 16, 24), rand(6, 16) if bias else None
    ref = _np(LayerNorm(jnp.asarray(x), jnp.asarray(gamma),
                        jnp.asarray(beta), eps=1e-5))
    got = pnn.layer_norm(t(x), t(gamma), t(beta), 1e-5)
    onp.testing.assert_allclose(got.numpy(), ref, **KERNEL_TOL)
    ref = _np(FullyConnected(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b),
                             num_hidden=16, no_bias=not bias, flatten=False))
    got = pnn.fully_connected(t(x), t(w), None if b is None else t(b))
    onp.testing.assert_allclose(got.numpy(), ref, **KERNEL_TOL)
