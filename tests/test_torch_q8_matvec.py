"""Kernel K4 (int8 matvec) of the PyTorch port against the JAX package:
the port's plain version vs ``mxnet_tpu.ops.q8_matvec`` — the Pallas
kernel in interpret mode where the shape tiles, and its einsum path —
in float32 at tolerance 1e-5.  The CUDA kernel itself is held against the
plain version on the card (``cuda`` marker; skipped without one)."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, need_cuda, rand, t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.q8_matvec import q8_matvec, q8_matvec_plain

CASES = [(1, 64, 128, False), (3, 96, 256, True), (8, 64, 200, True),
         (9, 32, 384, False)]


def _inputs(B, K, O, bias):
    rs = onp.random.RandomState(B * 1000 + O)
    x = rand(B + K, B, K)
    wt = rs.randint(-127, 128, (K, O)).astype(onp.int8)
    s = (rs.rand(O).astype(onp.float32) + 0.5) / 127.0
    b = rand(O, O) if bias else None
    return x, wt, s, b


def _jax(x, wt, s, b):
    import jax.numpy as jnp
    from mxnet_tpu.ops.q8_matvec import q8_matvec as jq8

    return onp.asarray(jq8(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(s),
                           None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "einsum"])
@pytest.mark.parametrize("B,K,O,bias", CASES)
def test_plain_matches_jax(monkeypatch, interpret, B, K, O, bias):
    if interpret:
        monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    else:
        monkeypatch.delenv("MXNET_FLASH_INTERPRET", raising=False)
    x, wt, s, b = _inputs(B, K, O, bias)
    ref = _jax(x, wt, s, b)
    before = q8_matvec.launches
    got = q8_matvec(t(x), t(wt), t(s), None if b is None else t(b))
    assert got.dtype == torch.float32 and got.shape == (B, O)
    onp.testing.assert_allclose(got.numpy(), ref, **KERNEL_TOL)
    assert q8_matvec.launches == before       # CPU never counts a launch


@pytest.mark.parametrize("bad", ["x_dtype", "w_dtype", "s_shape", "k_dim",
                                 "noncontig"])
def test_wrapper_rejects(bad):
    x, wt, s, b = (t(a) for a in _inputs(2, 32, 128, True))
    if bad == "x_dtype":
        x = x.double()
    elif bad == "w_dtype":
        wt = wt.float()
    elif bad == "s_shape":
        s = s[:64]
    elif bad == "k_dim":
        x = x[:, :16]
    else:
        wt = wt.t().contiguous().t()
    with pytest.raises(MXNetError):
        q8_matvec(x, wt, s, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    need_cuda()
    x, wt, s, b = (t(a).cuda() for a in _inputs(9, 768, 2304, True))
    x = x.to(dtype)
    before = q8_matvec.launches
    got = q8_matvec(x, wt, s, b)
    torch.cuda.synchronize()
    assert q8_matvec.launches == before + 1
    ref = q8_matvec_plain(x, wt, s, b)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)
