"""Kernel K1 (flash-attention forward) and the attention ops of the
PyTorch port against the JAX package, float32 on the CPU.

- the plain K1 vs ``mxnet_tpu.ops.attention._pallas_fwd`` in Pallas
  interpret mode — causal, key mask, dropout — on out AND lse (1e-5);
- the dropout position hash bit for bit;
- ``_plain_attn``, ``rope`` and the ``flash_attention`` op (whose long
  rows take K1 in the port and the blockwise scan in JAX), in inference
  and with ``training=True``;
- fp16 (amp's float16 target) past 512² scores: the plain K1 vs
  ``_pallas_fwd`` on fp16 inputs, and the ``flash_attention`` op, within
  one fp16 rounding of the output (``FP16_TOL``: 2^-10 relative and of
  the largest magnitude), lse within 1e-5;
- the CUDA kernel vs its plain version on the card (``cuda`` marker)."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, need_cuda, rand, t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as pa


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _qkv(B, H, L, Lk, D, seed=0):
    return (rand(seed, B, H, L, D), rand(seed + 1, B, H, Lk, D),
            rand(seed + 2, B, H, Lk, D))


def _kmask(Nb, Lk, seed):
    m = onp.zeros((Nb, 1, Lk), onp.float32)
    rs = onp.random.RandomState(seed)
    for b in range(Nb):
        m[b, 0, Lk - rs.randint(1, Lk // 2):] = -1e30
    m[0, 0, 3] = -2.5                       # a finite bias entry too
    return m


# one fp16 rounding of an output both packages compute in f32
FP16_REL = 2.0 ** -10


def _fp16_close(got, ref):
    ref = onp.asarray(ref).astype(onp.float32)
    onp.testing.assert_allclose(
        onp.asarray(got).astype(onp.float32), ref, rtol=FP16_REL,
        atol=FP16_REL * float(onp.abs(ref).max()))


FWD_CASES = {
    "causal": dict(B=1, H=2, L=256, D=16, causal=True),
    "kmask_batch": dict(B=2, H=2, L=128, D=16, causal=False, Nb=2),
    "kmask_causal_bcast": dict(B=2, H=1, L=128, D=32, causal=True, Nb=1),
    "dropout": dict(B=1, H=2, L=128, D=16, causal=True, dropout=0.25,
                    seed=12345),
    # 640² scores, past the plain path's 512²
    "fp16_causal_dropout": dict(B=1, H=2, L=640, D=16, causal=True,
                                dropout=0.1, seed=5, dtype="float16"),
    "fp16_kmask": dict(B=2, H=1, L=640, D=16, causal=False, Nb=2,
                       dtype="float16"),
}


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_plain_k1_matches_pallas_fwd(interpret, name):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _pallas_fwd

    c = FWD_CASES[name]
    q, k, v = (a.astype(c.get("dtype", "float32"))
               for a in _qkv(c["B"], c["H"], c["L"], c["L"], c["D"]))
    km = _kmask(c["Nb"], c["L"], 7) if "Nb" in c else None
    scale = 1.0 / c["D"] ** 0.5
    rate, seed = c.get("dropout", 0.0), c.get("seed", 0)
    ro, rl = _pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale, c["causal"],
                         kmask=None if km is None else jnp.asarray(km),
                         seed=seed, dropout=rate)
    before = pa.flash_fwd.launches
    out, lse = pa.flash_fwd(t(q), t(k), t(v), scale, c["causal"],
                            None if km is None else t(km), seed, rate)
    assert pa.flash_fwd.launches == before
    assert lse.shape == (c["B"], c["H"], c["L"])
    assert out.numpy().dtype == onp.asarray(ro).dtype == q.dtype
    if q.dtype == onp.float16:
        _fp16_close(out.numpy(), ro)
    else:
        onp.testing.assert_allclose(out.numpy(), onp.asarray(ro),
                                    **KERNEL_TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(rl), **KERNEL_TOL)


def test_hash_bits_bit_exact():
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _hash_bits, _keep

    rs = onp.random.RandomState(0)
    bh = rs.randint(0, 2 ** 31 - 1, (5, 1, 1), dtype=onp.int64)
    qp = rs.randint(0, 70000, (1, 7, 1), dtype=onp.int64)
    kp = rs.randint(0, 70000, (1, 1, 9), dtype=onp.int64)
    for seed in (0, 1, 0xDEADBEEF, 2 ** 32 - 1):
        ref = onp.asarray(_hash_bits(jnp.uint32(seed), jnp.asarray(bh),
                                     jnp.asarray(qp), jnp.asarray(kp)))
        got = pa._hash_bits(seed, t(bh), t(qp), t(kp)).numpy()
        onp.testing.assert_array_equal(got, ref.astype(onp.int64))
        keep = onp.asarray(_keep(jnp.uint32(seed), jnp.asarray(bh),
                                 jnp.asarray(qp), jnp.asarray(kp), 0.3))
        onp.testing.assert_array_equal(
            pa._keep(seed, t(bh), t(qp), t(kp), 0.3).numpy(), keep)


@pytest.mark.parametrize("causal,bias,dropout",
                         [(True, None, 0.0), (False, "kmask", 0.0),
                          (False, "dense", 0.0), (True, None, 0.2)])
def test_plain_attn_matches_jax(causal, bias, dropout):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _plain_attn

    q, k, v = _qkv(2, 3, 40, 40, 16, seed=3)
    b = None
    if bias == "kmask":
        b = _kmask(2, 40, 1).reshape(2, 1, 1, 40)
    elif bias == "dense":
        b = rand(9, 1, 3, 40, 40)
    ref = _plain_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      None if b is None else jnp.asarray(b), 0.25, causal,
                      dropout=dropout, seed=jnp.uint32(77))
    got = pa._plain_attn(t(q), t(k), t(v), None if b is None else t(b),
                         0.25, causal, dropout=dropout, seed=77)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **KERNEL_TOL)


@pytest.mark.parametrize("offset", ["scalar", "vector"])
def test_rope_matches_jax(offset):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import rope

    x = rand(4, 3, 2, 5, 8)
    off = 7 if offset == "scalar" else onp.array([0, 3, 11], onp.int32)
    ref = rope.__wrapped__(jnp.asarray(x), base=500.0,
                           position_offset=jnp.asarray(off))
    got = pa.rope(t(x), base=500.0, position_offset=torch.as_tensor(off))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **KERNEL_TOL)


@pytest.mark.parametrize("L,masked", [(40, False), (600, False),
                                      (600, True)])
def test_flash_attention_op_matches_jax(L, masked):
    """Short rows take the plain path on both sides; long rows take K1 in
    the port (its plain version here) and the blockwise scan in JAX."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import flash_attention as jfa

    q, k, v = _qkv(1, 2, L, L, 16, seed=5)
    b = _kmask(1, L, 2).reshape(1, 1, 1, L) if masked else None
    ref = jfa.__wrapped__(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if b is None else jnp.asarray(b),
                          causal=True, training=False)
    got = pa.flash_attention(t(q), t(k), t(v), None if b is None else t(b),
                             causal=True)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **KERNEL_TOL)


def test_flash_attention_fp16_past_512_squared():
    """Causal q = k = v of (1, 1, 1024, 8) in fp16: the reference's op
    returns fp16 (its Pallas gate has no dtype clause); the port's, which
    refused fp16 there, now takes ``_FlashAttention`` and agrees within
    one fp16 rounding."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import flash_attention as jfa

    x = rand(11, 1, 1, 1024, 8).astype(onp.float16)
    ref = jfa.__wrapped__(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                          None, causal=True, training=False)
    got = pa.flash_attention(t(x), t(x), t(x), causal=True)
    assert got.dtype == torch.float16 and got.shape == (1, 1, 1024, 8)
    _fp16_close(got.numpy(), ref)


def test_training_raises():
    """``training=True`` no longer raises: without dropout it returns the
    inference forward's value, on the plain path and the kernel path."""
    for L in (8, 600):
        q, k, v = (t(a) for a in _qkv(1, 2, L, L, 8))
        got = pa.flash_attention(q, k, v, causal=True, training=True)
        ref = pa.flash_attention(q, k, v, causal=True, training=False)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (t(a) for a in _qkv(1, 2, 16, 16, 8))
    with pytest.raises(MXNetError):
        pa.flash_fwd(q, k.double(), v, 0.3, True)
    with pytest.raises(MXNetError):
        pa.flash_fwd(q, k[:, :1], v, 0.3, True)
    with pytest.raises(MXNetError):
        pa.flash_fwd(q, k, v, 0.3, True, kmask=torch.zeros(1, 1, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("L,Lk,D,causal,masked,rate",
                         [(1024, 1024, 64, True, False, 0.0),
                          (300, 333, 40, False, True, 0.1),
                          (129, 129, 128, True, True, 0.0),
                          (257, 257, 32, True, False, 0.0),
                          (200, 201, 96, False, True, 0.1),
                          (77, 77, 64, True, True, 0.0)])
def test_kernel_matches_plain_on_card(dtype, L, Lk, D, causal, masked,
                                      rate):
    need_cuda()
    q, k, v = (t(a).cuda().to(dtype) for a in _qkv(2, 3, L, Lk, D))
    km = t(_kmask(2, Lk, 4)).cuda() if masked else None
    before = pa.flash_fwd.launches
    out, lse = pa.flash_fwd(q, k, v, D ** -0.5, causal, km, 99, rate)
    torch.cuda.synchronize()
    assert pa.flash_fwd.launches == before + 1
    ro, rl = pa.flash_fwd_plain(q, k, v, D ** -0.5, causal, km, 99, rate)
    tol = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float16: dict(rtol=2e-3, atol=2e-3)}.get(
        dtype, dict(rtol=1e-4, atol=1e-4))
    torch.testing.assert_close(out.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
