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
from mxnet_tpu_torch.ops.q8_matvec import plan, q8_matvec, q8_matvec_plain

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


# (K, O): GPT-2 small's qkv, proj, fc1, fc2 and an odd O; a K that no
# split divides (1000 rows in splits of 8+); the head's width at 768
CARD_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
               (768, 200), (1000, 3072), (768, 50304)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,O", CARD_SHAPES)
@pytest.mark.parametrize("B", [1, 4, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype, B, K, O):
    need_cuda()
    x, wt, s, b = (t(a).cuda() for a in _inputs(B, K, O, True))
    x = x.to(dtype)
    before = q8_matvec.launches
    got = q8_matvec(x, wt, s, b)
    torch.cuda.synchronize()
    assert q8_matvec.launches == before + 1
    ref = q8_matvec_plain(x, wt, s, b)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("K,O", [(768, 768), (3072, 768), (768, 200),
                                 (4096, 11008)])
@pytest.mark.parametrize("B", [1, 8, 9])
def test_kernel_repeats_bit_for_bit_on_card(B, K, O):
    """Two launches agree exactly: the K splits' partials are summed in
    split order, whichever block finishes last."""
    need_cuda()
    x, wt, s, b = (None if a is None else t(a).cuda()
                   for a in _inputs(B, K, O, B % 2 == 1))
    x = x.bfloat16()
    first = q8_matvec(x, wt, s, b)
    for _ in range(3):
        assert torch.equal(q8_matvec(x, wt, s, b), first)


# --------------------------------------------------------------------------- #
# the launch plan (CPU)
# --------------------------------------------------------------------------- #

def _block_work(block, blocks, units, K):
    """Block ``block``'s ``(unit, k0, k1)``, as ``block_work`` and the
    slice bounds of ``csrc/q8_matvec.cu`` give it: slice ``j = block //
    units`` of unit ``block % units``; slice j of ``n = blocks // units``
    holds the 16-row steps ``[j * S // n, (j + 1) * S // n)`` of the ``S =
    ceil(K / 16)`` steps of K."""
    u, j, n = block % units, block // units, blocks // units
    steps = -(-K // 16)
    return (u, min(K, 16 * (j * steps // n)),
            min(K, 16 * ((j + 1) * steps // n)))


def _owners(B, K, O):
    """How often the plan's blocks own each (batch row, K row, column),
    mapping blocks to units and K rows as the kernel does."""
    rows, blocks, slices = plan(B, K, O)
    ctiles = -(-O // 128)
    units = ctiles * -(-B // rows)
    assert blocks == units * slices
    own = onp.zeros((B, K, O), onp.int32)
    for blk in range(blocks):
        u, k0, k1 = _block_work(blk, blocks, units, K)
        assert k0 < k1                            # no slice without rows
        assert k0 % 16 == 0                       # slices start on steps
        assert (k1 - k0) * rows <= 8192           # its x slice fits
        tile, b0 = u % ctiles, u // ctiles * rows
        own[b0:b0 + rows, k0:k1, tile * 128:(tile + 1) * 128] += 1
    return own, rows, blocks, units


GPT2 = [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 50304)]
LLAMA = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("B", list(range(1, 10)))
@pytest.mark.parametrize("K,O", GPT2 + [(1000, 200), (37, 3000),
                                        (3001, 129), (5, 17)])
def test_plan_covers_each_output_once(B, K, O):
    own, rows, blocks, units = _owners(B, K, O)
    assert (own == 1).all()                      # slices cover K exactly
    assert rows == next(r for r in (1, 2, 4, 8) if r >= min(B, 8))
    # a block on every SM wherever K has a 16-row step a slice
    assert blocks >= min(132, units * -(-K // 16))


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("K,O", GPT2 + LLAMA)
def test_plan_fills_the_card_at_main_path_shapes(B, K, O):
    rows, blocks, slices = plan(B, K, O)
    units = -(-O // 128) * -(-B // rows)
    assert blocks == units * slices >= 132                  # every SM
    # no slice more than the card or the x slice asks for
    assert slices == 1 or units * (slices - 1) < 132 or \
        16 * -(-(-(-K // 16)) // (slices - 1)) * rows > 8192


def test_plan_of_a_small_card():
    rows, blocks, slices = plan(8, 768, 768, sms=16)
    assert (rows, blocks, slices) == (8, 18, 3)
