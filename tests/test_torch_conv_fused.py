"""Kernel K6 (the fused 1x1-convolution backward) of the PyTorch port
against the JAX package.

- The port's plain version against ``_conv1x1_bwd_pair`` (the Pallas
  kernel in interpret mode) at the reference test's shapes and a
  ResNet-like one: float32 within 1e-5 (only the order of the P sums
  differs), bf16 within the reference test's own tolerances.
- ``conv1x1_nhwc`` (forward and gradients) against ``jax.vjp`` of the
  reference's ``conv1x1_nhwc``, float32, 1e-5.
- The gate: the port admits every configuration the reference admits;
  the reference's tile/VMEM clause is the only other difference.
- The launch plan covers P: in f32 its tile fits a block's shared
  memory; in bf16 its split-K grid fills an H100.
- On the card (``cuda`` marker; skipped without one): the kernel against
  its plain version at ResNet-50's nine stride-1 1x1 shapes (batch 128)
  and at ragged shapes, with dx and dW bit for bit across two launches,
  and across three at stage 4's split-K shape.
"""
import itertools

import numpy as onp
import pytest
import torch

from _torch_parity import need_cuda, t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import conv_fused as pc

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# (N, H, W, Ci, Co): the reference test's shapes, then ResNet-like ones
SHAPES = [(2, 8, 8, 64, 256), (1, 4, 4, 128, 32), (4, 8, 8, 256, 64),
          (2, 14, 14, 256, 1024), (2, 8, 8, 512, 2048)]
# ResNet-50's stride-1 1x1 convolutions: (spatial, Ci, Co); the eight of
# the reference's test, and stage 1's first conv1
RESNET50 = [(56, 64, 256), (56, 256, 64), (28, 128, 512), (28, 512, 128),
            (14, 256, 1024), (14, 1024, 256), (7, 512, 2048),
            (7, 2048, 512), (56, 64, 64)]


@pytest.fixture(autouse=True)
def _interpret_and_switch(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")
    monkeypatch.setenv("MXNET_FUSED_CONV_BWD", "1")


def _inputs(n, h, w, ci, co, seed=0):
    rs = onp.random.RandomState(seed)
    return (rs.randn(n, h, w, ci).astype(onp.float32),
            (rs.randn(co, ci, 1, 1) * 0.05).astype(onp.float32),
            rs.randn(n, h, w, co).astype(onp.float32))


def _jax_pair(dy2, x2, w2, dtype):
    import jax.numpy as jnp
    from mxnet_tpu.ops.conv_fused import _conv1x1_bwd_pair, _pick_tile

    p, co = dy2.shape
    tp = _pick_tile(p, x2.shape[1], co, jnp.dtype(dtype).itemsize)
    assert tp > 0
    dx, dw = _conv1x1_bwd_pair(jnp.asarray(dy2, dtype), jnp.asarray(x2, dtype),
                               jnp.asarray(w2, dtype), tp)
    return onp.asarray(dx, onp.float32), onp.asarray(dw, onp.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_f32(shape):
    n, h, w, ci, co = shape
    x, wt, dy = _inputs(*shape)
    p = n * h * w
    x2, w2, dy2 = x.reshape(p, ci), wt.reshape(co, ci), dy.reshape(p, co)
    rdx, rdw = _jax_pair(dy2, x2, w2, "float32")
    before = pc.conv1x1_bwd_pair.launches
    dx, dw = pc.conv1x1_bwd_pair(t(dy2), t(x2), t(w2))
    assert pc.conv1x1_bwd_pair.launches == before   # CPU: the plain version
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    onp.testing.assert_allclose(dx.numpy(), rdx, **F32_TOL)
    onp.testing.assert_allclose(dw.numpy(), rdw,
                                rtol=1e-5, atol=1e-5 * onp.abs(rdw).max())


def test_plain_matches_pallas_bf16():
    """The reference test's bf16 case and tolerances
    (``tests/test_conv_fused.py::test_bf16_grads_close``): dx rounded once
    to bf16, dW in f32."""
    rs = onp.random.RandomState(1)
    x = rs.randn(2 * 8 * 8, 64).astype(onp.float32)
    w = (rs.randn(128, 64) * 0.05).astype(onp.float32)
    dy = rs.randn(2 * 8 * 8, 128).astype(onp.float32)
    rdx, rdw = _jax_pair(dy, x, w, "bfloat16")
    bf = [t(a).bfloat16() for a in (dy, x, w)]
    dx, dw = pc.conv1x1_bwd_pair(*bf)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    onp.testing.assert_allclose(dx.float().numpy(), rdx, rtol=2e-2,
                                atol=1e-2)
    onp.testing.assert_allclose(dw.numpy(), rdw, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_conv1x1_nhwc_grads_match_jax(shape):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.conv_fused import conv1x1_nhwc as jconv

    x, w, dy = _inputs(*shape, seed=2)
    ry, vjp = jax.vjp(jconv, jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(dy))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = pc.conv1x1_nhwc(xt, wt)
    y.backward(t(dy))
    onp.testing.assert_allclose(y.detach().numpy(), onp.asarray(ry),
                                **F32_TOL)
    onp.testing.assert_allclose(xt.grad.numpy(), onp.asarray(rdx),
                                **F32_TOL)
    rdw = onp.asarray(rdw)
    assert wt.grad.dtype == wt.dtype and wt.grad.shape == wt.shape
    onp.testing.assert_allclose(wt.grad.numpy(), rdw, rtol=1e-5,
                                atol=1e-5 * onp.abs(rdw).max())


def _gate_cases():
    shapes = [(2, 8, 8, 64), (2, 7, 7, 256), (1, 4, 4, 128), (3, 5, 5, 16),
              (2, 64, 8, 8)]
    weights = [(256, 64, 1, 1), (64, 256, 1, 1), (32, 128, 1, 1),
               (64, 64, 3, 3), (8, 16, 1, 1), (5000, 64, 1, 1)]
    for s, w, st, dl, g, item in itertools.product(
            shapes, weights, [(1, 1), (2, 2)], [(1, 1), (2, 2)], [1, 2],
            [2, 4]):
        yield s, w, st, dl, g, item


def test_gate_admits_what_the_reference_admits():
    """Every configuration the reference admits, the port admits.  Where
    the port admits one the reference refuses, the reference's tile/VMEM
    clause is why (no P tile fits), except past the port's own limit of
    ``MAX_CO`` output channels, which only the port refuses."""
    from mxnet_tpu.ops.conv_fused import _pick_tile
    from mxnet_tpu.ops.conv_fused import fused_bwd_supported as ref_gate

    n_both = n_tile_only = 0
    for s, w, st, dl, g, item in _gate_cases():
        ref = ref_gate(s, w, st, dl, g, itemsize=item)
        got = pc.fused_bwd_supported(s, w, st, dl, g, itemsize=item)
        if w[0] > pc.MAX_CO:
            assert not got
            continue
        assert got >= ref, (s, w, st, dl, g, item)
        if got and not ref:
            p = s[0] * s[1] * s[2]
            assert _pick_tile(p, w[1], w[0], item) == 0
            n_tile_only += 1
        n_both += int(got and ref)
    assert n_both > 0 and n_tile_only > 0


@pytest.mark.parametrize("case", ["3x3", "stride2", "dilate2", "groups2",
                                  "nchw", "switch_off", "f16"])
def test_gate_refuses(monkeypatch, case):
    from mxnet_tpu.ops.conv_fused import fused_bwd_supported as ref_gate

    s, w, st, dl, g = (2, 8, 8, 64), (64, 64, 1, 1), (1, 1), (1, 1), 1
    kw = {}
    if case == "3x3":
        w = (64, 64, 3, 3)
    elif case == "stride2":
        st = (2, 2)
    elif case == "dilate2":
        dl = (2, 2)
    elif case == "groups2":
        g = 2
    elif case == "nchw":
        s = (2, 64, 8, 8)
        w = (64, 32, 1, 1)
    elif case == "switch_off":
        monkeypatch.setenv("MXNET_FUSED_CONV_BWD", "0")
    else:
        kw = dict(dtype=torch.float16)
    assert not pc.fused_bwd_supported(s, w, st, dl, g, **kw)
    if case != "f16":
        assert not ref_gate(s, w, st, dl, g)


def _smem(co, tc):
    """``conv1x1_bwd_smem_bytes`` of ``csrc/conv1x1_bwd.cu`` (the f32
    kernel's)."""
    co_pad = -(-co // 32) * 32
    return 4 * (co_pad * tc + 64 * (tc + 8) + 64 * 40 + 32 * (tc + 8))


@pytest.mark.parametrize("p,ci,co", [(128 * s * s, ci, co)
                                     for s, ci, co in RESNET50] +
                         [(1, 1, 1), (77, 13, 4096), (100, 3000, 17)],
                         ids=str)
def test_plan_fits_and_covers(p, ci, co):
    """f32: the Ci tile's dW partial fits a block's shared memory; bf16:
    the split-K grid of 128 x tc tiles fills an H100.  Both cover P."""
    tc, rows, nchunks = pc.plan(p, ci, co)
    assert tc in (8, 16, 32, 64) and rows % 64 == 0
    assert rows * nchunks >= p > rows * (nchunks - 1)
    assert _smem(co, tc) <= 232448
    # at least one block per SM of an H100 where P and Ci allow it
    blocks = -(-ci // tc) * nchunks
    assert blocks >= min(132, -(-ci // tc) * -(-p // 64))

    tc, rows, nchunks = pc.plan(p, ci, co, torch.bfloat16)
    assert tc == (64 if ci <= 64 else 128) and rows % 64 == 0
    assert rows * nchunks >= p > rows * (nchunks - 1)
    # 128 x tc tiles of dx (P x Ci) and of each split of dW (Co x Ci); a
    # split is long enough to pay for its f32 partial, and the grid fills
    # an H100 twice over wherever P has that many row tiles
    ntn = -(-ci // tc)
    blocks = nchunks * -(-co // 128) * ntn + -(-p // 128) * ntn
    assert nchunks == 1 or rows >= 1024
    assert blocks >= min(2 * 132, -(-p // 128) * ntn)


def test_plan_refuses_past_max_co():
    with pytest.raises(MXNetError, match="output channels"):
        pc.plan(64, 64, pc.MAX_CO + 1)


@pytest.mark.parametrize("bad", ["dtype_mix", "f16", "noncontig", "shape",
                                 "rank"])
def test_wrapper_rejects(bad):
    x, w, dy = _inputs(2, 4, 4, 16, 8)
    dy2, x2, w2 = t(dy.reshape(32, 8)), t(x.reshape(32, 16)), \
        t(w.reshape(8, 16))
    if bad == "dtype_mix":
        w2 = w2.bfloat16()
    elif bad == "f16":
        dy2, x2, w2 = dy2.half(), x2.half(), w2.half()
    elif bad == "noncontig":
        x2 = x2.t().contiguous().t()
    elif bad == "shape":
        w2 = w2[:, :8].contiguous()
    else:
        x2 = x2[None]
    with pytest.raises(MXNetError):
        pc.conv1x1_bwd_pair(dy2, x2, w2)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _card_inputs(p, ci, co, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((p, ci), generator=g, device="cuda").to(dtype)
    w = (torch.randn((co, ci), generator=g, device="cuda") *
         ci ** -0.5).to(dtype)
    dy = torch.randn((p, co), generator=g, device="cuda").to(dtype)
    return dy, x, w


def _check_on_card(p, ci, co, dtype):
    """dx within 2 bf16 steps (f32: 1e-5) of its magnitude, dW within 1e-3
    (f32: 1e-5) of its magnitude, dW bit for bit across two launches."""
    dy, x, w = _card_inputs(p, ci, co, dtype, p + ci + co)
    before = pc.conv1x1_bwd_pair.launches
    dx, dw = pc.conv1x1_bwd_pair(dy, x, w)
    dx2, dw2 = pc.conv1x1_bwd_pair(dy, x, w)
    torch.cuda.synchronize()
    assert pc.conv1x1_bwd_pair.launches == before + 2
    rdx, rdw = pc.conv1x1_bwd_pair_plain(dy, x, w)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    mx = rdx.float().abs().max().item()
    step = 2.0 ** (onp.floor(onp.log2(mx)) - 7)
    dx_tol = 2 * step if dtype == torch.bfloat16 else 1e-5 * mx
    dw_tol = (1e-3 if dtype == torch.bfloat16 else 1e-5) * \
        rdw.abs().max().item()
    assert (dx.float() - rdx.float()).abs().max().item() <= dx_tol
    assert (dw - rdw).abs().max().item() <= dw_tol


@pytest.mark.cuda
@pytest.mark.parametrize("s,ci,co", RESNET50, ids=str)
def test_kernel_matches_plain_resnet50(s, ci, co):
    need_cuda()
    _check_on_card(128 * s * s, ci, co, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit_split_k():
    """At stage 4's expand shape (P = 6272, 512 -> 2048) dW is summed over
    several P splits by a second pass in split order: three launches give
    the same dx and dW bit for bit."""
    need_cuda()
    p, ci, co = 6272, 512, 2048
    assert pc.plan(p, ci, co, torch.bfloat16)[2] > 1
    dy, x, w = _card_inputs(p, ci, co, torch.bfloat16, 5)
    runs = [pc.conv1x1_bwd_pair(dy, x, w) for _ in range(3)]
    torch.cuda.synchronize()
    for dx, dw in runs[1:]:
        assert torch.equal(dx, runs[0][0]) and torch.equal(dw, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("p,ci,co,dtype", [
    (6272, 512, 2048, torch.float32), (2048, 16, 8, torch.float32),
    (1000, 24, 40, torch.bfloat16), (77, 13, 70, torch.bfloat16),
    (130, 3, 4096, torch.float32), (64, 2048, 512, torch.bfloat16)],
    ids=str)
def test_kernel_matches_plain_ragged(p, ci, co, dtype):
    need_cuda()
    _check_on_card(p, ci, co, dtype)
