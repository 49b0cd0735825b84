"""Kernels K2 (flash backward dq) and K3 (dk, dv, dbias) of the PyTorch
port and the ``_FlashAttention`` autograd Function against the JAX
package, float32 on the CPU.

- the plain K2/K3 vs ``_pallas_bwd_dq`` / ``_pallas_bwd_dkv`` in Pallas
  interpret mode (causal and not, key mask Nb = 1 and B, dbias, dropout
  0.1 whose keep bits are the shared position hash): 1e-5;
- the Function's gradients, dbias included, vs ``jax.vjp`` of the
  reference's ``_flash(..., "pallas")`` custom VJP (interpret mode);
- ``flash_attention(training=True)`` at L = 640 (the port's kernel path,
  the reference's ``"xla"`` blockwise path) in value and gradients: 1e-4,
  as the blockwise scan sums its tiles in another order;
- fp16 (amp's float16 target) at 640² scores, past the plain path's
  512²: the Function's output and gradients vs ``jax.vjp`` of the
  reference's Pallas VJP on the same fp16 inputs, within one fp16
  rounding (2^-10 relative and of the largest magnitude);
- ``gradcheck`` of the Function's backward in f64 at a tiny shape;
- the CUDA kernels vs their plain versions on the card (``cuda``)."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, need_cuda, rand, t
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as pa

XLA_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _kmask(Nb, Lk, seed):
    m = onp.zeros((Nb, 1, Lk), onp.float32)
    rs = onp.random.RandomState(seed)
    for b in range(Nb):
        m[b, 0, Lk - rs.randint(1, Lk // 2):] = -1e30
    m[0, 0, 3] = -2.5                       # a finite bias entry too
    return m


def _inputs(B, H, L, Lk, D, seed=0):
    """q, k, v, g as numpy, and the forward's lse and delta from the
    plain K1 (the same residuals the reference kernels are handed)."""
    q, k, v = (rand(seed + i, B, H, n, D) for i, n in
               enumerate((L, Lk, Lk)))
    g = rand(seed + 3, B, H, L, D)
    return q, k, v, g


def _residuals(q, k, v, g, scale, causal, km, seed, rate):
    out, lse = pa.flash_fwd_plain(t(q), t(k), t(v), scale, causal,
                                  None if km is None else t(km), seed, rate)
    delta = (out * t(g)).sum(-1)
    return lse, delta


BWD_CASES = {
    "causal": dict(B=1, H=2, causal=True),
    "kmask_batch_dbias": dict(B=2, H=2, causal=False, Nb=2),
    "kmask_bcast_causal_dropout": dict(B=2, H=1, causal=True, Nb=1,
                                       dropout=0.1, seed=4321),
    "dropout": dict(B=1, H=2, causal=False, dropout=0.1, seed=99),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_plain_k2_k3_match_pallas_bwd(interpret, name):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import (_pallas_bwd_dkv, _pallas_bwd_dq,
                                         _rep)

    c = BWD_CASES[name]
    B, H, L, D = c["B"], c["H"], 256, 64
    scale = D ** -0.5
    rate, seed = c.get("dropout", 0.0), c.get("seed", 0)
    q, k, v, g = _inputs(B, H, L, L, D)
    km = _kmask(c["Nb"], L, 7) if "Nb" in c else None
    lse, delta = _residuals(q, k, v, g, scale, c["causal"], km, seed, rate)
    jargs = [jnp.asarray(a) for a in (q, k, v, g)]
    reps = [_rep(jnp.asarray(x.reshape(B * H, L).numpy()))
            for x in (lse, delta)]
    jkm = None if km is None else jnp.asarray(km)
    rdq = _pallas_bwd_dq(*jargs, *reps, scale, c["causal"], kmask=jkm,
                         seed=seed, dropout=rate)
    rdk, rdv, rdb = _pallas_bwd_dkv(*jargs, *reps, scale, c["causal"],
                                    kmask=jkm, seed=seed, dropout=rate,
                                    need_dbias=km is not None)
    before = (pa.flash_bwd_dq.launches, pa.flash_bwd_dkv.launches)
    targs = [t(a) for a in (q, k, v, g)] + [lse, delta, scale, c["causal"],
                                            None if km is None else t(km),
                                            seed, rate]
    dq = pa.flash_bwd_dq(*targs)
    dk, dv, db = pa.flash_bwd_dkv(*targs, need_dbias=km is not None)
    assert (pa.flash_bwd_dq.launches, pa.flash_bwd_dkv.launches) == before
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                    **KERNEL_TOL)
    if km is None:
        assert db is None and rdb is None
    else:
        assert db.shape == (B, H, L)
        onp.testing.assert_allclose(db.numpy(), onp.asarray(rdb),
                                    **KERNEL_TOL)


def _port_grads(q, k, v, bias, g, scale, causal, seed, rate, fn):
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    b = None if bias is None else t(bias).requires_grad_()
    out = fn(*leaves, b, scale, causal, seed, rate)
    out.backward(t(g))
    grads = [x.grad.numpy() for x in leaves]
    return out.detach().numpy(), grads + ([] if b is None else
                                          [b.grad.numpy()])


def _jax_grads(fn, q, k, v, bias, g):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is None:
        out, vjp = jax.vjp(lambda a, b_, c: fn(a, b_, c, None), *args)
    else:
        out, vjp = jax.vjp(fn, *args, jnp.asarray(bias))
    return onp.asarray(out), [onp.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal,Nb,rate", [(True, None, 0.0),
                                            (False, 2, 0.0),
                                            (True, 1, 0.1)])
def test_function_grads_match_jax_pallas_vjp(interpret, causal, Nb, rate):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _flash

    B, H, L, D, seed = 2, 2, 256, 32, 2024
    scale = D ** -0.5
    q, k, v, g = _inputs(B, H, L, L, D, seed=10)
    bias = None if Nb is None else _kmask(Nb, L, 3).reshape(Nb, 1, 1, L)
    ref_out, ref = _jax_grads(
        lambda a, b_, c, m: _flash(a, b_, c, m, jnp.uint32(seed), scale,
                                   causal, rate, "pallas"),
        q, k, v, bias, g)
    out, got = _port_grads(q, k, v, bias, g, scale, causal, seed, rate,
                           pa._FlashAttention.apply)
    onp.testing.assert_allclose(out, ref_out, **KERNEL_TOL)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        onp.testing.assert_allclose(a, b, **KERNEL_TOL)


@pytest.mark.parametrize("causal,Nb,rate", [(True, None, 0.1),
                                            (False, 1, 0.0)])
def test_fp16_function_grads_match_jax_pallas_vjp(interpret, causal, Nb,
                                                  rate):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _flash

    B, H, L, D, seed = 1, 2, 640, 16, 77
    scale = D ** -0.5
    q, k, v, g = (a.astype(onp.float16)
                  for a in _inputs(B, H, L, L, D, seed=20))
    bias = None if Nb is None else _kmask(Nb, L, 3).reshape(Nb, 1, 1, L)
    ref_out, ref = _jax_grads(
        lambda a, b_, c, m: _flash(a, b_, c, m, jnp.uint32(seed), scale,
                                   causal, rate, "pallas"),
        q, k, v, bias, g)
    out, got = _port_grads(q, k, v, bias, g, scale, causal, seed, rate,
                           pa._FlashAttention.apply)
    assert out.dtype == ref_out.dtype == onp.float16
    assert len(got) == len(ref)
    for a, b in zip([out] + got[:3], [ref_out] + ref[:3]):
        assert a.dtype == onp.float16
        b = b.astype(onp.float32)
        onp.testing.assert_allclose(
            a.astype(onp.float32), b, rtol=2.0 ** -10,
            atol=2.0 ** -10 * float(onp.abs(b).max()))
    if Nb is not None:          # the f32 key mask's gradient
        onp.testing.assert_allclose(got[3], ref[3], **XLA_TOL)


def test_function_returns_no_bias_grad_when_not_needed():
    q, k, v, g = _inputs(1, 2, 64, 64, 16)
    bias = t(_kmask(1, 64, 5).reshape(1, 1, 1, 64))     # no requires_grad
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = pa._FlashAttention.apply(*leaves, bias, 0.25, True, 0, 0.0)
    out.backward(t(g))
    assert bias.grad is None and all(x.grad is not None for x in leaves)


@pytest.mark.parametrize("masked,rate", [(False, 0.0), (True, 0.0),
                                         (True, 0.1)])
def test_flash_attention_training_matches_jax_xla_path(masked, rate):
    """L = 640: the port's kernel path (plain versions here) against the
    reference's blockwise ``"xla"`` path, which its training table picks
    at this length; with dropout both take the same explicit seed."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _choose_path, _flash
    from mxnet_tpu.ops.attention import flash_attention as jfa

    B, H, L, D, seed = 1, 2, 640, 16, 77
    scale = D ** -0.5
    q, k, v, g = _inputs(B, H, L, L, D, seed=20)
    bias = _kmask(1, L, 9).reshape(1, 1, 1, L) if masked else None
    assert _choose_path(L, L, bias, True) == "xla"
    if rate == 0.0:
        def ref_fn(a, b_, c, m):
            return jfa.__wrapped__(a, b_, c, m, causal=True, training=True)

        def port_fn(a, b_, c, m, scale_, causal_, seed_, rate_):
            return pa.flash_attention(a, b_, c, m, causal=True,
                                      training=True)
    else:
        def ref_fn(a, b_, c, m):
            return _flash(a, b_, c, m, jnp.uint32(seed), scale, True, rate,
                          "xla")
        port_fn = pa._FlashAttention.apply
    ref_out, ref = _jax_grads(ref_fn, q, k, v, bias, g)
    before = pa.flash_fwd.launches
    out, got = _port_grads(q, k, v, bias, g, scale, True, seed, rate,
                           port_fn)
    assert pa.flash_fwd.launches == before
    onp.testing.assert_allclose(out, ref_out, **XLA_TOL)
    for a, b in zip(got, ref):
        onp.testing.assert_allclose(a, b, **XLA_TOL)


def test_flash_attention_training_dropout_draws_seeds():
    """``training=True`` with dropout draws a fresh seed per call from the
    port's host generator; ``random.seed`` replays the draws."""
    from mxnet_tpu_torch import random as prandom

    q, k, v = (t(a) for a in _inputs(1, 2, 600, 600, 8)[:3])
    prandom.seed(5)
    a = pa.flash_attention(q, k, v, causal=True, dropout=0.3, training=True)
    b = pa.flash_attention(q, k, v, causal=True, dropout=0.3, training=True)
    prandom.seed(5)
    c = pa.flash_attention(q, k, v, causal=True, dropout=0.3, training=True)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    off = pa.flash_attention(q, k, v, causal=True, dropout=0.3)
    torch.testing.assert_close(
        off, pa.flash_attention(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("causal,rate", [(True, 0.0), (False, 0.25)])
def test_gradcheck_backward_f64(causal, rate):
    B, H, L, Lk, D = 2, 1, 5, 7 if not causal else 5, 8
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, n, D, generator=gen, dtype=torch.float64,
                           requires_grad=True) for n in (L, Lk, Lk))
    bias = (torch.randn(B, 1, 1, Lk, generator=gen, dtype=torch.float64)
            ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b_, c, m: pa._FlashAttention.apply(a, b_, c, m, 0.4,
                                                     causal, 11, rate),
        (q, k, v, bias))


def test_backward_wrappers_reject_bad_inputs():
    q, k, v, g = (t(a) for a in _inputs(1, 2, 16, 16, 8))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(MXNetError, match="g "):
        pa.flash_bwd_dq(q, k, v, g[:, :1], lse, lse, 0.3, True)
    with pytest.raises(MXNetError, match="lse"):
        pa.flash_bwd_dkv(q, k, v, g, lse[..., :3], lse, 0.3, True)
    with pytest.raises(MXNetError, match="delta"):
        pa.flash_bwd_dq(q, k, v, g, lse, lse.double(), 0.3, True)


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
def test_kernels_match_plain_on_card(dtype, L, Lk, D, causal, masked,
                                     rate):
    need_cuda()
    q, k, v = (t(a).cuda().to(dtype) for a in _inputs(2, 3, L, Lk, D)[:3])
    g = t(rand(8, 2, 3, L, D)).cuda().to(dtype)
    km = t(_kmask(2, Lk, 4)).cuda() if masked else None
    scale = D ** -0.5
    out, lse = pa.flash_fwd(q, k, v, scale, causal, km, 99, rate)
    delta = (out.float() * g.float()).sum(-1)
    args = (q, k, v, g, lse, delta, scale, causal, km, 99, rate)
    before = (pa.flash_bwd_dq.launches, pa.flash_bwd_dkv.launches)
    dq = pa.flash_bwd_dq(*args)
    dk, dv, db = pa.flash_bwd_dkv(*args, need_dbias=masked)
    torch.cuda.synchronize()
    assert (pa.flash_bwd_dq.launches, pa.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    rdq = pa.flash_bwd_dq_plain(*args)
    rdk, rdv, rdb = pa.flash_bwd_dkv_plain(*args, need_dbias=masked)
    # f32 outputs: the kernels and the plain versions sum the same exact
    # products in other orders; the tolerance is relative to each
    # output's magnitude
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv), (db, rdb)):
        if ref is None:
            assert got is None
            continue
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= tol


def _repeat_bit_for_bit(dtype):
    q, k, v, g = (t(a).cuda().to(dtype)
                  for a in _inputs(2, 3, 333, 333, 64))
    km = t(_kmask(2, 333, 4)).cuda()
    args = (q, k, v, 64 ** -0.5, True, km, 99, 0.1)
    out, lse = pa.flash_fwd(*args)
    out2, lse2 = pa.flash_fwd(*args)
    delta = (out.float() * g.float()).sum(-1)
    bwd = (q, k, v, g, lse, delta, 64 ** -0.5, True, km, 99, 0.1)
    first = (pa.flash_bwd_dq(*bwd), *pa.flash_bwd_dkv(*bwd, need_dbias=True))
    second = (pa.flash_bwd_dq(*bwd), *pa.flash_bwd_dkv(*bwd,
                                                        need_dbias=True))
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_kernels_repeat_bit_for_bit_on_card():
    """The bf16 tensor-core K1, K2 and K3 use no atomics: two launches on
    the same inputs give the same out, lse, dq, dk, dv and dbias bit for
    bit."""
    need_cuda()
    _repeat_bit_for_bit(torch.bfloat16)


@pytest.mark.cuda
def test_fp16_kernels_repeat_bit_for_bit_on_card():
    """The fp16 instantiations of the same kernels repeat bit for bit."""
    need_cuda()
    _repeat_bit_for_bit(torch.float16)
