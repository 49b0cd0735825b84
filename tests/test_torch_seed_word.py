"""The dropout seed as a device word and the traced key of the PyTorch
port, against the JAX package, float32 on the CPU.

- the plain K1, K2, K3 and ``_plain_attn`` given the seed as a
  one-element int64 word equal the same calls given the Python int, bit
  for bit (causal and not, key mask, dropout 0.1), and equal the
  reference's ``_pallas_fwd`` / ``_pallas_bwd_dq`` / ``_pallas_bwd_dkv``
  in Pallas interpret mode (and its ``_plain_attn``) fed the same seed,
  within the existing files' 1e-5;
- the traced key (``random.trace``): one key, the same seeds; draws
  within a program differ; another key, other seeds; ``random.seed``
  fixes the keys; the eager ``attention_seed`` sequence is the host
  generator's, as before the traced key existed;
- a capture with no traced key still refuses every draw, and the three
  kernels read the word on the card (``cuda``)."""
import numpy as onp
import pytest
import torch

from _torch_parity import KERNEL_TOL, need_cuda, rand, t
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as pa

RATE = 0.1
SEED = 0xC0FFEE42


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_INTERPRET", "1")


def _word(seed=SEED):
    return torch.full((1,), seed, dtype=torch.int64)


def _kmask(B, Lk):
    m = onp.zeros((B, 1, Lk), onp.float32)
    m[0, 0, Lk - 9:] = -1e30
    m[-1, 0, 5] = -2.0
    return m


CASES = {"causal": (True, False), "kmask": (False, True),
         "causal_kmask": (True, True)}


def _case(name, B=2, H=2, L=128, D=16):
    causal, masked = CASES[name]
    q, k, v, g = (rand(i, B, H, L, D) for i in range(4))
    km = _kmask(B, L) if masked else None
    return q, k, v, g, km, causal, D ** -0.5


@pytest.mark.parametrize("name", list(CASES))
def test_plain_kernels_take_the_word_bit_for_bit(name):
    q, k, v, g, km, causal, scale = _case(name)
    kmt = None if km is None else t(km)
    by_int = pa.flash_fwd(t(q), t(k), t(v), scale, causal, kmt, SEED, RATE)
    by_word = pa.flash_fwd(t(q), t(k), t(v), scale, causal, kmt, _word(),
                           RATE)
    for a, b in zip(by_int, by_word):
        assert torch.equal(a, b)
    lse = by_int[1]
    delta = (by_int[0] * t(g)).sum(-1)
    args = [t(q), t(k), t(v), t(g), lse, delta, scale, causal, kmt]
    assert torch.equal(pa.flash_bwd_dq(*args, SEED, RATE),
                       pa.flash_bwd_dq(*args, _word(), RATE))
    for a, b in zip(pa.flash_bwd_dkv(*args, SEED, RATE,
                                     need_dbias=km is not None),
                    pa.flash_bwd_dkv(*args, _word(), RATE,
                                     need_dbias=km is not None)):
        assert (a is None and b is None) or torch.equal(a, b)
    bias = None if km is None else t(km).reshape(2, 1, 1, -1)
    assert torch.equal(
        pa._plain_attn(t(q), t(k), t(v), bias, scale, causal, RATE, SEED),
        pa._plain_attn(t(q), t(k), t(v), bias, scale, causal, RATE,
                       _word()))


@pytest.mark.parametrize("name", list(CASES))
def test_word_kernels_match_pallas(interpret, name):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import (_pallas_bwd_dkv, _pallas_bwd_dq,
                                         _pallas_fwd, _rep)

    q, k, v, g, km, causal, scale = _case(name)
    B, H, L, _ = q.shape
    jkm = None if km is None else jnp.asarray(km)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    ro, rl = _pallas_fwd(jq, jk, jv, scale, causal, kmask=jkm, seed=SEED,
                         dropout=RATE)
    kmt = None if km is None else t(km)
    out, lse = pa.flash_fwd(t(q), t(k), t(v), scale, causal, kmt, _word(),
                            RATE)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ro), **KERNEL_TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(rl), **KERNEL_TOL)
    delta = (out * t(g)).sum(-1)
    reps = [_rep(jnp.asarray(x.reshape(B * H, L).numpy()))
            for x in (lse, delta)]
    rdq = _pallas_bwd_dq(jq, jk, jv, jg, *reps, scale, causal, kmask=jkm,
                         seed=SEED, dropout=RATE)
    rdk, rdv, _ = _pallas_bwd_dkv(jq, jk, jv, jg, *reps, scale, causal,
                                  kmask=jkm, seed=SEED, dropout=RATE)
    args = [t(q), t(k), t(v), t(g), lse, delta, scale, causal, kmt,
            _word(), RATE]
    dk, dv, _ = pa.flash_bwd_dkv(*args)
    for got, ref in ((pa.flash_bwd_dq(*args), rdq), (dk, rdk), (dv, rdv)):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                    **KERNEL_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attn_word_matches_jax(causal):
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _plain_attn

    q, k, v = (rand(20 + i, 2, 2, 16, 8) for i in range(3))
    ref = _plain_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                      0.25, causal, dropout=RATE, seed=jnp.uint32(SEED))
    got = pa._plain_attn(t(q), t(k), t(v), None, 0.25, causal,
                         dropout=RATE, seed=_word())
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **KERNEL_TOL)


def test_seed_word_is_checked():
    q = t(rand(0, 1, 1, 8, 8))
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(MXNetError, match="seed"):
            pa.flash_fwd(q, q, q, 0.3, False, None, bad, RATE)
    # without dropout the seed is not read
    pa.flash_fwd(q, q, q, 0.3, False, None, torch.zeros(2), 0.0)


# --------------------------------------------------------------------------- #
# the traced key
# --------------------------------------------------------------------------- #

def _program_seeds(key, n=3):
    with mxrandom.trace(torch.tensor([key], dtype=torch.int32)) as tr:
        seeds = [int(mxrandom.attention_seed()) for _ in range(n)]
    assert tr.draws == n
    return seeds


def test_traced_key_draws():
    a = _program_seeds(5)
    assert a == _program_seeds(5)               # one key, the same seeds
    assert len(set(a)) == 3                     # sites within a program
    b = _program_seeds(6)                       # the next step's key
    assert not set(a) & set(b)
    assert all(0 <= s < 2 ** 32 for s in a + b)
    # a key's high bit set (an int32 view of a uint32 key)
    assert _program_seeds(-1) == _program_seeds(-1)
    # next_key under a trace is the same derivation
    with mxrandom.trace(torch.tensor([5], dtype=torch.int32)):
        w = mxrandom.next_key()
    assert w.dtype == torch.int64 and w.shape == (1,) and int(w) == a[0]


def test_random_seed_fixes_the_keys_and_the_generators():
    mxrandom.seed(42)
    keys = [mxrandom.next_key() for _ in range(3)]
    g = mxrandom.generator("cpu")
    draw = torch.rand(4, generator=g)
    mxrandom.seed(42)
    assert [mxrandom.next_key() for _ in range(3)] == keys
    assert mxrandom.generator("cpu") is g       # reseeded in place
    assert torch.equal(torch.rand(4, generator=g), draw)
    assert all(isinstance(k, int) and 0 <= k < 2 ** 32 for k in keys)
    mxrandom.seed(43)
    assert [mxrandom.next_key() for _ in range(3)] != keys


def test_eager_attention_seed_sequence_is_unchanged():
    """Outside a trace the seeds are the attention host generator's
    draws (the stream before the traced key existed: a CPU generator
    seeded with ``seed * 1000003``), handed over as int64 words."""
    mxrandom.seed(9)
    got = [mxrandom.attention_seed() for _ in range(4)]
    g = torch.Generator(device="cpu")
    g.manual_seed(9 * 1000003)
    want = [int(torch.randint(0, 2 ** 32, (1,), generator=g,
                              dtype=torch.int64).item()) for _ in range(4)]
    assert [int(w) for w in got] == want
    assert all(w.dtype == torch.int64 and w.shape == (1,) for w in got)


def test_flash_attention_under_a_trace_takes_the_traced_seed():
    """At L = 640 (the K1-K3 path) with dropout, the output under one
    key repeats, and the seed is the trace's first draw."""
    q, k, v = (t(rand(40 + i, 1, 2, 640, 8)) for i in range(3))

    def run(key):
        with mxrandom.trace(torch.tensor([key], dtype=torch.int32)):
            return pa.flash_attention(q, k, v, causal=True, dropout=RATE,
                                      training=True)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    seed = _program_seeds(3, 1)[0]
    want = pa._FlashAttention.apply(q, k, v, None, 8 ** -0.5, True, seed,
                                    RATE)
    assert torch.equal(a, want)


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_capture_without_a_traced_key_refuses_on_card():
    need_cuda()
    g = torch.cuda.CUDAGraph()
    raised = []
    x = torch.zeros(1, device="cuda")
    with torch.cuda.graph(g):
        x.add_(1)
        for fn in (mxrandom.next_key, lambda: mxrandom.attention_seed("cuda"),
                   lambda: mxrandom.generator("cuda")):
            try:
                fn()
            except MXNetError:
                raised.append(fn)
    assert len(raised) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_read_the_word_on_card(dtype):
    """K1-K3 with the word on the card equal the plain versions with the
    same word (f32: 1e-4, bf16: 2e-2 of the forward; 2e-3 of each
    gradient's magnitude, as chip_smoke holds them), and equal their own
    launch with the Python int bit for bit."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, H, L, D = 2, 4, 256, 64
    q, k, v, g = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    word = torch.full((1,), SEED, dtype=torch.int64, device="cuda")
    out, lse = pa.flash_fwd(q, k, v, 0.125, True, None, word, RATE)
    ro, _ = pa.flash_fwd_plain(q, k, v, 0.125, True, None, word, RATE)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (out.float() - ro.float()).abs().max().item() < tol
    assert torch.equal(out, pa.flash_fwd(q, k, v, 0.125, True, None, SEED,
                                         RATE)[0])
    delta = (out.float() * g.float()).sum(-1)
    args = (q, k, v, g, lse, delta, 0.125, True, None, word, RATE)
    for got, ref in ((pa.flash_bwd_dq(*args), pa.flash_bwd_dq_plain(*args)),
                     *zip(pa.flash_bwd_dkv(*args)[:2],
                          pa.flash_bwd_dkv_plain(*args)[:2])):
        assert (got - ref).abs().max().item() <= \
            2e-3 * max(1.0, ref.abs().max().item())
