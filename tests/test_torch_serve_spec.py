"""The PyTorch port's speculative draft-and-verify decoding against the
JAX package.

The port's server and the reference's, pump-driven with the same carried
weights, settings and prompts and speculation on (f32, CPU), for Llama
(grouped-query 4/2) and GPT, native and int8 weights, native and int8 KV
pages: streams and every counter equal (tolerance 0 tokens), draft
ledgers included, on prompts that repeat so that drafts land; the
reference's ``tests/test_serve_spec.py`` cases on the port (EOS inside an
accepted burst, a short budget, a sampled server, a drafter that is
always wrong, bucket validation, the env knobs, the n-gram drafter, the
copy-on-write hit, chunked prefill and speculation on one int8 pool);
the port's drafter proposing what the reference's does on random
histories (hypothesis).  On the card, captured verify dispatches equal
eager ones bit for bit, one capture a (pool size, k bucket)."""
import numpy as onp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import jax_gpt, jax_llama, need_cuda, port_gpt, \
    port_llama
from mxnet_tpu_torch.base import MXNetError

T = 64
BUCKETS = (8, 16)
CASES = [(f, w, kv) for f in ("llama", "gpt") for w in ("native", "int8")
         for kv in ("native", "int8")]


def _prompt(seed, n):
    return onp.random.RandomState(seed).randint(0, 97, (n,))


def _drain(srv):
    while srv.pump():
        pass


@pytest.fixture(scope="module")
def nets():
    out = {}
    for family, make, port in (("llama", jax_llama, port_llama),
                               ("gpt", jax_gpt, port_gpt)):
        net = make()
        out[family] = (net, port(net))
    return out


def _ref(model, p, n, **kw):
    from mxnet_tpu_torch.models import kv_generate

    kw.setdefault("temperature", 0.0)
    return list(kv_generate(model, p[None], n, **kw)[0, p.size:])


SYS = _prompt(400, 32)                                  # two full pages


def _scenario(srv):
    """Repeating prompts (one chunks in), a short one, a late arrival
    that grows the pool, then a copy-on-write full hit and a partial hit
    beside a speculating slot.  Returns the streams' tokens."""
    streams = [srv.submit(onp.tile(_prompt(401, 6), 4), max_new_tokens=20),
               srv.submit(_prompt(402, 5), max_new_tokens=12)]
    for _ in range(2):
        srv.pump()
    streams.append(srv.submit(onp.tile(_prompt(403, 3), 5),
                              max_new_tokens=16))
    _drain(srv)
    streams.append(srv.submit(SYS, max_new_tokens=6))
    _drain(srv)
    streams += [srv.submit(SYS, max_new_tokens=14),
                srv.submit(onp.concatenate([SYS, _prompt(404, 4)]),
                           max_new_tokens=10),
                srv.submit(onp.tile(_prompt(405, 4), 3), max_new_tokens=18)]
    _drain(srv)
    return [s.tokens(5) for s in streams], streams


@pytest.fixture(scope="module")
def served(nets):
    cache = {}

    def get(family, weights, kv):
        key = (family, weights, kv)
        if key not in cache:
            from mxnet_tpu.serve import DecodeServer as JServer
            from mxnet_tpu_torch.serve import DecodeServer

            net, model = nets[family]
            kw = dict(max_total_len=T, prefill_buckets=BUCKETS,
                      weights=weights, kv_dtype=kv, pool_sizes=(1, 2, 4),
                      autostart=False)
            out = []
            for srv in (JServer(net, spec=True, **kw),
                        DecodeServer(model, **kw)):
                toks, streams = _scenario(srv)
                ledger = [(s.draft_accepted, s.draft_rejected)
                          for s in streams]
                out.append((toks, dict(srv.counters), ledger, srv.stats()))
                srv.close()
            cache[key] = out
        return cache[key]
    return get


@pytest.mark.parametrize("family,weights,kv", CASES)
def test_spec_server_matches_reference_server(served, family, weights, kv):
    (rtoks, rcnt, rledger, _), (toks, cnt, ledger, stats) = \
        served(family, weights, kv)
    assert toks == rtoks
    assert cnt == {k: rcnt[k] for k in cnt}
    assert ledger == rledger
    assert stats["spec"] is True and stats["spec_depth"] == 4
    assert stats["kv_dtype"] == kv
    assert cnt["verify_dispatches"] > 0 and cnt["draft_accepted"] > 0
    assert cnt["prefix_hits"] >= 2 and cnt["cow_copies"] >= 1
    assert cnt["chunk_dispatches"] >= 2 and cnt["pool_grows"] >= 1
    assert cnt["draft_accepted"] + cnt["draft_rejected"] == \
        cnt["draft_proposed"]
    assert sum(a for a, _ in ledger) == cnt["draft_accepted"]
    assert sum(r for _, r in ledger) == cnt["draft_rejected"]
    assert stats["draft_accept_rate"] == pytest.approx(
        cnt["draft_accepted"] / cnt["draft_proposed"])


@pytest.mark.parametrize("family,weights", [("llama", "native"),
                                            ("gpt", "int8")])
def test_native_spec_streams_equal_kv_generate(served, nets, family,
                                               weights):
    """Speculation changes the dispatches, never the tokens: with native
    pages every stream equals the port's own ``kv_generate`` (int8
    weights: the prompts that entered by one batched prefill)."""
    toks, _, _, _ = served(family, weights, "native")[1]
    model = nets[family][1]
    prompts = [onp.tile(_prompt(401, 6), 4), _prompt(402, 5),
               onp.tile(_prompt(403, 3), 5), SYS]
    news = [20, 12, 16, 6]
    for i, (p, n) in enumerate(zip(prompts, news)):
        if weights == "native" or p.size <= BUCKETS[-1]:
            assert toks[i] == _ref(model, p, n, weights=weights), i


def test_cow_chunk_and_spec_coresident_on_int8_pool(nets):
    """Every serving feature on ONE int8 pool: a copy-on-write prefix hit
    (no admission dispatch), a chunked prompt and speculation, side by
    side; the ledger is exact, tokens per dispatch clear 1.5, and each
    stream agrees >= 0.9 with the native ``kv_generate`` (PARITY.md)."""
    from mxnet_tpu_torch.serve import DecodeServer

    model = nets["gpt"][1]
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(2,),
                       prefill_buckets=(8,), spec=True, kv_dtype="int8",
                       autostart=False)
    assert srv.stats()["kv_dtype"] == "int8"
    p_hit = onp.tile(_prompt(364, 8), 4)       # two full pages
    p_long = onp.tile(_prompt(365, 7), 3)      # > bucket 8: 3 chunks
    warm = srv.submit(p_hit, max_new_tokens=4)
    _drain(srv)
    assert len(warm.tokens(5)) == 4
    srv.reset_counters()
    s_hit = srv.submit(p_hit, max_new_tokens=16)
    s_long = srv.submit(p_long, max_new_tokens=20)
    _drain(srv)
    c = dict(srv.counters)
    assert c["prefix_hits"] == 1 and c["admit_dispatches"] == 0
    assert c["chunk_dispatches"] == 3
    assert c["verify_dispatches"] > 0 and c["draft_accepted"] > 0
    assert c["draft_accepted"] + c["draft_rejected"] == c["draft_proposed"]
    total = len(s_hit.tokens(5)) + len(s_long.tokens(5))
    assert total == 36
    assert total / max(total - c["draft_accepted"], 1) > 1.5, c
    for s, p, n in ((s_hit, p_hit, 16), (s_long, p_long, 20)):
        got, ref = s.tokens(5), _ref(model, p, n)
        assert sum(int(a == b) for a, b in zip(got, ref)) / n >= 0.9
    srv.close()


# --------------------------------------------------------------------- #
# the reference's cases
# --------------------------------------------------------------------- #

def _server(model, **kw):
    from mxnet_tpu_torch.serve import DecodeServer

    kw.setdefault("pool_sizes", (2,))
    return DecodeServer(model, max_total_len=T, autostart=False, **kw)


def test_eos_retirement_exact_under_spec(nets):
    """EOS inside an accepted burst: the advance stops at the first EOS,
    so the stream is the offline decode cut after it."""
    model = nets["gpt"][1]
    p = onp.tile(_prompt(10, 4), 3)
    ref = _ref(model, p, 16)
    eos = ref[7]
    srv = _server(model, eos_id=eos)
    s = srv.submit(p, max_new_tokens=16)
    _drain(srv)
    assert s.tokens(5) == ref[:ref.index(eos) + 1]
    assert srv.counters["verify_dispatches"] > 0
    srv.close()


def test_short_budget_never_overruns(nets):
    model = nets["llama"][1]
    srv = _server(model)
    for n in (1, 2, 3):
        p = onp.tile(_prompt(304, 3), 3)
        s = srv.submit(p, max_new_tokens=n)
        _drain(srv)
        assert s.tokens(5) == _ref(model, p, n)
    srv.close()


def test_sampled_server_takes_plain_path(nets):
    """temperature > 0: no speculation, no verify program, the sampled
    stream equals the port's batch-1 ``kv_generate(seed=)``."""
    model = nets["gpt"][1]
    srv = _server(model, temperature=0.8, top_k=5, spec=True)
    assert srv.spec_enabled is False and srv.stats()["spec"] is False
    p = onp.tile(_prompt(305, 4), 3)
    s = srv.submit(p, max_new_tokens=8, seed=9)
    _drain(srv)
    assert s.tokens(5) == _ref(model, p, 8, temperature=0.8, top_k=5, seed=9)
    assert srv.counters["verify_dispatches"] == 0
    assert [r["k"] for r in srv.program_records()] == [None]
    srv.close()


def test_rejecting_drafter_still_exact(nets):
    from mxnet_tpu_torch.serve import Drafter

    class WrongDrafter(Drafter):
        def propose(self, history, k):
            return [96] * k

    model = nets["gpt"][1]
    p = _prompt(306, 4)
    ref = _ref(model, p, 12)
    assert 96 not in ref
    srv = _server(model, pool_sizes=(1,), drafter=WrongDrafter())
    s = srv.submit(p, max_new_tokens=12)
    _drain(srv)
    assert s.tokens(5) == ref
    assert s.draft_accepted == 0 and s.draft_rejected > 0
    assert s.accept_rate == 0.0
    srv.close()


def test_verify_acceptance_matches_reference(nets):
    """The verify program's acceptance on the device against the
    reference's ``verify_fn``, both fed the same logits: the longest
    matching prefix within ``min(nd, spec)``, the first-EOS clamp, the
    stop clamp ``max(stop - pos, 1)``, no advance on an inactive lane,
    and the retirement flags."""
    import jax.numpy as jnp
    from mxnet_tpu.serve import engine as jeng
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve.engine import PoolPrograms, pool_state_init

    net, model = nets["gpt"]
    S, k = 5, 3
    rs = onp.random.RandomState(50)
    logits = rs.standard_normal((S, k + 1, 97)).astype(onp.float32)
    out = logits.argmax(-1)
    eos = int(out[3, 1])
    drafts = out[:, :k].copy()
    drafts[1, 1] = (drafts[1, 1] + 1) % 97      # slot 1: rejects at 1
    slot = dict(nd=[3, 3, 1, 3, 2], spec=[2, 4, 4, 4, 4],
                pos=[10, 20, 30, 40, 50], stop=[11, 40, 60, 60, 52],
                tok=[1, 2, 3, 4, 5], active=[True, True, True, True, False])
    rows = onp.full((S, T // 16), S * T // 16)
    jp = jeng.PoolPrograms(net, S, T, 0.0, 0, eos, "native", page_size=16)
    jp.eng.pool_verify_paged = lambda *a: (jnp.asarray(logits), a[4], a[5])
    js = list(jeng.pool_state_init(jp))
    for i, name in ((2, "pos"), (3, "tok"), (4, "active"), (5, "stop"),
                    (8, "spec")):
        js[i] = jnp.asarray(onp.asarray(slot[name]), js[i].dtype)
    jstate, jout = jp.verify_fn(k)(
        *jp.operands, onp.float32(0.0), rows.astype(onp.int32),
        drafts.astype(onp.int32), onp.asarray(slot["nd"], onp.int32), *js)
    progs = PoolPrograms(_DecodeEngine(model), S, T, 16, eos_id=eos)
    progs.eng.pool_verify_paged = lambda *a: torch.from_numpy(logits)
    state = pool_state_init(progs)
    for name in ("pos", "tok", "active", "stop", "spec"):
        state[name][:] = torch.as_tensor(slot[name])
    got = progs.verify(state, rows, drafts, onp.asarray(slot["nd"]), k)
    for g, r in zip(got, jout):
        assert onp.array_equal(g.numpy(), onp.asarray(r))
    for i, name in ((2, "pos"), (3, "tok"), (4, "active")):
        assert onp.array_equal(state[name].numpy(), onp.asarray(jstate[i]))
    # the cases the slots were built for: spec cap and stop, a
    # rejection, the nd cap, EOS, an inactive lane
    assert got[1].tolist()[:5] == [1, 2, 2, 2, 0]


def test_verify_bucket_validation(nets):
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve.engine import PoolPrograms, pool_state_init

    srv = _server(nets["gpt"][1], pool_sizes=(1,))
    rows = onp.full((1, 4), 4)
    with pytest.raises(MXNetError, match=">= 1"):
        srv._progs.verify(srv._state, rows, onp.zeros((1, 0)),
                          onp.zeros((1,)), 0)
    srv.close()
    progs = PoolPrograms(_DecodeEngine(nets["gpt"][1], temperature=0.8), 1,
                         T)
    with pytest.raises(MXNetError, match="greedy"):
        progs.verify(pool_state_init(progs), rows, onp.zeros((1, 1)),
                     onp.zeros((1,)), 1)


def test_env_knobs(nets, monkeypatch):
    model = nets["gpt"][1]
    monkeypatch.setenv("MXNET_SERVE_SPEC", "0")
    srv = _server(model, pool_sizes=(1,))
    assert srv.spec_enabled is False
    srv.close()
    monkeypatch.delenv("MXNET_SERVE_SPEC")
    srv = _server(model, pool_sizes=(1,))
    assert srv.spec_enabled and srv.spec_depth == 4
    assert srv.spec_sizes == (1, 2, 4)
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_SPEC_DEPTH", "2")
    monkeypatch.setenv("MXNET_SERVE_SPEC_SIZES", "1,2")
    srv = _server(model, pool_sizes=(1,))
    assert srv.spec_enabled and srv.spec_depth == 2
    assert srv.spec_sizes == (1, 2)
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_SPEC_DEPTH", "0")
    assert _server(model, pool_sizes=(1,)).spec_enabled is False
    monkeypatch.setenv("MXNET_SERVE_SPEC_DEPTH", "eight")
    with pytest.raises(MXNetError, match="MXNET_SERVE_SPEC_DEPTH"):
        _server(model, pool_sizes=(1,))
    monkeypatch.setenv("MXNET_SERVE_SPEC_DEPTH", "-1")
    with pytest.raises(MXNetError, match="MXNET_SERVE_SPEC_DEPTH"):
        _server(model, pool_sizes=(1,))
    monkeypatch.delenv("MXNET_SERVE_SPEC_DEPTH")
    monkeypatch.setenv("MXNET_SERVE_SPEC_SIZES", "1,x")
    with pytest.raises(MXNetError, match="MXNET_SERVE_SPEC_SIZES"):
        _server(model, pool_sizes=(1,))


def test_kwarg_validation(nets):
    model = nets["gpt"][1]
    with pytest.raises(MXNetError, match="spec_depth"):
        _server(model, pool_sizes=(1,), spec_depth=-1)
    with pytest.raises(MXNetError, match="spec_sizes"):
        _server(model, pool_sizes=(1,), spec_sizes=(4, 2))
    srv = _server(model, pool_sizes=(1,), spec_depth=64,
                  spec_sizes=(1, 2, 4))
    assert srv.spec_depth == 4
    srv.close()
    assert _server(model, spec=False).stats()["spec"] is False


# --------------------------------------------------------------------- #
# the drafter
# --------------------------------------------------------------------- #

def test_ngram_longest_suffix_most_recent_match():
    from mxnet_tpu_torch.serve import NGramDrafter

    d = NGramDrafter()
    assert d.propose([1, 2, 3, 4, 1, 2, 3], 2) == [4, 1]
    assert d.propose([1, 2, 5, 1, 2, 6, 1, 2], 1) == [6]


def test_ngram_no_repeat_proposes_nothing():
    from mxnet_tpu_torch.serve import NGramDrafter

    d = NGramDrafter()
    assert d.propose([1, 2, 3, 4, 5], 4) == []
    assert d.propose([7], 4) == []
    assert d.propose([1, 2, 1, 2], 0) == []


def test_ngram_window_bounds_the_scan():
    from mxnet_tpu_torch.serve import NGramDrafter

    assert NGramDrafter(window=4).propose([1, 2, 9, 8, 7, 1, 2], 2) == []


def test_ngram_bad_config_raises():
    from mxnet_tpu_torch.serve import NGramDrafter

    with pytest.raises(ValueError):
        NGramDrafter(min_match=0)
    with pytest.raises(ValueError):
        NGramDrafter(min_match=3, max_match=2)


@settings(max_examples=200, deadline=None)
@given(hist=st.lists(st.integers(0, 5), max_size=48),
       k=st.integers(0, 6), min_match=st.integers(1, 3),
       extra=st.integers(0, 3), window=st.integers(2, 64))
def test_ngram_drafter_matches_reference(hist, k, min_match, extra, window):
    from mxnet_tpu.serve.draft import NGramDrafter as JDrafter
    from mxnet_tpu_torch.serve import NGramDrafter

    kw = dict(min_match=min_match, max_match=min_match + extra,
              window=window)
    assert NGramDrafter(**kw).propose(hist, k) == \
        JDrafter(**kw).propose(hist, k)


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #

def _card_llama():
    from mxnet_tpu_torch.models import llama_7b

    model, _ = llama_7b(dtype=torch.bfloat16, num_layers=2, units=256,
                        num_heads=4, num_kv_heads=2, hidden_size=512,
                        vocab_size=512, device="cuda")
    model.initialize(0.02, seed=0)
    return model


def _card_run(model, kv):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(model, max_total_len=128, pool_sizes=(2, 4),
                       weights="int8", prefill_buckets=(8, 16), kv_dtype=kv,
                       autostart=False)
    rs = onp.random.RandomState(380)
    prompts = [onp.tile(rs.randint(0, 512, (n,)), 4) for n in (3, 5, 4, 6)]
    streams = [srv.submit(p, max_new_tokens=24) for p in prompts[:2]]
    for _ in range(4):
        srv.pump()
    streams += [srv.submit(p, max_new_tokens=24) for p in prompts[2:]]
    _drain(srv)
    out = ([s.tokens(5) for s in streams], dict(srv.counters),
           srv.program_records())
    srv.close()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["native", "int8"])
def test_captured_verifies_equal_eager_on_card(kv):
    """On the card: the same requests with captured programs and with
    each program's own function give the same tokens and counters bit
    for bit, through two pool sizes; every (pool size, k bucket) that
    ran twice is captured exactly once and no capture failed."""
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    need_cuda()
    model = _card_llama()
    captured = _card_run(model, kv)
    call = _GraphProgram.__call__
    _GraphProgram.__call__ = lambda self: self.run()
    try:
        eager = _card_run(model, kv)
    finally:
        _GraphProgram.__call__ = call
    assert captured[:2] == eager[:2]
    assert captured[1]["verify_dispatches"] > 0
    verifies = [r for r in captured[2] if r["k"] is not None]
    assert verifies and {r["S"] for r in verifies} <= {2, 4}
    assert len({(r["S"], r["k"]) for r in verifies}) == len(verifies)
    for r in captured[2]:
        assert r["captures"] == int(r["calls"] >= 2), r
        assert r["capture_failures"] == 0
        if r["replays"]:
            assert r["launches"]["q8_matvec"] > 0
    assert all(r["captures"] == 0 for r in eager[2])
