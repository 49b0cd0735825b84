"""The PyTorch port's ``DecodeServer`` against the JAX package: greedy
int8 streams token-identical to the JAX server and to JAX
``kv_generate`` for the same carried weights and prompts, across
mid-run admission, slot reuse and pool growth; sampled streams equal the
port's own batch-1 ``kv_generate(seed=...)``; the fault-tolerance knobs
take the reference's values.  Chunked prefill, the prefix cache and Llama are held in
``tests/test_torch_serve_paged.py``; speculation and int8 KV pages in
``tests/test_torch_serve_spec.py`` and
``tests/test_torch_serve_kvquant.py``; deadlines, cancellation, the
watchdog, the budget and sync mode in
``tests/test_torch_serve_faults.py``."""
import numpy as onp
import pytest

from _torch_parity import jax_gpt, port_gpt
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(scope="module")
def pair():
    net = jax_gpt()
    return net, port_gpt(net)


def _prompt(seed, n):
    return onp.random.RandomState(seed).randint(0, 97, (n,))


def _drain(srv):
    while srv.pump():
        pass


def _scenario(srv):
    """Two requests, a few steps, then three more (mid-run admission;
    five requests over two slots reuse retired slots)."""
    prompts = [_prompt(10 + i, 3 + (2 * i) % 7) for i in range(5)]
    news = [6, 9, 4, 5, 7]
    streams = [srv.submit(prompts[i], max_new_tokens=news[i])
               for i in range(2)]
    for _ in range(3):
        srv.pump()
    streams += [srv.submit(prompts[i], max_new_tokens=news[i])
                for i in range(2, 5)]
    _drain(srv)
    return prompts, news, [s.tokens(5) for s in streams]


def test_int8_streams_match_jax_server_and_kv_generate(pair):
    from mxnet_tpu.models import kv_generate as jgen
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer

    net, model = pair
    jsrv = JServer(net, max_total_len=64, pool_sizes=(2,), weights="int8",
                   spec=False, prefix_cache=False, autostart=False)
    prompts, news, ref = _scenario(jsrv)
    jsrv.close()
    srv = DecodeServer(model, max_total_len=64, pool_sizes=(2,),
                       weights="int8", spec=False, prefix_cache=False,
                       autostart=False)
    _, _, got = _scenario(srv)
    assert srv.counters["admit_dispatches"] >= 2
    srv.close()
    assert got == ref
    for p, n, toks in zip(prompts, news, got):
        assert toks == list(jgen(net, p[None], max_new_tokens=n,
                                 temperature=0.0, weights="int8")[0, p.size:])


def test_pool_growth_and_threaded_loop(pair):
    """autostart=True: the scheduler thread serves a burst that grows the
    pool 1 -> 2 -> 4; every stream equals the port's kv_generate."""
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    _, model = pair
    srv = DecodeServer(model, max_total_len=48, pool_sizes=(1, 2, 4),
                       weights="int8", page_size=8)
    prompts = [_prompt(30 + i, 2 + i) for i in range(4)]
    streams = [srv.submit(p, max_new_tokens=5) for p in prompts]
    toks = [s.tokens(30) for s in streams]
    stats = srv.stats()
    srv.close()
    assert stats["num_slots"] == 4 and stats["counters"]["pool_grows"] >= 1
    assert stats["pages_in_use"] == 0
    for p, got in zip(prompts, toks):
        assert got == list(kv_generate(model, p[None], 5, temperature=0.0,
                                       weights="int8")[0, p.size:])


def test_sampled_stream_matches_batch1_seed(pair):
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    _, model = pair
    srv = DecodeServer(model, max_total_len=64, pool_sizes=(2,),
                       temperature=0.8, top_k=5, autostart=False)
    p1, p2 = _prompt(4, 5), _prompt(5, 3)
    s1 = srv.submit(p1, max_new_tokens=6, seed=11)
    s2 = srv.submit(p2, max_new_tokens=6, seed=42)
    _drain(srv)
    srv.close()
    for p, s, seed in ((p1, s1, 11), (p2, s2, 42)):
        assert s.tokens(5) == list(kv_generate(
            model, p[None], 6, temperature=0.8, top_k=5,
            seed=seed)[0, p.size:])


def test_eos_and_one_token_budget(pair):
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    _, model = pair
    p = _prompt(0, 5)
    full = list(kv_generate(model, p[None], 8, temperature=0.0)[0, 5:])
    srv = DecodeServer(model, max_total_len=64, pool_sizes=(2,),
                       eos_id=full[2], autostart=False)
    s = srv.submit(p, max_new_tokens=8)
    one = srv.submit(p, max_new_tokens=1)
    _drain(srv)
    srv.close()
    assert s.tokens(5) == full[:full.index(full[2]) + 1]
    assert one.tokens(5) == full[:1]


@pytest.mark.parametrize("kw", [dict(step_timeout=5.0), dict(deadline=5.0),
                                dict(hbm_budget="1G"),
                                dict(default_deadline=5.0)])
def test_later_slice_features_raise(pair, kw):
    """The knobs the earlier slices refused — the watchdog's
    ``step_timeout``, a per-request ``deadline`` at ``submit``, the HBM
    budget and ``default_deadline`` — are accepted and do what the
    reference's do at these values: the JAX and the port server hold the
    same setting and serve the same stream (a generous deadline retires
    nothing; a 1G budget fits the pool)."""
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer

    net, model = pair
    ctor = {k: v for k, v in kw.items() if k != "deadline"}
    sub = {k: v for k, v in kw.items() if k == "deadline"}
    p = _prompt(0, 3)
    got = []
    for cls, m in ((JServer, net), (DecodeServer, model)):
        srv = cls(m, max_total_len=64, pool_sizes=(1,), spec=False,
                  autostart=False, **ctor)
        s = srv.submit(p, max_new_tokens=5, **sub)
        _drain(srv)
        got.append((s.tokens(5), srv.step_timeout, srv.hbm_budget,
                    srv.default_deadline, srv.stats()["counters"]))
        srv.close()
    assert got[0] == got[1]
    assert len(got[1][0]) == 5
    if "hbm_budget" in kw:
        assert got[1][2] == 1 << 30


def test_sync_mode_deadline_and_long_prompt_raise(pair, monkeypatch):
    """``MXNET_SERVE_SYNC=1`` serves through ``kv_generate`` as the
    reference does: a request whose deadline lapses in the queue retires
    with no tokens and reason ``deadline_exceeded``, the next request
    serves, and a prompt past ``max_total_len`` raises at ``submit``."""
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import DecodeServer

    net, model = pair
    monkeypatch.setenv("MXNET_SERVE_SYNC", "1")
    got = []
    for cls, m in ((JServer, net), (DecodeServer, model)):
        srv = cls(m, max_total_len=64, pool_sizes=(1,),
                  prefill_buckets=(8, 16), autostart=False)
        t = [srv._epoch]
        srv._clock = lambda: t[0]
        lapsed = srv.submit(_prompt(0, 3), max_new_tokens=4, deadline=1.0)
        ok = srv.submit(_prompt(1, 3), max_new_tokens=4)
        t[0] += 5.0
        _drain(srv)
        with pytest.raises(Exception, match="exceeds the pool cache length"):
            srv.submit(_prompt(2, 60), max_new_tokens=8)
        got.append((srv.sync_mode, srv.sync_reason, lapsed.tokens(5),
                    ok.tokens(5), dict(srv.counters)))
        srv.close()
    assert got[0] == got[1]
    assert got[1][2] == [] and len(got[1][3]) == 4
    assert got[1][4]["sync_requests"] == 1
    evs = [e for e in telemetry.events("serve_request")
           if e["reason"] == "deadline_exceeded"]
    assert evs and evs[-1]["tokens"] == 0
