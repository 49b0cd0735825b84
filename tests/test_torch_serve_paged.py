"""The PyTorch port's paged serving against the JAX package: chunked
prefill, the copy-on-write prefix cache and Llama in ``DecodeServer``
(the reference's ``tests/test_serve.py`` long-prompt case and
``TestPagedKV``).

Every scenario runs pump-driven on the JAX server and on the port's with
the same carried weights and prompts (f32, CPU), for ``LLAMA_SMALL``
(grouped-query 4/2) and ``SMALL`` GPT, native and int8 weights.  The
port's greedy streams and dispatch counters must equal the JAX server's
(tolerance 0 tokens).  Native streams must also equal JAX
``kv_generate``'s; int8 ones too wherever the prompt entered by one
batched prefill.  (An int8 chunk projects its K/V through ``q8_matvec``
in the reference, while the batched prefill's are native, so a chunked
int8 prompt, and a hit on its pages, follow the JAX server rather than
``kv_generate``.)  ``_DecodeEngine.chunk_tokens`` (K4 on the chunk's rows
in int8) is held to the reference's chunk program directly, 1e-5.  On the
card, captured steps equal eager ones bit for bit, one capture a pool
size, and a capture that another thread's device-wide sync fails does
not stop the server."""
import numpy as onp
import pytest
import torch

from _torch_parity import jax_gpt, jax_llama, need_cuda, port_gpt, \
    port_llama

T = 64
BUCKETS = (8, 16)
COUNTERS = ("step_dispatches", "admit_dispatches", "chunk_dispatches",
            "prefix_hits", "cow_copies", "pool_grows")
CASES = [("llama", "native"), ("llama", "int8"), ("gpt", "native"),
         ("gpt", "int8")]


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


def _servers(pair, weights, **kw):
    """A JAX server and the port's, both pump-driven, same settings."""
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer

    net, model = pair
    kw = dict(max_total_len=T, prefill_buckets=BUCKETS, weights=weights,
              autostart=False, **kw)
    return (JServer(net, spec=False, **kw),
            DecodeServer(model, spec=False, **kw))


def _counts(srv):
    return {k: srv.counters[k] for k in COUNTERS}


def _delta(before, srv):
    return {k: srv.counters[k] - before[k] for k in COUNTERS}


SYS = _prompt(300, 32)                                  # two full pages


def _phases(srv):
    """The main scenario, one phase after another on one server:
    {phase: (prompts, streams' tokens, counter deltas, extra)}."""
    out = {}

    def run(name, submit, extra=None):
        before = _counts(srv)
        prompts, streams = submit()
        _drain(srv)
        out[name] = (prompts, [s.tokens(5) for s in streams],
                     _delta(before, srv), extra() if extra else None)

    def growth():
        # one request, then two more mid-run: the pool grows 1 -> 4
        ps = [_prompt(301, 5), _prompt(302, 9), _prompt(303, 12)]
        streams = [srv.submit(ps[0], max_new_tokens=6)]
        for _ in range(2):
            srv.pump()
        streams += [srv.submit(p, max_new_tokens=5) for p in ps[1:]]
        return ps, streams

    def chunked():
        # 24 and 40 tokens past the largest bucket (16): 2 + 3 chunks;
        # a short one admits beside them
        ps = [_prompt(304, 24), _prompt(305, 40), _prompt(306, 6)]
        return ps, [srv.submit(p, max_new_tokens=4) for p in ps]

    def producer():
        return [SYS], [srv.submit(SYS, max_new_tokens=5)]

    def full_hits():
        # SYS exactly (ends on a page boundary: one copy-on-write page)
        # and SYS + 1 token (every matched page shared, no copy)
        ps = [SYS, onp.concatenate([SYS, _prompt(307, 1)])]
        return ps, [srv.submit(p, max_new_tokens=5) for p in ps]

    def fork():
        # a one-page prefix, then two prompts that diverge after it: the
        # second maps the shared page and chunks in its 4-token suffix
        prefix = _prompt(308, 16)
        ps = [onp.concatenate([prefix, _prompt(309, 4)]),
              onp.concatenate([prefix, _prompt(310, 4)])]
        streams = [srv.submit(ps[0], max_new_tokens=5)]
        _drain(srv)
        streams.append(srv.submit(ps[1], max_new_tokens=5))
        return ps, streams

    pages = {}

    def retire():
        # 20 + 4 tokens reserve 2 pages; after retirement only its one
        # full prompt page stays, owned by the prefix index
        pages["before"] = (srv.stats()["pages_in_use"],
                           srv.stats()["prefix_nodes"])
        p = _prompt(311, 20)
        s = srv.submit(p, max_new_tokens=4)
        srv.pump()
        pages["admitted"] = srv.stats()["pages_in_use"]
        return [p], [s]

    run("growth", growth, lambda: srv.stats()["num_slots"])
    run("chunked", chunked)
    run("producer", producer)
    run("full_hits", full_hits)
    run("fork", fork)
    run("retire", retire, lambda: dict(
        pages, after=(srv.stats()["pages_in_use"],
                      srv.stats()["prefix_nodes"])))
    return out


@pytest.fixture(scope="module")
def runs(nets):
    cache = {}

    def get(family, weights):
        if (family, weights) not in cache:
            jsrv, srv = _servers(nets[family], weights,
                                 pool_sizes=(1, 2, 4))
            ref = _phases(jsrv)
            jsrv.close()
            got = _phases(srv)
            srv.close()
            cache[(family, weights)] = (ref, got, srv.stats())
        return cache[(family, weights)]
    return get


def _jax_kv(net, p, n, weights):
    from mxnet_tpu.models import kv_generate

    return list(kv_generate(net, p[None], max_new_tokens=n, temperature=0.0,
                            weights=weights)[0, p.size:])


def _check_phase(runs, nets, family, weights, phase, batched=()):
    """Port streams and counters equal the JAX server's; the streams of
    ``batched`` (indices of prompts that entered by one batched prefill,
    all of them for native weights) equal JAX ``kv_generate``'s."""
    ref, got, _ = runs(family, weights)
    (ps, rtoks, rcnt, rextra), (_, toks, cnt, extra) = ref[phase], got[phase]
    assert toks == rtoks
    assert cnt == rcnt
    net = nets[family][0]
    for i, (p, tk) in enumerate(zip(ps, toks)):
        if weights == "native" or i in batched:
            assert tk == _jax_kv(net, p, len(tk), weights)
    return cnt, extra, rextra


@pytest.mark.parametrize("family,weights", CASES)
def test_midrun_admission_and_pool_growth(runs, nets, family, weights):
    cnt, slots, rslots = _check_phase(runs, nets, family, weights,
                                      "growth", batched=(0, 1, 2))
    assert slots == rslots == 4 and cnt["pool_grows"] >= 1
    assert cnt["chunk_dispatches"] == 0


@pytest.mark.parametrize("family,weights", CASES)
def test_long_prompts_chunk_in(runs, nets, family, weights):
    cnt, _, _ = _check_phase(runs, nets, family, weights, "chunked",
                             batched=(2,))
    assert cnt["chunk_dispatches"] == 5 and cnt["admit_dispatches"] == 1


@pytest.mark.parametrize("family,weights", CASES)
def test_full_hits_with_and_without_cow_copy(runs, nets, family, weights):
    cnt, _, _ = _check_phase(runs, nets, family, weights, "producer")
    assert cnt["chunk_dispatches"] == 2 and cnt["prefix_hits"] == 0
    cnt, _, _ = _check_phase(runs, nets, family, weights, "full_hits")
    assert cnt["prefix_hits"] == 2 and cnt["cow_copies"] == 1
    assert cnt["admit_dispatches"] == 0 and cnt["chunk_dispatches"] == 0


@pytest.mark.parametrize("family,weights", CASES)
def test_partial_hit_and_diverging_fork(runs, nets, family, weights):
    cnt, _, _ = _check_phase(runs, nets, family, weights, "fork")
    # the producer chunks in (20 > 16); the fork shares its first page
    # and chunks in only its 4-token suffix
    assert cnt["prefix_hits"] == 1 and cnt["cow_copies"] == 0
    assert cnt["chunk_dispatches"] == 3 and cnt["admit_dispatches"] == 0
    ref, got, _ = runs(family, weights)
    assert got["fork"][1][0] != got["fork"][1][1]


@pytest.mark.parametrize("family,weights", CASES)
def test_pages_freed_and_only_full_pages_retained(runs, nets, family,
                                                  weights):
    _, pages, rpages = _check_phase(runs, nets, family, weights, "retire")
    assert pages == rpages
    (used, nodes), (after, after_nodes) = pages["before"], pages["after"]
    assert pages["admitted"] == used + 2
    assert (after, after_nodes) == (used + 1, nodes + 1)
    _, _, closed = runs(family, weights)
    assert closed["pages_in_use"] == 0 and closed["prefix_nodes"] == 0


@pytest.mark.parametrize("family,weights", [("llama", "int8"),
                                            ("gpt", "native")])
def test_eviction_under_a_small_fixed_pool(nets, family, weights):
    """Six pages: each 32-token prompt (+ 4 new) reserves three and
    leaves its two full pages indexed, so later prompts evict the least
    recently used ones; a repeat of the newest still hits."""
    jsrv, srv = _servers(nets[family], weights, pool_sizes=(2,),
                         num_pages=6)
    ps = [_prompt(320 + i, 32) for i in range(4)]
    ps.append(ps[-1])
    toks = []
    for s in (jsrv, srv):
        out = []
        for p in ps:
            st = s.submit(p, max_new_tokens=4)
            _drain(s)
            out.append(st.tokens(5))
            assert s.stats()["pages_in_use"] <= 6
        toks.append((out, _counts(s), s.stats()["prefix_nodes"]))
        s.close()
    assert toks[1] == toks[0]
    _, cnt, nodes = toks[1]
    assert cnt["prefix_hits"] == 1 and nodes > 0
    if weights == "native":
        for p, tk in zip(ps, toks[1][0]):
            assert tk == _jax_kv(nets[family][0], p, 4, weights)


@pytest.mark.parametrize("family,weights", [("llama", "native"),
                                            ("gpt", "int8")])
def test_env_prefix_cache_off(nets, family, weights, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_PREFIX_CACHE", "0")
    jsrv, srv = _servers(nets[family], weights, pool_sizes=(2,))
    assert srv.prefix_cache_enabled is False
    p = _prompt(330, 16)
    got = []
    for s in (jsrv, srv):
        out = []
        for _ in range(2):
            st = s.submit(p, max_new_tokens=3)
            _drain(s)
            out.append(st.tokens(5))
        got.append((out, _counts(s)))
        assert s.stats()["pages_in_use"] == 0
        s.close()
    assert got[1] == got[0]
    assert got[1][1]["prefix_hits"] == 0
    assert got[1][1]["admit_dispatches"] == 2
    for tk in got[1][0]:
        assert tk == _jax_kv(nets[family][0], p, 3, weights)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_sampled_hit_matches_batch1_seed(nets, family):
    """A hit's first token comes from the step's recompute of position
    L - 1 with the admission's own (seed, position): hit and miss streams
    equal the port's batch-1 ``kv_generate(seed=)``."""
    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    model = nets[family][1]
    srv = DecodeServer(model, max_total_len=T, pool_sizes=(2,),
                       temperature=0.8, top_k=5, autostart=False)
    toks = []
    for seed in (7, 99):
        s = srv.submit(SYS, max_new_tokens=5, seed=seed)
        _drain(srv)
        toks.append((seed, s.tokens(5)))
    assert srv.counters["prefix_hits"] == 1
    assert srv.counters["admit_dispatches"] == 1
    srv.close()
    for seed, tk in toks:
        assert tk == list(kv_generate(model, SYS[None], 5, temperature=0.8,
                                      top_k=5, seed=seed)[0, SYS.size:])


@pytest.mark.parametrize("family,weights", CASES)
def test_chunk_tokens_matches_reference_chunk(nets, family, weights):
    """One 8-token chunk at offset 16 over a 16-token cached prefix, into
    a one-slot pool: the port's pages and first token against the
    reference's ``chunk_fn`` on the same pool, 1e-5."""
    import jax.numpy as jnp
    from mxnet_tpu.serve import engine as jeng
    from mxnet_tpu.serve import schema
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve.engine import PoolPrograms, pool_state_init

    net, model = nets[family]
    jp = jeng.PoolPrograms(net, 1, T, 0.0, 0, None, weights, page_size=16)
    js = jeng.pool_state_init(jp)
    progs = PoolPrograms(_DecodeEngine(model, 0.0, 0, weights), 1, T, 16)
    state = pool_state_init(progs)
    rs = onp.random.RandomState(340)
    prefix = rs.standard_normal((2,) + tuple(js[0].shape[:1]) +
                                tuple(js[0].shape[2:])).astype(onp.float32)
    row = [2, 0, 3]                     # pages of the slot, out of order
    kp0 = onp.zeros(js[0].shape, onp.float32)
    vp0 = onp.zeros(js[0].shape, onp.float32)
    kp0[:, row[0]], vp0[:, row[0]] = prefix[0], prefix[1]
    js = (jnp.asarray(kp0), jnp.asarray(vp0)) + tuple(js[2:])
    state["kp"][:, :4] = torch.from_numpy(kp0)
    state["vp"][:, :4] = torch.from_numpy(vp0)
    toks = rs.randint(0, 97, (8,))
    L, off, nlast = 21, 16, 4
    ptrow = onp.array(row + [4], onp.int32)
    meta = onp.asarray(schema.meta_row(
        "chunk", final=1, slot=0, true_len=L, stop_pos=L + 3, seed=0,
        nlast=nlast, off=off, spec_depth=0), onp.int32)
    zrow = onp.full((4,), 4, onp.int32)
    new_state, (first, _) = jp.chunk_fn(8)(
        *jp.operands, toks.astype(onp.int32), meta, onp.float32(onp.inf),
        ptrow, zrow, *js)
    got_first, _ = progs.chunk(
        state, torch.from_numpy(toks), torch.from_numpy(ptrow.astype(
            onp.int64)), off, nlast, True, 0, L, L + 3, 0)
    for j, name in ((0, "kp"), (1, "vp")):
        onp.testing.assert_allclose(state[name][:, :4].numpy(),
                                    onp.asarray(new_state[j]),
                                    rtol=1e-5, atol=1e-5)
    assert int(got_first[0]) == int(first)
    assert int(state["pos"][0]) == L and bool(state["active"][0])


def test_outgrown_pool_is_freed_at_growth(nets):
    """Growth drops the outgrown pool: its state and its step program
    are freed at once (no cyclic collection needed), and only the
    program's record stays; the streams still equal ``kv_generate``'s."""
    import gc
    import weakref

    from mxnet_tpu_torch.models import kv_generate
    from mxnet_tpu_torch.serve import DecodeServer

    _, model = nets["llama"]
    srv = DecodeServer(model, max_total_len=T, prefill_buckets=BUCKETS,
                       pool_sizes=(1, 2), spec=False, autostart=False)
    prompts = [_prompt(360, 5), _prompt(361, 7)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        streams = [srv.submit(prompts[0], max_new_tokens=6)]
        for _ in range(3):
            srv.pump()
        old = [weakref.ref(x) for x in (srv._state["kp"], srv._progs,
                                        srv._progs.step_program)]
        streams.append(srv.submit(prompts[1], max_new_tokens=6))
        srv.pump()
        assert srv.stats()["num_slots"] == 2
        assert [r() for r in old] == [None, None, None]
    finally:
        if enabled:
            gc.enable()
    _drain(srv)
    records = srv.step_records()
    srv.close()
    assert [r["S"] for r in records] == [1, 2]
    assert all(r["capture_failures"] == 0 for r in records)
    for p, s in zip(prompts, streams):
        assert s.tokens(5) == list(kv_generate(
            model, p[None], 6, temperature=0.0)[0, p.size:])


def _eager_steps():
    """Patch every step program to run its own function (``_GraphProgram.
    run``): no capture, no replay.  Returns the undo."""
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    call = _GraphProgram.__call__
    _GraphProgram.__call__ = lambda self: self.run()

    def undo():
        _GraphProgram.__call__ = call
    return undo


def _card_llama():
    from mxnet_tpu_torch.models import llama_7b

    model, _ = llama_7b(dtype=torch.bfloat16, num_layers=2, units=256,
                        num_heads=4, num_kv_heads=2, hidden_size=512,
                        vocab_size=512, device="cuda")
    model.initialize(0.02, seed=0)
    return model


def _card_run(model, prompts, temperature, new):
    """Two requests step a while on two slots; the rest grow the pool to
    four mid-run.  Returns the tokens, the counters and the step
    records."""
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(model, max_total_len=128, pool_sizes=(2, 4),
                       weights="int8", prefill_buckets=(8, 16),
                       temperature=temperature, top_k=5, spec=False,
                       autostart=False)
    streams = [srv.submit(p, max_new_tokens=new) for p in prompts[:2]]
    for _ in range(4):
        srv.pump()
    streams += [srv.submit(p, max_new_tokens=new) for p in prompts[2:]]
    _drain(srv)
    out = ([s.tokens(5) for s in streams], dict(srv.counters),
           srv.step_records())
    srv.close()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_steps_equal_eager_on_card(temperature):
    """On the card: the same requests served with the captured step and
    with the step program's own function give the same tokens bit for
    bit, greedy and sampled (the sampler's hash inside the graph),
    through two pool sizes, each captured exactly once.  Pump-driven, so
    both runs dispatch the same waves; meanwhile another thread
    allocates, launches and synchronizes its own stream, which a capture
    in ``thread_local`` error mode tolerates."""
    import threading

    need_cuda()
    model = _card_llama()
    prompts = [_prompt(350 + i, n) for i, n in enumerate((5, 40, 17, 32))]
    prompts.append(prompts[-1])
    stop = threading.Event()

    def other_thread():
        while not stop.is_set():
            x = torch.ones(1 << 16, device="cuda")
            x.add_(1.0)
            torch.cuda.current_stream().synchronize()

    hammer = threading.Thread(target=other_thread, daemon=True)
    hammer.start()
    try:
        captured = _card_run(model, prompts, temperature, 6)
        undo = _eager_steps()
        try:
            eager = _card_run(model, prompts, temperature, 6)
        finally:
            undo()
    finally:
        stop.set()
        hammer.join()
    assert captured[:2] == eager[:2]
    records = captured[2]
    assert [r["S"] for r in records] == [2, 4]
    for r in records:
        assert r["captures"] == 1 and r["capture_failures"] == 0
        assert r["replays"] >= 1 and r["launches"]["q8_matvec"] > 0
    assert all(r["captures"] == 0 and r["replays"] == 0 for r in eager[2])


@pytest.mark.cuda
def test_server_recovers_from_a_failed_capture_on_card():
    """On the card: a device-wide ``torch.cuda.synchronize()`` from
    another thread during a step's capture fails that call and the
    capture.  The server keeps serving: that step runs the program's own
    function and a later step captures again.  One such sync is made
    during the first pool's first capture; another thread then calls
    ``torch.cuda.synchronize()`` in a loop through the growth.  The
    tokens equal those of eager steps, the outgrown pool's graph is
    freed at the growth, and both pool sizes end captured."""
    import threading
    import weakref

    need_cuda()
    model = _card_llama()
    prompts = [_prompt(370 + i, n) for i, n in enumerate((5, 40, 17, 32))]
    undo = _eager_steps()
    try:
        eager = _card_run(model, prompts, 0.0, 16)
    finally:
        undo()

    sync_errors = []

    def device_sync():
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:          # the capture's other victim
            sync_errors.append(str(e))

    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    orig = _DecodeEngine.paged_step
    injected = []

    def paged_step(self, *args, **kw):
        if not injected and torch.cuda.is_current_stream_capturing():
            injected.append(True)
            t = threading.Thread(target=device_sync)
            t.start()
            t.join()
        return orig(self, *args, **kw)

    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            device_sync()

    state = {"pumps": 0, "old": None, "hammer": None}

    def during(srv):
        state["pumps"] += 1
        if state["pumps"] == 1:
            state["hammer"] = threading.Thread(target=hammer, daemon=True)
            state["hammer"].start()
        if state["pumps"] == 6:
            stop.set()
            state["hammer"].join()

    _DecodeEngine.paged_step = paged_step
    try:
        from mxnet_tpu_torch.serve import DecodeServer

        srv = DecodeServer(model, max_total_len=128, pool_sizes=(2, 4),
                           weights="int8", prefill_buckets=(8, 16),
                           spec=False, autostart=False)
        streams = [srv.submit(p, max_new_tokens=16) for p in prompts[:2]]
        for _ in range(4):
            srv.pump()
        old = weakref.ref(srv._progs.step_program)
        streams += [srv.submit(p, max_new_tokens=16) for p in prompts[2:]]
        while srv.pump():
            during(srv)
        tokens = [s.tokens(5) for s in streams]
        counters, records = dict(srv.counters), srv.step_records()
        srv.close()
    finally:
        _DecodeEngine.paged_step = orig
        stop.set()
        if state["hammer"] is not None:
            state["hammer"].join()
    assert injected
    assert old() is None
    assert (tokens, counters) == tuple(eager[:2])
    assert [r["S"] for r in records] == [2, 4]
    assert records[0]["capture_failures"] >= 1
    assert all(r["captures"] == 1 for r in records)
