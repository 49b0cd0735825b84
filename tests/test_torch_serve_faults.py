"""Fault tolerance and telemetry of the PyTorch port's ``DecodeServer``
against the JAX package (the reference's ``tests/test_fault_tolerance.py``
and ``tests/test_telemetry.py`` serving cases, on the port).

The port's server and the reference's run pump-driven on the same carried
weights (f32, CPU) under the same scripted clock (``_FakeClock`` patched
over ``_clock``): deadlines in the queue and on the device (greedy and
sampled, plain step and verify), cancellation, the scheduler's death,
the watchdog (a wedged pump, a late wedged dispatch, a dead thread, a
cold first call), the ``MXNET_FAULT_INJECT`` sites, a timed-out
consumer, sync mode (``MXNET_SERVE_SYNC=1`` and a model the slot-pool
gate rejects), the ``stats()``/``counters`` key sets and values, and
``models.decode_step_program``.  Greedy streams and counters are exact
(tolerance 0 tokens); a sampled stream has the reference's length and
equals the port's own batch-1 ``kv_generate(seed=...)`` (the two
packages' samplers draw different random numbers).  One ``cuda`` case
retires a slot by the clock at the second of two replays of a captured
step."""
import threading
import time

import numpy as onp
import pytest
import torch

from _torch_parity import (jax_gpt, jax_llama, need_cuda, port_gpt,
                           port_llama)
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import faults

SAMPLED = dict(temperature=0.7, top_k=7)


@pytest.fixture(scope="module")
def pair():
    net = jax_gpt()
    return net, port_gpt(net)


@pytest.fixture(autouse=True)
def _fresh_faults():
    """Zeroed fault hit counts (the spec is per test, the counts are
    process-wide)."""
    faults.reset_faults()
    yield
    faults.reset_faults()


class _FakeClock:
    """A scripted stand-in for ``DecodeServer._clock``."""

    def __init__(self, start):
        self.t = float(start)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _prompt(seed, n):
    return onp.random.RandomState(seed).randint(0, 97, (n,))


def _drain(srv):
    while srv.pump():
        pass


def _ref(model, p, n, **kw):
    from mxnet_tpu_torch.models import kv_generate

    kw.setdefault("temperature", 0.0)
    return list(kv_generate(model, p[None], n, **kw)[0, p.size:])


def _both(pair, **kw):
    """The reference's server and the port's, each with a fake clock at
    its epoch."""
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer

    out = []
    for cls, m in ((JServer, pair[0]), (DecodeServer, pair[1])):
        srv = cls(m, **kw)
        clk = _FakeClock(srv._epoch)
        srv._clock = clk
        out.append((srv, clk))
    return out


def _my_events(kind, srv):
    """``srv``'s events of ``kind``, from its own package's ring."""
    tel = telemetry
    if type(srv).__module__.startswith("mxnet_tpu."):
        from mxnet_tpu import telemetry as tel
    return [e for e in tel.events(kind)
            if e.get("server") == srv.telemetry_label]


# --------------------------------------------------------------------- #
# deadlines
# --------------------------------------------------------------------- #

def test_queue_lapsed_deadline_retires_without_slot(pair):
    """A deadline that lapses while the request is queued retires it at
    the admission boundary: no slot, no tokens, reason
    ``deadline_exceeded``; the request ahead of it serves."""
    got = []
    for srv, clk in _both(pair, max_total_len=64, pool_sizes=(1,),
                          autostart=False):
        pA, pB = _prompt(0, 4), _prompt(1, 4)
        sA = srv.submit(pA, max_new_tokens=4)
        sB = srv.submit(pB, max_new_tokens=4, deadline=1.0)
        clk.advance(5.0)
        _drain(srv)
        got.append((sA.tokens(5), sB.done, sB.tokens(5),
                    srv.stats()["in_flight"], dict(srv.counters)))
        srv.close()
    assert got[0] == got[1]
    assert got[1][2] == [] and got[1][0] == _ref(pair[1], _prompt(0, 4), 4)
    evs = [e for e in _my_events("deadline_exceeded", srv)]
    assert [e["tokens"] for e in evs] == [0]
    reqs = _my_events("serve_request", srv)
    assert sorted(e["reason"] for e in reqs) == ["deadline_exceeded",
                                                 "max_len"]


@pytest.mark.parametrize("sampled", [False, True])
def test_device_side_expiry_frees_slot_coresident_exact(pair, sampled):
    """Expiry retires the sequence on the device at a step boundary, at
    the same step as the reference's: the deadlined stream has the
    reference's length (and, greedy, its tokens) and is a prefix of its
    undisturbed run; the co-resident stream is exact; one admit for the
    wave and one step dispatch a step, nothing extra for the deadline;
    one step program; the freed slot serves again."""
    kw = SAMPLED if sampled else {}
    N = 10
    pA, pB, pC = _prompt(2, 5), _prompt(3, 4), _prompt(4, 3)
    got = []
    for srv, clk in _both(pair, max_total_len=64, pool_sizes=(2,),
                          spec=False, autostart=False, **kw):
        sA = srv.submit(pA, max_new_tokens=N, seed=11)
        sB = srv.submit(pB, max_new_tokens=N, seed=42, deadline=3.5)
        srv.reset_counters()
        while srv.pump():
            clk.advance(1.0)        # steps dispatch at now = 1, 2, 3, ...
        c = dict(srv.counters)
        sC = srv.submit(pC, max_new_tokens=3, seed=7)
        _drain(srv)
        got.append(dict(A=sA.tokens(5), B=sB.tokens(5), C=sC.tokens(5),
                        counters=c, srv=srv,
                        reasons=(getattr(sA, "reason", None),
                                 getattr(sB, "reason", None))))
        srv.close()
    ref, mine = got
    model = pair[1]
    refA = _ref(model, pA, N, seed=11, **kw)
    refB = _ref(model, pB, N, seed=42, **kw)
    assert mine["A"] == refA
    assert 0 < len(mine["B"]) < N and mine["B"] == refB[:len(mine["B"])]
    assert len(mine["B"]) == len(ref["B"])
    assert (mine["reasons"], ref["reasons"][1]) == \
        (("max_len", "deadline_exceeded"), None)
    assert mine["C"] == _ref(model, pC, 3, seed=7, **kw)
    if not sampled:
        assert (mine["A"], mine["B"], mine["C"]) == \
            (ref["A"], ref["B"], ref["C"])
    assert mine["counters"] == ref["counters"]
    assert mine["counters"]["admit_dispatches"] == 1
    assert mine["counters"]["step_dispatches"] == (N - 1) + 1
    assert len(mine["srv"].step_records()) == 1
    evs = _my_events("deadline_exceeded", mine["srv"])
    assert [e["tokens"] for e in evs] == [len(mine["B"])]


def test_deadline_on_a_verify_retires_after_the_accepted_prefix(pair):
    """With speculation on, a deadline that passes between verify
    dispatches retires the slot after that dispatch's accepted tokens:
    the same stream, reasons and counters as the reference's."""
    got = []
    p = onp.tile(_prompt(5, 6), 4)
    for srv, clk in _both(pair, max_total_len=64, pool_sizes=(2,),
                          autostart=False):
        a = srv.submit(p, max_new_tokens=20)
        b = srv.submit(onp.tile(_prompt(6, 4), 3), max_new_tokens=20,
                       deadline=4.5)
        while srv.pump():
            clk.advance(1.0)
        got.append((a.tokens(5), b.tokens(5), dict(srv.counters),
                    sorted(e["reason"] for e in
                           _my_events("serve_request", srv))))
        srv.close()
    assert got[0] == got[1]
    assert got[1][2]["verify_dispatches"] >= 1
    assert "deadline_exceeded" in got[1][3]
    assert 0 < len(got[1][1]) < 20


def test_deadline_mid_chunked_prefill_retires_at_the_chunk(pair):
    """A request whose deadline passes between its prefill chunks retires
    before its next chunk, without a token, as the reference's does."""
    got = []
    for srv, clk in _both(pair, max_total_len=64, pool_sizes=(1,),
                          prefill_buckets=(8, 16), autostart=False):
        s = srv.submit(_prompt(7, 40), max_new_tokens=4, deadline=1.5)
        srv.pump()
        clk.advance(2.0)
        _drain(srv)
        ok = srv.submit(_prompt(8, 5), max_new_tokens=3)
        _drain(srv)
        got.append((s.tokens(5), ok.tokens(5), dict(srv.counters),
                    srv.stats()["pages_in_use"]))
        srv.close()
    assert got[0][:3] == got[1][:3]
    assert got[1][0] == [] and got[1][2]["chunk_dispatches"] == 1


def test_env_default_deadline(pair, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeServer

    monkeypatch.setenv("MXNET_SERVE_DEADLINE", "0.000001")
    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       autostart=False)
    assert srv.default_deadline == pytest.approx(1e-6)
    s = srv.submit(_prompt(5, 4), max_new_tokens=4)
    time.sleep(0.01)
    _drain(srv)
    assert s.done and s.tokens(5) == []
    # submit(deadline=) wins over the default
    s2 = srv.submit(_prompt(5, 4), max_new_tokens=3, deadline=60.0)
    _drain(srv)
    assert s2.tokens(5) == _ref(pair[1], _prompt(5, 4), 3)
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_DEADLINE", "soon")
    with pytest.raises(MXNetError, match="MXNET_SERVE_DEADLINE"):
        DecodeServer(pair[1], max_total_len=64, autostart=False)
    monkeypatch.setenv("MXNET_SERVE_DEADLINE", "0")
    srv = DecodeServer(pair[1], max_total_len=64, autostart=False)
    assert srv.default_deadline is None
    srv.close()


@pytest.mark.parametrize("bad", [dict(deadline=-1.0), dict(deadline=0)])
def test_bad_deadline_rejected(pair, bad):
    msgs = []
    for srv, _ in _both(pair, max_total_len=64, pool_sizes=(1,),
                        autostart=False):
        with pytest.raises(Exception, match="deadline") as ei:
            srv.submit(_prompt(6, 3), max_new_tokens=2, **bad)
        msgs.append(str(ei.value))
        srv.close()
    assert msgs[0] == msgs[1]
    from mxnet_tpu_torch.serve import DecodeServer
    with pytest.raises(MXNetError, match="default_deadline"):
        DecodeServer(pair[1], default_deadline=-2.0, autostart=False)


def test_step_timeout_zero_and_env_disable_watchdog(pair, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       step_timeout=0, autostart=False)
    assert srv.step_timeout is None
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_STEP_TIMEOUT", "2.5")
    srv = DecodeServer(pair[1], max_total_len=64, autostart=False)
    assert srv.step_timeout == 2.5
    srv.close()
    monkeypatch.setenv("MXNET_SERVE_STEP_TIMEOUT", "later")
    with pytest.raises(MXNetError, match="MXNET_SERVE_STEP_TIMEOUT"):
        DecodeServer(pair[1], max_total_len=64, autostart=False)


# --------------------------------------------------------------------- #
# cancellation
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("sampled", [False, True])
def test_cancel_mid_decode_frees_slot_coresident_exact(pair, sampled):
    """``cancel()`` frees the slot at the next step boundary: the other
    stream is exact, the cancelled one a sealed prefix of its own run,
    no extra dispatch, and the slot serves again."""
    kw = SAMPLED if sampled else {}
    N = 10
    pA, pB, pC = _prompt(10, 5), _prompt(11, 4), _prompt(12, 3)
    got = []
    for srv, _ in _both(pair, max_total_len=64, pool_sizes=(2,),
                        spec=False, autostart=False, **kw):
        sA = srv.submit(pA, max_new_tokens=N, seed=11)
        sB = srv.submit(pB, max_new_tokens=N, seed=42)
        srv.reset_counters()
        for _ in range(3):
            srv.pump()
        assert not sB.done
        assert sB.cancel() is True
        assert sB.cancel() is True           # idempotent while closing
        _drain(srv)
        c = dict(srv.counters)
        sC = srv.submit(pC, max_new_tokens=4, seed=7)
        _drain(srv)
        got.append(dict(A=sA.tokens(5), B=sB.tokens(5), C=sC.tokens(5),
                        cancelled=sB.cancelled, counters=c, srv=srv))
        srv.close()
    ref, mine = got
    model = pair[1]
    refB = _ref(model, pB, N, seed=42, **kw)
    assert mine["A"] == _ref(model, pA, N, seed=11, **kw)
    assert mine["cancelled"] and 0 < len(mine["B"]) < N
    assert mine["B"] == refB[:len(mine["B"])]
    assert len(mine["B"]) == len(ref["B"])
    assert mine["C"] == _ref(model, pC, 4, seed=7, **kw)
    if not sampled:
        assert (mine["A"], mine["B"], mine["C"]) == \
            (ref["A"], ref["B"], ref["C"])
    assert mine["counters"] == ref["counters"]
    assert mine["counters"]["step_dispatches"] == (N - 1) + 1
    assert len(mine["srv"].step_records()) == 1
    evs = _my_events("request_cancelled", mine["srv"])
    assert [e["tokens"] for e in evs] == [len(mine["B"])]


def test_cancel_queued_and_after_done(pair):
    got = []
    for srv, _ in _both(pair, max_total_len=64, pool_sizes=(1,),
                        autostart=False):
        pA, pB = _prompt(13, 4), _prompt(14, 4)
        sA = srv.submit(pA, max_new_tokens=6)
        sB = srv.submit(pB, max_new_tokens=6)   # queued: one slot
        first = sB.cancel()
        state = (sB.done, sB.cancelled, sB.tokens(1))
        _drain(srv)
        got.append((first, state, sA.tokens(5), sA.cancel(),
                    sA.cancelled, srv.stats()["pending"]))
        srv.close()
    assert got[0] == got[1]
    assert got[1][:2] == (True, (True, True, []))
    assert got[1][3] is False and got[1][4] is False


def test_cancel_from_another_thread_while_serving(pair):
    """On the scheduler's own thread: a stream cancelled from a consumer
    thread mid-decode seals as a prefix of its run; the co-resident one
    is exact and a request submitted after takes the freed slot."""
    from mxnet_tpu_torch.serve import DecodeServer

    model = pair[1]
    srv = DecodeServer(model, max_total_len=64, pool_sizes=(2,),
                       spec=False)
    pA, pB, pC = _prompt(15, 5), _prompt(16, 4), _prompt(17, 6)
    sA = srv.submit(pA, max_new_tokens=30)
    sB = srv.submit(pB, max_new_tokens=30)
    seen = threading.Event()

    def consumer():
        for i, _ in enumerate(sB):
            if i == 2:
                sB.cancel()
                seen.set()

    th = threading.Thread(target=consumer)
    th.start()
    assert seen.wait(60)
    th.join(60)
    got = sB.tokens(60)
    sC = srv.submit(pC, max_new_tokens=5)
    assert sA.tokens(60) == _ref(model, pA, 30)
    assert sC.tokens(60) == _ref(model, pC, 5)
    srv.close()
    assert sB.cancelled and 3 <= len(got) < 30
    assert got == _ref(model, pB, 30)[:len(got)]


def test_sync_mode_cancel_mid_generation_reports_failure(pair,
                                                         monkeypatch):
    """Sync mode has no step boundaries: ``cancel()`` of a request inside
    ``kv_generate`` returns False and the stream completes; a queued one
    cancels for real."""
    from mxnet_tpu_torch.models import decoding
    from mxnet_tpu_torch.serve import DecodeServer

    monkeypatch.setenv("MXNET_SERVE_SYNC", "1")
    srv = DecodeServer(pair[1], max_total_len=64, autostart=False)
    started, release = threading.Event(), threading.Event()
    real = decoding.kv_generate

    def slow(*a, **k):
        started.set()
        release.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(decoding, "kv_generate", slow)
    p, p2 = _prompt(70, 4), _prompt(71, 4)
    s = srv.submit(p, max_new_tokens=3)
    s2 = srv.submit(p2, max_new_tokens=3)
    th = threading.Thread(target=srv.pump)
    th.start()
    assert started.wait(10)
    assert s.cancel() is False
    assert s2.cancel() is True
    release.set()
    th.join(10)
    monkeypatch.setattr(decoding, "kv_generate", real)
    assert s.tokens(10) == _ref(pair[1], p, 3) and not s.cancelled
    assert s2.cancelled and s2.tokens(1) == []
    srv.close()


# --------------------------------------------------------------------- #
# the scheduler's death and the watchdog
# --------------------------------------------------------------------- #

def test_injected_scheduler_death_fails_all_streams(pair, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(2,),
                       spec=False, autostart=False)
    s1 = srv.submit(_prompt(20, 4), max_new_tokens=8)
    s2 = srv.submit(_prompt(21, 5), max_new_tokens=8)
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve.step:raise:2")
    faults.reset_faults()
    srv.start()
    with pytest.raises(MXNetError, match="injected fault"):
        s1.tokens(30)
    with pytest.raises(MXNetError, match="injected fault"):
        s2.tokens(30)
    with pytest.raises(MXNetError, match="server failed"):
        srv.submit(_prompt(20, 4), max_new_tokens=2)
    assert srv.stats()["pool_bytes"] == 0 and srv._state is None


def test_watchdog_fires_on_wedged_pump(pair):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       step_timeout=0.25, autostart=False)
    real_pump = srv.pump

    def wedged_pump():
        time.sleep(1.2)
        return real_pump()

    srv.pump = wedged_pump
    s = srv.submit(_prompt(22, 4), max_new_tokens=6)
    srv.start()
    with pytest.raises(MXNetError, match="watchdog.*step_timeout=0.25"):
        s.tokens(30)
    with pytest.raises(MXNetError, match="server failed"):
        srv.submit(_prompt(22, 4), max_new_tokens=2)
    assert len(_my_events("watchdog_fired", srv)) == 1
    assert telemetry.counter("serve_watchdog_fired_total",
                             server=srv.telemetry_label).value == 1


def test_late_wedged_dispatch_does_not_repin_pool(pair):
    """A wedged step that completes after the watchdog tore the server
    down leaves the pool released: no state, the accountant and
    ``stats()`` at 0 bytes."""
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       step_timeout=0.25, autostart=False)
    w = srv.submit(_prompt(24, 4), max_new_tokens=3)
    _drain(srv)                     # the programs are warm
    assert w.tokens(5) == _ref(pair[1], _prompt(24, 4), 3)
    assert telemetry.ACCOUNTANT.bytes(
        subsystem="serve.kv_pool", key=srv.telemetry_label) == \
        srv.stats()["pool_bytes"] > 0
    real_step = srv._progs._step
    entered, release = threading.Event(), threading.Event()

    def wedged(*a, **k):
        entered.set()
        release.wait(10)
        return real_step(*a, **k)

    srv._progs._step = wedged
    s = srv.submit(_prompt(25, 4), max_new_tokens=6)
    srv.start()
    assert entered.wait(10)
    with pytest.raises(MXNetError, match="watchdog"):
        s.tokens(30)
    assert srv._state is None
    release.set()
    srv._thread.join(10)
    assert srv._state is None
    assert telemetry.ACCOUNTANT.bytes(
        subsystem="serve.kv_pool", key=srv.telemetry_label) == 0
    assert srv.stats()["pool_bytes"] == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_fires_on_dead_pump_thread(pair):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       autostart=False)
    s = srv.submit(_prompt(23, 4), max_new_tokens=6)

    def die():
        raise SystemExit("thread torn down")

    srv.pump = die
    srv.start()
    with pytest.raises(MXNetError, match="watchdog.*died"):
        s.tokens(30)
    with pytest.raises(MXNetError, match="server failed"):
        srv.submit(_prompt(23, 4), max_new_tokens=2)


def test_cold_compile_does_not_trip_step_timeout(pair, monkeypatch):
    """A program's first call (and an admission bucket's) suspends the
    gauge: made ten times slower than ``step_timeout``, the first calls
    do not fire the watchdog and the requests serve."""
    from mxnet_tpu_torch.gluon import block
    from mxnet_tpu_torch.serve import engine

    real_admit = engine.PoolPrograms.admit
    real_call = block._GraphProgram.__call__

    def slow_admit(self, *a, **k):
        time.sleep(1.0)
        return real_admit(self, *a, **k)

    def slow_first(self):
        if self.calls == 0:
            time.sleep(1.0)
        return real_call(self)

    monkeypatch.setattr(engine.PoolPrograms, "admit", slow_admit)
    monkeypatch.setattr(block._GraphProgram, "__call__", slow_first)
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       step_timeout=0.2, spec=False)
    p = _prompt(26, 4)
    s = srv.submit(p, max_new_tokens=4)
    assert s.tokens(60) == _ref(pair[1], p, 4)
    monkeypatch.setattr(engine.PoolPrograms, "admit", real_admit)
    p2 = _prompt(27, 3)
    s2 = srv.submit(p2, max_new_tokens=3)
    assert s2.tokens(60) == _ref(pair[1], p2, 3)
    assert not _my_events("watchdog_fired", srv)
    srv.close()


def test_kernel_build_suspends_the_gauge(pair, monkeypatch):
    """While ``_build`` compiles a kernel the watchdog does not time the
    pump."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       step_timeout=0.1, autostart=False)
    w = srv.submit(_prompt(28, 4), max_new_tokens=3)
    _drain(srv)
    w.tokens(5)
    real_pump = srv.pump

    def building_pump():
        monkeypatch.setattr(_build, "building", 1)
        time.sleep(0.6)
        monkeypatch.setattr(_build, "building", 0)
        return real_pump()

    srv.pump = building_pump
    s = srv.submit(_prompt(29, 4), max_new_tokens=3)
    srv.start()
    assert s.tokens(30) == _ref(pair[1], _prompt(29, 4), 3)
    srv.pump = real_pump
    srv.close()
    assert not _my_events("watchdog_fired", srv)


@pytest.mark.parametrize("site", ["serve.pump", "serve.admit", "serve.step",
                                  "serve.chunk", "serve.verify"])
def test_fault_sites_surface_to_the_pump_caller(pair, monkeypatch, site):
    """Each of the five sites, armed at its first hit, raises the injected
    error out of ``pump()`` in both packages, after the same dispatches."""
    from mxnet_tpu.telemetry import faults as jfaults

    got = []
    for srv, _ in _both(pair, max_total_len=64, pool_sizes=(2,),
                        prefill_buckets=(8, 16), autostart=False):
        # a chunked prompt that repeats (its drafts verify) and a short
        # one (an admission)
        w = srv.submit(onp.tile(_prompt(30, 5), 4), max_new_tokens=8)
        srv.submit(_prompt(31, 5), max_new_tokens=8)
        monkeypatch.setenv("MXNET_FAULT_INJECT", f"{site}:raise:1")
        faults.reset_faults()
        jfaults.reset_faults()
        with pytest.raises(Exception, match=f"injected fault at {site}"):
            for _ in range(40):
                srv.pump()
        monkeypatch.delenv("MXNET_FAULT_INJECT")
        got.append((dict(srv.counters), w.done))
        srv.close(drain=False)
    jfaults.reset_faults()
    assert got[0] == got[1]


def test_timed_out_consumer_can_retry_and_drain(pair):
    from mxnet_tpu_torch.serve import DecodeServer

    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       autostart=False)
    p = _prompt(31, 4)
    s = srv.submit(p, max_new_tokens=5)
    with pytest.raises(MXNetError, match="not finished"):
        s.tokens(timeout=0.02)
    srv.pump()
    with pytest.raises(MXNetError, match="not finished"):
        s.tokens(timeout=0.02)
    _drain(srv)
    ref = _ref(pair[1], p, 5)
    assert s.tokens(5) == ref and s.tokens(5) == ref
    got = []
    th = threading.Thread(target=lambda: got.append(s.tokens(5)))
    th.start()
    th.join(5.0)
    assert not th.is_alive() and got == [ref]
    srv.close()


# --------------------------------------------------------------------- #
# sync mode
# --------------------------------------------------------------------- #

def _comparable_stats(st):
    """``stats()`` without the figures that differ by package (the
    label, the priced bytes: the port's slot columns are int64) or by
    host timing (the latency histograms' values)."""
    out = {k: v for k, v in st.items()
           if k not in ("server", "pool_bytes", "page_bytes", "ttft",
                        "token_gap", "queue_wait")}
    for k in ("ttft", "token_gap", "queue_wait"):
        out[k + "_count"] = st[k]["count"]
    return out


def test_env_sync_mode_serves_through_kv_generate(pair, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_SYNC", "1")
    got = []
    for srv, _ in _both(pair, max_total_len=64, autostart=False,
                        eos_id=None):
        ps = [_prompt(40 + i, 3 + i) for i in range(3)]
        ss = [srv.submit(p, max_new_tokens=4 + i, seed=i)
              for i, p in enumerate(ps)]
        _drain(srv)
        got.append(([s.tokens(5) for s in ss], srv.sync_mode,
                    srv.sync_reason, dict(srv.counters),
                    _comparable_stats(srv.stats())))
        srv.close()
    assert got[0] == got[1]
    assert got[1][3]["sync_requests"] == 3 and \
        got[1][3]["step_dispatches"] == 0
    assert got[1][4]["ttft_count"] == 3
    st = srv.stats()
    assert st["sync_mode"] and st["pool_bytes"] == 0


def test_gate_rejected_model_falls_back(monkeypatch):
    """A model the slot-pool gate rejects (a non-uniform layer stack)
    serves through ``kv_generate``, the reason recorded, as the
    reference's does."""
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer

    net = jax_gpt()
    net.blocks[1].ln1._eps = 1e-3
    model = port_gpt(net)
    model.blocks[1].ln1.eps = 1e-3
    got = []
    for cls, m in ((JServer, net), (DecodeServer, model)):
        srv = cls(m, max_total_len=64, autostart=False)
        p = _prompt(45, 4)
        s = srv.submit(p, max_new_tokens=4)
        _drain(srv)
        got.append((srv.sync_mode, "stacked" in srv.sync_reason,
                    s.tokens(5), dict(srv.counters)))
        srv.close()
    assert got[0] == got[1] and got[1][0] and got[1][1]


def test_sync_mode_budget_warns_inert(pair, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeServer

    monkeypatch.setenv("MXNET_SERVE_SYNC", "1")
    with pytest.warns(UserWarning, match="NOT enforced in sync mode"):
        srv = DecodeServer(pair[1], max_total_len=64, hbm_budget="1G",
                           autostart=False)
    srv.close()


# --------------------------------------------------------------------- #
# stats, counters and events
# --------------------------------------------------------------------- #

def test_stats_and_counters_match_reference(pair):
    """``set(stats())`` and ``set(counters)`` are the reference's, and
    for the same run so are the values (timing and priced bytes
    aside)."""
    got = []
    for srv, clk in _both(pair, max_total_len=64, pool_sizes=(1, 2),
                          prefill_buckets=(8, 16), autostart=False):
        fresh = srv.stats()
        ss = [srv.submit(onp.tile(_prompt(50, 5), 4), max_new_tokens=8),
              srv.submit(_prompt(51, 6), max_new_tokens=6),
              srv.submit(_prompt(52, 4), max_new_tokens=6, deadline=2.5)]
        while srv.pump():
            clk.advance(1.0)
        st = srv.stats()
        got.append((set(fresh), list(srv.counters), set(st),
                    _comparable_stats(st), [s.tokens(5) for s in ss]))
        srv.close()
    assert got[0] == got[1]
    assert "sync_requests" in got[1][1]
    assert {"server", "sync_mode", "hbm_budget", "ttft", "token_gap",
            "queue_wait", "pool_bytes"} <= got[1][2]


def test_counter_view_is_dict_api_over_registry():
    from mxnet_tpu.serve.server import _CounterView as JView
    from mxnet_tpu_torch.serve.server import _CounterView

    v = _CounterView("t_port_view_srv")
    assert list(v) == list(JView("t_ref_view_srv"))
    v.inc("step_dispatches")
    v["step_dispatches"] += 2
    assert v["step_dispatches"] == 3
    assert telemetry.counter("serve_step_dispatches_total",
                             server="t_port_view_srv").value == 3
    for k in v:
        v[k] = 0
    assert dict(v) == {k: 0 for k in v}
    with pytest.raises(MXNetError):
        del v["step_dispatches"]


def test_module_aggregate_reset_is_locked():
    """``reset_serve_counters`` racing ``_bump`` loses no count: every
    bump lands before a reset (erased with the aggregate) or after."""
    from mxnet_tpu_torch.serve import server as smod

    smod.reset_serve_counters()
    stop = threading.Event()

    def resetter():
        while not stop.is_set():
            smod.reset_serve_counters()

    t = threading.Thread(target=resetter)
    t.start()
    try:
        for _ in range(20000):
            smod._bump("step_dispatches")
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    smod.reset_serve_counters()
    assert smod.serve_counters["step_dispatches"] == 0
    assert set(smod.serve_counters) == set(smod._CounterView._KEYS)


def test_telemetry_of_a_served_run(pair):
    """One served run's telemetry: ``serve_config`` at construction, one
    TTFT observation and one ``serve_request`` a request, the counters in
    ``render_prometheus()``, the pool in the accountant, one ``compile``
    event for the step program, ``serve_stats`` at close, and the module
    aggregate counting the dispatches."""
    from mxnet_tpu_torch.serve import DecodeServer, server as smod

    before = dict(smod.serve_counters)
    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(2,),
                       spec=False, autostart=False)
    label = srv.telemetry_label
    ss = [srv.submit(_prompt(60 + i, 4), max_new_tokens=5) for i in range(3)]
    _drain(srv)
    [s.tokens(5) for s in ss]
    assert _my_events("serve_config", srv)[0]["pool_sizes"] == [2]
    assert telemetry.histogram("serve_ttft_seconds",
                               server=label).count == 3
    assert len(_my_events("serve_request", srv)) == 3
    text = telemetry.render_prometheus()
    n = srv.counters["step_dispatches"]
    assert f'serve_step_dispatches_total{{server="{label}"}} {n}' in text
    assert telemetry.ACCOUNTANT.bytes(subsystem="serve.kv_pool",
                                      key=label) == \
        srv.stats()["pool_bytes"] == telemetry.nbytes_of(srv._state)
    comp = [e for e in telemetry.events("compile")
            if e.get("server") == label]
    assert [e["site"] for e in comp] == ["serve.step"]
    assert comp[0]["key"] == str((label, 2))
    assert smod.serve_counters["step_dispatches"] - \
        before["step_dispatches"] >= n
    srv.close()
    st = _my_events("serve_stats", srv)
    assert len(st) == 1 and st[0]["counters"]["step_dispatches"] == n
    assert telemetry.ACCOUNTANT.bytes(subsystem="serve.kv_pool",
                                      key=label) == 0


def test_telemetry_off_serves_unwatched(pair, monkeypatch):
    from mxnet_tpu_torch.serve import DecodeServer

    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    n0 = len(telemetry.events())
    srv = DecodeServer(pair[1], max_total_len=64, pool_sizes=(1,),
                       autostart=False)
    p = _prompt(65, 3)
    s = srv.submit(p, max_new_tokens=4)
    _drain(srv)
    assert s.tokens(5) == _ref(pair[1], p, 4)
    assert srv._progs.step_program.watch is None
    assert srv.counters["step_dispatches"] >= 1
    srv.close()
    assert len(telemetry.events()) == n0


# --------------------------------------------------------------------- #
# models.decode_step_program
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("batch", [1, 2])
def test_decode_step_program_matches_reference(family, batch):
    """One call of the port's step program gives the reference's
    ``next_tok`` for the same token, position and caches (greedy)."""
    import jax.numpy as jnp
    from mxnet_tpu.models import decode_step_program as jprog
    from mxnet_tpu_torch.models import decode_step_program

    net = jax_gpt() if family == "gpt" else jax_llama()
    model = port_gpt(net) if family == "gpt" else port_llama(net)
    total, pos = 16, 9
    jfn, jargs = jprog(net, batch=batch, total=total)
    fn, args = decode_step_program(model, batch=batch, total=total)
    rs = onp.random.RandomState(batch)
    ck = (rs.standard_normal(args[2].shape) * 0.5).astype(onp.float32)
    cv = (rs.standard_normal(args[3].shape) * 0.5).astype(onp.float32)
    ck[..., pos:, :] = 0
    cv[..., pos:, :] = 0
    tok = rs.randint(0, 97, (batch,))
    want, jck, _ = jfn(*jargs[:4], jnp.asarray(tok, jnp.int32),
                       jnp.asarray(pos, jnp.int32), jnp.asarray(ck),
                       jnp.asarray(cv), jargs[8])
    got, pck, _ = fn(torch.as_tensor(tok), pos, torch.as_tensor(ck),
                     torch.as_tensor(cv), 0)
    assert got.tolist() == onp.asarray(want).tolist()
    onp.testing.assert_allclose(pck.numpy()[..., pos, :],
                                onp.asarray(jck)[..., pos, :],
                                rtol=1e-5, atol=1e-5)
    # the example arguments run as they are, a second time too
    a = fn(*args)[0]
    assert a.tolist() == fn(*args)[0].tolist()
    assert fn.program.watch is not None


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #

@pytest.mark.cuda
def test_captured_step_retires_by_clock_on_card():
    """The step's clock is a device operand, not a constant of the
    graph: after its capture, two replays at two values of ``now``
    straddling a slot's deadline retire the slot at the second and not
    the first."""
    need_cuda()
    from mxnet_tpu_torch.models import GPT, GPTConfig
    from mxnet_tpu_torch.serve import PoolPrograms, pool_state_init
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    model = GPT(GPTConfig(vocab_size=97, max_length=64, num_layers=2,
                          units=32, num_heads=4, hidden_size=64))
    model.initialize(0.15, seed=0)
    progs = PoolPrograms(_DecodeEngine(model), 2, 64, page_size=16)
    state = pool_state_init(progs)
    rows = onp.arange(2 * progs.maxp).reshape(2, progs.maxp)
    state["active"].fill_(True)
    state["stop"].fill_(60)
    state["dl"].copy_(torch.tensor([5.0, float("inf")]))
    for _ in range(2):                  # the eager call, then the capture
        progs.step(state, rows, 1.0)
    state["active"].fill_(True)
    assert progs.step_program.graph is not None
    done1 = progs.step(state, rows, 4.0)[2].cpu().tolist()
    done2 = progs.step(state, rows, 5.0)[2].cpu().tolist()
    assert done1 == [False, False] and done2 == [True, False]
    assert progs.step_program.replays >= 2
