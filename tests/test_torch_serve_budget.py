"""The HBM budget and the pool pricing of the PyTorch port's
``DecodeServer`` against the JAX package (the reference's
``tests/test_memory.py`` serving cases, on the port).

The two packages price the same configuration differently (the port's
slot columns are int64 and its pool keeps a trash page), so each budget
is set by each package's own pricing and the behaviour is held against
the reference's: the same refusals with the same kind of message, the
same admissions and the same streams.  The port's figures are held
against the tensors it allocates: ``pool_state_bytes`` against
``telemetry.nbytes_of`` of the state at init and after growth, for
native and int8 pages, and ``admit_scratch_bytes`` against the K/V pair
an admission's prefill computes."""
import numpy as onp
import pytest
import torch

from _torch_parity import jax_gpt, port_gpt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError

TINY = dict(init=0.02, vocab_size=64, max_length=24, units=16, num_heads=2,
            hidden_size=32)


@pytest.fixture(scope="module")
def pair():
    net = jax_gpt(**TINY)
    return net, port_gpt(net)


def _servers():
    from mxnet_tpu.serve import DecodeServer as JServer
    from mxnet_tpu_torch.serve import DecodeServer
    return JServer, DecodeServer


def _models(pair):
    J, P = _servers()
    return ((J, pair[0]), (P, pair[1]))


def _pool1_bytes(cls, model):
    """Bytes of a 1-slot pool at T=24, by the server's own pricing."""
    srv = cls(model, max_total_len=24, pool_sizes=(1,), autostart=False)
    try:
        return srv.stats()["pool_bytes"]
    finally:
        srv.close()


def _drain(srv):
    while srv.pump():
        pass


def test_growth_over_budget_raises(pair):
    """At 2.5x the one-slot pool both packages serve at one slot and
    refuse the growth to two with an error naming requested against
    available bytes."""
    msgs = []
    for cls, m in _models(pair):
        srv = cls(m, max_total_len=24, pool_sizes=(1, 2),
                  hbm_budget=int(_pool1_bytes(cls, m) * 2.5),
                  autostart=False)
        try:
            one = srv.submit(onp.array([7, 8, 9]), max_new_tokens=4)
            _drain(srv)
            assert len(one.tokens(30)) == 4
            srv.submit(onp.array([1, 2, 3]), max_new_tokens=6)
            srv.submit(onp.array([4, 5, 6]), max_new_tokens=6)
            with pytest.raises(Exception, match=r"pool growth 1 -> 2") as ei:
                _drain(srv)
            msgs.append(str(ei.value))
            assert srv.stats()["num_slots"] == 1
        finally:
            srv.close(drain=False)
    for msg in msgs:
        assert "requests" in msg and "remains" in msg
        assert "KiB" in msg or " B" in msg
        assert "MXNET_SERVE_HBM_BUDGET" in msg
    assert type(msgs[1]) is str and msgs[1].startswith(
        "serve HBM budget exceeded: pool growth 1 -> 2 slots requests ")


def test_growth_priced_at_transient_peak(pair):
    for cls, m in _models(pair):
        srv = cls(m, max_total_len=24, pool_sizes=(1, 2),
                  hbm_budget=int(_pool1_bytes(cls, m) * 2.2),
                  autostart=False)
        try:
            srv.submit(onp.array([1, 2]), max_new_tokens=6)
            srv.submit(onp.array([3, 4]), max_new_tokens=6)
            with pytest.raises(Exception, match="pool growth"):
                _drain(srv)
        finally:
            srv.close(drain=False)


@pytest.mark.parametrize("budget,match", [
    (16, "initial pool"), (None, "smallest admission wave")])
def test_construction_refuses_an_unusable_budget(pair, budget, match):
    """A budget the smallest pool cannot fit, or one the pool fits but
    the smallest admission wave's scratch does not, fails at
    construction."""
    for cls, m in _models(pair):
        b = budget if budget is not None else _pool1_bytes(cls, m) + 100
        with pytest.raises(Exception, match=match):
            cls(m, max_total_len=24, pool_sizes=(1,), hbm_budget=b,
                autostart=False)


def test_admission_wave_clamped_to_budget(pair):
    """A burst whose A=2 wave's scratch would pass the budget admits in
    two A=1 waves, every request served, in both packages."""
    from mxnet_tpu_torch.serve import (PoolPrograms, admit_scratch_bytes,
                                       pool_state_bytes)
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    progs = PoolPrograms(_DecodeEngine(pair[1]), 2, 24)
    port_budget = pool_state_bytes(progs) + admit_scratch_bytes(progs, 1) \
        + 100
    assert port_budget < pool_state_bytes(progs) + \
        admit_scratch_bytes(progs, 2)
    got = []
    for (cls, m), budget in zip(_models(pair), (
            int(_pool1_bytes(*_models(pair)[0]) * 3) + 100, port_budget)):
        srv = cls(m, max_total_len=24, pool_sizes=(2,), hbm_budget=budget,
                  autostart=False)
        try:
            a = srv.submit(onp.array([1, 2, 3]), max_new_tokens=4)
            b = srv.submit(onp.array([4, 5, 6]), max_new_tokens=4)
            _drain(srv)
            got.append((a.tokens(30), b.tokens(30),
                        srv.counters["admit_dispatches"]))
        finally:
            srv.close(drain=False)
    assert got[0] == got[1] and got[1][2] == 2


def test_admission_unserveable_after_growth_raises(pair):
    """When even the smallest wave's scratch no longer fits beside the
    grown pool, admission refuses before the wave touches the slot table:
    nothing in flight, both requests still pending."""
    from mxnet_tpu_torch.serve import PoolPrograms, pool_state_bytes
    from mxnet_tpu_torch.models.decoding import _DecodeEngine

    progs = PoolPrograms(_DecodeEngine(pair[1]), 1, 24)
    # fits the constructor's pool(1) + scratch(2) and the growth's
    # transient pool(2) + pool(1), not pool(2) + scratch(2)
    port_budget = pool_state_bytes(progs, 2) + pool_state_bytes(progs) + 1
    states = []
    for (cls, m), budget in zip(_models(pair), (
            int(_pool1_bytes(*_models(pair)[0]) * 3.5), port_budget)):
        srv = cls(m, max_total_len=24, pool_sizes=(1, 2), admit_sizes=(2,),
                  hbm_budget=budget, autostart=False)
        try:
            srv.submit(onp.array([1, 2, 3]), max_new_tokens=4)
            srv.submit(onp.array([4, 5, 6]), max_new_tokens=4)
            with pytest.raises(Exception, match="admission wave"):
                _drain(srv)
            st = srv.stats()
            states.append((st["in_flight"], st["pending"], st["num_slots"]))
        finally:
            srv.close(drain=False)
    assert states[0] == states[1] == (0, 2, 2)


def test_env_and_kwarg_budget(pair, monkeypatch):
    J, P = _servers()
    for cls, m in _models(pair):
        monkeypatch.setenv("MXNET_SERVE_HBM_BUDGET", "64M")
        srv = cls(m, max_total_len=24, pool_sizes=(1,), autostart=False)
        assert srv.hbm_budget == 64 << 20
        srv.close()
        monkeypatch.setenv("MXNET_SERVE_HBM_BUDGET", "plenty")
        with pytest.raises(Exception, match="MXNET_SERVE_HBM_BUDGET"):
            cls(m, max_total_len=24, pool_sizes=(1,), autostart=False)
        monkeypatch.delenv("MXNET_SERVE_HBM_BUDGET")
    srv = P(pair[1], max_total_len=24, pool_sizes=(1,), hbm_budget="1G",
            autostart=False)
    assert srv.hbm_budget == 1 << 30
    s = srv.submit(onp.array([5, 6]), max_new_tokens=3)
    _drain(srv)
    assert len(s.tokens(30)) == 3
    srv.close()
    assert telemetry.ACCOUNTANT.bytes(subsystem="serve.kv_pool",
                                      key=srv.telemetry_label) == 0


# --------------------------------------------------------------------- #
# pricing against allocation
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pool_state_bytes_match_the_allocated_state(pair, kv_dtype):
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve import (PoolPrograms, pool_state_bytes,
                                       pool_state_grow, pool_state_init)

    progs = PoolPrograms(_DecodeEngine(pair[1]), 1, 24, kv_dtype=kv_dtype)
    state = pool_state_init(progs)
    assert telemetry.nbytes_of(state) == pool_state_bytes(progs)
    assert state["dl"].dtype == torch.float32 and \
        bool(torch.isinf(state["dl"]).all())
    grown = pool_state_grow(state, 3, 3 * progs.maxp)
    assert telemetry.nbytes_of(grown) == \
        pool_state_bytes(progs, 3, num_pages=3 * progs.maxp)
    assert bool(torch.isinf(grown["dl"]).all())


def test_admit_scratch_bytes_match_the_prefill(pair):
    """The priced admission scratch is the dense K/V pair the wave's
    prefill computes at the largest prompt it can take, plus the wave's
    slot-state rows."""
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve import (PoolPrograms, admit_scratch_bytes,
                                       schema)

    eng = _DecodeEngine(pair[1])
    for kv in ("native", "int8"):
        progs = PoolPrograms(eng, 2, 24, page_size=8, kv_dtype=kv)
        for A in (1, 2):
            _, knew, vnew = eng.prefill(torch.zeros((A, progs.Tp),
                                                    dtype=torch.int64))
            assert admit_scratch_bytes(progs, A) == \
                telemetry.nbytes_of((knew, vnew)) + \
                A * schema.slot_state_bytes()


def test_int8_pool_shrinks_pages(pair):
    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve import PoolPrograms, pool_state_bytes

    eng = _DecodeEngine(pair[1])
    f32 = PoolPrograms(eng, 2, 24)
    i8 = PoolPrograms(eng, 2, 24, kv_dtype="int8")
    assert i8.page_bytes() * 2 < f32.page_bytes()
    assert pool_state_bytes(i8) * 2 < pool_state_bytes(f32)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pool_bytes_truthful_under_page_reuse(pair, kv_dtype):
    """Admission and retirement recycle pages in place: ``stats()`` and
    the accountant keep the state's bytes."""
    from mxnet_tpu_torch.serve import pool_state_bytes

    _, P = _servers()
    srv = P(pair[1], max_total_len=24, pool_sizes=(1,), prefix_cache=False,
            autostart=False, kv_dtype=kv_dtype)
    try:
        b0 = srv.stats()["pool_bytes"]
        assert b0 == pool_state_bytes(srv._progs) == \
            telemetry.nbytes_of(srv._state) > 0
        for seed in range(3):
            rng = onp.random.RandomState(seed)
            s = srv.submit(rng.randint(0, 64, (5,)), max_new_tokens=4)
            _drain(srv)
            s.tokens(10)
            st = srv.stats()
            assert st["pool_bytes"] == b0 and st["pages_in_use"] == 0
            assert telemetry.ACCOUNTANT.bytes(
                subsystem="serve.kv_pool", key=srv.telemetry_label) == b0
    finally:
        srv.close()


def test_fresh_server_stats_sensible_zeros(pair):
    got = []
    for cls, m in _models(pair):
        srv = cls(m, max_total_len=24, pool_sizes=(1,), autostart=False)
        st = srv.stats()
        assert st["pool_bytes"] > 0 and st["hbm_budget"] is None
        for hist in ("ttft", "token_gap", "queue_wait"):
            assert st[hist]["count"] == 0 and st[hist]["p50"] is None
        assert all(v == 0 for v in st["counters"].values())
        srv.close()
        st2 = srv.stats()
        got.append((sorted(st), st["steps"], st["occupancy"],
                    st2["in_flight"], st2["pool_bytes"], srv._state))
    assert got[0] == got[1]
    assert got[1][4] == 0 and got[1][5] is None


def test_sync_mode_pool_bytes_zero(pair, monkeypatch):
    _, P = _servers()
    monkeypatch.setenv("MXNET_SERVE_SYNC", "1")
    srv = P(pair[1], max_total_len=24, autostart=False)
    st = srv.stats()
    assert st["sync_mode"] and st["pool_bytes"] == 0
    assert st["page_bytes"] is None and st["pages_total"] == 0
    s = srv.submit(onp.array([1, 2]), max_new_tokens=2)
    srv.pump()
    assert len(s.tokens(30)) == 2
    srv.close()
    with pytest.raises(MXNetError, match="server is closed"):
        srv.submit(onp.array([1, 2]), max_new_tokens=2)


def test_schema_declares_the_engine_and_the_state(pair):
    """``serve/schema.py`` is the declaration: every unit of work's
    method takes the state, then exactly the declared operands in order,
    and ``pool_state_init`` allocates the declared columns with their
    dtypes."""
    import inspect

    from mxnet_tpu_torch.models.decoding import _DecodeEngine
    from mxnet_tpu_torch.serve import PoolPrograms, pool_state_init, schema

    for name, ops in schema.PROGRAMS.items():
        params = list(inspect.signature(
            getattr(PoolPrograms, name)).parameters)
        assert params[:2] == ["self", "state"]
        assert tuple(params[2:]) == ops, name
        assert schema.operands(name)[len(schema.state_operands()):] == ops
    state = pool_state_init(PoolPrograms(_DecodeEngine(pair[1]), 2, 24))
    assert tuple(state) == schema.state_operands()
    for col, dtype, n in schema.SLOT_STATE:
        assert str(state[col].dtype) == f"torch.{dtype}"
        assert state[col].shape == (2 * n,)
    with pytest.raises(ValueError, match="no serve program"):
        schema.operands("prefill")
