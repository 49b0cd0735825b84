"""The port's ``telemetry`` package (registry, events, faults, memory, the
capture watch) held against the JAX package's, case for case: the same
calls give the same values, the same Prometheus text, the same
fault-spec errors and the same byte tables.

The registries, event rings and accountants are process-wide, so each
case uses names of its own and compares fresh ``Registry`` objects where
it compares whole exports."""
import json
import threading
import time

import numpy as onp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st


@pytest.fixture(scope="module")
def ref():
    from mxnet_tpu import telemetry
    return telemetry


@pytest.fixture(scope="module")
def port():
    from mxnet_tpu_torch import telemetry
    return telemetry


def _both(ref, port):
    return (("ref", ref), ("port", port))


def _errors():
    from mxnet_tpu.base import MXNetError as JErr
    from mxnet_tpu_torch.base import MXNetError as PErr
    return JErr, PErr


def _outcome(fn, *args):
    """``("ok", value)`` or ``("error", message)``: the same call on both
    packages must land on the same side with the same text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:      # both packages raise their MXNetError
        return ("error", type(e).__name__, str(e))


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #

def _registry_ops(reg):
    """One script of registry calls; returns what it observed."""
    out = []
    c = reg.counter("t_c", case="a")
    c.inc()
    c.inc(4)
    out.append(c.value)
    out.append(reg.counter("t_c", case="a") is c)
    out.append(reg.counter("t_c", case="b") is c)
    g = reg.gauge("t_g")
    g.set(2.5)
    g.add(0.5)
    out.append(g.value)
    h = reg.histogram("t_h")
    for v in (0.001, 0.003, 0.02, 0.4, 7.0, 100.0):
        h.observe(v)
    out.append(h.summary())
    out.append([h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 1.0)])
    out.append(reg.histogram("t_empty").summary())
    reg.histogram("t_buckets", buckets=(1.0, 0.1, 10.0)).observe(0.5)
    reg.counter("t_escape", path="a\\b", msg='say "hi"\nline2').inc()
    try:
        reg.gauge("t_c", case="a")
    except TypeError as e:
        out.append(str(e))
    out.append(reg.render_prometheus())
    out.append(reg.snapshot())
    reg.reset_metrics()
    out.append((c.value, g.value, h.summary()))
    return out


def test_registry_script_matches_reference(ref, port):
    from mxnet_tpu.telemetry.registry import Registry as JReg
    from mxnet_tpu_torch.telemetry.registry import Registry as PReg

    assert _registry_ops(PReg()) == _registry_ops(JReg())


def test_registry_names_and_buckets(ref, port):
    assert port.DEFAULT_LATENCY_BUCKETS == ref.DEFAULT_LATENCY_BUCKETS
    for name in ("Counter", "Gauge", "Histogram", "Registry", "counter",
                 "gauge", "histogram", "snapshot", "render_prometheus",
                 "reset_metrics", "emit", "events", "clear_events",
                 "add_sink", "remove_sink", "add_jsonl_sink", "JsonlSink",
                 "fault_point", "parse_fault_spec", "reset_faults",
                 "instrument_jit", "annotation", "span", "ACCOUNTANT",
                 "MemoryAccountant", "nbytes_of", "per_device_bytes",
                 "live_device_bytes", "parse_bytes", "format_bytes",
                 "reconcile", "memory_analysis", "mem_enabled"):
        assert hasattr(port, name), name
    assert port.instrument_jit is port.instrument_program


def test_concurrent_counter_increments_not_lost(port):
    c = port.counter("t_port_concurrent")
    N, per = 8, 5000

    def work():
        for _ in range(per):
            c.inc()

    ts = [threading.Thread(target=work) for _ in range(N)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == N * per


def test_module_helpers_share_one_registry(ref, port):
    for name, tel in _both(ref, port):
        c = tel.counter("t_mod_helper", pkg=name)
        c.inc(7)
        rows = tel.snapshot()["t_mod_helper"]
        assert any(r["value"] == 7 and r["labels"] == {"pkg": name}
                   for r in rows)
        assert f't_mod_helper{{pkg="{name}"}} 7' in tel.render_prometheus()


# --------------------------------------------------------------------- #
# events
# --------------------------------------------------------------------- #

def test_emit_ring_and_filter(ref, port):
    got = []
    for name, tel in _both(ref, port):
        tel.emit("t_ev_kind", n=1)
        tel.emit("t_ev_kind", n=2)
        tel.emit("t_ev_other")
        evs = tel.events("t_ev_kind")
        got.append([{k: v for k, v in e.items() if k != "ts"}
                    for e in evs[-2:]])
        assert all("ts" in e for e in tel.events())
    assert got[0] == got[1] == [{"kind": "t_ev_kind", "n": 1},
                                {"kind": "t_ev_kind", "n": 2}]


def test_ring_capacity_from_env(ref, port, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_EVENTS", "3")
    for _, tel in _both(ref, port):
        tel.clear_events()
        for i in range(5):
            tel.emit("t_ev_cap", i=i)
        assert [e["i"] for e in tel.events()] == [2, 3, 4]
    monkeypatch.delenv("MXNET_TELEMETRY_EVENTS")
    for _, tel in _both(ref, port):
        tel.clear_events()


def test_disabled_by_env(ref, port, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    for _, tel in _both(ref, port):
        assert tel.emit("t_ev_disabled") is None
        assert tel.events("t_ev_disabled") == []
        assert not tel.telemetry_enabled()


def test_jsonl_sink_writes_scalars(ref, port, tmp_path):
    rows = {}
    for name, tel in _both(ref, port):
        path = str(tmp_path / f"{name}.jsonl")
        sink = tel.add_jsonl_sink(path)
        try:
            tel.emit("t_ev_sink", value=onp.int32(3), f=onp.float32(0.5))
            if name == "port":
                tel.emit("t_ev_sink", value=torch.tensor(4),
                         f=torch.tensor(0.25))
        finally:
            tel.remove_sink(sink)
        tel.emit("t_ev_sink", value=9)      # after detach: not written
        with open(path) as fh:
            rows[name] = [json.loads(ln) for ln in fh]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"}  # noqa
                        for r in rs]
    assert strip(rows["port"])[:1] == strip(rows["ref"])
    assert strip(rows["port"])[1] == {"kind": "t_ev_sink", "value": 4,
                                      "f": 0.25}


def test_broken_sink_is_dropped_not_fatal(port):
    def bad(_ev):
        raise RuntimeError("boom")

    port.add_sink(bad)
    with pytest.warns(UserWarning, match="sink"):
        port.emit("t_ev_broken")
    port.emit("t_ev_broken")
    assert len(port.events("t_ev_broken")) >= 2


def test_rank_tag_from_env(ref, port, monkeypatch):
    monkeypatch.setenv("MXNET_WORKER_ID", "3")
    for _, tel in _both(ref, port):
        assert tel.emit("t_ev_rank")["rank"] == 3
        assert tel.emit("t_ev_rank", rank=1)["rank"] == 1


# --------------------------------------------------------------------- #
# span / annotation / capture watch
# --------------------------------------------------------------------- #

def test_span_observes_histogram(ref, port):
    for name, tel in _both(ref, port):
        with tel.span("t_span_phase", pkg=name) as h:
            time.sleep(0.001)
        assert h is tel.histogram("t_span_phase_seconds", pkg=name)
        assert h.count == 1 and h.sum > 0


def test_annotation_is_record_function_under_profiler(port):
    import contextlib

    assert isinstance(port.annotation("t_ann"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with port.annotation("mx:t_ann_range"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "mx:t_ann_range" in names


def test_capture_watch_emits_one_compile_event_a_program(port):
    """On the CPU a program's first call is its compile: one ``compile``
    event with the site, key, fields and seconds, and
    ``compiles_total{site=}`` one up; later calls emit nothing."""
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    x = torch.ones(3)
    prog = port.instrument_program(
        _GraphProgram(lambda: [x * 2], "cpu", None, [x]), "t.capture",
        key="k", fields={"extra": "f"})
    before = port.counter("compiles_total", site="t.capture").value
    n0 = len(port.events("compile"))
    assert prog()[0].tolist() == [2.0, 2.0, 2.0]
    prog()
    prog()
    evs = [e for e in port.events("compile")[n0:]
           if e.get("site") == "t.capture"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["key"] == "k" and ev["extra"] == "f"
    assert ev["seconds"] >= 0 and ev["kernel_nodes"] is None
    assert port.counter("compiles_total", site="t.capture").value == \
        before + 1


def test_capture_watch_off_by_env(port, monkeypatch):
    from mxnet_tpu_torch.gluon.block import _GraphProgram

    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    x = torch.ones(2)
    prog = _GraphProgram(lambda: [x + 1], "cpu", None, [x])
    assert port.instrument_jit(prog, "t.off") is prog
    assert prog.watch is None


# --------------------------------------------------------------------- #
# faults
# --------------------------------------------------------------------- #

@pytest.fixture
def fresh_faults(ref, port):
    ref.reset_faults()
    port.reset_faults()
    yield
    ref.reset_faults()
    port.reset_faults()


def test_parse_spec_matches_reference(ref, port):
    spec = "serve.step:raise:3, kvstore.push:delay:1:0.5,x:hang:2:1,y:kill:9"
    got = port.parse_fault_spec(spec)
    assert [tuple(r) for r in got] == \
        [tuple(r) for r in ref.parse_fault_spec(spec)]
    assert got[0] == ("serve.step", "raise", 3, None)
    assert got[1] == ("kvstore.push", "delay", 1, 0.5)


@pytest.mark.parametrize("bad", ["serve.step", "x:boom:1", "x:raise:zero",
                                 "x:raise:0", ":raise:1", "a:b:c:d:e",
                                 "x:delay:1:slow"])
def test_malformed_spec_same_error(ref, port, bad):
    j = _outcome(ref.parse_fault_spec, bad)
    p = _outcome(port.parse_fault_spec, bad)
    assert j[0] == p[0] == "error"
    assert j[2] == p[2] and "MXNET_FAULT_INJECT" in p[2]


def test_fires_once_on_nth_hit(ref, port, monkeypatch, fresh_faults):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "t.site:raise:3")
    seen = []
    for _, tel in _both(ref, port):
        tel.clear_events()
        got = [_outcome(tel.fault_point, s)
               for s in ("t.site", "t.other", "t.site", "t.site",
                         "t.site")]
        seen.append([g[0] if g[0] == "ok" else g[2] for g in got])
        evs = tel.events("fault_injected")
        assert len(evs) == 1 and evs[0]["site"] == "t.site"
        assert evs[0]["fault_kind"] == "raise"
    assert seen[0] == seen[1]
    assert seen[1][3] == "injected fault at t.site (MXNET_FAULT_INJECT, " \
                         "hit 3)"


def test_unset_is_noop_and_rearm_fires_again(port, monkeypatch,
                                             fresh_faults):
    from mxnet_tpu_torch.base import MXNetError

    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    port.clear_events()
    port.fault_point("anywhere")
    assert port.events("fault_injected") == []
    monkeypatch.setenv("MXNET_FAULT_INJECT", "t.re:raise:1")
    with pytest.raises(MXNetError, match="injected fault"):
        port.fault_point("t.re")
    monkeypatch.delenv("MXNET_FAULT_INJECT")
    port.fault_point("t.re")            # unset: the cache drops
    monkeypatch.setenv("MXNET_FAULT_INJECT", "t.re:raise:1")
    with pytest.raises(MXNetError, match="injected fault"):
        port.fault_point("t.re")


def test_reserved_context_keys_are_prefixed(ref, port, monkeypatch,
                                            fresh_faults):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "t.ctx:delay:1:0.001")
    got = []
    for _, tel in _both(ref, port):
        tel.clear_events()
        tel.fault_point("t.ctx", kind="colliding", ts="also", wave=2)
        ev = tel.events("fault_injected")[-1]
        got.append({k: v for k, v in ev.items() if k != "ts"})
    assert got[0] == got[1]
    assert got[1]["ctx_kind"] == "colliding" and got[1]["wave"] == 2


def test_delay_and_counter(port, monkeypatch, fresh_faults):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "t.slow:delay:1:0.05")
    t0 = time.monotonic()
    port.fault_point("t.slow")
    assert time.monotonic() - t0 >= 0.04
    assert port.counter("faults_injected_total", site="t.slow",
                        kind="delay").value >= 1


# --------------------------------------------------------------------- #
# memory
# --------------------------------------------------------------------- #

PARSE_CASES = [1024, "1024", "4k", "4K", "2M", "1.5G", "0.5T", " 7m ", "0",
               0, 3.9, "lots", -1, "-1k", "1e999", float("inf"),
               float("nan"), True, False, "", "k", "12KB", "1e3", "2.5"]


@pytest.mark.parametrize("raw", PARSE_CASES, ids=[repr(c)
                                                  for c in PARSE_CASES])
def test_parse_bytes_table(ref, port, raw):
    assert _outcome(port.parse_bytes, raw, "t_budget") == \
        _outcome(ref.parse_bytes, raw, "t_budget")


@settings(max_examples=200, deadline=None)
@given(st.one_of(
    st.integers(-2 ** 40, 2 ** 50),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(alphabet="0123456789.-+eEkKmMgGtT b", max_size=8),
    st.builds(lambda n, s: f"{n}{s}", st.floats(0, 1e6),
              st.sampled_from(["", "k", "M", "g", "T", "B"]))))
def test_parse_bytes_property(ref, port, raw):
    assert _outcome(port.parse_bytes, raw) == _outcome(ref.parse_bytes, raw)


@pytest.mark.parametrize("n", [0, 1, 512, 1023, 1024, 5 << 20, 3 << 29,
                               (1 << 40) + 7, -2048, 1.9e9])
def test_format_bytes_table(ref, port, n):
    assert port.format_bytes(n) == ref.format_bytes(n)


def test_nbytes_and_per_device(ref, port):
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as pmx

    assert port.nbytes_of(None) == ref.nbytes_of(None) == 0
    assert port.nbytes_of("not an array") == 0
    assert port.nbytes_of(onp.zeros((4, 4), onp.float32)) == 64
    assert port.nbytes_of(torch.zeros(8, dtype=torch.int32)) == \
        ref.nbytes_of(jnp.zeros((8,), jnp.int32)) == 32
    with pmx.cpu():
        nd = pmx.nd.array(onp.zeros((2, 2), onp.float32))
    assert port.nbytes_of(nd) == \
        ref.nbytes_of(jmx.nd.array(onp.zeros((2, 2), onp.float32))) == 16
    tree = {"a": [onp.zeros(2, onp.float64), None],
            "b": (torch.zeros(3), torch.zeros((2, 2), dtype=torch.bool))}
    assert port.nbytes_of(tree) == 16 + 12 + 4
    assert port.per_device_bytes(torch.zeros(4)) == {"cpu:0": 16}
    assert port.per_device_bytes(onp.zeros(4, onp.int8)) == \
        ref.per_device_bytes(onp.zeros(4, onp.int8)) == {"host:0": 4}


def _acct_script(tel, arr_a, arr_b, sub):
    A = tel.ACCOUNTANT
    out = []
    ev0 = len([e for e in tel.events("device_memory")
               if e.get("subsystem") == sub])
    A.set(sub, "k1", arr_a)
    out.append(A.bytes(subsystem=sub))
    A.set(sub, "k1", arr_a)                  # unchanged: no event
    A.set(sub, "k2", arr_b)
    out.append(A.bytes(subsystem=sub))
    out.append(sorted(A.snapshot()[sub].values()))
    A.drop(sub, "k1")
    A.drop(sub, "k2")
    A.drop(sub, "k2")                        # idempotent
    out.append(A.bytes(subsystem=sub))
    evs = [e for e in tel.events("device_memory")
           if e.get("subsystem") == sub][ev0:]
    out.append([(e["key"], e["bytes"], e["subsystem_bytes"]) for e in evs])
    A.set(sub, "d", per_device={"cpu:0": 64, "cpu:1": 50})
    out.append(A.bytes(subsystem=sub, device="cpu:1"))
    A.drop_deferred(sub, "d")
    A.drop_deferred(sub, "never-registered")
    out.append(A.bytes(subsystem=sub))
    out.append(sub in A.snapshot())
    return out


def test_accountant_matches_reference(ref, port):
    import jax.numpy as jnp

    j = _acct_script(ref, jnp.zeros((8, 8), jnp.float32),
                     jnp.zeros((4,), jnp.float32), "t.acct_cmp")
    p = _acct_script(port, torch.zeros((8, 8)), torch.zeros(4),
                     "t.acct_cmp")
    assert p == j
    assert p[0] == 256 and p[1] == 272
    g = port.gauge("device_bytes", subsystem="t.acct_cmp", device="cpu:0")
    assert g.value == 0


def test_live_bytes_reconcile_and_no_memory_analysis(port):
    from mxnet_tpu_torch.base import MXNetError

    assert port.live_device_bytes() == {}       # no card here
    A = port.ACCOUNTANT
    A.set("t.acct_rec", "arr", torch.ones((32, 32)))
    try:
        rec = port.reconcile()
        assert rec["cpu:0"]["accounted"] >= 32 * 32 * 4
        assert rec["cpu:0"]["live"] == 0 and rec["cpu:0"]["coverage"] is None
    finally:
        A.drop("t.acct_rec", "arr")
    with pytest.raises(MXNetError, match="no counterpart for a CUDA graph"):
        port.memory_analysis(object())
