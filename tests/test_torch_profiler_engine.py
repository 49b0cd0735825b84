"""``mx.profiler`` and ``mx.engine`` of the port against the JAX
package's, on the CPU.

- the aggregate table: the same ops called in both packages while
  profiling give the same names and call counts (times differ); ``pause``
  keeps the table and ``resume`` adds to it; ``dumps(reset=True)``
  empties it; ``dump`` writes the table and the trace;
- ``Counter`` (a telemetry gauge shared by name), ``Marker`` (a telemetry
  event), ``Domain``, ``Scope``, ``Task``/``Frame``; ``set_config``
  refusing an unknown key; ``set_state``/``state``;
- ``device_dumps(by="tf_op"|"name"|"category"|"source")`` over the
  last window;
- ``MXNET_ENGINE_TYPE=NaiveEngine``: ``engine_type``, and a small MLP's
  forward, loss, gradients and SGD step equal the threaded engine's bit
  for bit; ``bulk``/``set_bulk_size`` as the reference's.
On the card (``cuda``): the flash kernels in ``device_dumps``.
"""
import contextlib
import json
import re

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference, need_cuda

rmx = LazyReference()


def _calls(table):
    out = {}
    for line in table.splitlines()[2:]:
        m = re.match(r"^(\S+)\s+(\d+)\s", line)
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


def _ops(pkg, n_dot):
    a = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    with (pmx.cpu() if pkg is pmx else contextlib.nullcontext()):
        x = pkg.nd.array(a)
        for _ in range(n_dot):
            pkg.nd.dot(x, x.T)
        pkg.nd.relu(x)


@pytest.fixture
def clean_profilers(tmp_path):
    for pkg in (rmx, pmx):
        pkg.profiler.set_config(filename=str(tmp_path / f"{pkg.__name__}.json"),
                                aggregate_stats=True)
        pkg.profiler.dumps(reset=True)
    yield
    for pkg in (rmx, pmx):
        pkg.profiler.stop()
        pkg.profiler.dumps(reset=True)


def test_aggregate_table_counts_match_the_reference(clean_profilers):
    tables = []
    for pkg in (rmx, pmx):
        pkg.profiler.start()
        _ops(pkg, 3)
        pkg.profiler.stop()
        tables.append(_calls(pkg.profiler.dumps()))
    ref, got = tables
    assert got["dot"] == ref["dot"] == 3
    assert got["relu"] == ref["relu"] == 1
    assert got == {k: v for k, v in ref.items() if k in got}


def test_pause_keeps_the_stats_and_reset_empties(clean_profilers):
    for pkg in (rmx, pmx):
        pkg.profiler.start()
        _ops(pkg, 1)
        pkg.profiler.pause()
        assert pkg.profiler.state() == "stop"
        _ops(pkg, 5)                       # not counted
        pkg.profiler.resume()
        _ops(pkg, 1)
        pkg.profiler.stop()
        assert _calls(pkg.profiler.dumps(reset=True))["dot"] == 2
        assert "dot" not in _calls(pkg.profiler.dumps())


def test_dump_writes_the_table_and_the_trace(clean_profilers, tmp_path):
    pmx.profiler.set_state("run")
    assert pmx.profiler.state() == "run"
    with pmx.profiler.Scope("outer"):
        _ops(pmx, 2)
    pmx.profiler.set_state("stop")
    pmx.profiler.dump()
    table = json.loads((tmp_path / "mxnet_tpu_torch.json").read_text())
    names = {e["name"]: e["args"]["calls"] for e in table["traceEvents"]}
    assert names["dot"] == 2
    trace = json.loads((tmp_path / "mxnet_tpu_torch_trace" /
                        "trace.json").read_text())
    assert any(e.get("name") == "outer" for e in trace["traceEvents"])


def test_device_dumps_by_name_and_category(clean_profilers):
    pmx.profiler.start()
    _ops(pmx, 2)
    pmx.profiler.stop()
    by_name = pmx.profiler.device_dumps(by="name")
    assert "aten::mm" in by_name or "aten::matmul" in by_name
    assert "TOTAL" in pmx.profiler.device_dumps(by="category")
    # tf_op (the default) names the registry op, source the caller's line
    assert "dot" in pmx.profiler.device_dumps()
    assert "test_torch_profiler_engine.py:" in \
        pmx.profiler.device_dumps(by="source")
    with pytest.raises(ValueError):
        pmx.profiler.device_dumps(by="nope")


def test_set_config_refuses_unknown_keys():
    for pkg in (rmx, pmx):
        with pytest.raises(pkg.base.MXNetError, match="unknown config"):
            pkg.profiler.set_config(profile_imperativ=True)


def test_counter_marker_domain_task():
    dom = pmx.profiler.Domain("dom_")
    c = pmx.profiler.Counter(dom, "steps", value=5)
    c += 3
    c.decrement(2)
    assert c.value == 6
    twin = pmx.profiler.Counter(dom, "steps")
    assert twin.value == 6                 # one gauge by name, not reset
    assert pmx.telemetry.gauge("profiler_counter",
                               counter="dom_steps").value == 6
    pmx.telemetry.clear_events()
    pmx.profiler.Marker(dom, "here").mark()
    ev = pmx.telemetry.events(kind="marker")
    assert ev and ev[-1]["name"] == "dom_here"
    t = pmx.profiler.Task(dom, "work")
    t.start()
    _ops(pmx, 1)
    t.stop()
    assert pmx.profiler.Frame is pmx.profiler.Task


def _mlp_step():
    """One SGD step of a small MLP: the loss, the gradients and the
    updated weights."""
    pmx.random.seed(0)
    with pmx.cpu():
        net = pmx.gluon.nn.HybridSequential()
        net.add(pmx.gluon.nn.Dense(16, activation="relu", in_units=8),
                pmx.gluon.nn.Dense(3, in_units=16))
        net.initialize(pmx.init.Xavier())
        x = pmx.nd.array(onp.random.RandomState(1).rand(4, 8))
        y = pmx.nd.array(onp.random.RandomState(2).rand(4, 3))
    tr = pmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    with pmx.autograd.record():
        L = pmx.gluon.loss.L2Loss()(net(x), y)
    L.backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()]
    tr.step(4)
    return L.asnumpy(), grads, [p.data().asnumpy()
                                for p in net.collect_params().values()]


def test_naive_engine_equals_the_threaded_engine(monkeypatch):
    monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    assert pmx.engine.engine_type() == "ThreadedEnginePerDevice"
    threaded = _mlp_step()
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert pmx.engine.engine_type() == rmx.engine.engine_type() == \
        "NaiveEngine"
    assert pmx.engine.is_naive_engine()
    naive = _mlp_step()
    onp.testing.assert_array_equal(naive[0], threaded[0])
    for a, b in zip(naive[1] + naive[2], threaded[1] + threaded[2]):
        onp.testing.assert_array_equal(a, b)
    pmx.engine.wait_all()


def test_bulk_size_is_recorded():
    for pkg in (rmx, pmx):
        prev = pkg.engine.set_bulk_size(7)
        with pkg.engine.bulk(3):
            assert pkg.engine.set_bulk_size(3) == 3
        assert pkg.engine.set_bulk_size(prev) == 7


@pytest.mark.cuda
def test_device_dumps_lists_the_flash_kernels_on_the_card():
    need_cuda()
    q = torch.randn(1, 2, 640, 64, device="cuda", dtype=torch.float16)
    pmx.profiler.start()
    out = pmx.ops.attention.flash_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    pmx.profiler.stop()
    assert out.dtype == torch.float16
    assert "flash_fwd_mma_kernel" in pmx.profiler.device_dumps(by="name",
                                                               limit=100)
