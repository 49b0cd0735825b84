"""The port's trace parser (``mxnet_tpu_torch/profiler_trace.py``, the
counterpart of ``mxnet_tpu/profiler_xla.py``): a Chrome trace written
here with kernel, runtime, annotation and autograd events linked by
correlation id and sequence number; ``aggregate``/``format_table``
against the reference's on the same records; ``count_hlo_ops`` against
the reference's on its own test's HLO text; and ``device_dumps``,
``profile_fn`` and ``hlo_op_count`` on the CPU."""
import json

import numpy as onp
import pytest

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import profiler_trace as pt
from _torch_parity import LazyReference

rmx = LazyReference()

FWD, BWD = 100, 200             # host threads


def _x(cat, name, ts, dur, tid=FWD, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace(tmp_path, events, session="session_000000"):
    d = tmp_path / session
    d.mkdir(parents=True)
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


def _events():
    return [
        # the forward: flash_attention's range around the Function's op
        _x("user_annotation", "mx.op:flash_attention|model.py:42", 0, 50),
        _x("cpu_op", "_FlashAttention", 5, 40, **{"Sequence number": 7,
                                                  "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 3, correlation=1),
        _x("kernel", "flash_fwd_mma_kernel<__nv_bfloat16>", 20, 30.0,
           pid=0, tid=7, correlation=1),
        # a FullyConnected with two kernels and a copy
        _x("user_annotation", "mx.op:FullyConnected|model.py:50", 60, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 2, correlation=2),
        _x("kernel", "sm90_xmma_gemm_bf16", 70, 12.0, pid=0, tid=7,
           correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 70, 2, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoD", 85, 1.0, pid=0, tid=8,
           correlation=3, bytes=4096),
        # the backward on the autograd thread: the node of sequence 7
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "_FlashAttentionBackward", 300, 60, tid=BWD,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=BWD,
           correlation=4),
        _x("kernel", "flash_bwd_dq_mma_kernel<__nv_bfloat16>", 320, 25.0,
           pid=0, tid=7, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 330, 2, tid=BWD,
           correlation=5),
        _x("kernel", "flash_bwd_dkv_mma_kernel<__nv_bfloat16>", 350, 35.0,
           pid=0, tid=7, correlation=5),
        # a graph replay inside the fused step's annotation
        _x("user_annotation", "mx:fused_step:micro", 500, 100),
        _x("cuda_runtime", "cudaGraphLaunch", 510, 5, correlation=6),
        _x("kernel", "flash_fwd_mma_kernel<__nv_bfloat16>", 520, 31.0,
           pid=0, tid=7, correlation=6),
        _x("kernel", "elementwise_kernel", 560, 4.0, pid=0, tid=7,
           correlation=6),
        # an unattributed launch and a host-only op
        _x("cuda_runtime", "cudaLaunchKernel", 700, 2, correlation=9),
        _x("kernel", "some_kernel", 710, 2.0, pid=0, tid=7, correlation=9),
        _x("cpu_op", "aten::mm", 61, 20),
    ]


def test_parse_trace_links_kernels_to_their_ops(tmp_path):
    recs = pt.parse_trace(_trace(tmp_path, _events()))
    assert len(recs) == 8
    by = {(r["name"], r["dur_us"]): r for r in recs}
    fwd = by[("flash_fwd_mma_kernel<__nv_bfloat16>", 30.0)]
    assert set(fwd) == {"name", "category", "tf_op", "source", "long_name",
                        "dur_us", "flops", "bytes"}
    assert fwd["tf_op"] == "flash_attention"
    assert fwd["source"] == "model.py:42"
    assert fwd["category"] == "attention"
    # the backward kernels take their node's forward op
    for name in ("flash_bwd_dq_mma_kernel<__nv_bfloat16>",
                 "flash_bwd_dkv_mma_kernel<__nv_bfloat16>"):
        r = next(r for r in recs if r["name"] == name)
        assert r["tf_op"] == "flash_attention" and \
            r["source"] == "model.py:42"
    gemm = by[("sm90_xmma_gemm_bf16", 12.0)]
    assert (gemm["tf_op"], gemm["category"]) == ("FullyConnected", "matmul")
    copy = by[("Memcpy DtoD", 1.0)]
    assert copy["category"] == "copy" and copy["bytes"] == 4096
    replay = [r for r in recs if r["tf_op"] == "mx:fused_step:micro"]
    assert len(replay) == 2 and all(r["source"] == "" for r in replay)
    assert by[("some_kernel", 2.0)]["tf_op"] == ""
    assert all(r["flops"] == 0 for r in recs)


def test_kernel_names_keep_their_own_name_in_a_table(tmp_path):
    # CUDA C++ kernels in an anonymous namespace, as the port's own:
    # torch.profiler names them with the return type and the namespace
    long = ("void (anonymous namespace)::flash_fwd_mma_kernel<"
            "__nv_bfloat16, 64, 128, true>(FwdParams, unsigned int const*)")
    events = [
        _x("user_annotation", "mx.op:flash_attention|model.py:42", 0, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 3, correlation=1),
        _x("kernel", long, 20, 30.0, pid=0, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 3, correlation=2),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
           45, 2.0, pid=0, tid=7, correlation=2),
    ]
    recs = pt.parse_trace(_trace(tmp_path, events))
    assert [r["name"] for r in recs] == [
        "flash_fwd_mma_kernel<__nv_bfloat16, 64, 128, true>(FwdParams, "
        "unsigned int const*)",
        "at::native::vectorized_elementwise_kernel<4>()"]
    assert recs[0]["long_name"] == long
    assert [r["category"] for r in recs] == ["attention", "elementwise"]
    table = pt.format_table(pt.aggregate(recs, by="name"))
    assert "flash_fwd_mma_kernel<" in table
    assert pt.short_name("flash_fwd_mma_kernel") == "flash_fwd_mma_kernel"


def _reference_records():
    """Records with the keys both parsers give, some sharing a key."""
    rs = onp.random.RandomState(0)
    out = []
    for i in range(12):
        out.append({"name": f"k{i % 4}", "category": ["fusion", "copy",
                                                      "matmul"][i % 3],
                    "tf_op": ["flash_attention", "", "FullyConnected"][i % 3],
                    "source": f"model.py:{40 + i % 2}", "long_name": "",
                    "dur_us": float(rs.randint(1, 500)) / 4,
                    "flops": int(rs.randint(0, 10 ** 9)) * (i % 2),
                    "bytes": int(rs.randint(0, 10 ** 7))})
    return out


@pytest.mark.parametrize("by", ["category", "name", "tf_op", "source"])
def test_aggregate_and_format_table_equal_the_reference(by):
    from mxnet_tpu import profiler_xla as rx

    recs = _reference_records()
    assert pt.aggregate(recs, by=by) == rx.aggregate(recs, by=by)
    rows = pt.aggregate(recs, by=by)
    for peak in (None, 989.0):
        assert pt.format_table(rows, peak_tflops=peak, limit=5) == \
            rx.format_table(rows, peak_tflops=peak, limit=5)


def test_count_hlo_ops_equals_the_reference():
    from mxnet_tpu import profiler_xla as rx
    from test_profiler_xla import _HLO_SAMPLE

    assert pt.count_hlo_ops(_HLO_SAMPLE) == rx.count_hlo_ops(_HLO_SAMPLE) \
        == 6


def test_latest_session(tmp_path):
    with pytest.raises(FileNotFoundError):
        pt.latest_session(str(tmp_path))
    _trace(tmp_path, [], "session_000000")
    _trace(tmp_path, [], "session_000001")
    assert pt.latest_session(str(tmp_path)).endswith("session_000001")


@pytest.fixture
def clean_profiler():
    pmx.profiler.stop()
    yield
    pmx.profiler.stop()


def _step(x, w):
    with pmx.autograd.record():
        y = pmx.nd.sum(pmx.nd.relu(pmx.nd.dot(x, w)))
    y.backward()
    return y


def test_device_dumps_by_tf_op_on_the_cpu(clean_profiler):
    with pmx.cpu():
        x = pmx.nd.array(onp.ones((4, 8), onp.float32))
        w = pmx.nd.array(onp.ones((8, 3), onp.float32))
        w.attach_grad()
        pmx.profiler.start()
        _step(x, w)
        pmx.profiler.stop()
    table = pmx.profiler.device_dumps()
    header = table.splitlines()[0]
    assert header.startswith("Op") and "TFLOP/s" in header
    keys = [line.split()[0] for line in table.splitlines()[2:-1]]
    assert "dot" in keys and "relu" in keys and "sum" in keys
    src = pmx.profiler.device_dumps(by="source")
    assert "test_torch_profiler_trace.py:" in src
    recs = pmx.profiler.device_records()
    # the backward's matmuls are the dot's
    assert sum(r["tf_op"] == "dot" for r in recs) >= 3
    # device_events reads the same records, under their full names
    assert pmx.profiler.device_events() == [
        (r["long_name"], r["dur_us"]) for r in recs]


def test_profile_fn_divides_by_its_calls(clean_profiler):
    with pmx.cpu():
        x = pmx.nd.array(onp.ones((4, 8), onp.float32))
        w = pmx.nd.array(onp.ones((8, 3), onp.float32))
        recs = pt.profile_fn(lambda: pmx.nd.dot(x, w), iters=3)
    dots = [r for r in recs if r["tf_op"] == "dot"]
    assert len(dots) == 3
    assert pmx.profiler.state() == "stop"
    pmx.profiler.start()
    try:
        with pytest.raises(pmx.MXNetError, match="already running"):
            pt.profile_fn(lambda: None)
    finally:
        pmx.profiler.stop()


def test_hlo_op_count_on_the_cpu_counts_dispatched_ops():
    import torch

    x = torch.ones(2, 16)
    w = torch.ones(8, 16, 16)

    def unrolled(x, w):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x

    assert pt.hlo_op_count(unrolled, x, w) == 24   # select, mm, tanh
    assert pt.hlo_op_count(lambda a: a * 2, x) == 1
