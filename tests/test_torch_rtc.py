"""``mxnet_tpu_torch.rtc`` (kernel K7): CUDA source compiled at run time
by NVRTC, against the reference's ``mxnet_tpu.rtc``.

On the CPU: the signature parser (every MXNet type, ``const``, spacing,
malformed strings), the argument and launch checks, the packing of
``cuLaunchKernel``'s parameters (widths and bits), the CUBIN cache key,
the refusals (``CudaModule`` without CUDA, ``PallasModule``), and the
reference's ``addmul`` through ``mxnet_tpu.rtc.PallasModule`` (interpret
mode, as ``tests/test_tools.py`` runs it) against the plain ``addmul``.

The launch plans (no card): their slots against ``pack_args``'s bytes
for every type, their refusals against ``check_args``, ``check_launch``
and ``pack_args``, and when ``launch_plan`` builds a new one.

``cuda``-marked (the card): each user kernel of ``_torch_rtc_sources``
through ``CudaModule`` against its plain version, element by element
within ``_torch_rtc_sources.err_units`` (1e-6 of the output's largest
magnitude, as the kernel's ``tanhf``/``expf`` and torch's differ by ulps,
plus for bf16 one bf16 step of the element's own magnitude), the templated
exports, shared memory past 48 KB and its refusal past 227 KB,
launches with a host array or a host context raising, a plan's second
launch, a launch recorded into a CUDA graph and replayed, and two threads
launching at once.
"""
import ctypes

import numpy as onp
import pytest
import torch

import _torch_rtc_sources as S
import mxnet_tpu_torch as mx
from _torch_parity import need_cuda
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError

TYPES = {"float": torch.float32, "double": torch.float64,
         "__half": torch.float16, "__nv_bfloat16": torch.bfloat16,
         "uint8_t": torch.uint8, "int": torch.int32, "int32_t": torch.int32,
         "int8_t": torch.int8, "char": torch.int8, "int64_t": torch.int64}


@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_parse_every_type(ctype):
    specs = rtc.parse_signature(f"const {ctype} *a, {ctype}* b, {ctype} c")
    assert [(s.name, s.ctype, s.dtype, s.pointer, s.const) for s in specs] \
        == [("a", ctype, TYPES[ctype], True, True),
            ("b", ctype, TYPES[ctype], True, False),
            ("c", ctype, TYPES[ctype], False, False)]


@pytest.mark.parametrize("sig,expect", [
    ("const float*x,float *y , int   n",
     [("x", True, True), ("y", True, False), ("n", False, False)]),
    ("  const   float   *   x  ", [("x", True, True)]),
    ("float*", [("arg0", True, False)]),
    ("int, int64_t m", [("arg0", False, False), ("m", False, False)]),
    ("const\tint\n n", [("n", False, True)]),
])
def test_parse_spacing_and_names(sig, expect):
    got = [(s.name, s.pointer, s.const) for s in rtc.parse_signature(sig)]
    assert got == expect


@pytest.mark.parametrize("sig", [
    "", "const", "const *x", "float **x", "float x y", "float *x,",
    "unsigned int n", "std::vector<int> v", "constfloat *x",
    "float *x, half y", "bool flag"])
def test_parse_refuses_malformed(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


def _cpu(a, dtype=None):
    return mx.nd.array(a, ctx=mx.cpu(), dtype=dtype)


def test_check_args():
    specs = rtc.parse_signature("const float *x, float *y, int n")
    x, y = _cpu(onp.ones(4)), _cpu(onp.zeros(4))
    rtc.check_args(specs, [x, y, 4])
    bad = [
        [x, y],                              # count
        [x, 3.0, 4],                         # pointer given a number
        [x, y, y],                           # scalar given an array
        [x, y, "4"],                         # scalar given a string
        [x, y, True],                        # a bool is not an int
        [x, _cpu(onp.zeros(4), "float16"), 4],           # dtype
        [x, _cpu(onp.zeros((4, 2)))[:, 0], 4],          # not contiguous
        [x, x, 4],                           # writes what it reads
        [x, x[1:3], 4],                      # a view of what it reads
    ]
    for args in bad:
        with pytest.raises(MXNetError):
            rtc.check_args(specs, args)
    # two const views of one array are fine
    rtc.check_args(rtc.parse_signature("const float *a, const float *b"),
                   [x, x[1:]])


def test_check_launch_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = rtc.parse_signature("const float *x, float *y, int n")
    args = [_cpu(onp.ones(4)), _cpu(onp.zeros(4)), 4]
    gpu = mx.Context("gpu", 0)
    for ctx, grid, block, smem, match in [
            (mx.cpu(), (1, 1, 1), (32, 1, 1), 0, "GPU context"),
            ("gpu", (1, 1, 1), (32, 1, 1), 0, "GPU context"),
            (gpu, (1, 1), (32, 1, 1), 0, "grid_dims"),
            (gpu, (1, 1, 1), (0, 1, 1), 0, "block_dims"),
            (gpu, (1, 1, 1), (32, 1, 1), rtc.MAX_SHARED_BYTES + 1,
             "at most"),
            (gpu, (1, 1, 1), (32, 1, 1), 0, "on the host")]:
        with pytest.raises(MXNetError, match=match):
            rtc.check_launch(specs, args, ctx, grid, block, smem)


def _read(ptr, ctype):
    return ctypes.cast(ptr, ctypes.POINTER(ctype)).contents.value


def test_pack_args_widths_and_bits():
    sig = ("const float *x, float a, double b, __half c, __nv_bfloat16 d, "
           "uint8_t e, int f, int32_t g, int8_t h, char i, int64_t j")
    specs = rtc.parse_signature(sig)
    x = _cpu(onp.arange(3.0))
    vals = [x, 1.5, -2.25, 0.333, 3.140625, 200, -7, 2 ** 31 - 1, -128, 5,
            2 ** 40 + 3]
    holders, params = rtc.pack_args(specs, vals)
    assert len(params) == len(specs)
    assert ctypes.sizeof(params) == 8 * len(specs)
    widths = [ctypes.sizeof(h) for h in holders]
    assert widths == [8, 4, 8, 2, 2, 1, 4, 4, 1, 1, 8]
    assert _read(params[0], ctypes.c_void_p) == x.astorch().data_ptr()
    assert _read(params[1], ctypes.c_float) == 1.5
    assert _read(params[2], ctypes.c_double) == -2.25
    assert _read(params[3], ctypes.c_uint16) == int(
        onp.array(0.333, onp.float16).view(onp.uint16))
    assert _read(params[4], ctypes.c_uint16) == 0x4049   # 3.140625 in bf16
    assert [_read(params[k], t) for k, t in (
        (5, ctypes.c_uint8), (6, ctypes.c_int32), (7, ctypes.c_int32),
        (8, ctypes.c_int8), (9, ctypes.c_int8), (10, ctypes.c_int64))] \
        == [200, -7, 2 ** 31 - 1, -128, 5, 2 ** 40 + 3]


@pytest.mark.parametrize("sig,value", [
    ("int n", 2 ** 31), ("int n", 1.5), ("uint8_t n", -1),
    ("int8_t n", 128), ("int64_t n", 2 ** 63)])
def test_pack_args_refuses_what_does_not_fit(sig, value):
    with pytest.raises(MXNetError, match="cannot hold"):
        rtc.pack_args(rtc.parse_signature(sig), [value])


# --------------------------------------------------------------------------- #
# launch plans (no card)
# --------------------------------------------------------------------------- #

# a value of each type, and a second one to overwrite it with
VALUES = {"float": (1.5, -3.25), "double": (-2.25, 1e300),
          "__half": (0.333, -65504.0), "__nv_bfloat16": (3.140625, -1e-3),
          "uint8_t": (200, 0), "int": (-7, 2 ** 31 - 1),
          "int32_t": (2 ** 31 - 1, -2 ** 31), "int8_t": (-128, 127),
          "char": (5, -1), "int64_t": (2 ** 40 + 3, -2 ** 63)}


def _slot_bytes(params, holders):
    """Each argument's bytes behind ``params``, at its holder's width."""
    return [ctypes.string_at(params[i], ctypes.sizeof(h))
            for i, h in enumerate(holders)]


@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_plan_slots_equal_pack_args(ctype):
    """The plan's slots hold ``pack_args``'s bytes for each type, for a
    Python number and a numpy one, and again after a second pack
    overwrites them."""
    specs = rtc.parse_signature(f"const {ctype} *p, {ctype} v, int n")
    arr = mx.nd.from_torch(torch.zeros(3, dtype=TYPES[ctype]))
    plan = rtc.LaunchPlan(specs, -1, (1, 1, 1), (32, 1, 1), 0)
    np_type = {"float": onp.float32, "double": onp.float64,
               "__half": onp.float16, "__nv_bfloat16": onp.float32,
               "uint8_t": onp.uint8, "int8_t": onp.int8,
               "char": onp.int8, "int64_t": onp.int64}.get(ctype, onp.int32)
    for v in VALUES[ctype] + tuple(np_type(v) for v in VALUES[ctype]):
        args = [arr, v, 3]
        params, record = plan.pack(args)
        assert record == 0               # no function: the plan only packs
        holders, want = rtc.pack_args(specs, args)
        assert _slot_bytes(params, holders) == _slot_bytes(want, holders)
        assert ctypes.sizeof(params) == 8 * len(specs)


def _message(fn, *a):
    with pytest.raises(MXNetError) as e:
        fn(*a)
    return str(e.value)


def _bad_args():
    x, y = _cpu(onp.ones(4)), _cpu(onp.zeros(4))
    return {
        "count": [x, y],
        "pointer_given_a_number": [x, 3.0, 4],
        "scalar_given_an_array": [x, y, y],
        "scalar_given_a_string": [x, y, "4"],
        "bool_for_int": [x, y, True],
        "numpy_bool_for_int": [x, y, onp.bool_(True)],
        "dtype": [x, _cpu(onp.zeros(4), "float16"), 4],
        "not_contiguous": [x, _cpu(onp.zeros((4, 2)))[:, 0], 4],
        "writes_what_it_reads": [x, x, 4],
        "writes_a_view_of_what_it_reads": [x, x[1:3], 4],
    }


@pytest.mark.parametrize("card", [-1, 0])
@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_plan_refuses_what_check_args_refuses(case, card):
    """Each input ``check_args`` refuses, the plan refuses with the same
    message, whether its arrays' card matches (-1, the host) or not."""
    specs = rtc.parse_signature("const float *x, float *y, int n")
    args = _bad_args()[case]
    plan = rtc.LaunchPlan(specs, card, (1, 1, 1), (32, 1, 1), 0)
    assert _message(plan.pack, args) == _message(rtc.check_args, specs,
                                                 args)


@pytest.mark.parametrize("sig,value", [
    ("int n", 2 ** 31), ("int n", 1.5), ("uint8_t n", -1),
    ("int8_t n", 128), ("int64_t n", 2 ** 63), ("int n", onp.int64(2 ** 40))])
def test_plan_refuses_what_does_not_fit(sig, value):
    specs = rtc.parse_signature(sig)
    plan = rtc.LaunchPlan(specs, 0, (1, 1, 1), (32, 1, 1), 0)
    msg = _message(plan.pack, [value])
    assert "cannot hold" in msg
    assert msg == _message(rtc.pack_args, specs, [value])


@pytest.mark.parametrize("card", [0, 1])
def test_plan_refuses_host_arrays(monkeypatch, card):
    """A card's plan refuses host arrays with ``check_launch``'s
    message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = rtc.parse_signature("const float *x, float *y, int n")
    args = [_cpu(onp.ones(4)), _cpu(onp.zeros(4)), 4]
    plan = rtc.LaunchPlan(specs, card, (1, 1, 1), (32, 1, 1), 0)
    msg = _message(plan.pack, args)
    assert "on the host" in msg
    assert msg == _message(rtc.check_launch, specs, args,
                           mx.Context("gpu", 0), (1, 1, 1), (32, 1, 1), 0)


@pytest.mark.parametrize("ctx,grid,block,smem,match", [
    ("cpu", (1, 1, 1), (32, 1, 1), 0, "GPU context"),
    ("gpu", (1, 1, 1), (32, 1, 1), 0, "GPU context"),
    (None, (1, 1), (32, 1, 1), 0, "grid_dims"),
    (None, (1, 1, 1), (0, 1, 1), 0, "block_dims"),
    (None, (1, 1, 1), (32, 1, 1), rtc.MAX_SHARED_BYTES + 1, "at most")])
def test_launch_plan_refuses_what_check_launch_refuses(ctx, grid, block,
                                                       smem, match):
    ctx = {"cpu": mx.cpu(), "gpu": "gpu"}.get(ctx, mx.Context("gpu", 0))
    specs = rtc.parse_signature("const float *x, float *y, int n")
    args = [_cpu(onp.ones(4)), _cpu(onp.zeros(4)), 4]
    msg = _message(rtc.launch_plan, {}, specs, ctx, grid, block, smem)
    assert match in msg
    assert msg == _message(rtc.check_launch, specs, args, ctx, grid, block,
                           smem)


def test_launch_plan_is_reused_and_rebuilt():
    """One plan per signature kinds and types, card, grid, block and
    shared memory: the same launch (dims as a list or numpy ints too)
    finds it again, a change of any one builds another."""
    f32 = rtc.parse_signature(S.SIGNATURES["gelu_fwd"].format(T="float"))
    bf16 = rtc.parse_signature(
        S.SIGNATURES["gelu_fwd"].format(T="__nv_bfloat16"))
    gpu0, gpu1 = mx.Context("gpu", 0), mx.Context("gpu", 1)
    plans = {}
    base = rtc.launch_plan(plans, f32, gpu0, (4, 1, 1), (256, 1, 1), 0)
    for again in [(f32, mx.Context("gpu", 0), (4, 1, 1), (256, 1, 1), 0),
                  (f32, gpu0, [4, 1, 1], onp.array([256, 1, 1]), 0),
                  (f32, gpu0, (onp.int64(4), 1, 1), (256, 1, 1),
                   onp.int32(0))]:
        assert rtc.launch_plan(plans, *again) is base
    others = [(bf16, gpu0, (4, 1, 1), (256, 1, 1), 0),
              (f32, gpu1, (4, 1, 1), (256, 1, 1), 0),
              (f32, gpu0, (8, 1, 1), (256, 1, 1), 0),
              (f32, gpu0, (4, 1, 1), (128, 1, 1), 0),
              (f32, gpu0, (4, 1, 1), (256, 1, 1), 1024)]
    built = [rtc.launch_plan(plans, *o) for o in others]
    assert len({id(p) for p in [base] + built}) == 6 == len(plans)
    assert [rtc.launch_plan(plans, *o) for o in others] == built
    assert base.dims == (4, 1, 1, 256, 1, 1, 0) and base.index == 0
    assert (built[1].index, built[1].device) == (1, torch.device("cuda", 1))
    assert built[4].dims[-1] == 1024 and base.record is None


@pytest.mark.parametrize("sig,alias", [
    (S.SIGNATURES["addmul"], True), ("const float *a, const float *b", False),
    ("float *a, float *b, int n", False), ("const float *a, int n", False)])
def test_plan_checks_aliasing_only_where_it_can_occur(sig, alias):
    plan = rtc.LaunchPlan(rtc.parse_signature(sig), -1, (1, 1, 1),
                          (32, 1, 1), 0)
    assert plan.alias is alias


def test_cache_key():
    k = rtc.cache_key(S.SOURCE, (), S.EXPORTS)
    assert k == rtc.cache_key(S.SOURCE, [], list(S.EXPORTS))
    assert len(k) == 32 and int(k, 16) >= 0
    others = {rtc.cache_key(S.SOURCE + " ", (), S.EXPORTS),
              rtc.cache_key(S.SOURCE, ("--use_fast_math",), S.EXPORTS),
              rtc.cache_key(S.SOURCE, (), S.EXPORTS[:1]),
              rtc.cache_key(S.SOURCE, (), S.EXPORTS, arch="sm_90")}
    assert k not in others and len(others) == 4


def test_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="needs a CUDA card"):
        rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule({"addmul": lambda x_ref, o_ref: None})
    assert mx.rtc is rtc


def test_nvrtc_search(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    dirs = [str(d) for d in rtc.nvrtc_dirs()]
    assert dirs[:2] == [str(tmp_path / "cuda" / "lib64"),
                        "/usr/local/cuda/lib64"]
    assert any(d.endswith("nvidia/cuda_nvrtc/lib") for d in dirs)
    assert len(dirs) == len(set(dirs))
    monkeypatch.setattr(rtc, "nvrtc_dirs",
                        lambda: [tmp_path / "a", tmp_path / "b"])
    monkeypatch.setattr(rtc, "_libs", {})
    with pytest.raises(MXNetError) as e:
        rtc._nvrtc()
    assert str(tmp_path / "a") in str(e.value)
    assert str(tmp_path / "b") in str(e.value)


def test_reference_addmul_matches_plain():
    """The reference's kernel through ``mxnet_tpu.rtc.PallasModule``
    (interpret mode on the CPU) equals the plain ``addmul`` of the port's
    user-kernel file; the reference gates ``CudaModule`` as the port gates
    ``PallasModule``."""
    import mxnet_tpu as rmx

    def addmul(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + y_ref[...]

    rs = onp.random.RandomState(0)
    x = rs.standard_normal((2, 4)).astype(onp.float32)
    y = rs.standard_normal((2, 4)).astype(onp.float32)
    k = rmx.rtc.PallasModule({"addmul": addmul}).get_kernel(
        "addmul", S.SIGNATURES["addmul"])
    ref = k([rmx.nd.array(x), rmx.nd.array(y)]).asnumpy()
    plain = S.addmul_plain(torch.from_numpy(x), torch.from_numpy(y))
    onp.testing.assert_array_equal(plain.numpy(), ref)
    with pytest.raises(rmx.MXNetError):
        rmx.rtc.CudaModule(S.SOURCE)


def test_err_units_holds_each_element_to_its_own_step():
    """The kernels' tolerance: a bf16 output one step (ulp) off each
    element passes, two steps off does not, nor a bf16 GELU without its
    cubic term; an f32 output passes within 1e-6 of its largest
    magnitude and fails past it."""
    x = torch.linspace(-6.0, 6.0, 4097)
    ref = S.gelu_fwd_plain(x.bfloat16())
    bits = ref.view(torch.int16)
    one, two = ((bits + d).view(torch.bfloat16) for d in (1, 2))
    assert S.err_units(one, ref) <= 1
    assert S.err_units(two, ref) > 1
    no_cubic = (0.5 * x * (1.0 + (S.GELU_K0 * x).tanh())).bfloat16()
    assert S.err_units(no_cubic, ref) > 1
    ref32 = S.gelu_fwd_plain(x)
    top = ref32.abs().max().item()
    assert S.err_units(ref32 + 0.9e-6 * top, ref32) <= 1
    assert S.err_units(ref32 + 1.1e-6 * top, ref32) > 1


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def module():
    need_cuda()
    return rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)


def _nd(t):
    return mx.nd.from_torch(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(8192 * 3072, 0), (1001, 0),
                                      (4099, 1)])
def test_gelu_kernels_match_plain(module, dtype, n, offset):
    ct = S.CTYPES[str(dtype)]
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:]
    dy = torch.randn(n + offset, device="cuda",
                     generator=g).to(dtype)[offset:]
    y, dx = torch.empty_like(x), torch.empty_like(x)
    kf = module.get_kernel(f"gelu_fwd<{ct}>",
                           S.SIGNATURES["gelu_fwd"].format(T=ct))
    kb = module.get_kernel(f"gelu_bwd<{ct}>",
                           S.SIGNATURES["gelu_bwd"].format(T=ct))
    grid = S.elementwise_grid(n, x.element_size())
    kf.launch([_nd(x), _nd(y), n], mx.gpu(0), grid, (S.THREADS, 1, 1))
    kb.launch([_nd(x), _nd(dy), _nd(dx), n], mx.gpu(0), grid,
              (S.THREADS, 1, 1))
    torch.cuda.synchronize()
    assert (kf.launches, kb.launches) == (1, 1)
    assert S.err_units(y, S.gelu_fwd_plain(x)) <= 1
    assert S.err_units(dx, S.gelu_bwd_plain(x, dy)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(8192 * 3072, 0), (1001, 0),
                                      (4099, 1)])
def test_plan_launch_matches_plain(module, dtype, n, offset):
    """A second launch of the same signature takes the plan the first
    built: the same bits as the first, within tolerance of the plain
    version, one plan, two counted launches."""
    ct = S.CTYPES[str(dtype)]
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    x = torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:]
    ys = [torch.empty_like(x) for _ in range(2)]
    k = module.get_kernel(f"gelu_fwd<{ct}>",
                          S.SIGNATURES["gelu_fwd"].format(T=ct))
    grid = S.elementwise_grid(n, x.element_size())
    for y in ys:
        k.launch([_nd(x), _nd(y), n], mx.gpu(0), grid, (S.THREADS, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])
    assert S.err_units(ys[1], S.gelu_fwd_plain(x)) <= 1
    assert (k.launches, len(k._by_key), len(k._plans)) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["eager", "captured"])
def test_graph_capture_replays_eager_bits(module, first):
    """A launch under ``torch.cuda.graph`` records; the replay gives the
    eager launch's bits; the capture counts as a launch, a replay does
    not.  ``first``: whether the signature's plan was built by an eager
    launch or inside the capture."""
    n = 4099
    ct = "__nv_bfloat16"
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n + 1, device="cuda", generator=g).bfloat16()[1:]
    eager, replayed = torch.empty_like(x), torch.empty_like(x)
    k = module.get_kernel(f"gelu_fwd<{ct}>",
                          S.SIGNATURES["gelu_fwd"].format(T=ct))
    grid, block = S.elementwise_grid(n, 2), (S.THREADS, 1, 1)
    graph = torch.cuda.CUDAGraph()
    if first == "eager":
        k.launch([_nd(x), _nd(eager), n], mx.gpu(0), grid, block)
    with torch.cuda.graph(graph):
        k.launch([_nd(x), _nd(replayed), n], mx.gpu(0), grid, block)
    if first == "captured":
        k.launch([_nd(x), _nd(eager), n], mx.gpu(0), grid, block)
    replayed.fill_(float("nan"))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager.view(torch.int16), replayed.view(torch.int16))
    assert k.launches == 2


@pytest.mark.cuda
def test_two_threads_launch_addmul(module):
    """Two threads each launch ``addmul`` 1000 times, each launch into
    its own output row, with the interpreter switching threads every
    microsecond: every row holds its thread's result, and every launch
    is counted."""
    import sys
    import threading

    n, reps = 1000, 1000
    k = module.get_kernel("addmul", S.SIGNATURES["addmul"])
    xs = [torch.full((n,), float(i + 1), device="cuda") for i in range(2)]
    ys = [torch.arange(n, dtype=torch.float32, device="cuda") * (i + 3)
          for i in range(2)]
    outs = [torch.full((reps, n), float("nan"), device="cuda")
            for _ in range(2)]
    errors = []

    def work(i):
        try:
            x, y = _nd(xs[i]), _nd(ys[i])
            for r in range(reps):
                k.launch([x, y, _nd(outs[i][r]), n], mx.gpu(0), (4, 1, 1),
                         (256, 1, 1))
        except Exception as e:          # reported below, with the thread
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        want = S.addmul_plain(xs[i], ys[i]).expand(reps, n)
        torch.testing.assert_close(outs[i], want, rtol=0, atol=0)
    assert k.launches == 2 * reps


@pytest.mark.cuda
def test_softmax_past_48kb_and_refusal_past_227kb(module):
    rows, cols, rpb = 8192, 3072, S.SOFTMAX_ROWS_PER_BLOCK
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(rows, cols, device="cuda", generator=g).to(torch.bfloat16)
    y = torch.empty_like(x)
    k = module.get_kernel("softmax_rows", S.SIGNATURES["softmax_rows"])
    smem = rpb * cols * 4
    assert smem > 48 * 1024
    k.launch([_nd(x), _nd(y), rows, cols, rpb], mx.gpu(0),
             (-(-rows // rpb), 1, 1), (S.THREADS, 1, 1), shared_mem=smem)
    torch.cuda.synchronize()
    assert S.err_units(y, S.softmax_rows_plain(x)) <= 1
    big = 19
    with pytest.raises(MXNetError, match="at most"):
        k.launch([_nd(x), _nd(y), rows, cols, big], mx.gpu(0),
                 (-(-rows // big), 1, 1), (S.THREADS, 1, 1),
                 shared_mem=big * cols * 4)
    assert k.launches == 1


@pytest.mark.cuda
def test_addmul_and_placement_refusals(module):
    n = 1000
    x = torch.arange(n, dtype=torch.float32, device="cuda")
    y = torch.ones(n, device="cuda")
    out = torch.empty(n, device="cuda")
    k = module.get_kernel("addmul", S.SIGNATURES["addmul"])
    k.launch([_nd(x), _nd(y), _nd(out), n], mx.gpu(0), (4, 1, 1),
             (256, 1, 1))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, S.addmul_plain(x, y), rtol=0, atol=0)
    with pytest.raises(MXNetError, match="on the host"):
        k.launch([_nd(x.cpu()), _nd(y), _nd(out), n], mx.gpu(0),
                 (4, 1, 1), (256, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([_nd(x), _nd(y), _nd(out), n], mx.cpu(), (4, 1, 1),
                 (256, 1, 1))
    with pytest.raises(MXNetError):
        k.launch([_nd(x), _nd(y), _nd(x), n], mx.gpu(0), (4, 1, 1),
                 (256, 1, 1))
    assert k.launches == 1


@pytest.mark.cuda
def test_compile_errors_and_cache(module):
    need_cuda()
    with pytest.raises(MXNetError, match="NVRTC log"):
        rtc.CudaModule('extern "C" __global__ void k(float *x) { x[0] = y; }')
    with pytest.raises(MXNetError, match="cuModuleGetFunction"):
        module.get_kernel("no_such_kernel", "float *x")
    again = rtc.CudaModule(S.SOURCE, exports=S.EXPORTS)
    assert again.cached and again.compile_seconds == 0.0


@pytest.mark.cuda
def test_rtc_gelu_custom_op_on_the_card():
    """The custom op launches one kernel forward and one backward, and
    agrees with its own CPU branch (f32, TF32 off)."""
    need_cuda()
    op = S.RtcGelu(mx, op_type="rtc_gelu_test").register()
    rs = onp.random.RandomState(0)
    h = rs.standard_normal((64, 96)).astype(onp.float32)
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        x = mx.nd.array(h, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="rtc_gelu_test")
            loss = (y * y).sum()
        loss.backward()
        grads.append((y.asnumpy(), x.grad.asnumpy()))
    assert op.launches() == 2
    for a, b in zip(*grads):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
