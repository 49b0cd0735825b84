"""The port's C ABI (``mxnet_tpu_torch/capi_shim.py`` and
``native/mxtpu_c_api.cc``, built by ``_build.capi_library()``) against
the JAX package.

Models are exported by ``mxnet_tpu`` (an MLP as ``tests/test_c_api.py``
exports it, and a small convolution net) and served by the reference's
``Predictor`` in this process and by the port's library on the CPU
(``dev_type`` 1): from a ctypes host in a child Python process, and from
a C program compiled here, each in its own process (no process loads
both packages' libraries).  Outputs agree within 1e-5.  The C training
host's weights after ``STEPS`` SGD steps agree with the reference's
``Executor`` on the same data within 1e-5, and the ctypes host's equal
the C program's bit for bit.  The library and every host are built once
for the module.
"""
import os
import subprocess

import numpy as onp
import pytest

import _torch_capi_hosts as hosts
from _torch_parity import LazyReference, need_cuda

rmx = LazyReference()
STEPS = 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _export_mlp(d):
    mx = rmx
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=4))
    net.add(mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    x = onp.random.RandomState(0).rand(2, 4).astype("float32")
    net(mx.nd.array(x))
    net.export(os.path.join(d, "mlp"))
    return os.path.join(d, "mlp"), [("data", x)]


def _export_conv(d):
    mx = rmx
    mx.random.seed(1)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(4, 3, in_channels=2, activation="relu"))
    net.add(mx.gluon.nn.MaxPool2D(2))
    net.add(mx.gluon.nn.Flatten())
    net.add(mx.gluon.nn.Dense(5, in_units=36))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    x = onp.random.RandomState(1).standard_normal((2, 2, 8, 8)).astype(
        "float32")
    net(mx.nd.array(x))
    net.export(os.path.join(d, "conv"))
    return os.path.join(d, "conv"), [("data", x)]


def _train_symbol(d):
    mx = rmx
    data, label = mx.sym.Variable("data"), mx.sym.Variable("label")
    w1, b1 = mx.sym.Variable("w1"), mx.sym.Variable("b1")
    w2, b2 = mx.sym.Variable("w2"), mx.sym.Variable("b2")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, w1, b1,
                                                num_hidden=hosts.H),
                          act_type="relu")
    out = mx.sym.FullyConnected(h, w2, b2, num_hidden=hosts.NC)
    loss = mx.sym.softmax_cross_entropy(out, label) / float(hosts.B)
    path = os.path.join(d, "train-symbol.json")
    loss.save(path)
    return path, loss


def _reference_train(loss):
    """The C host's loop on the reference's ``Executor``."""
    mx = rmx
    from mxnet_tpu.symbol.symbol import infer_args

    names = loss.list_arguments()
    shapes = [tuple(s) for s in infer_args(
        loss, data=(hosts.B, hosts.NF), label=(hosts.B,)).values()]
    init = hosts.lcg_init(names, shapes)
    params = [n for n in names if n not in ("data", "label")]

    def step(vals):
        args = {n: mx.nd.array(vals[n]) for n in names}
        grads = {n: mx.nd.zeros(vals[n].shape) for n in params}
        ex = loss.bind(args=args, args_grad=grads,
                       grad_req={n: "write" if n in params else "null"
                                 for n in names})
        out = ex.forward(is_train=True)
        ex.backward()
        return float(out[0].asnumpy().ravel()[0]), {
            n: ex.grad_dict[n].asnumpy().astype(onp.float32) for n in params}

    return hosts.sgd_reference(step, names, init, STEPS)


def _reference_predict(prefix, inputs):
    from mxnet_tpu.predictor import Predictor

    rmx.random.seed(0)      # a fresh root key before each trace
    pred = Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                     {n: a.shape for n, a in inputs})
    for n, a in inputs:
        pred.set_input(n, a)
    pred.run()
    return pred.get_output(0).asnumpy()


def _inputs_file(path, inputs):
    specs, off = [], 0
    with open(path, "wb") as f:
        for n, a in inputs:
            a = onp.ascontiguousarray(a, onp.float32)
            f.write(a.tobytes())
            specs.append((n, list(a.shape), off))
            off += a.nbytes
    return specs


def _load_params(path):
    """A ``.params`` file's arrays as numpy (the port's reader)."""
    import mxnet_tpu_torch as pmx

    with pmx.cpu():
        return {k: v.asnumpy() for k, v in pmx.nd.load(path).items()}


@pytest.fixture(scope="module")
def capi(tmp_path_factory):
    """The library, the exported models and every host's results, each
    host run once in its own process."""
    from mxnet_tpu_torch import _build

    d = str(tmp_path_factory.mktemp("capi"))
    lib = _build.capi_library()
    env = _build.capi_env()
    env.pop("XLA_FLAGS", None)
    models = dict(mlp=_export_mlp(d), conv=_export_conv(d))
    sym_train, loss = _train_symbol(d)
    ref = {k: _reference_predict(p, ins) for k, (p, ins) in models.items()}
    ref["train"] = _reference_train(loss)
    jobs = []
    for k, (p, ins) in models.items():
        specs = _inputs_file(os.path.join(d, f"{k}.in"), ins)
        jobs.append(dict(kind="predict", name=k, symbol=p + "-symbol.json",
                         params=p + "-0000.params", dev_type=1,
                         inputs=os.path.join(d, f"{k}.in"), specs=specs,
                         out=os.path.join(d, f"{k}.ctypes.out"), repeats=2))
    jobs.append(dict(kind="train", name="train", symbol=sym_train,
                     dev_type=1, steps=STEPS,
                     out=os.path.join(d, "train.ctypes.params")))
    jobs.append(dict(kind="surface", name="surface", dir=d,
                     symbol=sym_train))
    child = hosts.run_child(lib, {"jobs": jobs}, env=env)
    flags = _build.capi_link_flags()
    pexe = hosts.compile_host(hosts.PREDICT_HOST, os.path.join(d, "predict"),
                              flags)
    texe = hosts.compile_host(hosts.TRAIN_HOST, os.path.join(d, "train"),
                              flags)
    c_out = {}
    for k, (p, ins) in models.items():
        out = os.path.join(d, f"{k}.c.out")
        proc = subprocess.run(
            [pexe, p + "-symbol.json", p + "-0000.params", "1",
             os.path.join(d, f"{k}.in"), out, "2",
             *[hosts.shape_arg(n, a.shape) for n, a in ins]],
            capture_output=True, text=True, env=env, timeout=300)
        c_out[k] = (proc, out)
    tproc = subprocess.run([texe, sym_train, "1", str(STEPS),
                            os.path.join(d, "train.c.params")],
                           capture_output=True, text=True, env=env,
                           timeout=300)
    return dict(dir=d, lib=lib, models=models, ref=ref, child=child,
                c_out=c_out, train=tproc, loss=loss)


def test_library_is_built_by_gxx_without_nvcc(capi):
    from mxnet_tpu_torch import _build

    cmd = _build.capi_command("out.so")
    assert cmd[0] == "g++" and "-shared" in cmd
    assert not any("nvcc" in c for c in cmd)
    assert capi["lib"].name == "libmxtpu_torch_capi.so"
    assert capi["lib"].parent.parent == _build.BUILD_DIR.parent / "capi"
    syms = subprocess.run(["nm", "-D", "--defined-only", str(capi["lib"])],
                          capture_output=True, text=True).stdout
    for name in ("MXGetLastError", "MXGetVersion", "MXPredCreate",
                 "MXPredSetInput", "MXPredForward", "MXPredGetNumOutputs",
                 "MXPredGetOutputShape", "MXPredGetOutput", "MXPredFree",
                 "MXNDArrayCreate", "MXNDArrayFree",
                 "MXNDArraySyncCopyFromCPU", "MXNDArraySyncCopyToCPU",
                 "MXNDArrayGetShape", "MXNDArrayGetDType", "MXNDArraySave",
                 "MXNDArrayLoad", "MXSymbolCreateFromFile", "MXSymbolFree",
                 "MXSymbolListArguments", "MXSymbolInferShape",
                 "MXSymbolSaveToFile", "MXExecutorBind", "MXExecutorForward",
                 "MXExecutorBackward", "MXExecutorOutputs", "MXExecutorFree",
                 "MXListAllOpNames", "NNGetOpHandle", "MXImperativeInvoke",
                 "MXImperativeInvokeEx"):
        assert f" T {name}\n" in syms, name
    src = open(_build.CAPI_SRC).read()
    assert '"mxnet_tpu_torch.capi_shim"' in src
    assert "mxnet_tpu.capi_shim" not in src


def test_shim_has_every_reference_function():
    import inspect

    import mxnet_tpu.capi_shim as ref
    import mxnet_tpu_torch.capi_shim as port

    names = [n for n, f in vars(ref).items() if not n.startswith("_")
             and inspect.isfunction(f) and f.__module__ == ref.__name__]
    assert len(names) >= 27
    assert [n for n in names if not callable(getattr(port, n, None))] == []
    assert port.nd_free is port.free


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_ctypes_host_predicts_as_the_reference(capi, model):
    got = capi["child"][model]
    ref = capi["ref"][model]
    out = onp.fromfile(os.path.join(capi["dir"], f"{model}.ctypes.out"),
                       onp.float32).reshape(got["shape"])
    assert tuple(got["shape"]) == ref.shape and got["num_outputs"] == 1
    onp.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_c_program_predicts_as_the_reference(capi, model):
    proc, path = capi["c_out"][model]
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])
    assert "C_PREDICT_OK" in proc.stdout and "version=10900" in proc.stdout
    ref = capi["ref"][model]
    assert f"shape={','.join(map(str, ref.shape))}" in proc.stdout
    out = onp.fromfile(path, onp.float32).reshape(ref.shape)
    onp.testing.assert_allclose(out, ref, **TOL)
    assert proc.stdout.count("forward_ms=") == 2


def test_c_training_host_matches_the_reference_executor(capi):
    proc = capi["train"]
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])
    assert "n_args=6 inferred in=6 out=1 complete=1" in proc.stdout
    got = _load_params(os.path.join(capi["dir"], "train.c.params"))
    want, losses = capi["ref"]["train"]
    assert set(got) == set(want)
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], **TOL)
    first = float(proc.stdout.split("first_loss=")[1].split()[0])
    last = float(proc.stdout.split("last_loss=")[1].split()[0])
    onp.testing.assert_allclose([first], [losses[0]], **TOL)
    assert last < first


def test_ctypes_training_equals_the_c_program(capi):
    c = _load_params(os.path.join(capi["dir"], "train.c.params"))
    t = _load_params(os.path.join(capi["dir"], "train.ctypes.params"))
    assert set(c) == set(t)
    for k in c:
        onp.testing.assert_array_equal(t[k], c[k])
    losses = capi["child"]["train"]["losses"]
    assert len(losses) == STEPS and losses[-1] < losses[0]


def test_error_surface_and_last_error(capi):
    s = capi["child"]["surface"]
    assert s["version"] == 10900
    rc, msg = s["bad_file"]
    assert rc == -1 and "nonexistent-symbol.json" in msg
    rc, msg = s["mismatch"]
    assert rc == -1 and "size mismatch" in msg
    rc, msg = s["unknown_op"]
    assert rc == -1 and "definitely_not_an_op" in msg
    assert s["not_ported"][0] == -1


def test_gpu_dev_type_fails_with_the_mxnet_error_text(capi):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: dev_type 2 succeeds")
    for key in ("gpu_pred", "gpu_nd"):
        rc, msg = capi["child"]["surface"][key]
        assert rc == -1
        assert "CUDA is not available" in msg, msg


def test_ndarray_and_symbol_calls(capi):
    s = capi["child"]["surface"]
    vals = (onp.arange(12, dtype=onp.float32) * 0.5).tolist()
    assert s["round_trip"] == vals and s["shape"] == [3, 4]
    assert s["dtype"] == 0                                  # kFloat32
    assert s["loaded"] == [1, "weight", vals]
    ref = rmx.sym.load(s["resaved"])
    assert ref.list_arguments() == capi["loss"].list_arguments()


def test_op_names_are_the_references_but_ring_attention(capi):
    from mxnet_tpu.capi_shim import op_list_names
    from mxnet_tpu_torch.ops.registry import NOT_PORTED

    ref = set(op_list_names())
    got = capi["child"]["surface"]["ops"]
    assert got == sorted(got)
    assert set(got) == ref - set(NOT_PORTED)
    assert set(NOT_PORTED) == {"ring_attention"}


def test_imperative_invoke(capi):
    s = capi["child"]["surface"]
    assert s["dot"] == [1, [4.0, 5.0, 10.0, 11.0]]
    assert s["sgd"] == [1, [0.5, 0.0, -0.5, -1.0]]     # written through w
    n, stype, vals = s["transpose"]
    assert (n, stype) == (1, 0)
    assert vals == onp.arange(1, 7, dtype=onp.float32).reshape(2, 3).T \
        .ravel().tolist()


@pytest.mark.cuda
def test_c_program_serves_on_the_card(tmp_path):
    """``dev_type`` 2: a C host serves a net the port exported, its output
    equal to the port's Predictor on the card bit for bit."""
    need_cuda()
    import mxnet_tpu_torch as pmx
    from mxnet_tpu_torch import _build

    pmx.random.seed(1)
    net = pmx.gluon.nn.HybridSequential()
    net.add(pmx.gluon.nn.Conv2D(4, 3, in_channels=2, activation="relu"))
    net.add(pmx.gluon.nn.Flatten())
    net.add(pmx.gluon.nn.Dense(5, in_units=144))
    net.initialize(pmx.init.Xavier(), ctx=pmx.gpu(0))
    x = onp.random.RandomState(1).standard_normal((2, 2, 8, 8)).astype(
        "float32")
    net(pmx.nd.array(x, ctx=pmx.gpu(0)))
    prefix = str(tmp_path / "conv")
    net.export(prefix)
    specs = _inputs_file(str(tmp_path / "in.bin"), [("data", x)])
    exe = hosts.compile_host(hosts.PREDICT_HOST, str(tmp_path / "predict"),
                             _build.capi_link_flags())
    proc = subprocess.run(
        [exe, prefix + "-symbol.json", prefix + "-0000.params", "2",
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin"), "3",
         hosts.shape_arg("data", x.shape)],
        capture_output=True, text=True, env=_build.capi_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert specs[0][1] == list(x.shape)
    pred = pmx.predictor.Predictor(prefix + "-symbol.json",
                                   prefix + "-0000.params",
                                   {"data": x.shape}, ctx=pmx.gpu(0))
    want = pred.forward(data=x)[0].asnumpy()
    onp.testing.assert_array_equal(
        onp.fromfile(str(tmp_path / "out.bin"), onp.float32)
        .reshape(want.shape), want)
