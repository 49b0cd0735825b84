"""``mx.util``, ``mx.runtime`` and ``mx.base``'s environment registry of
the port against the JAX package's."""
import os

import pytest
import torch

import mxnet_tpu_torch as pmx
from _torch_parity import LazyReference

rmx = LazyReference()


def test_base_names_match_reference():
    from mxnet_tpu import base as rb
    from mxnet_tpu_torch import base as pb

    assert pb.mx_real_t is rb.mx_real_t
    assert pb.string_types == rb.string_types
    assert pb.integer_types == rb.integer_types
    for b in (rb, pb):
        b.register_env("MXNET_TEST_KNOB_R25", 7, "a test knob")
    os.environ.pop("MXNET_TEST_KNOB_R25", None)
    assert pb.get_env("MXNET_TEST_KNOB_R25") == rb.get_env(
        "MXNET_TEST_KNOB_R25") == 7
    for raw in ("12", "junk"):
        os.environ["MXNET_TEST_KNOB_R25"] = raw
        assert pb.get_env("MXNET_TEST_KNOB_R25") == \
            rb.get_env("MXNET_TEST_KNOB_R25")
    for raw in ("1", "true", "on", "0", "no"):
        os.environ["MXNET_TEST_FLAG_R25"] = raw
        assert pb.env_truthy("MXNET_TEST_FLAG_R25") == \
            rb.env_truthy("MXNET_TEST_FLAG_R25")
    os.environ.pop("MXNET_TEST_KNOB_R25", None)
    os.environ.pop("MXNET_TEST_FLAG_R25", None)
    assert pb.get_env("MXNET_TEST_UNSET_R25", 1.5) == 1.5


def test_existing_base_helpers_keep_their_behaviour(monkeypatch):
    from mxnet_tpu_torch import base as pb

    assert pb.parse_seconds("X", None) is None
    assert pb.parse_seconds("X", "2.5") == 2.5
    with pytest.raises(pb.MXNetError, match="X="):
        pb.parse_seconds("X", "soon")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert pb.is_naive_engine()
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    assert not pb.is_naive_engine()


def test_util_switches_match_reference():
    for mx in (rmx, pmx):
        u = mx.util
        assert u.is_np_shape() and not u.is_np_array()
        prev = u.set_np_shape(False)
        assert prev is True and not u.is_np_shape()
        with u.np_shape(True):
            assert u.is_np_shape()
        assert not u.is_np_shape()
        u.set_np_shape(True)
        u.set_np()
        assert u.is_np_array()
        u.reset_np()
        assert not u.is_np_array() and u.is_np_shape()
        assert u.use_np(int) is int


def test_util_state_is_per_thread():
    import threading

    seen = []
    pmx.util.set_np()
    try:
        t = threading.Thread(target=lambda: seen.append(
            pmx.util.is_np_array()))
        t.start()
        t.join()
    finally:
        pmx.util.reset_np()
    assert seen == [False]


def test_environment_helpers_match_reference(monkeypatch):
    monkeypatch.delenv("MXNET_R25_A", raising=False)
    for mx in (rmx, pmx):
        u = mx.util
        with u.environment("MXNET_R25_A", "1"):
            assert u.getenv("MXNET_R25_A") == "1"
            with u.environment({"MXNET_R25_A": None}):
                assert u.getenv("MXNET_R25_A") is None
            assert os.environ["MXNET_R25_A"] == "1"
        assert u.getenv("MXNET_R25_A") is None
        u.setenv("MXNET_R25_A", 3)
        assert u.getenv("MXNET_R25_A") == "3"
        u.setenv("MXNET_R25_A", None)
        assert "MXNET_R25_A" not in os.environ
        with pytest.raises(ValueError):
            with u.environment("a", "b", "c"):
                pass


def test_gpu_helpers():
    assert pmx.util.get_gpu_count() == (torch.cuda.device_count()
                                        if torch.cuda.is_available() else 0)
    if not torch.cuda.is_available():
        with pytest.raises(pmx.MXNetError):
            pmx.util.get_gpu_memory(0)


def test_runtime_features_names_and_order_match_reference():
    ref = rmx.runtime.Features()
    got = pmx.runtime.Features()
    assert list(got) == list(ref)
    assert got.is_enabled("cpu")
    assert not got.is_enabled("TPU") and not got.is_enabled("PALLAS")
    assert not got.is_enabled("XLA")
    assert got.is_enabled("F16C") and got.is_enabled("BLAS_OPEN")
    assert got.is_enabled("CUDA") == torch.cuda.is_available()
    import importlib.util as iu
    assert got.is_enabled("OPENCV") == (iu.find_spec("cv2") is not None)
    for mx in (rmx, pmx):
        with pytest.raises(RuntimeError, match="does not exist"):
            mx.runtime.Features().is_enabled("NOPE")
    names = [f.name for f in pmx.runtime.feature_list()]
    assert names == list(ref)
    assert repr(got).startswith("[[") and "✔ CPU" in repr(got)
