"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``),
which ``ctypes`` then loads.  No PyTorch header is included, so a build
takes seconds, not minutes.  The library name carries a hash of its
source, so an edited kernel rebuilds and a stale library is never
loaded.  Nothing here runs at import time: the first wrapper call on a
CUDA tensor builds (or finds) its library.  A build or load failure
raises ``MXNetError``; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from .base import MXNetError

__all__ = ["KERNELS", "nvcc_command", "build", "load", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("q8_matvec", "flash_fwd", "flash_bwd", "decode_fused",
           "conv1x1_bwd", "rtc_launch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}      # name -> ptxas report of the last build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                     "the CUDA kernels of mxnet_tpu_torch build at first use")


def nvcc_command(src, out, nvcc="nvcc"):
    """The one compiler line every kernel library is built with."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(src)]


def _target(name) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds the
    build took per name (0.0 for one found already built)."""
    todo = [(n, _target(n)) for n in names]
    todo = [(n, t) for n, t in todo if not t.exists()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, target in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp, nvcc)
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, target)      # atomic: a concurrent loader
    if failed:                           # never sees half a library
        raise MXNetError("nvcc failed:\n" + "\n".join(failed))
    return secs


def load(name) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed (thread-safe; built once per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise MXNetError(f"cannot load {name} kernel library: "
                                 f"{e}") from e
            _libs[name] = lib
        return lib


def check(lib, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point of
    ``lib`` (each library exports ``mx_cuda_error_string``)."""
    if err:
        fn = lib.mx_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise MXNetError(f"{what} kernel launch failed: cudaError_t {err} "
                         f"({fn(err).decode(errors='replace')})")
