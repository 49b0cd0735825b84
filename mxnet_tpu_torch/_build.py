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

``capi_library()`` builds the C ABI (``native/mxtpu_c_api.cc``, host
C++ that embeds CPython, no CUDA) with ``g++`` and the running
interpreter's include and link flags into
``build/capi/<hash>/libmxtpu_torch_capi.so``; ``capi_link_flags()`` and
``capi_env()`` give a C host the flags it links with and the
environment its embedded interpreter needs.
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

__all__ = ["KERNELS", "nvcc_command", "build", "load", "check",
           "capi_command", "capi_library", "capi_link_flags", "capi_env"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("q8_matvec", "flash_fwd", "flash_bwd", "decode_fused",
           "conv1x1_bwd", "rtc_launch", "box_nms")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}      # name -> ptxas report of the last build
_busy_lock = threading.Lock()
building = 0              # builds running now (a watchdog waits them out)


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
    global building
    with _busy_lock:
        building += 1
    try:
        return _build_todo(todo, secs)
    finally:
        with _busy_lock:
            building -= 1


def _build_todo(todo, secs):
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


# ---------------------------------------------------------------------- #
# the C ABI library (host C++, built by g++)
# ---------------------------------------------------------------------- #

CAPI_SRC = Path(__file__).resolve().parent / "native" / "mxtpu_c_api.cc"
CAPI_NAME = "mxtpu_torch_capi"      # not the reference's libmxtpu_capi


def _python_flags():
    """(compile flags, link flags) of the running interpreter, as the
    reference's ``native/Makefile`` takes them from ``sysconfig``."""
    import sysconfig

    libdir = sysconfig.get_config_var("LIBDIR")
    inc = ["-I" + sysconfig.get_paths()["include"]]
    link = [f"-L{libdir}", "-lpython" + sysconfig.get_config_var(
        "LDVERSION"), f"-Wl,-rpath,{libdir}"]
    return inc, link


def capi_command(out):
    """The ``g++`` line the C ABI library is built with."""
    inc, link = _python_flags()
    return ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", *inc,
            str(CAPI_SRC), "-o", str(out), "-shared", *link]


def capi_library() -> Path:
    """The C ABI library, built at first use (``g++``, no ``nvcc``) into
    a directory named by the hash of its source and build line, so an
    edit rebuilds and a stale library is never linked."""
    h = hashlib.sha256(CAPI_SRC.read_bytes())
    h.update(" ".join(capi_command("out")).encode())
    target = BUILD_DIR.parent / "capi" / h.hexdigest()[:16] / \
        f"lib{CAPI_NAME}.so"
    with _lock:
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
            os.close(fd)
            proc = subprocess.run(capi_command(tmp), capture_output=True,
                                  text=True)
            if proc.returncode:
                os.unlink(tmp)
                raise MXNetError("g++ failed on the C ABI library:\n"
                                 + proc.stderr[-4000:])
            os.replace(tmp, target)
    return target


def capi_link_flags():
    """The flags a C or C++ host links the C ABI library with."""
    lib = capi_library()
    return [f"-L{lib.parent}", f"-l{CAPI_NAME}", f"-Wl,-rpath,{lib.parent}"]


def capi_env(base=None) -> dict:
    """The environment of a standalone C host: its embedded interpreter
    finds this repository and the running interpreter's packages (torch)
    on ``PYTHONPATH``, and the standard library under ``PYTHONHOME``
    where the running interpreter is a venv's."""
    import site
    import sys

    env = dict(os.environ if base is None else base)
    paths = [str(Path(__file__).resolve().parent.parent)]
    paths += [p for p in site.getsitepackages() + [site.getusersitepackages()]
              if os.path.isdir(p)]
    paths += [p for p in sys.path if p.endswith("-packages")
              and os.path.isdir(p) and p not in paths]
    old = env.get("PYTHONPATH")
    env["PYTHONPATH"] = os.pathsep.join(paths + ([old] if old else []))
    if sys.prefix != sys.base_prefix:
        env["PYTHONHOME"] = sys.base_prefix
    return env
