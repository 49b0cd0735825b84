"""``mx.rtc`` — CUDA kernels compiled at run time (kernel K7).

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasModule`` launches
user kernel functions through ``pl.pallas_call`` (``_PallasKernel.launch``)
and calls itself the TPU analog of MXNet's ``mx.rtc.CudaModule``.  On the
card the port is that original API (Apache MXNet 1.x
``python/mxnet/rtc.py``, ``src/common/rtc.cc``)::

    mod = mx.rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, int n")
    k.launch([x, y, n], mx.gpu(0), grid_dims, block_dims, shared_mem=0)

The kernel writes into its non-``const`` pointer arguments in place.

How: the source is compiled by NVRTC for ``sm_90a`` into a CUBIN, cached
under ``build/rtc/`` (git-ignored) by a hash of the source, the options,
the exports and the target, loaded through libcuda's module API
(``cuModuleLoadData``, ``cuModuleGetFunction``) into the card's primary
context, which PyTorch shares, and launched with ``cuLaunchKernel`` on
PyTorch's current stream.  Both libraries are reached through ``ctypes``;
nothing CUDA-specific is touched at import.  A launch's fixed part (the
function, the card, the dims, the shared-memory opt-in, each argument's
slot and check) is a ``LaunchPlan``, built once per kernel, card, grid,
block and ``shared_mem`` (the counterpart of the reference's
``_compiled[key]``); a repeat launch is one pass over the arguments and
one call of ``csrc/rtc_launch.cu`` (built by ``_build`` like the other
sources), which makes one ``cuLaunchKernel`` from a per-thread launch
record and counts it.  Nothing in a launch synchronises, allocates or
reads the card's memory, so it records into a CUDA graph
(``torch.cuda.graph``).  ``exports`` go through
``nvrtcAddNameExpression``/``nvrtcGetLoweredName``, so a templated kernel
(``gelu_fwd<__nv_bfloat16>``) is reached by that name; any other kernel
must be ``extern "C"``.  Dynamic shared memory above 48 KB is opted into
with ``cuFuncSetAttribute``; more than 227 KB (a Hopper block's most) is
refused before launching.  Every ``CUresult`` and NVRTC result is
checked; a failure raises ``MXNetError`` with the NVRTC log.  Each
``CudaKernel`` counts its launches (``.launches``).

``rtc`` has no host path: ``CudaModule`` raises without CUDA, and a
launch with a host array or a context that is not a GPU raises.  The
parts that need no card are plain: ``parse_signature``, ``check_args``,
``check_launch``, ``pack_args``, ``cache_key``, ``launch_plan`` and
``LaunchPlan.pack``.
``PallasModule`` raises, naming ``CudaModule``: the mirror of the
reference's gate.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .base import MXNetError, numeric_types
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "ArgSpec",
           "LaunchPlan", "parse_signature", "check_args", "check_launch",
           "pack_args", "cache_key", "launch_plan",
           "nvrtc_dirs", "ARCH", "MAX_SHARED_BYTES"]

ARCH = "sm_90a"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rtc"
MAX_SHARED_BYTES = 232448          # 227 KB: a Hopper block's most
_STATIC_SHARED_BYTES = 48 * 1024   # above this only after the opt-in
# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_ATTR_MAX_DYNAMIC_SHARED = 8

# MXNet's kernel argument types (plus __nv_bfloat16, the port's working
# type): C type -> (the NDArray dtype a pointer must have, the ctypes
# type a scalar is passed as; half types as their 16 bits)
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}


class ArgSpec(NamedTuple):
    """One kernel argument of a signature."""

    name: str
    ctype: str
    dtype: torch.dtype
    pointer: bool
    const: bool


_ARG = re.compile(r"^\s*(?:(const)\s+)?(\w+)\s*(\*)?\s*(\w+)?\s*$")


def parse_signature(signature: str) -> list:
    """``"const float *x, float *y, int n"`` -> one ``ArgSpec`` each, in
    order.  Raises ``MXNetError`` on a malformed argument or a type
    outside MXNet's list."""
    specs = []
    for i, arg in enumerate(str(signature).split(",")):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(f"invalid kernel argument {arg.strip()!r}: "
                             "expected '(const) type (*) (name)'")
        const, ctype, ptr, name = m.groups()
        if ctype not in _CTYPES:
            raise MXNetError(f"unsupported kernel argument type {ctype!r} "
                             f"in {arg.strip()!r}; supported: "
                             f"{', '.join(_CTYPES)}")
        specs.append(ArgSpec(name or f"arg{i}", ctype, _CTYPES[ctype][0],
                             bool(ptr), bool(const)))
    return specs


def check_args(specs, args) -> None:
    """Hold ``args`` against the signature: an NDArray of the pointer's
    dtype, contiguous, for each pointer; a number for each scalar; and no
    non-``const`` pointer sharing storage with a ``const`` one."""
    if len(args) != len(specs):
        raise MXNetError(f"kernel takes {len(specs)} arguments, got "
                         f"{len(args)}")
    for s, a in zip(specs, args):
        if s.pointer:
            if not isinstance(a, NDArray):
                raise MXNetError(f"argument {s.name} ({s.ctype} *) needs an "
                                 f"NDArray, got {type(a).__name__}")
            if a._data.dtype != s.dtype:
                raise MXNetError(f"argument {s.name} ({s.ctype} *) needs "
                                 f"dtype {s.dtype}, got {a._data.dtype}")
            if not a._data.is_contiguous():
                raise MXNetError(f"argument {s.name} is not contiguous")
        elif isinstance(a, NDArray) or not isinstance(a, numeric_types) \
                or isinstance(a, (bool, np.bool_)):
            raise MXNetError(f"argument {s.name} ({s.ctype}) needs a "
                             f"number, got {type(a).__name__}")
    read = {_storage(a): s.name for s, a in zip(specs, args)
            if s.pointer and s.const}
    for s, a in zip(specs, args):
        if s.pointer and not s.const and _storage(a) in read:
            raise MXNetError(f"argument {s.name} is written by the kernel "
                             f"but shares storage with const argument "
                             f"{read[_storage(a)]}")


def _storage(a: NDArray) -> int:
    return a._data.untyped_storage().data_ptr()


def _scalar(s: ArgSpec, v):
    ct = _CTYPES[s.ctype][1]
    if s.ctype in ("float", "double"):
        return ct(float(v))
    if s.ctype == "__half":
        return ct(int(np.array(float(v), np.float16).view(np.uint16)))
    if s.ctype == "__nv_bfloat16":
        bits = torch.tensor(float(v), dtype=torch.bfloat16).view(torch.int16)
        return ct(int(bits) & 0xFFFF)
    iv = int(v)
    info = torch.iinfo(s.dtype)
    if iv != v or not info.min <= iv <= info.max:
        raise MXNetError(f"argument {s.name} ({s.ctype}) cannot hold {v!r}")
    return ct(iv)


def pack_args(specs, args):
    """``cuLaunchKernel``'s ``kernelParams``: an array of ``void*``, each
    pointing at one argument's storage.  Device pointers are 64-bit,
    ``int`` is 32-bit, ``int64_t`` 64-bit, half types their 16 bits.
    Returns ``(holders, params)``; keep ``holders`` alive until the
    launch returns."""
    holders = [ctypes.c_void_p(a._data.data_ptr()) if s.pointer
               else _scalar(s, a) for s, a in zip(specs, args)]
    params = (ctypes.c_void_p * len(holders))(
        *[ctypes.addressof(h) for h in holders])
    return holders, params


def cache_key(source: str, options=(), exports=(), arch: str = ARCH) -> str:
    """The CUBIN cache's key: a hash of everything the CUBIN depends on."""
    blob = json.dumps([source, list(options), list(exports), arch])
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# --------------------------------------------------------------------------- #
# NVRTC and libcuda, through ctypes (loaded at first use)
# --------------------------------------------------------------------------- #

def nvrtc_dirs() -> list:
    """The directories searched for ``libnvrtc.so``, in order:
    ``$CUDA_HOME/lib64``, ``/usr/local/cuda/lib64`` and the
    ``nvidia/cuda_nvrtc/lib`` directory of PyTorch's CUDA wheels."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(Path(os.environ["CUDA_HOME"]) / "lib64")
    dirs.append(Path("/usr/local/cuda/lib64"))
    dirs += [Path(p or ".") / "nvidia" / "cuda_nvrtc" / "lib"
             for p in sys.path]
    return list(dict.fromkeys(dirs))


def _include_dirs(lib_dir: Path) -> list:
    """Where ``cuda_bf16.h`` and ``cuda_fp16.h`` are: the toolkit beside
    the NVRTC that was found, then ``$CUDA_HOME`` and ``/usr/local/cuda``,
    then the wheels' ``cuda_runtime`` headers."""
    cands = [lib_dir.parent / "include"]
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "include")
    cands.append(Path("/usr/local/cuda/include"))
    cands += [Path(p or ".") / "nvidia" / "cuda_runtime" / "include"
              for p in sys.path]
    out = []
    for d in cands:
        if (d / "cuda_bf16.h").exists() and d not in out:
            out.append(d)
    return out


_lock = threading.Lock()
_libs: dict = {}


def _nvrtc():
    with _lock:
        if "nvrtc" in _libs:
            return _libs["nvrtc"]
        tried = []
        for d in nvrtc_dirs():
            names = sorted((p for p in d.glob("libnvrtc.so*")
                            if "builtins" not in p.name), reverse=True) \
                if d.is_dir() else []
            if not names:
                tried.append(f"{d} (no libnvrtc.so*)")
            for p in names:
                try:
                    lib = ctypes.CDLL(str(p))
                except OSError as e:
                    tried.append(f"{p} ({e})")
                    continue
                _declare_nvrtc(lib)
                _libs["nvrtc"] = (lib, d)
                return _libs["nvrtc"]
        raise MXNetError("NVRTC (libnvrtc.so) not found; looked in: "
                         + "; ".join(tried))


def _declare_nvrtc(lib):
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    CP, CPP = ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)
    sig = {
        "nvrtcCreateProgram": [ctypes.POINTER(P), CP, CP, I, CPP, CPP],
        "nvrtcAddNameExpression": [P, CP],
        "nvrtcCompileProgram": [P, I, CPP],
        "nvrtcGetProgramLogSize": [P, ctypes.POINTER(S)],
        "nvrtcGetProgramLog": [P, ctypes.c_char_p],
        "nvrtcGetCUBINSize": [P, ctypes.POINTER(S)],
        "nvrtcGetCUBIN": [P, ctypes.c_char_p],
        "nvrtcGetLoweredName": [P, CP, CPP],
        "nvrtcDestroyProgram": [ctypes.POINTER(P)],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, I
    lib.nvrtcGetErrorString.argtypes = [I]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p


def _cuda():
    with _lock:
        if "cuda" in _libs:
            return _libs["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"libcuda.so.1 cannot be "
                             f"loaded: {e}") from e
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        sig = {
            "cuInit": [U],
            "cuDeviceGet": [ctypes.POINTER(I), I],
            "cuCtxGetCurrent": [ctypes.POINTER(P)],
            "cuCtxSetCurrent": [P],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(P), I],
            "cuModuleLoadData": [ctypes.POINTER(P), P],
            "cuModuleGetFunction": [ctypes.POINTER(P), P, ctypes.c_char_p],
            "cuFuncSetAttribute": [P, I, I],
            "cuLaunchKernel": [P, U, U, U, U, U, U, U, P,
                               ctypes.POINTER(P), ctypes.POINTER(P)],
            "cuGetErrorName": [I, ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, I
        _cu_check(lib, lib.cuInit(0), "cuInit")
        _libs["cuda"] = lib
        return lib


def _cu_check(lib, res: int, what: str) -> None:
    if res:
        name = ctypes.c_char_p()
        lib.cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError(f"{what} failed: CUresult {res} "
                         f"({(name.value or b'?').decode()})")


def _nv_check(lib, res: int, what: str, log: str = "") -> None:
    if res:
        msg = lib.nvrtcGetErrorString(res).decode()
        raise MXNetError(f"{what} failed: {msg}" +
                         (f"\nNVRTC log:\n{log}" if log else ""))


def _compile(source, options, exports):
    """NVRTC: source -> (CUBIN bytes, {export: lowered name}, log)."""
    lib, lib_dir = _nvrtc()
    prog = ctypes.c_void_p()
    _nv_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _nv_check(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                      f"nvrtcAddNameExpression({name})")
        opts = [f"--gpu-architecture={ARCH}", "-std=c++17",
                *(f"-I{d}" for d in _include_dirs(lib_dir)), *options]
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        _nv_check(lib, lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                  "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _nv_check(lib, lib.nvrtcGetProgramLog(prog, buf),
                  "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        _nv_check(lib, res, "nvrtcCompileProgram", log)
        _nv_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                  "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nv_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nv_check(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({name})")
            lowered[name] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _write_atomic(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)      # a concurrent reader never sees half a file


def _bind_context(lib, index: int) -> None:
    """Make the card's primary context (the one PyTorch uses) current on
    this thread; the caller holds ``torch.cuda.device(index)``."""
    torch.cuda.init()
    torch.cuda.current_stream(index)
    ctx = ctypes.c_void_p()
    _cu_check(lib, lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        dev = ctypes.c_int()
        _cu_check(lib, lib.cuDeviceGet(ctypes.byref(dev), index),
                  "cuDeviceGet")
        _cu_check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _cu_check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


class _LaunchRecord(ctypes.Structure):
    """``struct RtcLaunch`` of ``csrc/rtc_launch.cu``: ``rtc_launch``'s
    whole argument list but the stream."""

    _fields_ = [("launch", ctypes.c_void_p), ("fn", ctypes.c_void_p),
                ("dims", ctypes.c_uint * 7), ("params", ctypes.c_void_p),
                ("count", ctypes.c_void_p)]


def _launcher():
    """``rtc_launch(record, stream)`` of ``csrc/rtc_launch.cu``, built at
    first use."""
    with _lock:
        if "launch" not in _libs:
            fn = _build.load("rtc_launch").rtc_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs["launch"] = fn
        return _libs["launch"]


# --------------------------------------------------------------------------- #
# the user-facing classes
# --------------------------------------------------------------------------- #

class CudaModule:
    """CUDA source compiled at run time (reference MXNet
    ``mx.rtc.CudaModule``).

    ``options`` are extra NVRTC flags; ``exports`` are name expressions
    (``"gelu_fwd<float>"``) made reachable by ``get_kernel``.  After
    construction, ``compile_seconds`` is the NVRTC time (0.0 when the
    CUBIN came from the cache, and ``cached`` is True) and ``log`` the
    NVRTC log."""

    def __init__(self, source: str, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule needs a CUDA card: this host "
                             "has none (rtc has no host path)")
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        key = cache_key(source, self.options, self.exports)
        cubin_path = BUILD_DIR / f"{key}.cubin"
        names_path = BUILD_DIR / f"{key}.json"
        t0 = time.perf_counter()
        self.cached = cubin_path.exists() and names_path.exists()
        if self.cached:
            self._cubin = cubin_path.read_bytes()
            self._lowered = json.loads(names_path.read_text())
            self.log = ""
            self.compile_seconds = 0.0
        else:
            self._cubin, self._lowered, self.log = _compile(
                source, self.options, self.exports)
            self.compile_seconds = time.perf_counter() - t0
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _write_atomic(cubin_path, self._cubin)
            _write_atomic(names_path, json.dumps(self._lowered).encode())
        self._modules = {}         # device index -> CUmodule
        self._load_lock = threading.Lock()

    def _module(self, index: int):
        with self._load_lock:
            mod = self._modules.get(index)
            if mod is None:
                lib = _cuda()
                with torch.cuda.device(index):
                    _bind_context(lib, index)
                    mod = ctypes.c_void_p()
                    _cu_check(lib, lib.cuModuleLoadData(
                        ctypes.byref(mod), self._cubin), "cuModuleLoadData")
                self._modules[index] = mod
            return mod

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (an ``extern "C"`` name or one of
        ``exports``) with its argument ``signature``."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))


# every kernel made, weakly: ``launch_total`` sums their launch counts
_KERNELS: "weakref.WeakSet[CudaKernel]" = weakref.WeakSet()


def launch_total() -> int:
    """The launches of every live ``CudaKernel`` (a CUDA graph's replays
    are not launches)."""
    return sum(k.launches for k in list(_KERNELS))


class CudaKernel:
    """One kernel of a ``CudaModule``; ``launches`` counts its launches."""

    def __init__(self, module: CudaModule, name: str, lowered: str, specs):
        self._module = module
        self.name = name
        self._lowered = lowered
        self._specs = specs
        self._functions = {}       # device index -> CUfunction
        self._shared_set = {}      # device index -> opted-in smem bytes
        self._by_key = {}          # launch_plan's key -> LaunchPlan
        self._plans = {}           # (ctx, grid, block, smem) as given -> plan
        self._lock = threading.Lock()
        self._count = ctypes.c_uint64(0)     # raised by rtc_launch
        self._function(torch.cuda.current_device())
        _KERNELS.add(self)

    @property
    def launches(self) -> int:
        """Launches ``cuLaunchKernel`` accepted; ``rtc_launch`` raises it
        by one in each, so a CUDA graph's replay does not count."""
        return self._count.value

    @launches.setter
    def launches(self, value: int):
        self._count.value = value

    def _function(self, index: int):
        fn = self._functions.get(index)
        if fn is None:
            lib = _cuda()
            mod = self._module._module(index)
            fn = ctypes.c_void_p()
            with torch.cuda.device(index):
                _cu_check(lib, lib.cuModuleGetFunction(
                    ctypes.byref(fn), mod, self._lowered.encode()),
                    f"cuModuleGetFunction({self.name})")
            self._functions[index] = fn
        return fn

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``grid_dims`` and
        ``block_dims`` (three each) and ``shared_mem`` bytes of dynamic
        shared memory, on PyTorch's current stream of that card.

        Under ``torch.cuda.graph`` the launch records into the graph (a
        replay is not a launch and is not counted); its first launch with
        given ``ctx``, dims and ``shared_mem`` builds the plan, which may
        set the kernel's shared-memory attribute, so make that one before
        the capture where it asks for more than 48 KB."""
        if type(args) is not list and type(args) is not tuple:
            args = list(args)
        try:
            plan = self._plans[ctx, grid_dims, block_dims, shared_mem]
        except (KeyError, TypeError):
            plan = self._plan(args, ctx, grid_dims, block_dims, shared_mem)
        record = plan.pack(args)[1]
        index = plan.index
        if torch._C._cuda_getDevice() == index:
            res = plan.call(record,
                            torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                res = plan.call(record,
                                torch._C._cuda_getCurrentRawStream(index))
        if res:
            _cu_check(_cuda(), res, f"cuLaunchKernel({self.name})")

    def _plan(self, args, ctx, grid_dims, block_dims, shared_mem):
        """The first launch with these ``ctx``, dims and ``shared_mem``
        (as given): every check of ``check_launch``, then the plan, built
        once per ``launch_plan`` key, with the function resolved and the
        dynamic shared memory opted into."""
        check_launch(self._specs, args, ctx, grid_dims, block_dims,
                     shared_mem)
        with self._lock:
            plan = launch_plan(self._by_key, self._specs, ctx, grid_dims,
                               block_dims, shared_mem)
            if plan.record is None:
                lib, index = _cuda(), plan.index
                fn = self._function(index)
                smem = plan.dims[-1]
                if smem > max(_STATIC_SHARED_BYTES,
                              self._shared_set.get(index, 0)):
                    with torch.cuda.device(index):
                        _cu_check(lib, lib.cuFuncSetAttribute(
                            fn, _ATTR_MAX_DYNAMIC_SHARED, smem),
                            f"cuFuncSetAttribute({self.name}, {smem} "
                            "bytes)")
                    self._shared_set[index] = smem
                plan.record = _LaunchRecord(
                    ctypes.cast(lib.cuLaunchKernel, ctypes.c_void_p).value,
                    fn.value, (ctypes.c_uint * 7)(*plan.dims), None,
                    ctypes.addressof(self._count))
                plan.call = _launcher()
            try:
                self._plans[ctx, grid_dims, block_dims, shared_mem] = plan
            except TypeError:      # unhashable dims (a list): checked anew
                pass
        return plan


_INT, _FLOAT, _OTHER = range(3)      # LaunchPlan's scalar kinds


class LaunchPlan:
    """A launch's fixed part for one signature, card, grid, block and
    ``shared_mem``: the dims as plain ints, each argument's check,
    whether the written pointers need the aliasing check (only when the
    signature has both ``const`` and written pointers), and, on each
    thread that packs it, a buffer of 8-byte argument slots with the
    ``void*`` array ``cuLaunchKernel`` takes pointing into it.  Built by
    ``launch_plan`` (plain, no card); ``CudaKernel`` adds ``rtc_launch``
    (``call``) and the launch record, with the function, that each thread
    copies (``record``); a plan for card -1 takes host arrays and only
    packs, for the tests of the packing.

    ``pack(args)`` is a launch's one pass over its arguments.  It writes
    what ``pack_args`` would into the slots, and refuses, by the plain
    checks and with their messages, whatever ``check_launch`` and
    ``pack_args`` refuse.  ``cuLaunchKernel`` copies the parameters when
    it is called, so a thread's slots are reused launch after launch;
    threads never share them."""

    def __init__(self, specs, index: int, grid, block, shared_mem: int):
        self.specs = tuple(specs)
        self.index = index          # -1: host arrays; such a plan only packs
        self.device = torch.device("cuda", index) if index >= 0 \
            else torch.device("cpu")
        self.dims = (*grid, *block, shared_mem)
        self.call = self.record = None
        self.pointers = tuple((i, s.dtype) for i, s in enumerate(self.specs)
                              if s.pointer)
        scalars = []
        for i, s in enumerate(self.specs):
            if s.pointer:
                continue
            if s.ctype in ("float", "double"):
                scalars.append((i, _FLOAT, s, 0, 0))
            elif s.dtype.is_floating_point:        # the 16-bit types
                scalars.append((i, _OTHER, s, 0, 0))
            else:
                info = torch.iinfo(s.dtype)
                scalars.append((i, _INT, s, info.min, info.max))
        self.scalars = tuple(scalars)
        self.const = tuple(i for i, s in enumerate(self.specs)
                           if s.pointer and s.const)
        self.written = tuple(i for i, s in enumerate(self.specs)
                             if s.pointer and not s.const)
        self.alias = bool(self.const and self.written)
        self._local = threading.local()

    def _slots(self):
        """This thread's slots: typed views into one buffer of 8-byte
        slots, each beside its argument's check; the ``void*`` array
        pointing at them; and (a card's plan) the thread's copy of the
        launch record, which points at that array, with its address."""
        n = len(self.specs)
        buf = (ctypes.c_uint64 * n)()
        views = [(ctypes.c_void_p if s.pointer else _CTYPES[s.ctype][1])
                 .from_buffer(buf, 8 * i) for i, s in enumerate(self.specs)]
        params = (ctypes.c_void_p * n)(
            *[ctypes.addressof(buf) + 8 * i for i in range(n)])
        record, address = None, 0
        if self.record is not None:      # its context current on the thread
            with torch.cuda.device(self.index):
                _bind_context(_cuda(), self.index)
            record = _LaunchRecord.from_buffer_copy(self.record)
            record.params = ctypes.addressof(params)
            address = ctypes.addressof(record)
        self._local.slots = slots = (
            tuple((i, dtype, views[i]) for i, dtype in self.pointers),
            tuple((*c, views[c[0]]) for c in self.scalars),
            params, address, record)
        return slots

    def pack(self, args):
        """Check ``args`` and write them into this thread's slots; returns
        the ``void*`` array and the address of the thread's launch record
        (0 for a plan without a function).  Touches no device memory."""
        try:
            pointers, scalars, params, address, _ = self._local.slots
        except AttributeError:
            pointers, scalars, params, address, _ = self._slots()
        if len(args) != len(self.specs):
            self._refuse(args)
        index = self.index
        for i, dtype, view in pointers:
            a = args[i]
            if not isinstance(a, NDArray):
                self._refuse(args)
            t = a._data
            if t.dtype is not dtype or not t.is_contiguous() \
                    or t.get_device() != index:
                self._refuse(args)
            view.value = t.data_ptr()
        for i, kind, s, lo, hi, view in scalars:
            a = args[i]
            if kind == _INT and type(a) is int and lo <= a <= hi:
                view.value = a
            elif kind == _FLOAT and type(a) is float:
                view.value = a
            else:
                view.value = self._other(s, a, args)
        if self.alias:
            read = {args[i]._data.untyped_storage().data_ptr()
                    for i in self.const}
            for i in self.written:
                if args[i]._data.untyped_storage().data_ptr() in read:
                    self._refuse(args)
        return params, address

    def _other(self, s, a, args):
        """A scalar off the fast tests (another number type, a half
        type, a value that does not fit): ``_scalar``'s bits."""
        if isinstance(a, (NDArray, bool, np.bool_)) \
                or not isinstance(a, numeric_types):
            self._refuse(args)
        try:
            return _scalar(s, a).value
        except MXNetError:
            self._refuse(args)

    def _refuse(self, args):
        """Raise what the plain checks raise for ``args``, in their order:
        ``check_args``, the placement checks of ``check_launch``, then
        ``pack_args``'s scalars."""
        check_args(self.specs, args)
        _check_placement(self.specs, args, self.device)
        pack_args(self.specs, args)
        raise MXNetError(f"launch refused by its plan ({len(args)} "
                         "arguments) but not by the plain checks")


def launch_plan(plans, specs, ctx, grid_dims, block_dims, shared_mem):
    """The ``LaunchPlan`` in the dict ``plans`` for a launch of a kernel
    of signature ``specs`` on ``ctx`` with these dims and ``shared_mem``,
    built there at first use.  Its key is the signature's argument kinds
    and types, the card, the grid, the block and ``shared_mem``; a GPU
    context, three positive dims each and at most ``MAX_SHARED_BYTES``
    are required, as ``check_launch`` requires them."""
    grid, block = _gpu_dims(ctx, grid_dims, block_dims)
    shared_mem = _shared(shared_mem)
    key = (tuple((s.ctype, s.pointer, s.const) for s in specs),
           ctx.device_id, grid, block, shared_mem)
    plan = plans.get(key)
    if plan is None:
        plan = plans[key] = LaunchPlan(specs, ctx.device_id, grid, block,
                                       shared_mem)
    return plan


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1:
        raise MXNetError(f"{what} must be three positive integers, got "
                         f"{dims}")
    return dims


def check_launch(specs, args, ctx, grid_dims, block_dims, shared_mem):
    """Everything a launch checks before it touches the card: a GPU
    context, three grid and three block dimensions, the arguments
    (``check_args``), at most ``MAX_SHARED_BYTES`` of shared memory, and
    every array on the context's card.  Returns ``(card index, grid,
    block, shared_mem)``."""
    grid, block = _gpu_dims(ctx, grid_dims, block_dims)
    check_args(specs, args)
    shared_mem = _shared(shared_mem)
    dev = _check_placement(specs, args, ctx)
    return dev.index, grid, block, shared_mem


def _gpu_dims(ctx, grid_dims, block_dims):
    if not isinstance(ctx, Context) or ctx.device_type != "gpu":
        raise MXNetError(f"a CUDA kernel launches on a GPU context, not "
                         f"{ctx!r}")
    return _dims(grid_dims, "grid_dims"), _dims(block_dims, "block_dims")


def _shared(shared_mem) -> int:
    shared_mem = int(shared_mem)
    if not 0 <= shared_mem <= MAX_SHARED_BYTES:
        raise MXNetError(f"shared_mem={shared_mem} bytes: a block may use "
                         f"at most {MAX_SHARED_BYTES}")
    return shared_mem


def _check_placement(specs, args, where):
    """Every array on the card: none on the host, then each on ``where``
    (a ``Context``, or a plan's ``torch.device``), which is returned as a
    ``torch.device``."""
    for s, a in zip(specs, args):
        if s.pointer and a._data.device.type != "cuda":
            raise MXNetError(f"argument {s.name} is on the host "
                             f"({a.context}): rtc kernels run on the card")
    dev = where.torch_device() if isinstance(where, Context) else where
    for s, a in zip(specs, args):
        if s.pointer and a._data.device != dev:
            raise MXNetError(f"argument {s.name} is on {a._data.device}, "
                             f"the launch on {dev}")
    return dev


class PallasModule:
    """The reference's TPU module of Pallas kernel functions; on the card
    user kernels are CUDA source."""

    def __init__(self, *a, **kw):
        raise MXNetError(
            "mx.rtc.PallasModule runs Pallas kernels on a TPU, which "
            "mxnet_tpu_torch does not target; use mx.rtc.CudaModule with "
            "CUDA C++ source, compiled at run time by NVRTC")
