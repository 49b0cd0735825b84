"""Hosts of the port's C ABI (``mxnet_tpu_torch/native/mxtpu_c_api.cc``),
shared by ``tests/test_torch_capi.py`` and ``chip_smoke.py``'s phase 29.
No JAX and no ``mxnet_tpu``: plain strings, ``ctypes`` and NumPy.

- ``PREDICT_HOST``: a C program that serves an exported pair through
  ``MXPred*`` on ``dev_type`` 1 or 2, times each forward, and writes the
  first output's float32 bytes to a file.
- ``TRAIN_HOST``: the MLP training loop of ``tests/test_c_api.py`` (shapes
  inferred from the data's, an executor bound on ``dev_type``, SGD in C),
  which saves its arguments with ``MXNDArraySave`` at the end.
- ``ctypes_predict``/``ctypes_train``: the same calls through ``ctypes``;
  run this file as a script (``python _torch_capi_hosts.py LIB SPEC``) to
  make them in a child process, which prints ``CAPI_RESULT <json>``.

The training data and initial weights come from the same 32-bit LCG in C
and in ``lcg_init``, so a Python executor can be held against the hosts.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as onp

B, NF, H, NC = 64, 16, 32, 3       # the training MLP's batch and widths
LR = 0.5

_DECLS = r"""
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
typedef unsigned int mx_uint;
typedef void *PredictorHandle;
typedef void *NDArrayHandle;
typedef void *SymbolHandle;
typedef void *ExecutorHandle;
extern "C" {
const char *MXGetLastError();
int MXGetVersion(int *);
int MXPredCreate(const char *, const char *, int, int, mx_uint,
                 const char **, const mx_uint *, const mx_uint *,
                 PredictorHandle *);
int MXPredSetInput(PredictorHandle, const char *, const float *, mx_uint);
int MXPredForward(PredictorHandle);
int MXPredGetOutputShape(PredictorHandle, mx_uint, mx_uint **, mx_uint *);
int MXPredGetOutput(PredictorHandle, mx_uint, float *, mx_uint);
int MXPredFree(PredictorHandle);
int MXNDArrayCreate(const mx_uint *, mx_uint, int, int, int,
                    NDArrayHandle *);
int MXNDArrayFree(NDArrayHandle);
int MXNDArraySyncCopyFromCPU(NDArrayHandle, const void *, size_t);
int MXNDArraySyncCopyToCPU(NDArrayHandle, void *, size_t);
int MXNDArraySave(const char *, mx_uint, NDArrayHandle *, const char **);
int MXSymbolCreateFromFile(const char *, SymbolHandle *);
int MXSymbolFree(SymbolHandle);
int MXSymbolListArguments(SymbolHandle, mx_uint *, const char ***);
int MXSymbolInferShape(SymbolHandle, mx_uint, const char **,
    const mx_uint *, const mx_uint *,
    mx_uint *, const mx_uint **, const mx_uint ***,
    mx_uint *, const mx_uint **, const mx_uint ***,
    mx_uint *, const mx_uint **, const mx_uint ***, int *);
int MXExecutorBind(SymbolHandle, int, int, mx_uint, NDArrayHandle *,
                   NDArrayHandle *, mx_uint *, mx_uint, NDArrayHandle *,
                   ExecutorHandle *);
int MXExecutorForward(ExecutorHandle, int);
int MXExecutorBackward(ExecutorHandle, mx_uint, NDArrayHandle *);
int MXExecutorOutputs(ExecutorHandle, mx_uint *, NDArrayHandle **);
int MXExecutorFree(ExecutorHandle);
}
#define CHECK(x) if ((x) != 0) { \
    fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, \
            MXGetLastError()); return 1; }
static double now_ms(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e3 + t.tv_nsec / 1e6;
}
"""

PREDICT_HOST = _DECLS + r"""
/* host SYMBOL PARAMS DEV_TYPE IN.bin OUT.bin REPEATS KEY=D0xD1x... ...
   IN.bin holds every input's float32 values, in the keys' order */
int main(int argc, char **argv) {
  if (argc < 8) { fprintf(stderr, "usage\n"); return 2; }
  int dev_type = atoi(argv[3]), repeats = atoi(argv[6]);
  mx_uint nk = (mx_uint)(argc - 7);
  const char *keys[16];
  mx_uint indptr[17], dims[64], sizes[16];
  char names[16][64];
  indptr[0] = 0;
  for (mx_uint k = 0; k < nk; ++k) {
    const char *spec = argv[7 + k];
    const char *eq = strchr(spec, '=');
    size_t n = (size_t)(eq - spec);
    memcpy(names[k], spec, n);
    names[k][n] = 0;
    keys[k] = names[k];
    mx_uint nd = indptr[k], size = 1;
    for (const char *p = eq + 1; *p;) {
      dims[nd] = (mx_uint)strtoul(p, (char **)&p, 10);
      size *= dims[nd++];
      if (*p == 'x') ++p;
    }
    indptr[k + 1] = nd;
    sizes[k] = size;
  }
  int ver;
  CHECK(MXGetVersion(&ver));
  PredictorHandle h;
  CHECK(MXPredCreate(argv[1], argv[2], dev_type, 0, nk, keys, indptr, dims,
                     &h));
  FILE *fin = fopen(argv[4], "rb");
  if (!fin) { fprintf(stderr, "cannot read %s\n", argv[4]); return 1; }
  for (mx_uint k = 0; k < nk; ++k) {
    float *buf = (float *)malloc(sizes[k] * sizeof(float));
    if (fread(buf, sizeof(float), sizes[k], fin) != sizes[k]) return 1;
    CHECK(MXPredSetInput(h, keys[k], buf, sizes[k]));
    free(buf);
  }
  fclose(fin);
  mx_uint *sh, ndim;
  size_t total = 0;
  float *out = NULL;
  printf("version=%d\n", ver);
  for (int r = 0; r < repeats; ++r) {
    double t0 = now_ms();
    CHECK(MXPredForward(h));
    CHECK(MXPredGetOutputShape(h, 0, &sh, &ndim));
    if (!out) {
      total = 1;
      for (mx_uint d = 0; d < ndim; ++d) total *= sh[d];
      out = (float *)malloc(total * sizeof(float));
    }
    CHECK(MXPredGetOutput(h, 0, out, (mx_uint)total));
    printf("forward_ms=%.4f\n", now_ms() - t0);
  }
  printf("shape=");
  for (mx_uint d = 0; d < ndim; ++d) printf(d ? ",%u" : "%u", sh[d]);
  printf("\n");
  FILE *fo = fopen(argv[5], "wb");
  if (!fo || fwrite(out, sizeof(float), total, fo) != total) return 1;
  fclose(fo);
  free(out);
  CHECK(MXPredFree(h));
  printf("C_PREDICT_OK\n");
  return 0;
}
"""

TRAIN_HOST = _DECLS + r"""
#define B 64
#define NF 16
#define NC 3
static unsigned lcg_state = 12345u;
static float frand(void) {  /* deterministic U(-0.5, 0.5) */
  lcg_state = lcg_state * 1664525u + 1013904223u;
  return ((lcg_state >> 8) & 0xFFFFFF) / 16777216.0f - 0.5f;
}
/* host SYMBOL DEV_TYPE STEPS OUT.params */
int main(int argc, char **argv) {
  if (argc < 5) { fprintf(stderr, "usage\n"); return 2; }
  int dev_type = atoi(argv[2]), steps = atoi(argv[3]);
  SymbolHandle sym;
  CHECK(MXSymbolCreateFromFile(argv[1], &sym));
  mx_uint n_args; const char **arg_names;
  CHECK(MXSymbolListArguments(sym, &n_args, &arg_names));
  const char *keys[] = {"data", "label"};
  mx_uint indptr[] = {0, 2, 3};
  mx_uint shape_data[] = {B, NF, B};
  mx_uint in_n, out_n, aux_n; int complete;
  const mx_uint *in_nd, *out_nd, *aux_nd;
  const mx_uint **in_sh, **out_sh, **aux_sh;
  CHECK(MXSymbolInferShape(sym, 2, keys, indptr, shape_data,
                           &in_n, &in_nd, &in_sh, &out_n, &out_nd, &out_sh,
                           &aux_n, &aux_nd, &aux_sh, &complete));
  printf("n_args=%u inferred in=%u out=%u complete=%d\n", n_args, in_n,
         out_n, complete);
  if (in_n != n_args) return 1;
  NDArrayHandle args[16], grads[16];
  mx_uint reqs[16], sizes[16];
  char names[16][64];
  const char *name_ptrs[16];
  for (mx_uint i = 0; i < in_n; ++i) {
    snprintf(names[i], 64, "%s", arg_names[i]);
    name_ptrs[i] = names[i];
  }
  for (mx_uint i = 0; i < in_n; ++i) {
    CHECK(MXNDArrayCreate(in_sh[i], in_nd[i], dev_type, 0, 0, &args[i]));
    mx_uint sz = 1;
    for (mx_uint d = 0; d < in_nd[i]; ++d) sz *= in_sh[i][d];
    sizes[i] = sz;
    int is_param = strcmp(names[i], "data") != 0 &&
                   strcmp(names[i], "label") != 0;
    reqs[i] = is_param ? 1 : 0;
    grads[i] = NULL;
    if (is_param) {
      CHECK(MXNDArrayCreate(in_sh[i], in_nd[i], dev_type, 0, 0, &grads[i]));
      float *init = (float *)malloc(sz * sizeof(float));
      for (mx_uint j = 0; j < sz; ++j) init[j] = 0.2f * frand();
      CHECK(MXNDArraySyncCopyFromCPU(args[i], init, sz));
      free(init);
    }
  }
  float x[B * NF], y[B];
  for (int i = 0; i < B; ++i) {
    int c = i % NC;
    y[i] = (float)c;
    for (int f = 0; f < NF; ++f)
      x[i * NF + f] = 0.3f * frand() + (f == c ? 2.0f : 0.0f);
  }
  for (mx_uint i = 0; i < in_n; ++i) {
    if (strcmp(names[i], "data") == 0)
      CHECK(MXNDArraySyncCopyFromCPU(args[i], x, B * NF));
    if (strcmp(names[i], "label") == 0)
      CHECK(MXNDArraySyncCopyFromCPU(args[i], y, B));
  }
  ExecutorHandle exec;
  CHECK(MXExecutorBind(sym, dev_type, 0, in_n, args, grads, reqs, 0, NULL,
                       &exec));
  float first_loss = 0.0f, loss = 0.0f, lr = 0.5f;
  double t0 = now_ms();
  for (int step = 0; step < steps; ++step) {
    CHECK(MXExecutorForward(exec, 1));
    mx_uint n_out; NDArrayHandle *outs;
    CHECK(MXExecutorOutputs(exec, &n_out, &outs));
    CHECK(MXNDArraySyncCopyToCPU(outs[0], &loss, 1));
    for (mx_uint i = 0; i < n_out; ++i) MXNDArrayFree(outs[i]);
    if (step == 0) first_loss = loss;
    CHECK(MXExecutorBackward(exec, 0, NULL));
    for (mx_uint i = 0; i < in_n; ++i) {
      if (reqs[i] == 0) continue;
      float *w = (float *)malloc(sizes[i] * sizeof(float));
      float *g = (float *)malloc(sizes[i] * sizeof(float));
      CHECK(MXNDArraySyncCopyToCPU(args[i], w, sizes[i]));
      CHECK(MXNDArraySyncCopyToCPU(grads[i], g, sizes[i]));
      for (mx_uint j = 0; j < sizes[i]; ++j) w[j] -= lr * g[j];
      CHECK(MXNDArraySyncCopyFromCPU(args[i], w, sizes[i]));
      free(w); free(g);
    }
  }
  printf("step_ms=%.4f\n", (now_ms() - t0) / steps);
  printf("first_loss=%.9g last_loss=%.9g\n", first_loss, loss);
  CHECK(MXNDArraySave(argv[4], in_n, args, name_ptrs));
  CHECK(MXExecutorFree(exec));
  for (mx_uint i = 0; i < in_n; ++i) {
    CHECK(MXNDArrayFree(args[i]));
    if (grads[i]) CHECK(MXNDArrayFree(grads[i]));
  }
  CHECK(MXSymbolFree(sym));
  printf("C_TRAIN_OK\n");
  return 0;
}
"""


def compile_host(src, exe, link_flags):
    """``src`` compiled with ``g++`` into ``exe``, linked to the C ABI
    library by ``link_flags`` (``_build.capi_link_flags()``)."""
    path = str(exe) + ".cc"
    with open(path, "w") as f:
        f.write(src)
    proc = subprocess.run(["g++", "-O2", path, "-o", str(exe),
                           *link_flags], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {path}:\n{proc.stderr[-3000:]}")
    return str(exe)


def shape_arg(name, shape):
    return f"{name}=" + "x".join(str(int(d)) for d in shape)


# ---------------------------------------------------------------------- #
# the training MLP's data, as the C host draws it
# ---------------------------------------------------------------------- #

class Lcg:
    def __init__(self):
        self.state = 12345

    def frand(self):
        self.state = (self.state * 1664525 + 1013904223) & 0xFFFFFFFF
        return onp.float32((self.state >> 8) & 0xFFFFFF) / \
            onp.float32(16777216.0) - onp.float32(0.5)


def lcg_init(arg_names, arg_shapes):
    """``{name: initial value}`` for every argument, drawn as the C host
    draws them: the parameters in argument order, then the data."""
    rng = Lcg()
    out = {}
    for nm, shp in zip(arg_names, arg_shapes):
        if nm in ("data", "label"):
            continue
        n = int(onp.prod(shp))
        out[nm] = onp.array([onp.float32(0.2) * rng.frand()
                             for _ in range(n)], onp.float32).reshape(shp)
    x = onp.zeros((B, NF), onp.float32)
    y = onp.zeros((B,), onp.float32)
    for i in range(B):
        c = i % NC
        y[i] = c
        for f in range(NF):
            x[i, f] = onp.float32(0.3) * rng.frand() + onp.float32(
                2.0 if f == c else 0.0)
    out["data"], out["label"] = x, y
    return out


def sgd_reference(executor_step, arg_names, init, steps):
    """``steps`` of the C host's loop on a Python executor:
    ``executor_step(values)`` returns ``(loss, {name: grad})``."""
    vals = {k: v.copy() for k, v in init.items()}
    losses = []
    for _ in range(steps):
        loss, grads = executor_step(vals)
        losses.append(loss)
        for nm, g in grads.items():
            vals[nm] = (vals[nm] - onp.float32(LR) * g).astype(onp.float32)
    return vals, losses


# ---------------------------------------------------------------------- #
# the ctypes host
# ---------------------------------------------------------------------- #

def _lib(path):
    lib = ctypes.CDLL(path)
    lib.MXGetLastError.restype = ctypes.c_char_p
    return lib


def _err(lib):
    return lib.MXGetLastError().decode(errors="replace")


def _check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: {_err(lib)}")


def _uints(vals):
    return (ctypes.c_uint * len(vals))(*[int(v) for v in vals])


def _floats(a):
    a = onp.ascontiguousarray(a, onp.float32).ravel()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a


def ctypes_predict(lib, sym, params, dev_type, inputs, repeats=1,
                   before_free=None):
    """``MXPred*`` through ctypes; ``inputs`` is ``[(name, array)]``.
    Returns ``(first output, shape, ms a forward, outputs, what
    before_free() returned just before MXPredFree)``."""
    names = [n.encode() for n, _ in inputs]
    keys = (ctypes.c_char_p * len(names))(*names)
    indptr, dims = [0], []
    for _, a in inputs:
        dims += list(a.shape)
        indptr.append(len(dims))
    h = ctypes.c_void_p()
    _check(lib, lib.MXPredCreate(sym.encode(), params.encode(), dev_type, 0,
                                 len(inputs), keys, _uints(indptr),
                                 _uints(dims), ctypes.byref(h)),
           "MXPredCreate")
    for (n, a) in inputs:
        ptr, keep = _floats(a)
        _check(lib, lib.MXPredSetInput(h, n.encode(), ptr, keep.size),
               "MXPredSetInput")
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _check(lib, lib.MXPredForward(h), "MXPredForward")
        sh = ctypes.POINTER(ctypes.c_uint)()
        nd = ctypes.c_uint()
        _check(lib, lib.MXPredGetOutputShape(h, 0, ctypes.byref(sh),
                                             ctypes.byref(nd)),
               "MXPredGetOutputShape")
        shape = tuple(sh[i] for i in range(nd.value))
        out = onp.empty(shape, onp.float32)
        _check(lib, lib.MXPredGetOutput(
            h, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size), "MXPredGetOutput")
        ms.append((time.perf_counter() - t0) * 1e3)
    n_out = ctypes.c_uint()
    _check(lib, lib.MXPredGetNumOutputs(h, ctypes.byref(n_out)),
           "MXPredGetNumOutputs")
    seen = before_free() if before_free is not None else None
    _check(lib, lib.MXPredFree(h), "MXPredFree")
    return out, shape, ms, n_out.value, seen


def _nd(lib, shape, dev_type, values=None):
    h = ctypes.c_void_p()
    _check(lib, lib.MXNDArrayCreate(_uints(shape), len(shape), dev_type, 0,
                                    0, ctypes.byref(h)), "MXNDArrayCreate")
    if values is not None:
        ptr, keep = _floats(values)
        _check(lib, lib.MXNDArraySyncCopyFromCPU(h, ptr, keep.size),
               "MXNDArraySyncCopyFromCPU")
    return h


def _read(lib, h, shape):
    out = onp.empty(shape, onp.float32)
    _check(lib, lib.MXNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size),
        "MXNDArraySyncCopyToCPU")
    return out


def ctypes_train(lib, symf, dev_type, steps, out_params):
    """The training host's calls through ctypes; saves the arguments to
    ``out_params`` and returns the losses."""
    sym = ctypes.c_void_p()
    _check(lib, lib.MXSymbolCreateFromFile(symf.encode(), ctypes.byref(sym)),
           "MXSymbolCreateFromFile")
    n = ctypes.c_uint()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXSymbolListArguments(sym, ctypes.byref(n),
                                          ctypes.byref(arr)),
           "MXSymbolListArguments")
    names = [arr[i].decode() for i in range(n.value)]
    keys = (ctypes.c_char_p * 2)(b"data", b"label")
    counts = [ctypes.c_uint() for _ in range(3)]
    ndims = [ctypes.POINTER(ctypes.c_uint)() for _ in range(3)]
    datas = [ctypes.POINTER(ctypes.POINTER(ctypes.c_uint))()
             for _ in range(3)]
    complete = ctypes.c_int()
    _check(lib, lib.MXSymbolInferShape(
        sym, 2, keys, _uints([0, 2, 3]), _uints([B, NF, B]),
        *[x for g in range(3) for x in (ctypes.byref(counts[g]),
                                        ctypes.byref(ndims[g]),
                                        ctypes.byref(datas[g]))],
        ctypes.byref(complete)), "MXSymbolInferShape")
    shapes = [tuple(datas[0][i][d] for d in range(ndims[0][i]))
              for i in range(counts[0].value)]
    init = lcg_init(names, shapes)
    args, grads, reqs = [], [], []
    for nm, shp in zip(names, shapes):
        args.append(_nd(lib, shp, dev_type, init[nm]))
        param = nm not in ("data", "label")
        grads.append(_nd(lib, shp, dev_type) if param else None)
        reqs.append(1 if param else 0)
    ex = ctypes.c_void_p()
    arg_arr = (ctypes.c_void_p * len(args))(*[a.value for a in args])
    grad_arr = (ctypes.c_void_p * len(args))(
        *[g.value if g is not None else None for g in grads])
    _check(lib, lib.MXExecutorBind(sym, dev_type, 0, len(args), arg_arr,
                                   grad_arr, _uints(reqs), 0, None,
                                   ctypes.byref(ex)), "MXExecutorBind")
    losses = []
    for _ in range(steps):
        _check(lib, lib.MXExecutorForward(ex, 1), "MXExecutorForward")
        n_out = ctypes.c_uint()
        outs = ctypes.POINTER(ctypes.c_void_p)()
        _check(lib, lib.MXExecutorOutputs(ex, ctypes.byref(n_out),
                                          ctypes.byref(outs)),
               "MXExecutorOutputs")
        losses.append(float(_read(lib, ctypes.c_void_p(outs[0]), (1,))[0]))
        for i in range(n_out.value):
            lib.MXNDArrayFree(ctypes.c_void_p(outs[i]))
        _check(lib, lib.MXExecutorBackward(ex, 0, None),
               "MXExecutorBackward")
        for a, g, shp in zip(args, grads, shapes):
            if g is None:
                continue
            w = _read(lib, a, shp)
            w -= onp.float32(LR) * _read(lib, g, shp)
            ptr, keep = _floats(w)
            _check(lib, lib.MXNDArraySyncCopyFromCPU(a, ptr, keep.size),
                   "MXNDArraySyncCopyFromCPU")
    cnames = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
    _check(lib, lib.MXNDArraySave(out_params.encode(), len(args), arg_arr,
                                  cnames), "MXNDArraySave")
    lib.MXExecutorFree(ex)
    for a in args + [g for g in grads if g is not None]:
        lib.MXNDArrayFree(a)
    lib.MXSymbolFree(sym)
    return losses


def surface(lib, tmpdir, symf):
    """The rest of the ABI through ctypes, on the CPU: version, errors
    and ``MXGetLastError``, NDArray copies, shape, dtype, save and load,
    symbol save, the op list and ``MXImperativeInvoke[Ex]`` (an
    allocated output, an ``out`` handle, an unknown op), and
    ``dev_type`` 2 calls.  Returns what a test checks."""
    out = {}
    ver = ctypes.c_int()
    _check(lib, lib.MXGetVersion(ctypes.byref(ver)), "MXGetVersion")
    out["version"] = ver.value
    h = ctypes.c_void_p()
    keys = (ctypes.c_char_p * 1)(b"data")
    out["bad_file"] = (lib.MXPredCreate(
        b"/nonexistent-symbol.json", b"", 1, 0, 1, keys, _uints([0, 1]),
        _uints([4]), ctypes.byref(h)), _err(lib))
    out["gpu_pred"] = (lib.MXPredCreate(
        symf.encode(), b"", 2, 0, 1, keys, _uints([0, 1]), _uints([4]),
        ctypes.byref(h)), _err(lib))
    out["gpu_nd"] = (lib.MXNDArrayCreate(_uints([3]), 1, 2, 0, 0,
                                         ctypes.byref(h)), _err(lib))
    vals = onp.arange(12, dtype=onp.float32) * 0.5
    a = _nd(lib, (3, 4), 1, vals)
    out["round_trip"] = _read(lib, a, (3, 4)).ravel().tolist()
    nd, pdata = ctypes.c_uint(), ctypes.POINTER(ctypes.c_uint)()
    _check(lib, lib.MXNDArrayGetShape(a, ctypes.byref(nd),
                                      ctypes.byref(pdata)), "GetShape")
    out["shape"] = [pdata[i] for i in range(nd.value)]
    dt = ctypes.c_int()
    _check(lib, lib.MXNDArrayGetDType(a, ctypes.byref(dt)), "GetDType")
    out["dtype"] = dt.value
    small = (ctypes.c_float * 2)()
    out["mismatch"] = (lib.MXNDArraySyncCopyToCPU(a, small, 2), _err(lib))
    fn = os.path.join(tmpdir, "w.params").encode()
    k = (ctypes.c_char_p * 1)(b"weight")
    _check(lib, lib.MXNDArraySave(fn, 1, ctypes.byref(a), k), "Save")
    n, nn = ctypes.c_uint(), ctypes.c_uint()
    arrs = ctypes.POINTER(ctypes.c_void_p)()
    names = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXNDArrayLoad(fn, ctypes.byref(n), ctypes.byref(arrs),
                                  ctypes.byref(nn), ctypes.byref(names)),
           "Load")
    out["loaded"] = (n.value, names[0].decode(), _read(
        lib, ctypes.c_void_p(arrs[0]), (3, 4)).ravel().tolist())
    lib.MXNDArrayFree(ctypes.c_void_p(arrs[0]))
    sh = ctypes.c_void_p()
    _check(lib, lib.MXSymbolCreateFromFile(symf.encode(), ctypes.byref(sh)),
           "MXSymbolCreateFromFile")
    resaved = os.path.join(tmpdir, "resaved.json")
    _check(lib, lib.MXSymbolSaveToFile(sh, resaved.encode()), "SaveToFile")
    out["resaved"] = resaved
    lib.MXSymbolFree(sh)
    cnt = ctypes.c_uint()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    _check(lib, lib.MXListAllOpNames(ctypes.byref(cnt), ctypes.byref(arr)),
           "MXListAllOpNames")
    out["ops"] = [arr[i].decode() for i in range(cnt.value)]
    # dot with an allocated output; sgd_update through an out handle
    op = ctypes.c_void_p()
    _check(lib, lib.NNGetOpHandle(b"dot", ctypes.byref(op)), "NNGetOpHandle")
    x = _nd(lib, (2, 3), 1, onp.arange(1, 7, dtype=onp.float32))
    y = _nd(lib, (3, 2), 1, onp.array([1, 0, 0, 1, 1, 1], onp.float32))
    ins = (ctypes.c_void_p * 2)(x.value, y.value)
    n_out = ctypes.c_int(0)
    outs = ctypes.POINTER(ctypes.c_void_p)()
    _check(lib, lib.MXImperativeInvoke(op, 2, ins, ctypes.byref(n_out),
                                       ctypes.byref(outs), 0, None, None),
           "invoke dot")
    out["dot"] = (n_out.value, _read(lib, ctypes.c_void_p(outs[0]),
                                     (2, 2)).ravel().tolist())
    lib.MXNDArrayFree(ctypes.c_void_p(outs[0]))
    _check(lib, lib.NNGetOpHandle(b"sgd_update", ctypes.byref(op)),
           "NNGetOpHandle")
    w = _nd(lib, (4,), 1, onp.ones(4, onp.float32))
    g = _nd(lib, (4,), 1, onp.arange(1, 5, dtype=onp.float32))
    ins = (ctypes.c_void_p * 2)(w.value, g.value)
    wout = (ctypes.c_void_p * 1)(w.value)
    pout = ctypes.cast(wout, ctypes.POINTER(ctypes.c_void_p))
    n_out = ctypes.c_int(1)
    pk = (ctypes.c_char_p * 2)(b"lr", b"wd")
    pv = (ctypes.c_char_p * 2)(b"0.5", b"0.0")
    _check(lib, lib.MXImperativeInvoke(op, 2, ins, ctypes.byref(n_out),
                                       ctypes.byref(pout), 2, pk, pv),
           "invoke sgd_update")
    out["sgd"] = (n_out.value, _read(lib, w, (4,)).tolist())
    _check(lib, lib.NNGetOpHandle(b"transpose", ctypes.byref(op)),
           "NNGetOpHandle")
    stypes = ctypes.POINTER(ctypes.c_int)()
    n_out = ctypes.c_int(0)
    ins = (ctypes.c_void_p * 1)(x.value)
    _check(lib, lib.MXImperativeInvokeEx(
        op, 1, ins, ctypes.byref(n_out), ctypes.byref(outs), 1,
        (ctypes.c_char_p * 1)(b"axes"), (ctypes.c_char_p * 1)(b"(1, 0)"),
        ctypes.byref(stypes)), "invoke transpose")
    out["transpose"] = (n_out.value, stypes[0], _read(
        lib, ctypes.c_void_p(outs[0]), (3, 2)).ravel().tolist())
    out["unknown_op"] = (lib.NNGetOpHandle(b"definitely_not_an_op",
                                           ctypes.byref(op)), _err(lib))
    out["not_ported"] = (lib.NNGetOpHandle(b"ring_attention",
                                           ctypes.byref(op)), _err(lib))
    return out


def _child(lib_path, spec):
    """The jobs of ``spec`` through ctypes in this process; ``port``
    counts come from ``mxnet_tpu_torch`` (the library runs in this
    interpreter)."""
    lib = _lib(lib_path)
    res = {}
    for job in spec["jobs"]:
        kind = job["kind"]
        if kind == "predict":
            ins = [(n, onp.fromfile(job["inputs"], onp.float32, count=int(
                onp.prod(s)), offset=off).reshape(s))
                for n, s, off in job["specs"]]
            before = _launches()
            out, shape, ms, n_out, launches = ctypes_predict(
                lib, job["symbol"], job["params"], job["dev_type"], ins,
                job.get("repeats", 1), lambda: _launch_delta(before))
            res[job["name"]] = dict(shape=shape, ms=ms, num_outputs=n_out,
                                    launches=launches)
            out.tofile(job["out"])
        elif kind == "train":
            t0 = time.perf_counter()
            losses = ctypes_train(lib, job["symbol"], job["dev_type"],
                                  job["steps"], job["out"])
            res[job["name"]] = dict(losses=losses, seconds=time.perf_counter()
                                    - t0)
        elif kind == "surface":
            res[job["name"]] = surface(lib, job["dir"], job["symbol"])
    print("CAPI_RESULT " + json.dumps(res), flush=True)


def _launches():
    """The port's kernel launches so far, as the card ran them (the
    library runs in this interpreter): the wrappers' counters, where a
    capture counted the kernels it recorded once, plus a captured
    program's launches for every replay after that first one."""
    mod = sys.modules.get("mxnet_tpu_torch.capi_shim")
    if mod is None:
        return {}
    from mxnet_tpu_torch.gluon.block import _launch_counts

    counts = dict(_launch_counts())
    for entry in list(mod._handles.values()):
        pred = entry.get("pred") if isinstance(entry, dict) else None
        prog = getattr(pred, "_prog", None)
        if prog is not None:
            for k, v in (prog.launches or {}).items():
                counts[k] = counts.get(k, 0) + v * (prog.replays - 1)
    return counts


def _launch_delta(before):
    now = _launches()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def run_child(lib_path, spec, env=None, timeout=600):
    """Run ``spec``'s jobs in a child Python process; returns its result
    dict (raises with the child's output when it fails)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(lib_path),
         json.dumps(spec)], capture_output=True, text=True, env=env,
        timeout=timeout)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("CAPI_RESULT ")]
    if proc.returncode or not line:
        raise RuntimeError(f"ctypes host failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(line[-1][len("CAPI_RESULT "):])


if __name__ == "__main__":
    _child(sys.argv[1], json.loads(sys.argv[2]))
