"""Python side of the port's flat C ABI (``native/mxtpu_c_api.cc``).

Port of ``mxnet_tpu/capi_shim.py``.  The C library (built by
``_build.capi_library()``) embeds CPython, or reuses the interpreter of
a host that runs one (a ctypes caller), and forwards each ``MX*`` call
here.  This module keeps the handle table and marshals float32 bytes;
every function takes and returns plain types (int handles, bytes,
tuples), so the C side needs only the stable CPython object protocol.

Devices follow MXNet's enum: ``dev_type`` 1 is the CPU and 2 is
``cuda:<dev_id>``; a ``dev_type`` 2 call without CUDA raises
``MXNetError``, whose text the C caller reads from ``MXGetLastError``.
``MXPredCreate``, ``MXNDArrayCreate`` and ``MXExecutorBind`` pass their
device through (the reference drops it in the last two, which on the
port would put every array on the card).  ``MXNDArrayLoad`` has no
device argument: it loads onto the CPU.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

from .base import MXNetError

_lock = threading.Lock()
_handles: dict = {}
_next_id = [1]

_DEV_TYPES = {1: "cpu", 2: "gpu"}       # MXNet's kCPU, kGPU


def _context(dev_type, dev_id):
    """MXNet's ``(dev_type, dev_id)`` as a context; raises MXNetError for
    a card that is not there."""
    from .context import Context

    kind = _DEV_TYPES.get(int(dev_type))
    if kind is None:
        raise MXNetError(f"unknown dev_type {dev_type} (1: cpu, 2: gpu)")
    ctx = Context(kind, int(dev_id))
    ctx.torch_device()
    return ctx


def _f32_bytes(arr) -> bytes:
    """An NDArray's values as contiguous float32 bytes."""
    t = arr._data.detach().to(torch.float32).contiguous().cpu()
    return t.numpy().tobytes()


def _unpack_shapes(keys, indptr, shape_data) -> dict:
    """CSR-packed (keys, indptr, dims) -> {name: shape} (the packing every
    shape-taking C call uses)."""
    return {key: tuple(int(d) for d in shape_data[indptr[i]:indptr[i + 1]])
            for i, key in enumerate(keys)}


def _put(obj) -> int:
    with _lock:
        h = _next_id[0]
        _next_id[0] += 1
        _handles[h] = obj
    return h


def create(symbol_file: str, param_file: str, keys, indptr, shape_data,
           dev_type: int = 1, dev_id: int = 0) -> int:
    """MXPredCreate: keys + CSR-packed input shapes -> handle id."""
    from .predictor import Predictor

    ctx = _context(dev_type, dev_id)
    shapes = _unpack_shapes(keys, indptr, shape_data)
    pred = Predictor(symbol_file, param_file or None, shapes, ctx=ctx)
    return _put({"pred": pred, "outputs": []})


def set_input(h: int, name: str, buf: bytes) -> None:
    pred = _handles[h]["pred"]
    shape = pred._input_shapes[name]
    pred.set_input(name, onp.frombuffer(buf, dtype=onp.float32)
                   .reshape(shape))


def forward(h: int) -> None:
    entry = _handles[h]
    entry["pred"].run()
    entry["outputs"] = [_f32_bytes(entry["pred"].get_output(i))
                        for i in range(entry["pred"].num_outputs)]
    entry["shapes"] = [tuple(int(d) for d in entry["pred"].get_output(i)
                             .shape)
                       for i in range(entry["pred"].num_outputs)]


def num_outputs(h: int) -> int:
    return len(_handles[h]["outputs"])


def output_shape(h: int, index: int) -> tuple:
    return _handles[h]["shapes"][index]


def output_bytes(h: int, index: int) -> bytes:
    return _handles[h]["outputs"][index]


def free(h: int) -> None:
    with _lock:
        _handles.pop(h, None)


def version() -> int:
    return 10900  # the MXNet 1.9 line, as the reference reports


# ======================================================================= #
# the training ABI: NDArray / Symbol / Executor handles (float32)
# ======================================================================= #

_GRAD_REQ = {0: "null", 1: "write", 2: "write", 3: "add"}  # kNullOp..kAddTo


def nd_create(shape, dev_type: int = 1, dev_id: int = 0) -> int:
    from . import ndarray as nd

    ctx = _context(dev_type, dev_id)
    return _put({"nd": nd.zeros(tuple(int(d) for d in shape), ctx=ctx)})


# NDArray handles release through the same table as the others
nd_free = free


def nd_sync_copy_from(h: int, buf: bytes) -> None:
    arr = _handles[h]["nd"]
    data = onp.frombuffer(buf, dtype=onp.float32)
    if data.size != arr.size:
        raise ValueError(f"SyncCopyFromCPU: got {data.size} elements, "
                         f"ndarray has {arr.size}")
    arr._rebind(torch.from_numpy(data.reshape(arr.shape).copy())
                .to(arr._data.device))


def nd_sync_copy_to(h: int) -> bytes:
    return _f32_bytes(_handles[h]["nd"])


def nd_get_shape(h: int) -> tuple:
    return tuple(int(d) for d in _handles[h]["nd"].shape)


def nd_get_dtype(h: int) -> int:
    """MXNDArrayGetDType: the reference's dtype enum (the ``.params``
    format's table)."""
    from .ndarray.serialization import _TYPE_FLAGS

    return int(_TYPE_FLAGS[_handles[h]["nd"]._data.dtype])


def nd_save(fname: str, handles, keys) -> None:
    """MXNDArraySave: a ``.params`` file (``mx.nd.save``'s format) of
    C-held arrays."""
    from .ndarray import serialization as ser

    arrays = [_handles[h]["nd"] for h in handles]
    ser.save(fname, dict(zip(keys, arrays)) if keys else list(arrays))


def nd_load(fname: str):
    """MXNDArrayLoad: ``(handles, names)``, the arrays on the CPU."""
    from .context import cpu
    from .ndarray import serialization as ser

    loaded = ser.load(fname, ctx=cpu())
    if isinstance(loaded, dict):
        return (tuple(_put({"nd": v}) for v in loaded.values()),
                tuple(loaded.keys()))
    return tuple(_put({"nd": v}) for v in loaded), ()


def sym_create_from_file(fname: str) -> int:
    from .symbol import symbol as sym_mod

    return _put({"sym": sym_mod.load(fname)})


def sym_list_arguments(h: int) -> tuple:
    return tuple(_handles[h]["sym"].list_arguments())


def sym_infer_shape(h: int, keys, indptr, shape_data):
    """``(in_shapes, out_shapes, aux_shapes)`` as tuples of tuples in
    ``list_arguments()`` order; the parameters' shapes are deduced from
    the data's when they are not given (``infer_args``)."""
    sym = _handles[h]["sym"]
    shapes = _unpack_shapes(keys, indptr, shape_data)
    if any(nm not in shapes for nm in sym.list_arguments()):
        from .symbol.symbol import infer_args
        shapes = infer_args(sym, **shapes)
    in_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
    return (tuple(map(tuple, in_shapes)), tuple(map(tuple, out_shapes)),
            tuple(map(tuple, aux_shapes)))


def sym_save_to_file(h: int, fname: str) -> None:
    """MXSymbolSaveToFile: the exported JSON format."""
    _handles[h]["sym"].save(fname)


def executor_bind(sym_h: int, arg_handles, grad_handles, grad_reqs,
                  dev_type: int = 1, dev_id: int = 0) -> int:
    sym = _handles[sym_h]["sym"]
    ctx = _context(dev_type, dev_id)
    arg_names = sym.list_arguments()
    if len(arg_handles) != len(arg_names):
        raise ValueError(
            f"bind: {len(arg_names)} arguments expected ({arg_names}), got "
            f"{len(arg_handles)} handles")
    args = {nm: _handles[ah]["nd"] for nm, ah in zip(arg_names, arg_handles)}
    # a write/add request with no gradient handle has nowhere to put the
    # gradient: it is 'null'
    req = {nm: (_GRAD_REQ.get(int(r), "null") if gh else "null")
           for nm, gh, r in zip(arg_names, grad_handles, grad_reqs)}
    args_grad = {nm: _handles[gh]["nd"]
                 for nm, gh in zip(arg_names, grad_handles)
                 if gh and req[nm] != "null"}
    exe = sym.bind(ctx=ctx, args=args, args_grad=args_grad, grad_req=req)
    return _put({"exec": exe, "outputs": []})


def executor_forward(h: int, is_train: int) -> int:
    entry = _handles[h]
    entry["outputs"] = entry["exec"].forward(is_train=bool(is_train))
    return len(entry["outputs"])


def executor_backward(h: int) -> None:
    _handles[h]["exec"].backward()


def executor_num_outputs(h: int) -> int:
    return len(_handles[h]["outputs"])


def executor_output(h: int, index: int) -> int:
    """Output ``index`` as a new NDArray handle (the caller frees it)."""
    return _put({"nd": _handles[h]["outputs"][index]})


# ======================================================================= #
# op dispatch
# ======================================================================= #

def op_list_names() -> tuple:
    """MXListAllOpNames: every registered op name and alias."""
    from .ops.registry import _ALIASES, OPS

    return tuple(sorted(set(OPS) | set(_ALIASES)))


def op_exists(name: str) -> int:
    from .ops.registry import get_op

    try:
        get_op(name)
        return 1
    except Exception:
        return 0


def imperative_invoke(name: str, in_handles, out_handles, keys, vals):
    """MXImperativeInvoke: an op called by name on NDArray handles.
    Attributes arrive as strings and parse as Python literals (ints,
    floats, bools, tuples), else stay strings.  With an out handle the
    result is written through it (``sgd_update(w, g, out=w)`` updates
    ``w``'s handle); otherwise new handles are returned (the caller frees
    them)."""
    import ast

    from . import ndarray as nd
    from .ops.registry import get_op

    get_op(name)        # an unknown op raises here, with its message
    fn = getattr(nd, name, None)
    if fn is None or not callable(fn):
        raise ValueError(f"imperative invoke: op {name!r} is registered "
                         "but has no mx.nd wrapper")
    arrays = [_handles[h]["nd"] for h in in_handles]
    kwargs = {}
    for k, v in zip(keys, vals):
        try:
            kwargs[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            kwargs[k] = v
    outs = [_handles[h]["nd"] for h in out_handles]
    if len(outs) > 1:
        raise ValueError("imperative invoke: at most one caller-supplied "
                         "out handle (multi-output ops allocate theirs)")
    res = fn(*arrays, out=outs[0] if outs else None, **kwargs)
    if outs:
        return tuple(out_handles)
    res = res if isinstance(res, (list, tuple)) else (res,)
    return tuple(_put({"nd": r}) for r in res)
