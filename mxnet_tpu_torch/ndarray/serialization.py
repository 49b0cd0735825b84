"""NDArray binary serialization — the ``.params`` file format.

Counterpart of ``mxnet_tpu/ndarray/serialization.py``, byte for byte the
same layout, so a file written by either package loads in the other::

  file := uint64 kMXAPINDArrayListMagic(0x112) | uint64 reserved(0)
        | uint64 n_arrays | n * ndarray_blob
        | uint64 n_names  | n * (uint64 len | bytes)  (names; 0 for list)
  ndarray_blob := uint32 NDARRAY_V2_MAGIC(0xF993FAC9) | int32 stype(0 dense)
        | uint32 ndim | int64 dims[ndim]
        | int32 devtype | int32 devid | int32 type_flag | raw data

Arrays load on ``ctx``, by default the current context (``gpu(0)``
unless a ``with mx.cpu():`` scope says otherwise), as ``array`` does.
Unlike the reference (JAX without 64-bit types), 64-bit arrays
load as they were saved.
"""
from __future__ import annotations

import pickle
import struct

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from .ndarray import NDArray

_LIST_MAGIC = 0x112
_ND_MAGIC = 0xF993FAC9

# the mshadow type enum of the reference's C ABI; 12 is bfloat16
_TYPE_FLAGS = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.uint8: 3, torch.int32: 4, torch.int8: 5,
               torch.int64: 6, torch.bool: 7, torch.int16: 8,
               torch.bfloat16: 12}
_FLAG_TYPES = {v: k for k, v in _TYPE_FLAGS.items()}


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _write_nd(f, nd: NDArray):
    t = nd._data
    if t.dim() == 0:                # at least 1-d, as the reference writes
        t = t.reshape(1)
    if t.dtype not in _TYPE_FLAGS:
        raise MXNetError(f"save: unsupported dtype {t.dtype}")
    f.write(struct.pack("<I", _ND_MAGIC))
    f.write(struct.pack("<i", 0))  # stype: kDefaultStorage (dense)
    f.write(struct.pack("<I", t.dim()))
    for d in t.shape:
        f.write(struct.pack("<q", d))
    f.write(struct.pack("<ii", 1, 0))  # saved context: cpu(0)
    f.write(struct.pack("<i", _TYPE_FLAGS[t.dtype]))
    f.write(_raw(t))


def _read_nd(f, device) -> NDArray:
    magic, = struct.unpack("<I", f.read(4))
    if magic != _ND_MAGIC:
        raise MXNetError(f"bad ndarray magic {magic:#x}")
    stype, = struct.unpack("<i", f.read(4))
    # 0 = kDefaultStorage; -1 is what an early writer of the reference
    # used for dense
    if stype not in (0, -1):
        raise MXNetError(
            f"sparse .params load not supported (stype={stype}: "
            "1=row_sparse, 2=csr)")
    ndim, = struct.unpack("<I", f.read(4))
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
    f.read(8)  # saved context
    tf, = struct.unpack("<i", f.read(4))
    if tf not in _FLAG_TYPES:
        raise MXNetError(f"load: unsupported type flag {tf}")
    dtype = _FLAG_TYPES[tf]
    n = int(np.prod(shape, dtype=np.int64))
    width = torch.empty((), dtype=dtype).element_size()
    buf = bytearray(f.read(n * width))
    if len(buf) != n * width:
        raise MXNetError("load: file ends inside an array")
    raw = torch.frombuffer(buf, dtype=torch.uint8) if n else \
        torch.empty(0, dtype=torch.uint8)
    return NDArray(raw.view(dtype).reshape(shape).to(device))


def save(fname: str, data):
    """``mx.nd.save(fname, NDArray | list | dict of NDArray)``."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise MXNetError("save: need NDArray, list, or dict")
    for a in arrays:
        if not isinstance(a, NDArray):
            raise MXNetError("save: all values must be NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_nd(f, a)
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname: str, ctx=None):
    """``mx.nd.load`` — a list, or a dict when the file holds names, on
    ``ctx`` (default: the current context)."""
    device = (ctx if ctx is not None else current_context()).torch_device()
    with open(fname, "rb") as f:
        magic, _res = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"bad file magic {magic:#x}")
        n, = struct.unpack("<Q", f.read(8))
        arrays = [_read_nd(f, device) for _ in range(n)]
        n_names, = struct.unpack("<Q", f.read(8))
        if n_names == 0:
            return arrays
        names = []
        for _ in range(n_names):
            ln, = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode())
        return dict(zip(names, arrays))


# --------------------------------------------------------------------------- #
# the reference's optimizer-states pickle (``Trainer.save_states``)
# --------------------------------------------------------------------------- #
#
# The reference pickles its states as numpy arrays.  A bf16 array names
# ``ml_dtypes.bfloat16`` in the pickle, a package the port does not need:
# its states are read by an unpickler of the port's own, which takes such
# an array's raw 16 bits into a ``torch.bfloat16`` tensor, and written as
# ``numpy.ndarray(shape, numpy.dtype("bfloat16"), buffer)``, which numpy
# resolves by name wherever ``ml_dtypes`` is loaded (JAX loads it).

class _Bf16Dtype:
    """``numpy.dtype("bfloat16")`` in a pickle (a marker when read by the
    port)."""

    def __reduce__(self):
        return (np.dtype, ("bfloat16",))

    def __setstate__(self, state):
        pass


class _Bf16Array:
    """A bf16 tensor as a pickled numpy array of dtype ``bfloat16``."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)
        self.raw = t.detach().contiguous().view(torch.int16).cpu() \
            .numpy().tobytes()

    def __reduce__(self):
        return (np.ndarray, (self.shape, _Bf16Dtype(), bytearray(self.raw)))


def _bf16_tensor(shape, raw):
    return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) \
        .reshape(shape).clone()


def _dtype(obj, *args):
    if obj is _ML_BF16 or obj == "bfloat16":
        return _Bf16Dtype()
    return np.dtype(obj, *args)


def _ndarray(shape, dtype=float, buffer=None, *args, **kwargs):
    if isinstance(dtype, _Bf16Dtype):
        return _bf16_tensor(shape, buffer)
    return np.array(np.ndarray(shape, dtype, buffer, *args, **kwargs))


class _Reconstructed:
    """numpy's ``_reconstruct`` placeholder: ``__setstate__`` (pickle's
    BUILD) makes its value, a numpy array or a bf16 tensor."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _Bf16Dtype):
            if fortran:
                raise MXNetError("states file: a Fortran-ordered bf16 array")
            self.value = _bf16_tensor(shape, raw)
        else:
            self.value = np.frombuffer(bytearray(raw), dtype).reshape(
                shape, order="F" if fortran else "C").copy()


def _reconstruct(cls, shape, typecode):
    return _Reconstructed()


_ML_BF16 = object()


class _StatesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            if name != "bfloat16":
                raise MXNetError(f"states file: dtype ml_dtypes.{name} is "
                                 "not supported")
            return _ML_BF16
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "numpy" and name == "ndarray":
            return _ndarray
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        if module.startswith("numpy._core") and \
                not hasattr(np, "_core"):          # numpy 1 reads numpy 2
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _resolve(x):
    if isinstance(x, _Reconstructed):
        return x.value
    if isinstance(x, (list, tuple)):
        return type(x)(_resolve(a) for a in x)
    if isinstance(x, dict):
        return {k: _resolve(v) for k, v in x.items()}
    return x


def _as_file_array(x):
    """A state tensor as the reference writes it: numpy, bf16 by name."""
    if isinstance(x, (list, tuple)):
        return type(x)(_as_file_array(a) for a in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return _Bf16Array(x)
        return x.detach().cpu().numpy().copy()
    return x


def save_states(fname: str, payload: dict):
    """Pickle a trainer's ``payload`` (``num_update``,
    ``index_update_count``, ``states``, ``created``) as the reference's
    ``Trainer.save_states`` does, its tensors as numpy arrays."""
    payload = dict(payload, states=_as_file_array(payload["states"]))
    with open(fname, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def load_states(fname: str) -> dict:
    """Read a states file of either package; numpy arrays stay numpy, a
    bf16 array becomes a CPU ``torch.bfloat16`` tensor."""
    with open(fname, "rb") as f:
        return _resolve(_StatesUnpickler(f).load())
