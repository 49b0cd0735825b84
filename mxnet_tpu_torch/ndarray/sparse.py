"""Sparse storage types (``row_sparse``, ``csr``) over torch component
tensors, port of ``mxnet_tpu/ndarray/sparse.py``.

- Storage is the components: a ``CSRNDArray`` holds ``(data, indices,
  indptr)`` and the expanded row id of each nonzero; a
  ``RowSparseNDArray`` holds ``(data, indices)``.  All live on the
  array's device.  The dense mirror (``_data``) is built only when
  something outside the sparse API reads it, and writing it (an
  autograd rebind) marks the components stale; they are rebuilt from the
  mirror at the next component read.
- The kernels compute from the components at O(nnz) cost, as in the
  reference.  csr·dense and csrᵀ·dense are ``_sparse_segment_dot``: a
  gather and a *sorted segment sum* (``torch.segment_reduce`` over each
  segment's length, one sequential sum a segment), so the card repeats
  itself bit for bit and agrees with the CPU, where the reference's
  ``segment_sum`` (and torch's ``index_add_``) would add with atomics in
  no fixed order.  Its gradient is a ``torch.autograd.Function`` whose
  backward is the same sorted segment sum over the transposed pattern.
  row_sparse·dense is a gathered product written into the result's rows
  (``_sparse_rowsparse_dot``), and its transpose a product with gathered
  rows (``_sparse_rowsparse_dot_t``).
- ``add``/``subtract``/``multiply`` of two csr (or two row_sparse) arrays
  union or intersect the patterns on the device at the fixed capacity
  ``nnz_a + nnz_b`` (``_csr_union_device``/``_rs_union_device``) and read
  one trim count back.  Keys are int64, so the reference's 2^31-cell
  limit does not apply.
- Python operators on sparse arrays route as the reference's do:
  same-kind, same-shape pairs keep their storage outside ``record()``, a
  scalar product or quotient scales the stored values only, and
  everything else (mixed storage, broadcasts, under ``record()``) runs
  the dense op on the mirrors, so gradients reach sparse operands dense.

Not a Pallas kernel in the reference, so plain PyTorch: none of this is
a hand-written CUDA kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError, numeric_types, torch_dtype
from ..ops.registry import op
from .ndarray import NDArray, _coerce, array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "tostype", "retain",
           "sparse_retain", "zeros", "dot", "cast_storage", "add",
           "subtract", "multiply"]


# --------------------------------------------------------------------------- #
# sorted segment sums (no atomics, one order on every device)
# --------------------------------------------------------------------------- #

def _segment_sum(vals, seg, num_segments, is_sorted=False):
    """``out[s] = sum of vals[j] over seg[j] == s`` for ``s <
    num_segments``, each segment summed in one fixed order: the entries'
    order after a stable sort of ``seg`` (skipped when ``is_sorted``)."""
    if not is_sorted:
        seg, perm = torch.sort(seg, stable=True)
        vals = vals[perm]
    lengths = torch.bincount(seg, minlength=num_segments)
    if vals.shape[0] == 0:
        return vals.new_zeros((num_segments,) + tuple(vals.shape[1:]))
    # the lengths sum to len(vals) by construction: no check (a host read)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                unsafe=True)


class _SegmentDot(torch.autograd.Function):
    """``out[seg[j]] += data[j] * rhs[gather[j]]``; the backward to
    ``rhs`` is the same sorted segment sum with the roles of ``gather``
    and ``seg`` swapped, and to ``data`` a row-wise dot."""

    @staticmethod
    def forward(ctx, data, gather_ids, segment_ids, rhs, num_segments,
                is_sorted):
        ctx.save_for_backward(data, gather_ids, segment_ids, rhs)
        vals = data.to(rhs.dtype)[:, None] * rhs[gather_ids]
        return _segment_sum(vals, segment_ids, num_segments, is_sorted)

    @staticmethod
    def backward(ctx, g):
        data, gather_ids, segment_ids, rhs = ctx.saved_tensors
        d_data = d_rhs = None
        gs = g[segment_ids]
        if ctx.needs_input_grad[3]:
            d_rhs = _segment_sum(data.to(g.dtype)[:, None] * gs,
                                 gather_ids, rhs.shape[0])
        if ctx.needs_input_grad[0]:
            d_data = (gs * rhs[gather_ids]).sum(1).to(data.dtype)
        return d_data, None, None, d_rhs, None, None


@op("_sparse_segment_dot", wrap=False)
def _segment_dot(data, gather_ids, segment_ids, rhs, *, num_segments,
                 segments_sorted=False):
    """out[num_segments, N] = Σ_j data[j] · rhs[gather_ids[j], :] into row
    segment_ids[j]: the one kernel behind csr·dense and its transpose.
    ``segments_sorted`` (the port's) says ``segment_ids`` is already
    ascending, as a CSR's row ids are, and skips the sort."""
    return _SegmentDot.apply(data, gather_ids.long(), segment_ids.long(),
                             rhs, int(num_segments), bool(segments_sorted))


@op("_sparse_rowsparse_dot", wrap=False)
def _rowsparse_dot(values, indices, rhs, *, num_rows):
    """dot(row_sparse, dense): the stored rows' product written into the
    result's rows (indices are unique, so no sum)."""
    out_rows = torch.matmul(values.to(rhs.dtype), rhs)
    out = out_rows.new_zeros((int(num_rows), rhs.shape[1]))
    return out.index_copy(0, indices.long(), out_rows)


@op("_sparse_rowsparse_dot_t", wrap=False)
def _rowsparse_dot_t(values, indices, rhs, *, num_cols):
    """dot(row_sparse, dense, transpose_a=True) = valuesᵀ · rhs[indices]."""
    del num_cols
    return torch.matmul(values.to(rhs.dtype).t(), rhs[indices.long()])


# --------------------------------------------------------------------------- #
# NDArray subclasses with lazy dense mirrors
# --------------------------------------------------------------------------- #

class BaseSparseNDArray(NDArray):
    """Component storage and a lazy dense mirror.  ``_data`` is a
    property: reading it builds (and caches) the dense tensor; writing it
    stores the dense value and marks the components stale."""

    __slots__ = ("_sp_shape", "_sp_dtype", "_dense_cache", "_stale")

    _sparse_kind = True

    def _init_base(self, shape, dtype):
        self._sp_shape = tuple(int(s) for s in shape)
        self._sp_dtype = dtype
        self._dense_cache = None
        self._stale = False
        self._grad = None
        self._grad_req = "null"
        self._freed = False

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._to_dense()
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        self._dense_cache = value
        if value is not None:
            self._stale = True

    @property
    def shape(self):
        return self._sp_shape

    @property
    def dtype(self):
        if self._sp_dtype == torch.bfloat16:
            return torch.bfloat16
        return np.dtype(str(self._sp_dtype).replace("torch.", ""))

    @property
    def size(self):
        return math.prod(self._sp_shape)

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def _device(self):
        raise NotImplementedError

    @property
    def context(self):
        from ..context import from_torch_device
        return from_torch_device(self._device)

    ctx = context

    def _to_dense(self):
        raise NotImplementedError

    def _refresh(self):
        raise NotImplementedError

    def _components(self):
        if self._stale:
            self._refresh()
            self._stale = False

    def copy(self):
        return self._clone()

    def copyto(self, other):
        return NDArray(self._data.detach()).copyto(other)

    def as_in_context(self, ctx):
        return NDArray(self._data.detach()).as_in_context(ctx)

    def __repr__(self):
        shape = "x".join(map(str, self.shape))
        return f"<{type(self).__name__} {shape} @{self.context}>"


class RowSparseNDArray(BaseSparseNDArray):
    """``(data, indices)``: the stored rows and their ascending row ids."""

    __slots__ = ("_rs_data", "_rs_indices")

    def __init__(self, data, indices, shape):
        self._init_base(shape, data.dtype)
        self._rs_data = data
        self._rs_indices = indices.to(device=data.device, dtype=torch.int64)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def _device(self):
        return self._rs_data.device

    @property
    def indices(self):
        self._components()
        return NDArray(self._rs_indices)

    @property
    def data(self):
        self._components()
        return NDArray(self._rs_data)

    def _to_dense(self):
        out = torch.zeros(self._sp_shape, dtype=self._sp_dtype,
                          device=self._device)
        return out.index_copy(0, self._rs_indices, self._rs_data)

    def _refresh(self):
        dense = self._dense_cache.detach()
        self._rs_indices, self._rs_data = _dense_to_rs(dense)

    def _clone(self):
        self._components()
        return RowSparseNDArray(self._rs_data.clone(),
                                self._rs_indices.clone(), self.shape)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data.detach())
        if stype == "row_sparse":
            return self
        raise MXNetError(f"unsupported stype {stype}")


class CSRNDArray(BaseSparseNDArray):
    """``(data, indices, indptr)``, with each nonzero's row id expanded
    once at construction, so every dot is a static-shape computation."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr", "_csr_rowids",
                 "_csr_by_col")

    def __init__(self, data, indptr, indices, shape):
        self._init_base(shape, data.dtype)
        dev = data.device
        self._csr_data = data
        self._csr_indices = indices.to(device=dev, dtype=torch.int64)
        self._csr_indptr = indptr.to(device=dev, dtype=torch.int64)
        self._csr_rowids = _rowids_of(self._csr_indptr)
        self._csr_by_col = None

    @property
    def stype(self):
        return "csr"

    @property
    def _device(self):
        return self._csr_data.device

    @property
    def data(self):
        self._components()
        return NDArray(self._csr_data)

    @property
    def indices(self):
        self._components()
        return NDArray(self._csr_indices)

    @property
    def indptr(self):
        self._components()
        return NDArray(self._csr_indptr)

    def _to_dense(self):
        out = torch.zeros(self._sp_shape, dtype=self._sp_dtype,
                          device=self._device)
        out[self._csr_rowids, self._csr_indices] = self._csr_data
        return out

    def _refresh(self):
        data, indices, indptr = _dense_to_csr(self._dense_cache.detach())
        self._csr_data, self._csr_indices, self._csr_indptr = \
            data, indices, indptr
        self._csr_rowids = _rowids_of(indptr)
        self._csr_by_col = None

    def _by_col(self):
        """The nonzeros in column order (a stable sort of the column ids,
        kept): ``(data, row ids, column ids)`` for csrᵀ·dense."""
        self._components()
        if self._csr_by_col is None:
            cols, perm = torch.sort(self._csr_indices, stable=True)
            self._csr_by_col = (self._csr_data[perm],
                                self._csr_rowids[perm], cols)
        return self._csr_by_col

    def _clone(self):
        self._components()
        return CSRNDArray(self._csr_data.clone(), self._csr_indptr.clone(),
                          self._csr_indices.clone(), self.shape)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data.detach())
        if stype == "csr":
            return self
        raise MXNetError(f"unsupported stype {stype}")


# --------------------------------------------------------------------------- #
# conversions
# --------------------------------------------------------------------------- #

def _rowids_of(indptr):
    n = indptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1])


def _dense_to_rs(dense):
    """(row ids, rows) of a dense tensor's rows that hold a nonzero."""
    flat = dense.reshape(dense.shape[0], -1) if dense.dim() > 1 else \
        dense.reshape(-1, 1)
    nz = torch.nonzero((flat != 0).any(1)).reshape(-1)
    return nz, dense[nz]


def _dense_to_csr(dense):
    """(data, indices, indptr) of a 2-d dense tensor, row-major."""
    if dense.dim() != 2:
        raise MXNetError(f"csr storage needs a 2-d array, got shape "
                         f"{tuple(dense.shape)}")
    rows, cols = torch.nonzero(dense != 0, as_tuple=True)
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return dense[rows, cols], cols, indptr


def _tensor(x, ctx=None, dtype=None):
    if isinstance(x, NDArray):
        t = x._data.detach()
        if ctx is not None:
            t = t.to(ctx.torch_device())
        return t.to(torch_dtype(dtype)) if dtype is not None else t
    return array(x, ctx=ctx, dtype=dtype)._data


def _index_tensor(x, device):
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


# --------------------------------------------------------------------------- #
# constructors
# --------------------------------------------------------------------------- #

def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``(data, indices)`` with ``shape``, or a dense array to convert.
    On ``ctx`` (default: the current context)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _tensor(data, ctx, dtype)
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape")
        return RowSparseNDArray(data, _index_tensor(indices, data.device),
                                shape)
    return tostype(array(arg1, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``(data, indices, indptr)`` with ``shape``, or a dense array to
    convert.  On ``ctx`` (default: the current context)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _tensor(data, ctx, dtype)
        if shape is None:
            raise MXNetError("csr_matrix((data, indices, indptr)) needs "
                             "shape")
        return CSRNDArray(data, _index_tensor(indptr, data.device),
                          _index_tensor(indices, data.device), shape)
    if isinstance(arg1, NDArray) or hasattr(arg1, "__array__") or \
            isinstance(arg1, (list, torch.Tensor)):
        return tostype(array(arg1, ctx=ctx, dtype=dtype), "csr")
    raise MXNetError("csr_matrix: pass (data, indices, indptr) or a dense "
                     "array")


def tostype(nd: NDArray, stype: str):
    """``nd`` in storage ``stype`` ("default", "row_sparse", "csr")."""
    dense = nd._data.detach()
    if stype == "default":
        return NDArray(dense)
    if stype == "row_sparse":
        nz, rows = _dense_to_rs(dense)
        return RowSparseNDArray(rows, nz, tuple(dense.shape))
    if stype == "csr":
        data, indices, indptr = _dense_to_csr(dense)
        return CSRNDArray(data, indptr, indices, tuple(dense.shape))
    raise MXNetError(f"unknown stype {stype}")


def cast_storage(nd: NDArray, stype: str):
    """Convert between storage types (``mx.nd.cast_storage``)."""
    if isinstance(nd, BaseSparseNDArray):
        return nd.tostype(stype)
    return tostype(nd, stype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """``mx.nd.sparse.zeros('row_sparse' | 'csr', shape)``."""
    from ..context import current_context
    dev = (ctx if ctx is not None else current_context()).torch_device()
    dt = torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=dev),
                                torch.zeros((0,), dtype=torch.int64,
                                            device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros(shape[0] + 1, dtype=torch.int64,
                                      device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          shape)
    raise MXNetError(f"unknown stype {stype}")


# --------------------------------------------------------------------------- #
# the kernels' NDArray-level surface
# --------------------------------------------------------------------------- #

def retain(rs: RowSparseNDArray, indices):
    """Keep only the listed rows (``sparse_retain``): membership, a
    stable pack of the surviving rows and the gather run on the device;
    one count is read back to trim."""
    rs._components()
    rows = rs._rs_indices
    idx = _index_tensor(indices, rows.device)
    keep = torch.isin(rows, idx)
    n = rows.shape[0]
    ar = torch.arange(n, device=rows.device)
    order = torch.argsort(torch.where(keep, ar, n + ar))
    cnt = int(keep.sum())                      # the one host read
    order = order[:cnt]
    return RowSparseNDArray(rs._rs_data[order], rows[order], rs.shape)


def sparse_retain(data, indices):
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("sparse_retain expects a RowSparseNDArray")
    return retain(data, indices)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``mx.nd.sparse.dot``: csr or row_sparse times dense at O(nnz) cost
    (dense times dense is ``mx.nd.dot``).  Differentiable with respect
    to the dense operand under ``autograd.record()``."""
    from ..ops.registry import OPS

    if not isinstance(lhs, BaseSparseNDArray):
        return OPS["dot"].wrapper(lhs, rhs, transpose_a=transpose_a,
                                  transpose_b=transpose_b)
    rhs_d = NDArray(rhs._data) if isinstance(rhs, BaseSparseNDArray) \
        else rhs
    if transpose_b:
        rhs_d = OPS["swapaxes"].wrapper(rhs_d, dim1=-1, dim2=-2)
    seg_dot = OPS["_sparse_segment_dot"].wrapper
    if isinstance(lhs, CSRNDArray):
        m, k = lhs.shape
        if transpose_a:
            data, rowids, cols = lhs._by_col()
            return seg_dot(NDArray(data), NDArray(rowids), NDArray(cols), rhs_d,
                           num_segments=k, segments_sorted=True)
        lhs._components()
        return seg_dot(NDArray(lhs._csr_data), NDArray(lhs._csr_indices),
                       NDArray(lhs._csr_rowids), rhs_d, num_segments=m,
                       segments_sorted=True)
    if isinstance(lhs, RowSparseNDArray):
        lhs._components()
        if transpose_a:
            return OPS["_sparse_rowsparse_dot_t"].wrapper(
                NDArray(lhs._rs_data), NDArray(lhs._rs_indices), rhs_d,
                num_cols=lhs.shape[1])
        return OPS["_sparse_rowsparse_dot"].wrapper(
            NDArray(lhs._rs_data), NDArray(lhs._rs_indices), rhs_d,
            num_rows=lhs.shape[0])
    raise MXNetError(f"sparse.dot: unsupported lhs type {type(lhs)}")


_KEY_SENTINEL = torch.iinfo(torch.int64).max


def _csr_union_device(keys_a, vals_a, keys_b, vals_b, mode: str):
    """Fixed-capacity pattern union (``mode="sum"``; subtract negates
    ``vals_b`` first) or intersection (``"prod"``) of two key sets
    (row * ncols + col, unique within each operand), in f32 on the
    device.  Returns ``(keys, vals, valid)`` of capacity ``nnz_a +
    nnz_b``: live entries key-sorted and packed first, explicit zeros
    pruned, dead slots keyed ``_KEY_SENTINEL``."""
    cap = keys_a.shape[0] + keys_b.shape[0]
    dev = keys_a.device
    keys = torch.cat([keys_a, keys_b])
    vals = torch.cat([vals_a.float(), vals_b.float()])
    k, order = torch.sort(keys, stable=True)
    v = vals[order]
    if mode == "sum":
        is_new = torch.ones(cap, dtype=torch.bool, device=dev)
        is_new[1:] = k[1:] != k[:-1]
        seg = torch.cumsum(is_new.long(), 0) - 1
        out_keys = torch.full((cap,), _KEY_SENTINEL, dtype=torch.int64,
                              device=dev)
        out_keys[seg] = k
        # at most two adds onto 0 a slot, and a + b == b + a exactly, so
        # the atomics' order cannot change a bit
        out_vals = torch.zeros(cap, device=dev).index_add_(0, seg, v)
    elif mode == "prod":
        nxt_same = torch.zeros(cap, dtype=torch.bool, device=dev)
        nxt_same[:-1] = k[1:] == k[:-1]
        nxt = torch.zeros(cap, device=dev)
        nxt[:-1] = v[1:]
        out_keys = torch.where(nxt_same, k, torch.full_like(k, _KEY_SENTINEL))
        out_vals = torch.where(nxt_same, v * nxt, torch.zeros_like(v))
    else:
        raise MXNetError(f"unknown union mode {mode}")
    out_keys = torch.where(out_vals == 0.0,
                           torch.full_like(out_keys, _KEY_SENTINEL), out_keys)
    out_keys, order2 = torch.sort(out_keys, stable=True)
    return out_keys, out_vals[order2], out_keys != _KEY_SENTINEL


def _csr_elemwise(opname, a: CSRNDArray, b: CSRNDArray):
    """csr ± / × csr through ``_csr_union_device``; the row pointer is
    rebuilt on the device and one count is read back to trim."""
    if a.shape != b.shape:
        raise MXNetError(f"csr elemwise {opname}: shape mismatch "
                         f"{a.shape} vs {b.shape}")
    if opname not in ("add", "subtract", "multiply"):
        raise MXNetError(f"unsupported csr elemwise {opname}")
    nrows, ncols = a.shape
    a._components()
    b._components()
    ka = a._csr_rowids * ncols + a._csr_indices
    kb = b._csr_rowids * ncols + b._csr_indices
    vb = b._csr_data if opname != "subtract" else -b._csr_data
    mode = "prod" if opname == "multiply" else "sum"
    keys, vals, valid = _csr_union_device(ka, a._csr_data, kb, vb, mode)
    n = int(valid.sum())                       # the one host read
    keys = keys[:n]
    rows = keys // ncols
    indptr = torch.zeros(nrows + 1, dtype=torch.int64, device=keys.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=nrows), 0)
    return CSRNDArray(vals[:n].to(a._sp_dtype), indptr, keys % ncols,
                      a.shape)


def _rs_union_device(keys_a, vals_a, keys_b, vals_b, opname: str):
    """Fixed-capacity row-pattern union of two row_sparse operands on the
    device; all three ops keep the union (multiply gives zero rows
    outside the intersection, with no pruning by value, as the
    reference).  Returns ``(keys, vals, valid)``, live rows first."""
    na = keys_a.shape[0]
    cap = na + keys_b.shape[0]
    dev = keys_a.device
    cols = tuple(vals_a.shape[1:])
    k, order = torch.sort(torch.cat([keys_a, keys_b]), stable=True)
    is_new = torch.ones(cap, dtype=torch.bool, device=dev)
    is_new[1:] = k[1:] != k[:-1]
    seg = torch.cumsum(is_new.long(), 0) - 1
    out_keys = torch.full((cap,), _KEY_SENTINEL, dtype=torch.int64,
                          device=dev)
    out_keys[seg] = k
    slot = torch.empty_like(seg)
    slot[order] = seg                          # each original entry's slot
    dt = torch.promote_types(vals_a.dtype, vals_b.dtype)
    va = torch.zeros((cap,) + cols, dtype=dt, device=dev)
    vb = torch.zeros((cap,) + cols, dtype=dt, device=dev)
    va[slot[:na]] = vals_a.to(dt)
    vb[slot[na:]] = vals_b.to(dt)
    if opname == "add":
        vals = va + vb
    elif opname == "subtract":
        vals = va - vb
    elif opname == "multiply":
        vals = va * vb
    else:
        raise MXNetError(f"unsupported row_sparse elemwise {opname}")
    return out_keys, vals, out_keys != _KEY_SENTINEL


def _rs_elemwise(opname, a: RowSparseNDArray, b: RowSparseNDArray):
    if a.shape != b.shape:
        raise MXNetError(f"row_sparse elemwise {opname}: shape mismatch "
                         f"{a.shape} vs {b.shape}")
    a._components()
    b._components()
    keys, vals, valid = _rs_union_device(a._rs_indices, a._rs_data,
                                         b._rs_indices, b._rs_data, opname)
    n = int(valid.sum())                       # the one host read
    return RowSparseNDArray(vals[:n], keys[:n], a.shape)


def _scale(x, v: float):
    """Scale the stored values only (the reference's ``_mul_scalar`` on
    sparse storage): the pattern stays and no dense mirror is built."""
    x._components()
    if isinstance(x, RowSparseNDArray):
        return RowSparseNDArray(x._rs_data * v, x._rs_indices, x.shape)
    if isinstance(x, CSRNDArray):
        return CSRNDArray(x._csr_data * v, x._csr_indptr, x._csr_indices,
                          x.shape)
    raise MXNetError(f"_scale: unsupported storage {type(x).__name__}")


def _elemwise(opname, a, b):
    if isinstance(a, CSRNDArray) and isinstance(b, CSRNDArray):
        return _csr_elemwise(opname, a, b)
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        return _rs_elemwise(opname, a, b)
    ad = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
    bd = b._data if isinstance(b, NDArray) else torch.as_tensor(b)
    fn = {"add": torch.add, "subtract": torch.sub,
          "multiply": torch.mul}[opname]
    return NDArray(fn(ad, bd))


def add(a, b):
    return _elemwise("add", a, b)


def subtract(a, b):
    return _elemwise("subtract", a, b)


def multiply(a, b):
    return _elemwise("multiply", a, b)


# python-operator name -> union-kernel name (the storage-keeping subset)
_SPARSE_BINOPS = {"broadcast_add": "add", "broadcast_sub": "subtract",
                  "broadcast_mul": "multiply"}


def binop(self, other, name, reverse):
    """A Python operator with a sparse operand (``NDArray._binop``): the
    reference's storage-aware dispatch (see the module docstring)."""
    from .. import autograd
    from ..ops import defs

    recording = autograd.is_recording()
    if getattr(self, "_sparse_kind", False) and \
            isinstance(other, numeric_types) and not recording and \
            self._sp_dtype.is_floating_point and math.isfinite(float(other)):
        if name == "broadcast_mul":
            return _scale(self, float(other))
        if name == "broadcast_div" and not reverse and float(other) != 0.0:
            return _scale(self, 1.0 / float(other))
    a, b = (other, self) if reverse else (self, other)
    a, b = _coerce(a, self), _coerce(b, self)
    spname = _SPARSE_BINOPS.get(name)
    if spname is not None and type(a) is type(b) and \
            getattr(a, "_sparse_kind", False) and a.shape == b.shape and \
            not recording:
        return _elemwise(spname, a, b)
    return getattr(defs, name)(a, b)
