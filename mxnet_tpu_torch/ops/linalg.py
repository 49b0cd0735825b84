"""The extended linalg op family.

Port of ``mxnet_tpu/ops/linalg.py`` (the reference's ``la_op.cc``
surface): every op works on the last two axes with any leading batch
axes, and its gradient is ``torch.autograd``'s through
``torch.linalg``.  ``linalg_gemm2``, ``linalg_syrk``, ``linalg_potrf``
and ``linalg_trsm`` live in ``ops/defs.py``.

``linalg_syevd`` solves in float64 and rounds once (see there).

Signs: ``linalg_gelqf`` is LQ from the QR of the transpose and
``linalg_syevd`` returns eigenvectors as rows, so both inherit the sign
conventions of the library's QR and symmetric eigensolver, as the
reference's inherit XLA's.  Reconstruction, orthonormality and the
values with each row's sign normalised are what they share.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import alias, op

__all__ = [
    "linalg_gemm", "linalg_potri", "linalg_trmm", "linalg_gelqf",
    "linalg_syevd", "linalg_sumlogdiag", "linalg_extractdiag",
    "linalg_makediag", "linalg_extracttrian", "linalg_maketrian",
    "linalg_inverse", "linalg_det", "linalg_slogdet",
]


def _t(x):
    return x.transpose(-1, -2)


@op("linalg_gemm")
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False,
                alpha=1.0, beta=1.0, axis=-2):
    """C' = alpha * op(A) @ op(B) + beta * C."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@op("linalg_trmm")
def linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Triangular multiply: B' = alpha * op(tri(A)) @ B (or B @ op)."""
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@op("linalg_potri")
def linalg_potri(A):
    """The inverse of M = L @ L^T from its lower Cholesky factor L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@op("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorization of a full-rank m x n (m <= n) input: A = L @ Q
    with Q's rows orthonormal.  Returns (Q, L)."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(q), _t(r)


@op("linalg_syevd")
def linalg_syevd(A):
    """Symmetric eigendecomposition A = U^T diag(L) U; returns (U, L)
    with the eigenvectors as the rows of U.  Solved in float64 and
    rounded once to the input's dtype: in f32 the card's solver reaches
    only ~2e-4 of ||A|| at 256 x 256 where LAPACK's reaches ~1e-6, so
    the two devices would not agree to f32 rounding."""
    w, v = torch.linalg.eigh(A.double() if A.dtype != torch.float64
                             else A)
    return _t(v).to(A.dtype), w.to(A.dtype)


@op("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    """sum(log(diag(A))) over the last two axes."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@op("linalg_extractdiag")
def linalg_extractdiag(A, *, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@op("linalg_makediag")
def linalg_makediag(A, *, offset=0):
    return torch.diag_embed(A, offset=offset)


def _trian_indices(n, offset, lower, device):
    f = torch.tril_indices if lower else torch.triu_indices
    return f(n, n, offset, device=device)


@op("linalg_extracttrian")
def linalg_extracttrian(A, *, offset=0, lower=True):
    """The lower (upper) triangle packed into a vector, row-major."""
    rows, cols = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


def _trian_size(m, offset, lower):
    """The matrix size whose triangle at ``offset`` holds ``m`` values."""
    k = abs(offset)
    for n in range(1, 10001):
        if offset == 0:
            cnt = n * (n + 1) // 2
        elif (offset > 0) == lower:
            # the triangle grows past the diagonal
            cnt = n * (n + 1) // 2 + k * n - k * (k + 1) // 2
        else:
            # the triangle shrinks: (n - k)(n - k + 1) / 2
            cnt = n * (n + 1) // 2 - k * n + k * (k - 1) // 2
        if cnt == m:
            return n
    raise MXNetError(f"cannot infer matrix size from {m} packed elements")


@op("linalg_maketrian")
def linalg_maketrian(A, *, offset=0, lower=True):
    """Inverse of ``linalg_extracttrian``: unpack a vector into a
    triangular matrix."""
    n = _trian_size(A.shape[-1], offset, lower)
    rows, cols = _trian_indices(n, offset, lower, A.device)
    out = A.new_zeros(A.shape[:-1] + (n, n))
    out[..., rows, cols] = A
    return out


@op("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)


@op("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@op("linalg_slogdet")
def linalg_slogdet(A):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


alias("det", "linalg_det")
alias("slogdet", "linalg_slogdet")
alias("inverse", "linalg_inverse")
