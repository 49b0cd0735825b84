"""``mx.np.linalg`` — port of ``mxnet_tpu/numpy/linalg.py``.

Every function runs through ``_run`` (one registered ``_np_linalg_*``
op).  ``svd``, ``eig``, ``eigh``, ``qr``, ``lstsq`` and ``svdvals`` run
in float64 and round once to the input's precision, as ``linalg_syevd``
does: the card's and the CPU's solvers then agree to the f32
rounding, with the signs of eigenvectors and singular vectors free, as
in the reference (check them by reconstruction).  Integer inputs are
f32, as in the reference.  ``LinAlgError`` is the reference's class.
"""
from __future__ import annotations

import torch

from .multiarray import (_inexact, _promote_all, _real, _run,  # noqa: F401
                         ndarray)

__all__ = ["norm", "svd", "cholesky", "qr", "inv", "pinv", "det", "slogdet",
           "solve", "lstsq", "eig", "eigh", "eigvals", "eigvalsh",
           "matrix_rank", "matrix_power", "multi_dot", "tensorinv",
           "tensorsolve",
           "LinAlgError", "cond", "cross", "diagonal", "matmul", "outer",
           "trace", "tensordot", "vecdot", "svdvals", "matrix_norm",
           "vector_norm", "matrix_transpose"]


class LinAlgError(Exception):
    """Reference numpy.linalg.LinAlgError surface."""


def _f64(fn):
    """``fn`` on float64 operands, each result rounded once back to the
    operands' (real or complex) precision."""
    def run(*xs):
        xs = _inexact(*xs)
        dt = xs[0].dtype
        out = fn(*[x.to(torch.complex128 if x.is_complex() else
                        torch.float64) for x in xs])

        def back(t):
            if not isinstance(t, torch.Tensor):
                return t
            if t.is_complex():
                return t.to(torch.complex64 if dt in (
                    torch.float32, torch.complex64, torch.float16,
                    torch.bfloat16) else t.dtype)
            return t.to(dt.to_real() if dt.is_complex else dt) \
                if t.is_floating_point() else t
        if isinstance(out, (tuple, list)):
            return type(out)(back(t) for t in out)
        return back(out)
    return run


def _norm(x, ord, axis, keepdims):
    x = _real(x)
    if axis is None and ord is None:
        return torch.linalg.vector_norm(x.reshape(-1), keepdim=False) \
            .reshape((1,) * x.dim() if keepdims else ())
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    ax = tuple(axis) if isinstance(axis, list) else axis
    return _run("linalg_norm", lambda a: _norm(a, ord, ax, keepdims), [x])


def svd(a, full_matrices=False, compute_uv=True):
    if compute_uv:
        return tuple(_run("linalg_svd", _f64(lambda x: tuple(
            torch.linalg.svd(x, full_matrices=full_matrices))), [a]))
    return svdvals(a)


def cholesky(a):
    return _run("linalg_cholesky", lambda x: torch.linalg.cholesky(
        _real(x)), [a])


def qr(a, mode="reduced"):
    if mode == "r":
        return _run("linalg_qr", _f64(lambda x: torch.linalg.qr(
            x, mode="r")[1]), [a])
    return tuple(_run("linalg_qr", _f64(lambda x: tuple(
        torch.linalg.qr(x, mode=mode))), [a]))


def inv(a):
    return _run("linalg_inv", lambda x: torch.linalg.inv(_real(x)), [a])


def pinv(a, rcond=None):
    def run(x):
        x = _real(x)
        rc = rcond
        if rc is None:
            rc = 10 * max(x.shape[-2:]) * torch.finfo(x.dtype).eps
        return torch.linalg.pinv(x, rtol=rc)
    return _run("linalg_pinv", run, [a])


def det(a):
    return _run("linalg_det", lambda x: torch.linalg.det(_real(x)), [a])


def slogdet(a):
    return tuple(_run("linalg_slogdet", lambda x: tuple(
        torch.linalg.slogdet(_real(x))), [a]))


def solve(a, b):
    def run(x, y):
        x, y = _inexact(x, y)
        if y.dim() == 1:
            return torch.linalg.solve(x, y.unsqueeze(-1)).squeeze(-1)
        return torch.linalg.solve(x, y)
    return _run("linalg_solve", run, [a, b])


def _lstsq(x, y, rcond):
    """The least-squares solution through the float64 SVD (NumPy's
    ``gelsd``): ``(solution, residuals, rank, singular values)``."""
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    rc = torch.finfo(torch.float32).eps * max(m, n) if rcond is None \
        else rcond
    cut = s[..., :1] * rc
    keep = s > cut
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    vec = y.dim() == 1
    yy = y.unsqueeze(-1) if vec else y
    sol = vh.transpose(-1, -2) @ (sinv.unsqueeze(-1) * (
        u.transpose(-1, -2) @ yy))
    rank = keep.sum()
    if int(rank) == n and m > n:
        r = yy - x @ sol
        res = torch.sum(r * r, dim=-2)
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return (sol.squeeze(-1) if vec else sol), res, rank, s


def lstsq(a, b, rcond=None):
    x, res, rank, sv = _run("linalg_lstsq", _f64(
        lambda p, q: _lstsq(p, q, rcond)), [a, b])
    return x, res, int(rank.asnumpy()), sv


def eig(a):
    return tuple(_run("linalg_eig", _f64(lambda x: tuple(
        torch.linalg.eig(x))), [a]))


def eigh(a, UPLO="L"):
    return tuple(_run("linalg_eigh", _f64(lambda x: tuple(
        torch.linalg.eigh(x, UPLO=UPLO))), [a]))


def eigvals(a):
    return _run("linalg_eigvals", _f64(torch.linalg.eigvals), [a])


def eigvalsh(a, UPLO="L"):
    return _run("linalg_eigvalsh", _f64(
        lambda x: torch.linalg.eigvalsh(x, UPLO=UPLO)), [a])


def matrix_rank(a, tol=None):
    def run(x):
        x = _real(x)
        if x.dim() < 2:
            return (x != 0).any().to(torch.int32)
        if tol is None:
            return torch.linalg.matrix_rank(x)
        s = torch.linalg.svdvals(x.to(torch.float64))
        return (s > tol).sum(-1)
    return _run("linalg_matrix_rank", run, [a])


def matrix_power(a, n):
    return _run("linalg_matrix_power",
                lambda x: torch.linalg.matrix_power(x, n), [a])


def multi_dot(arrays):
    return _run("linalg_multi_dot", lambda *xs: torch.linalg.multi_dot(
        _promote_all(list(xs))), list(arrays))


def tensorinv(a, ind=2):
    return _run("linalg_tensorinv",
                lambda x: torch.linalg.tensorinv(_real(x), ind=ind), [a])


def tensorsolve(a, b, axes=None):
    return _run("linalg_tensorsolve", lambda x, y: torch.linalg.tensorsolve(
        *_inexact(x, y), dims=axes), [a, b])


def cond(a, p=None):
    return _run("linalg_cond", _f64(lambda x: torch.linalg.cond(x, p=p)),
                [a])


def cross(a, b, axis=-1):
    return _run("linalg_cross", lambda x, y: torch.linalg.cross(
        *_promote_all([x, y]), dim=axis), [a, b])


def diagonal(a, offset=0):
    return _run("linalg_diagonal", lambda x: torch.linalg.diagonal(
        x, offset=offset).clone(), [a])


def matmul(a, b):
    from .multiarray import _mm
    return _run("linalg_matmul", _mm(torch.matmul), [a, b])


def outer(a, b):
    from .multiarray import _mm
    return _run("linalg_outer", _mm(torch.outer), [a, b])


def trace(a, offset=0, dtype=None):
    from .multiarray import _int_acc, _tdt

    def run(x):
        d = torch.diagonal(x, offset, -2, -1)
        return torch.sum(d, dim=-1, dtype=_tdt(dtype) or _int_acc(x))
    return _run("linalg_trace", run, [a])


def tensordot(a, b, axes=2):
    from .multiarray import _mm

    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [list(x) if isinstance(x, (list, tuple)) else [x] for x in ax]
    return _run("linalg_tensordot", _mm(lambda x, y: torch.tensordot(
        x, y, dims=ax)), [a, b])


def vecdot(a, b, axis=-1):
    return _run("linalg_vecdot", lambda x, y: torch.linalg.vecdot(
        *_promote_all([x, y]), dim=axis), [a, b])


def svdvals(a):
    return _run("linalg_svdvals", _f64(torch.linalg.svdvals), [a])


def matrix_norm(a, ord="fro", keepdims=False):  # noqa: A002
    return _run("linalg_matrix_norm", _f64(
        lambda x: torch.linalg.matrix_norm(x, ord=ord, keepdim=keepdims)),
        [a])


def vector_norm(a, ord=2, axis=None, keepdims=False):  # noqa: A002
    return _run("linalg_vector_norm", lambda x: torch.linalg.vector_norm(
        _real(x), ord=ord, dim=axis, keepdim=keepdims), [a])


def matrix_transpose(a):
    return _run("linalg_matrix_transpose",
                lambda x: torch.swapaxes(x, -1, -2), [a])

