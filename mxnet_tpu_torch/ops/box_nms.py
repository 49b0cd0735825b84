"""Greedy non-maximum suppression (the port's own kernel, ``box_nms``).

Port of the loop inside ``mxnet_tpu/ops/nn.py::box_nms``.  The reference
runs it as one ``lax.fori_loop`` over every box of a row, one dispatch on
the TPU; it has no Pallas kernel.  Written as PyTorch ops the loop takes
about eight launches a box, so on the card it is one launch of
``csrc/box_nms.cu`` (which says what bounds it and how), and on the CPU
``nms_scores_plain``, the reference's loop step by step.

``nms_scores(score, box, ids, order, keep_lim, overlap_thresh,
valid_thresh)`` returns the rows' new scores: ``-1`` for every box that
is suppressed, under ``valid_thresh`` or ranked at or past ``keep_lim``,
else its score.  ``order`` is the stable descending score order
(``score_order``); ``ids`` is None where every box may suppress every
other (``force_suppress``, or no class column).  On a CUDA tensor it
launches the kernel (``nms_scores.launches`` counts launches) or raises:
there is no fallback.  The launch allocates its scratch with
``torch.empty`` and never synchronises, so a CUDA graph records it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["score_order", "nms_scores", "nms_scores_plain"]


def score_order(score):
    """Indices of ``score`` (..., n) by descending value, ties in index
    order: ``jnp.argsort(-score)``, which is stable and sorts -0.0 with
    0.0 (adding 0.0 makes every -0.0 key +0.0)."""
    return torch.argsort(-score + 0.0, dim=-1, stable=True)


def _iou_one(x1, y1, x2, y2, area, i):
    """The reference's f32 IoU of box ``i`` of each row against every box
    of the row, in its expression order (``mxnet_tpu/ops/nn.py:855-864``):
    ``inter / max(area_i + area_j - inter, 1e-12)``."""
    def at(t):
        return t.gather(-1, i)

    xx1 = torch.maximum(at(x1), x1)
    yy1 = torch.maximum(at(y1), y1)
    xx2 = torch.minimum(at(x2), x2)
    yy2 = torch.minimum(at(y2), y2)
    inter = (xx2 - xx1).clamp_min(0) * (yy2 - yy1).clamp_min(0)
    return inter / ((at(area) + area) - inter).clamp_min(1e-12)


def nms_scores_plain(score, box, ids, order, keep_lim, overlap_thresh,
                     valid_thresh):
    """The plain version: the reference's ``body`` for ``k < keep_lim``
    (later rounds change nothing), vectorized over the rows; ``score``
    (R, n), ``box`` (R, n, 4), ``ids`` (R, n) or None, ``order`` (R, n)."""
    rows, n = score.shape
    x1, y1, x2, y2 = box.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    sup = torch.zeros((rows, n), dtype=torch.bool, device=score.device)
    pos = torch.arange(n, device=score.device)
    for k in range(keep_lim):
        i = order[:, k:k + 1]
        valid_i = ~sup.gather(1, i) & (score.gather(1, i) >= valid_thresh)
        ious = _iou_one(x1, y1, x2, y2, area, i).gather(1, order)
        same = torch.ones_like(ious, dtype=torch.bool) if ids is None \
            else ids.gather(1, order) == ids.gather(1, i)
        kill = (ious > overlap_thresh) & same & (pos > k) & valid_i
        sup.scatter_(1, order, sup.gather(1, order) | kill)
    rank = torch.empty_like(order).scatter_(
        1, order, pos.expand(rows, n).contiguous())
    drop = sup | (score < valid_thresh) | (rank >= keep_lim)
    return torch.where(drop, torch.full_like(score, -1.0), score)


def _launcher():
    lib = _build.load("box_nms")
    fn = lib.box_nms_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 10 + [i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(score, box, ids, order):
    if score.dim() != 2 or box.shape != (*score.shape, 4) or \
            order.shape != score.shape or \
            (ids is not None and ids.shape != score.shape):
        raise MXNetError(
            f"box_nms: score (R, n), box (R, n, 4), ids (R, n) and order "
            f"(R, n) expected; got {tuple(score.shape)}, "
            f"{tuple(box.shape)}, {None if ids is None else tuple(ids.shape)}"
            f", {tuple(order.shape)}")
    if order.dtype != torch.int64:
        raise MXNetError(f"box_nms: order must be int64, got {order.dtype}")
    for name, t in (("box", box), ("ids", ids), ("order", order)):
        if t is not None and t.device != score.device:
            raise MXNetError(f"box_nms: {name} on {t.device}, score on "
                             f"{score.device}")


def nms_scores(score, box, ids, order, keep_lim, overlap_thresh,
               valid_thresh):
    """New scores of ``score`` (R, n) after greedy NMS in ``order`` (see
    the module's docstring); CPU tensors take the plain version, CUDA
    tensors launch ``csrc/box_nms.cu``."""
    _check(score, box, ids, order)
    keep_lim = int(keep_lim)
    if score.device.type == "cpu":
        return nms_scores_plain(score, box, ids, order, keep_lim,
                                overlap_thresh, valid_thresh)
    if score.device.type != "cuda":
        raise MXNetError(f"box_nms: unsupported device {score.device}")
    for name, t in (("score", score), ("box", box), ("ids", ids)):
        if t is not None and t.dtype != torch.float32:
            raise MXNetError(f"box_nms: {name} must be float32 on the card "
                             f"(the kernel's IoU is the reference's f32), "
                             f"got {t.dtype}")
    rows, n = score.shape
    if rows == 0 or n == 0:
        return score.clone()
    score, box, order = (t.contiguous() for t in (score, box, order))
    ids = None if ids is None else ids.contiguous()
    dev = score.device
    sbox = torch.empty((rows, n, 4), dtype=torch.float32, device=dev)
    scratch = torch.empty((3, rows, n), dtype=torch.float32, device=dev)
    sup = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    out = torch.empty_like(score)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(score.data_ptr(), box.data_ptr(),
                 None if ids is None else ids.data_ptr(), order.data_ptr(),
                 sbox.data_ptr(), scratch[0].data_ptr(),
                 scratch[1].data_ptr(), scratch[2].data_ptr(),
                 sup.data_ptr(), out.data_ptr(), rows, n, keep_lim,
                 float(overlap_thresh), float(valid_thresh),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "box_nms")
    nms_scores.launches += 1
    return out


nms_scores.launches = 0
