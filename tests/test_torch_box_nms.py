"""The port's own kernel ``box_nms`` (``csrc/box_nms.cu``, the loop of
``mxnet_tpu/ops/nn.py::box_nms``) and its plain version.  This file does
not import the JAX package, so its ``cuda`` tests run on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_box_nms.py``).

- On the CPU: the plain version against a greedy NMS written in numpy
  from the reference's loop (independent of the port's vectorization),
  exactly, on rows with tied scores, many -1 rows, ``topk`` below n,
  classes and ``force_suppress``; the stable score order and its signed
  zeros; the wrapper's checks.
- On the card (``cuda`` marker; skipped without one): the kernel against
  the plain version on the same inputs, bit for bit, at SSD-512's 6,132
  anchors and a Faster R-CNN proposal row of 6,000, with ``keep_lim``
  400 and all; twice (the same bits); and inside a CUDA graph.
"""
import numpy as onp
import pytest
import torch

from _torch_nn_cases import box_rows
from _torch_parity import need_cuda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import box_nms as bn


def _np_iou(b, i, j, area):
    xx1 = onp.maximum(b[i, 0], b[j, 0])
    yy1 = onp.maximum(b[i, 1], b[j, 1])
    xx2 = onp.minimum(b[i, 2], b[j, 2])
    yy2 = onp.minimum(b[i, 3], b[j, 3])
    inter = onp.float32(max(xx2 - xx1, 0)) * onp.float32(max(yy2 - yy1, 0))
    return inter / max(onp.float32(area[i] + area[j]) - inter,
                       onp.float32(1e-12))


def _np_nms(score, box, ids, keep_lim, thresh, valid):
    """Greedy NMS, one box at a time, as the reference's loop reads."""
    n = score.shape[0]
    order = sorted(range(n), key=lambda i: -score[i])      # stable
    area = onp.maximum(box[:, 2] - box[:, 0], 0) * \
        onp.maximum(box[:, 3] - box[:, 1], 0)
    sup = onp.zeros(n, bool)
    for k in range(keep_lim):
        i = order[k]
        if sup[i] or score[i] < valid:
            continue
        for p in range(k + 1, n):
            j = order[p]
            if (ids is None or ids[j] == ids[i]) and \
                    _np_iou(box, i, j, area) > onp.float32(thresh):
                sup[j] = True
    rank = onp.empty(n, int)
    rank[order] = onp.arange(n)
    drop = sup | (score < valid) | (rank >= keep_lim)
    return onp.where(drop, onp.float32(-1), score)


CASES = {
    # (batch, n, ties, keep_lim, thresh, valid, with ids)
    "ties_classes": (2, 40, True, 40, 0.3, 0.0, True),
    "ties_force": (2, 40, True, 40, 0.3, 0.0, False),
    "topk_below_n": (3, 50, True, 9, 0.25, 0.0, True),
    "valid_thresh": (1, 60, False, 60, 0.5, 0.45, True),
    "no_ties_force_topk": (2, 64, False, 17, 0.4, 0.1, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_greedy_loop(name):
    b, n, ties, keep_lim, thresh, valid, with_ids = CASES[name]
    rows = box_rows(onp.random.RandomState(sum(map(ord, name))), b, n,
                    ties=ties)
    t = torch.from_numpy(rows)
    score, box = t[..., 1], t[..., 2:6]
    ids = t[..., 0] if with_ids else None
    got = bn.nms_scores(score, box, ids, bn.score_order(score), keep_lim,
                        thresh, valid).numpy()
    for r in range(b):
        want = _np_nms(rows[r, :, 1], rows[r, :, 2:6],
                       rows[r, :, 0] if with_ids else None, keep_lim,
                       thresh, valid)
        onp.testing.assert_array_equal(got[r], want)
    # something was suppressed and something kept, or the case is empty
    assert (got == -1).any() and (got != -1).any()


def test_score_order_is_stable_descending_with_signed_zeros():
    """``jnp.argsort(-s)`` (stable, -0.0 sorted with 0.0): ties keep index
    order, -0.0 and 0.0 tie."""
    s = torch.tensor([0.0, -0.0, 0.5, -1.0, 0.0, -0.0, 0.5, -1.0])
    assert bn.score_order(s).tolist() == [2, 6, 0, 1, 4, 5, 3, 7]
    s2 = torch.tensor([[-0.0, 0.0, -0.0], [0.0, -0.0, 0.0]])
    assert bn.score_order(s2).tolist() == [[0, 1, 2], [0, 1, 2]]


def test_wrapper_checks():
    s = torch.zeros(2, 5)
    with pytest.raises(MXNetError, match="box_nms"):
        bn.nms_scores(s, torch.zeros(2, 5, 3), None, bn.score_order(s), 5,
                      0.5, 0.0)
    with pytest.raises(MXNetError, match="int64"):
        bn.nms_scores(s, torch.zeros(2, 5, 4), None,
                      bn.score_order(s).int(), 5, 0.5, 0.0)
    # keep_lim 0 drops every row, as the reference's rank test does
    out = bn.nms_scores(s + 1, torch.zeros(2, 5, 4), None,
                        bn.score_order(s), 0, 0.5, 0.0)
    assert (out == -1).all()


def test_plain_takes_the_rows_dtype():
    """On the CPU the plain version runs in the rows' dtype, as the
    reference's loop does (the kernel takes f32 only and raises on
    anything else)."""
    rows = torch.from_numpy(box_rows(onp.random.RandomState(3), 1, 30))
    half = rows.to(torch.bfloat16)
    s, b = half[..., 1], half[..., 2:6]
    got = bn.nms_scores(s, b, None, bn.score_order(s), 30, 0.3, 0.0)
    assert got.dtype == torch.bfloat16
    want = bn.nms_scores_plain(s.float(), b.float(), None, bn.score_order(s),
                               30, 0.3, 0.0)
    assert ((got.float() == -1) == (want == -1)).all()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _card_rows(seed, b, n, ties):
    rs = onp.random.RandomState(seed)
    rows = box_rows(rs, b, n, classes=20, ties=ties)
    return torch.from_numpy(rows).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 6132, True, 400, True),
                                   (32, 6132, True, -1, True),
                                   (1, 6000, False, -1, False),
                                   (3, 1000, True, 7, False)],
                         ids=["ssd_topk400", "ssd_all", "rpn_6000",
                              "small_topk7"])
def test_kernel_matches_plain_on_card(shape):
    need_cuda()
    b, n, ties, topk, with_ids = shape
    t = _card_rows(b * n, b, n, ties)
    score, box = t[..., 1], t[..., 2:6]
    ids = t[..., 0] if with_ids else None
    order = bn.score_order(score)
    keep = n if topk < 0 else topk
    before = bn.nms_scores.launches
    got = bn.nms_scores(score, box, ids, order, keep, 0.45, 0.01)
    again = bn.nms_scores(score, box, ids, order, keep, 0.45, 0.01)
    torch.cuda.synchronize()
    assert bn.nms_scores.launches == before + 2
    want = bn.nms_scores_plain(score, box, ids, order, keep, 0.45, 0.01)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_records_into_a_cuda_graph():
    need_cuda()
    t = _card_rows(5, 4, 700, True)
    score, box, ids = t[..., 1], t[..., 2:6], t[..., 0]
    static = score.clone()

    def run():
        return bn.nms_scores(static, box, ids, bn.score_order(static), 300,
                             0.5, 0.0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    fresh = _card_rows(6, 4, 700, True)[..., 1]
    static.copy_(fresh)
    g.replay()
    torch.cuda.synchronize()
    want = bn.nms_scores_plain(fresh, box, ids, bn.score_order(fresh), 300,
                               0.5, 0.0)
    assert torch.equal(out, want)
