"""The detection and sampling ops of the port (``ops/nn.py``: ``box_nms``,
the ``MultiBox`` family, ``Proposal``, ``ROIAlign``, ``ROIPooling``,
``DeformableConvolution``, ``GridGenerator``) against the JAX package on
the CPU, at the cases where the small-shape sweep of
``tests/test_torch_nn_ops.py`` (``tests/_torch_nn_cases.py``) would not
show a fault: tied scores, padded labels, chunking, tie gradients.

Tolerances: ``box_nms``, ``MultiBoxTarget``'s ``cls_target`` and
``loc_mask``, and which ROIs ``Proposal`` returns in which order, are
exact.  Coordinates that pass through ``exp`` are held to 1e-6 relative
(a few f32 ulps): the port takes ``exp`` correctly rounded (f64, rounded
once, so the card and the CPU agree), where XLA's f32 ``exp`` is off by
an ulp on ~9 % of inputs; with zero deltas (``exp(0) = 1``) the ROIs
are exact.  Other f32 outputs and gradients: 1e-5.
"""
import jax
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as mx
from _torch_nn_cases import box_rows, det_labels, prior
from mxnet_tpu_torch.ops import nn as pnn

TOL = dict(rtol=1e-5, atol=1e-6)
EXP_TOL = dict(rtol=1e-6, atol=1e-6)


def _both(name, arrays, kwargs, heads=None):
    """``nd.<name>`` of each package on ``arrays``: outputs, and with
    ``heads`` the f32 inputs' gradients."""
    res = []
    for pkg in (rmx, mx):
        with mx.cpu():
            nds = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
            if heads is not None:
                for x in nds:
                    x.attach_grad()
            with pkg.autograd.record():
                out = getattr(pkg.nd, name)(*nds, **kwargs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if heads is not None:
                pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads])
            res.append(([o.asnumpy() for o in outs],
                        [x.grad.asnumpy() for x in nds]
                        if heads is not None else []))
    return res


# --------------------------------------------------------------------------- #
# box_nms
# --------------------------------------------------------------------------- #

NMS_CASES = {
    "ties_many_minus_one": dict(overlap_thresh=0.3, id_index=0),
    "force_suppress": dict(overlap_thresh=0.3, id_index=0,
                           force_suppress=True),
    "topk_below_n": dict(overlap_thresh=0.25, id_index=0, topk=6),
    "force_topk_valid": dict(overlap_thresh=0.2, force_suppress=True,
                             topk=11, valid_thresh=0.4),
    "no_ids": dict(overlap_thresh=0.5),
}


@pytest.mark.parametrize("name", list(NMS_CASES))
def test_box_nms_exact(name):
    rows = box_rows(onp.random.RandomState(sum(map(ord, name))), 3, 40)
    (ref, _), (got, _) = _both("box_nms", [rows], NMS_CASES[name])
    onp.testing.assert_array_equal(got[0], ref[0])
    kept = got[0][..., 1] != -1
    assert kept.any() and (~kept & (rows[..., 1] != -1)).any()


def test_box_nms_signed_zero_scores_and_batch_dims():
    """Scores of 0.0 and -0.0 tie (``jnp.argsort`` sorts them together, in
    index order); leading batch dims are kept."""
    rows = box_rows(onp.random.RandomState(4), 6, 16, ties=False)
    rows[..., 1] = onp.where(rows[..., 1] < 0.5, 0.0, rows[..., 1])
    rows[::2, ::3, 1] = -0.0
    rows = rows.reshape(2, 3, 16, 6)
    (ref, _), (got, _) = _both("box_nms", [rows],
                               dict(overlap_thresh=0.1, valid_thresh=-0.5))
    assert got[0].shape == rows.shape
    onp.testing.assert_array_equal(got[0], ref[0])
    onp.testing.assert_array_equal(onp.signbit(got[0]), onp.signbit(ref[0]))


# --------------------------------------------------------------------------- #
# MultiBoxTarget and MultiBoxDetection
# --------------------------------------------------------------------------- #

def test_multibox_target_padded_labels():
    anchors = prior(6, 6, (0.3, 0.15), (1.0, 2.0, 0.5))
    labels = det_labels(onp.random.RandomState(7), 4, 5, 3)
    cls_pred = onp.zeros((4, 6, anchors.shape[1]), onp.float32)
    (ref, _), (got, _) = _both("MultiBoxTarget", [anchors, labels, cls_pred],
                               dict(overlap_threshold=0.5))
    onp.testing.assert_allclose(got[0], ref[0], **TOL)
    onp.testing.assert_array_equal(got[1], ref[1])
    onp.testing.assert_array_equal(got[2], ref[2])
    assert (got[2] > 0).sum() >= 4 * 5        # every object has an anchor


def test_multibox_target_forced_match_ignores_padding():
    """A valid object's best anchor is anchor 0 and a padded row follows.
    The reference's ``zeros(A).at[best_anchor].set(valid)`` lets the
    padded row (whose argmax is also anchor 0) write False last, so its
    ``cls_target`` loses the match (ROADMAP §3, a fault of the reference).
    The port forces an anchor that any valid object picks: its result
    equals the reference's on the same labels without the padding."""
    anc = onp.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                      [0.3, 0.3, 0.6, 0.6]]], onp.float32)
    lab = onp.array([[[1, 0.0, 0.0, 0.35, 0.35], [-1, 0, 0, 0, 0]]],
                    onp.float32)
    cls_pred = onp.zeros((1, 3, 3), onp.float32)
    (ref, _), (got, _) = _both("MultiBoxTarget", [anc, lab, cls_pred], {})
    (unpadded, _), _ = _both("MultiBoxTarget", [anc, lab[:, :1], cls_pred],
                             {})
    assert ref[2].tolist() == [[0.0, 0.0, 0.0]]       # the reference's fault
    assert got[2].tolist() == [[2.0, 0.0, 0.0]]
    for g, u in zip(got, unpadded):
        onp.testing.assert_array_equal(g, u)


def test_multibox_detection_ids_scores_exact():
    anchors = prior(5, 5, (0.4, 0.2), (1.0, 2.0, 0.5))
    a = anchors.shape[1]
    rs = onp.random.RandomState(9)
    e = onp.exp(rs.standard_normal((2, 6, a)) * 2)
    cls_prob = (e / e.sum(1, keepdims=True)).astype(onp.float32)
    loc = (rs.standard_normal((2, a * 4)) * 0.3).astype(onp.float32)
    for kw in (dict(nms_threshold=0.45, threshold=0.2),
               dict(nms_threshold=0.3, nms_topk=12, force_suppress=True)):
        (ref, _), (got, _) = _both("MultiBoxDetection",
                                   [cls_prob, loc, anchors], kw)
        onp.testing.assert_array_equal(got[0][..., :2], ref[0][..., :2])
        onp.testing.assert_allclose(got[0][..., 2:], ref[0][..., 2:],
                                    **EXP_TOL)


# --------------------------------------------------------------------------- #
# Proposal: which ROIs, in which order
# --------------------------------------------------------------------------- #

def _rpn(seed, a, h, w, scale):
    rs = onp.random.RandomState(seed)
    e = onp.exp(rs.standard_normal((1, 2 * a, h, w)))
    return ((e / e.sum(1, keepdims=True)).astype(onp.float32),
            (rs.standard_normal((1, 4 * a, h, w)) * scale).astype(
                onp.float32))


@pytest.mark.parametrize("min_size", [4, 40], ids=["few_filtered",
                                                   "many_minus_one"])
def test_proposal_rois_exact_with_zero_deltas(min_size):
    """Zero deltas (``exp(0) = 1``): the ROIs bit for bit, in order; with
    a large ``rpn_min_size`` most anchors score -1 and the output reaches
    into them, so their order is the stable sort's."""
    cls_prob, _ = _rpn(1, 6, 6, 7, 0.0)
    deltas = onp.zeros((1, 24, 6, 7), onp.float32)
    info = onp.array([[96, 112, 1.0]], onp.float32)
    kw = dict(scales=(2, 4), ratios=(0.5, 1, 2), rpn_pre_nms_top_n=120,
              rpn_post_nms_top_n=80, rpn_min_size=min_size, threshold=0.7,
              output_score=True)
    (ref, _), (got, _) = _both("Proposal", [cls_prob, deltas, info], kw)
    onp.testing.assert_array_equal(got[0], ref[0])
    onp.testing.assert_array_equal(got[1], ref[1])
    if min_size == 40:
        assert (got[1] == -1).sum() > 10


def test_proposal_random_deltas_order_exact():
    cls_prob, deltas = _rpn(2, 6, 5, 6, 0.2)
    info = onp.array([[80, 96, 1.0]], onp.float32)
    kw = dict(scales=(2, 4), ratios=(0.5, 1, 2), rpn_pre_nms_top_n=100,
              rpn_post_nms_top_n=40, rpn_min_size=8, threshold=0.6,
              output_score=True)
    (ref, _), (got, _) = _both("Proposal", [cls_prob, deltas, info], kw)
    onp.testing.assert_array_equal(got[1], ref[1])
    onp.testing.assert_allclose(got[0], ref[0], **EXP_TOL)


def test_proposal_base_anchors_in_f32():
    """``sqrt(size / r)`` of the f32-rounded quotient, in f32, as the
    reference's ``jnp.sqrt`` of a Python float."""
    import jax.numpy as jnp

    got = pnn._proposal_base((8, 16, 32), (0.5, 1, 2), 16.0, "cpu").numpy()
    want = []
    for r in (0.5, 1, 2):
        for s in (8, 16, 32):
            w = jnp.sqrt(256.0 * s * s / r)
            h = w * r
            want.append([7.5 - (w - 1) / 2, 7.5 - (h - 1) / 2,
                         7.5 + (w - 1) / 2, 7.5 + (h - 1) / 2])
    onp.testing.assert_array_equal(got, onp.asarray(jnp.asarray(
        want, jnp.float32)))


# --------------------------------------------------------------------------- #
# region pooling: tie gradients, chunking
# --------------------------------------------------------------------------- #

def test_roi_pooling_splits_ties_equally():
    """One bin whose max (0) ties at three pixels over two rows takes a
    third of the cotangent at each (nested maxima would give 1/4, 1/4,
    1/2), as the reference's ``reduce_max``."""
    data = onp.full((1, 1, 4, 4), -1.0, onp.float32)
    data[0, 0, 0, 0] = data[0, 0, 0, 1] = data[0, 0, 1, 0] = 0.0
    rois = onp.array([[0, 0, 0, 3, 3]], onp.float32)
    head = onp.ones((1, 1, 2, 2), onp.float32)
    (ref, rg), (got, pg) = _both("ROIPooling", [data, rois],
                                 dict(pooled_size=(2, 2)), [head])
    onp.testing.assert_array_equal(got[0], ref[0])
    onp.testing.assert_allclose(pg[0][0, 0, :2, :2],
                                [[1 / 3, 1 / 3], [1 / 3, 0]], **TOL)
    onp.testing.assert_allclose(pg[0], rg[0], **TOL)
    onp.testing.assert_array_equal(pg[1], 0 * rg[1])


def test_roi_pooling_relu_data_gradient_matches_reference():
    rs = onp.random.RandomState(12)
    data = onp.maximum(rs.standard_normal((2, 4, 10, 12)), 0).astype(
        onp.float32)
    rois = onp.array([[0, 0, 0, 11, 9], [1, 2, 3, 9, 8], [0, 5, 5, 5, 5],
                      [1, -2, -3, 14, 13], [0, 8, 1, 3, 7]], onp.float32)
    head = rs.standard_normal((5, 4, 3, 4)).astype(onp.float32)
    (ref, rg), (got, pg) = _both("ROIPooling", [data, rois],
                                 dict(pooled_size=(3, 4), spatial_scale=1.0),
                                 [head])
    onp.testing.assert_array_equal(got[0], ref[0])
    onp.testing.assert_allclose(pg[0], rg[0], **TOL)


@pytest.mark.parametrize("name,kw", [
    ("ROIAlign", dict(pooled_size=(3, 3), sample_ratio=2)),
    ("ROIPooling", dict(pooled_size=(2, 3)))])
def test_roi_chunks_equal_one_chunk(monkeypatch, name, kw):
    """ROIs in chunks of one give the outputs of a single chunk bit for
    bit (each ROI's result is its own), and its gradients to 1e-6 (the
    chunks' data gradients are summed in another order)."""
    rs = onp.random.RandomState(13)
    data = rs.standard_normal((2, 3, 9, 8)).astype(onp.float32)
    rois = onp.array([[0, 0.5, 0.5, 6.2, 7.7], [1, 1, 1, 7, 5],
                      [0, 2.5, 1.2, 5.3, 7.9], [1, 0, 0, 8, 9]], onp.float32)
    head = rs.standard_normal((4, 3) + kw["pooled_size"]).astype(onp.float32)

    def run():
        with mx.cpu():
            x, r = mx.nd.array(data), mx.nd.array(rois)
            x.attach_grad()
            r.attach_grad()
            with mx.autograd.record():
                out = getattr(mx.nd, name)(x, r, **kw)
            out.backward(mx.nd.array(head))
            return out.asnumpy(), x.grad.asnumpy(), r.grad.asnumpy()

    one = run()
    monkeypatch.setattr(pnn, "_CHUNK_BYTES", 1)
    assert len(pnn._chunks(4, 100)) == 4
    got = run()
    onp.testing.assert_array_equal(got[0], one[0])
    for a, b in zip(got[1:], one[1:]):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# sampling layers
# --------------------------------------------------------------------------- #

def test_deformable_convolution_four_groups_gradients():
    rs = onp.random.RandomState(14)
    arrays = [rs.standard_normal((2, 8, 7, 6)).astype(onp.float32),
              (rs.standard_normal((2, 2 * 4 * 9, 7, 6)) * 1.5).astype(
                  onp.float32),
              rs.standard_normal((5, 8, 3, 3)).astype(onp.float32),
              rs.standard_normal(5).astype(onp.float32)]
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=5,
              num_deformable_group=4)
    head = rs.standard_normal((2, 5, 7, 6)).astype(onp.float32)
    (ref, rg), (got, pg) = _both("DeformableConvolution", arrays, kw, [head])
    onp.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    for p, r in zip(pg, rg):
        onp.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num", [0, 1, 2, 7, 64, 513])
def test_linspace_is_jax_formula(num):
    """``_linspace`` is ``jnp.linspace``'s formula with every operation
    rounded on its own, bit for bit (numpy in f32), and within 2**-23 of
    ``jnp.linspace`` itself: XLA turns its division by ``num - 1`` into a
    product with the reciprocal and fuses a multiply-add (index 3 of 7
    reads 2**-26, not 0), which is GridGenerator's stated tolerance."""
    import jax.numpy as jnp

    got = pnn._linspace(-1.0, 1.0, num, "cpu").numpy()
    if num >= 2:
        t = onp.arange(num - 1, dtype=onp.float32) / onp.float32(num - 1)
        want = onp.float32(-1) * (onp.float32(1) - t) + onp.float32(1) * t
        onp.testing.assert_array_equal(got, onp.append(want, onp.float32(1)))
    onp.testing.assert_allclose(got, onp.asarray(jnp.linspace(-1.0, 1.0,
                                                              num)),
                                rtol=0, atol=2.0 ** -23)


def test_grid_generator_then_sampler_identity():
    """The reference test's identity transform, through both ops: the
    sampled image equals the input."""
    theta = onp.array([[1, 0, 0, 0, 1, 0]], onp.float32)
    x = onp.random.RandomState(15).rand(1, 2, 5, 6).astype(onp.float32)
    with mx.cpu():
        grid = mx.nd.GridGenerator(mx.nd.array(theta), transform_type="affine",
                                   target_shape=(5, 6))
        out = mx.nd.BilinearSampler(mx.nd.array(x), grid).asnumpy()
    ref_grid = rmx.nd.GridGenerator(rmx.nd.array(theta),
                                    transform_type="affine",
                                    target_shape=(5, 6)).asnumpy()
    onp.testing.assert_allclose(grid.asnumpy(), ref_grid, rtol=0,
                                atol=2.0 ** -23)
    onp.testing.assert_allclose(out, x, atol=1e-6)


def test_box_nms_reference_loop_unjitted_agrees():
    """The reference's loop run op by op (``jax.disable_jit``: no FMA
    contraction of its IoU) gives the same rows as the port at a
    threshold IoU: two boxes whose IoU is exactly 0.5 are kept at 0.5."""
    rows = onp.array([[[0, 0.9, 0, 0, 2, 1], [0, 0.8, 0, 0, 1, 1],
                       [0, 0.7, 1, 0, 2, 1], [0, 0.6, 0, 0, 2, 2]]],
                     onp.float32)
    with jax.disable_jit():
        (ref, _), (got, _) = _both("box_nms", [rows],
                                   dict(overlap_thresh=0.5, id_index=0))
    onp.testing.assert_array_equal(got[0], ref[0])
    assert (got[0][..., 1] == rows[..., 1]).all()


# --------------------------------------------------------------------------- #
# the slice as a whole: the SSD and Faster R-CNN heads' op chains, and the
# SSD of tests/_torch_ssd_models.py trained through fused_step on the CPU
# --------------------------------------------------------------------------- #

def test_detection_chains_match_reference():
    """SSD's chain (anchors of two maps, targets, softmax, detection) and
    Faster R-CNN's (Proposal, then ROIAlign and ROIPooling with the
    feature's gradient) from the same head outputs in both packages."""
    rs = onp.random.RandomState(30)

    def ssd_chain(pkg):
        nd = pkg.nd
        maps = [nd.array(onp.zeros((1, 1, s, s), onp.float32))
                for s in (4, 2)]
        anchors = nd.concat(*[nd.MultiBoxPrior(m, sizes=(0.3, 0.5),
                                               ratios=(1, 2, 0.5))
                              for m in maps], dim=1)
        a = anchors.shape[1]
        logits = nd.array(onp.random.RandomState(31).standard_normal(
            (2, a, 5)).astype(onp.float32))
        loc = nd.array((onp.random.RandomState(32).standard_normal(
            (2, a * 4)) * 0.2).astype(onp.float32))
        label = nd.array(det_labels(onp.random.RandomState(33), 2, 3, 1))
        targets = nd.MultiBoxTarget(anchors, label,
                                    nd.transpose(logits, axes=(0, 2, 1)))
        prob = nd.transpose(nd.softmax(logits, axis=-1), axes=(0, 2, 1))
        det = nd.MultiBoxDetection(prob, loc, anchors, nms_threshold=0.45,
                                   threshold=0.1, nms_topk=20)
        return [t.asnumpy() for t in targets] + [det.asnumpy()]

    ref = ssd_chain(rmx)
    with mx.cpu():
        got = ssd_chain(mx)
    onp.testing.assert_allclose(got[0], ref[0], **TOL)
    for g, r in zip(got[1:3], ref[1:3]):
        onp.testing.assert_array_equal(g, r)
    onp.testing.assert_array_equal(got[3][..., :2], ref[3][..., :2])
    onp.testing.assert_allclose(got[3][..., 2:], ref[3][..., 2:], **EXP_TOL)

    cls_prob, deltas = _rpn(34, 3, 6, 8, 0.0)
    feat = rs.standard_normal((1, 6, 6, 8)).astype(onp.float32)
    info = onp.array([[96, 128, 1.0]], onp.float32)
    heads = [rs.standard_normal((12, 6, 3, 3)).astype(onp.float32),
             rs.standard_normal((12, 6, 2, 2)).astype(onp.float32)]

    def rcnn_chain(pkg):
        nd = pkg.nd
        rois = nd.Proposal(nd.array(cls_prob), nd.array(deltas),
                           nd.array(info), scales=(2, 4, 8),
                           ratios=(1.0,), rpn_pre_nms_top_n=50,
                           rpn_post_nms_top_n=12, rpn_min_size=4)
        x = nd.array(feat)
        x.attach_grad()
        with pkg.autograd.record():
            a = nd.ROIAlign(x, rois, pooled_size=(3, 3),
                            spatial_scale=1 / 16)
            p = nd.ROIPooling(x, rois, pooled_size=(2, 2),
                              spatial_scale=1 / 16)
        pkg.autograd.backward([a, p], [nd.array(h) for h in heads])
        return [rois.asnumpy(), a.asnumpy(), p.asnumpy(), x.grad.asnumpy()]

    ref = rcnn_chain(rmx)
    with mx.cpu():
        got = rcnn_chain(mx)
    onp.testing.assert_array_equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        onp.testing.assert_allclose(g, r, **TOL)


def test_ssd_trains_through_fused_step_on_cpu():
    """The SSD of ``tests/_torch_ssd_models.py`` (GluonCV's head layout on
    a small ResNet v1, 128 x 128 inputs) through ``Trainer.fused_step``:
    one program for three steps, finite losses, the first class loss near
    ln 21, the step's targets equal to ``MultiBoxTarget`` run on its
    batch, and the hybridized detection equal to the imperative one."""
    import math

    from _torch_ssd_models import ssd, ssd_detect, ssd_loss
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import fused_step as fsm
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)

    rs = onp.random.RandomState(35)
    with mx.cpu():
        base = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                        classes=10, layout="NHWC")
        net = ssd(mx, base, filters=(32, 32, 16, 16))
        net.initialize(mx.init.Xavier(magnitude=3), ctx=mx.cpu())
        loss = ssd_loss(mx, net)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(learning_rate=0.001, momentum=0.9,
                                     wd=5e-4))

        def loss_fn(x, y):
            return loss(x, y)

        x = mx.nd.array(rs.uniform(-1, 1, (2, 3, 128, 128)).astype(
            onp.float32))
        y = mx.nd.array(det_labels(rs, 2, 3, 2))
        fsm.reset_step_counters()
        outs = [trainer.fused_step(loss_fn, x, y) for _ in range(3)]
        assert fsm.step_counters["compiles"] == 1
        assert fsm.step_counters["legacy_steps"] == 0
        losses = [float(o[0].asnumpy().mean()) for o in outs]
        assert all(math.isfinite(v) for v in losses)
        assert abs(float(outs[0][1].asnumpy().mean()) - math.log(21)) < 1.0
        _, _, anchors = net(mx.nd.transpose(x, axes=(0, 2, 3, 1)))
        assert anchors.shape == (1, 4 * 64 + 6 * 16 + 6 * 4 + 6 + 4 + 4, 4)
        want = mx.nd.MultiBoxTarget(anchors, y,
                                    mx.nd.zeros((2, 21, anchors.shape[1])))
        for got, w in zip(outs[-1][2:], want):
            onp.testing.assert_array_equal(got.asnumpy(), w.asnumpy())
        det = ssd_detect(mx, net, nms_topk=50)
        imperative = det(x)[0].asnumpy()
        det.hybridize()
        for _ in range(2):
            onp.testing.assert_array_equal(det(x)[0].asnumpy(), imperative)
