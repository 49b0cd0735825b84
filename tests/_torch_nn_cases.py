"""The cases of ``tests/test_torch_nn_ops.py``: every op that the port's
``ops/nn.py`` and ``ops/attention.py`` register, at small f32 shapes
made from a seed with numpy.  Kept apart from the test (which imports
the JAX package) so that ``chip_smoke.py`` runs the same cases on the
card against the CPU.
"""
import numpy as onp


def _input(rs, spec):
    kind, *rest = spec
    if kind == "n":                     # standard normal
        return rs.standard_normal(rest[0]).astype(onp.float32)
    if kind == "p":                     # positive, away from 0
        return rs.uniform(0.5, 2.0, rest[0]).astype(onp.float32)
    if kind == "i":                     # int32 in [lo, hi)
        shape, lo, hi = rest
        return rs.randint(lo, hi, shape).astype(onp.int32)
    if kind == "v":                     # a fixed value
        return onp.asarray(rest[0], dtype=onp.float32)
    if kind == "z":                     # ReLU of a normal: ties at 0
        return onp.maximum(rs.standard_normal(rest[0]), 0).astype(
            onp.float32)
    raise ValueError(kind)


def N(*shape):
    return ("n", shape)


def Z(*shape):
    return ("z", shape)


def P(*shape):
    return ("p", shape)


def I(lo, hi, *shape):
    return ("i", shape, lo, hi)


X = N(2, 3, 5)
# (id, op name, input specs, static kwargs)
CASES = [(f"Activation_{a}", "Activation", [X], dict(act_type=a))
         for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign",
                   "log_sigmoid", "mish", "gelu", "erf_gelu", "swish")]
CASES += [
    ("LeakyReLU_leaky", "LeakyReLU", [X], dict(slope=0.1)),
    ("LeakyReLU_prelu", "LeakyReLU", [N(2, 3, 4, 4), P(3)],
     dict(act_type="prelu")),
    ("LeakyReLU_elu", "LeakyReLU", [X], dict(act_type="elu", slope=0.7)),
    ("LeakyReLU_selu", "LeakyReLU", [X], dict(act_type="selu")),
    ("LeakyReLU_gelu", "LeakyReLU", [X], dict(act_type="gelu")),
    ("LeakyReLU_rrelu", "LeakyReLU", [X], dict(act_type="rrelu")),
    ("softmax", "softmax", [X], {}),
    ("softmax_axis_temperature", "softmax", [X],
     dict(axis=1, temperature=2.5)),
    ("softmax_length", "softmax", [N(3, 6), ("v", [2., 6., 4.])],
     dict(use_length=True)),
    ("softmax_length_axis1", "softmax", [N(2, 5, 3), ("v", [3., 1.])],
     dict(axis=1, use_length=True)),
    ("log_softmax", "log_softmax", [X], dict(axis=1)),
    ("log_softmax_temperature", "log_softmax", [X], dict(temperature=0.5)),
    ("_sparse_softmax_ce", "_sparse_softmax_ce", [N(4, 5), I(0, 5, 4)], {}),
    ("_sparse_softmax_ce_axis1", "_sparse_softmax_ce",
     [N(2, 5, 3), I(-1, 6, 2, 3)], dict(axis=1)),
    ("softmin", "softmin", [X], dict(axis=0)),
    ("SoftmaxActivation", "SoftmaxActivation", [N(2, 3, 2, 2)], {}),
    ("SoftmaxActivation_channel", "SoftmaxActivation", [N(2, 3, 2, 2)],
     dict(mode="channel")),
    ("FullyConnected", "FullyConnected", [N(2, 3, 4), N(5, 12), N(5)],
     dict(num_hidden=5)),
    ("FullyConnected_noflatten", "FullyConnected",
     [N(2, 3, 4), N(5, 4), N(5)], dict(num_hidden=5, flatten=False)),
    ("FullyConnected_nobias", "FullyConnected", [N(3, 4), N(5, 4), N(5)],
     dict(num_hidden=5, no_bias=True)),
    # Convolution at 1, 2 and 3 spatial dims, channels first and last
    ("Convolution_1d", "Convolution", [N(2, 4, 9), N(6, 2, 3), N(6)],
     dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=6, num_group=2)),
    ("Convolution_1d_nwc", "Convolution", [N(2, 9, 3), N(4, 3, 3), N(4)],
     dict(kernel=(3,), dilate=(2,), num_filter=4, layout="NWC")),
    ("Convolution_2d_groups_dilate", "Convolution",
     [N(1, 4, 9, 8), N(6, 2, 3, 3), N(6)],
     dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
          num_filter=6, num_group=2)),
    ("Convolution_2d_nhwc", "Convolution", [N(2, 7, 6, 3), N(4, 3, 3, 3),
                                            N(4)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=4, layout="NHWC")),
    ("Convolution_2d_nhwc_1x1", "Convolution", [N(2, 4, 4, 8), N(16, 8, 1, 1)],
     dict(kernel=(1, 1), num_filter=16, no_bias=True, layout="NHWC")),
    ("Convolution_3d", "Convolution", [N(1, 2, 5, 6, 5), N(3, 2, 3, 2, 3),
                                       N(3)],
     dict(kernel=(3, 2, 3), stride=(1, 2, 1), pad=(1, 0, 1),
          num_filter=3)),
    ("Convolution_3d_ndhwc_groups", "Convolution",
     [N(1, 4, 5, 5, 4), N(4, 2, 2, 3, 2)],
     dict(kernel=(2, 3, 2), dilate=(2, 1, 1), num_filter=4, num_group=2,
          no_bias=True, layout="NDHWC")),
    ("Deconvolution_1d", "Deconvolution", [N(2, 3, 6), N(3, 4, 3), N(4)],
     dict(kernel=(3,), stride=(2,), adj=(1,), num_filter=4, no_bias=False)),
    ("Deconvolution_2d", "Deconvolution", [N(1, 3, 5, 4), N(3, 2, 3, 2)],
     dict(kernel=(3, 2), stride=(2, 3), pad=(1, 0), dilate=(1, 2),
          num_filter=2)),
    ("Deconvolution_2d_adj_past_pad", "Deconvolution",
     [N(1, 2, 4, 4), N(2, 3, 3, 3), N(3)],
     dict(kernel=(3, 3), stride=(3, 3), adj=(2, 1), num_filter=3,
          no_bias=False)),
    ("Deconvolution_3d", "Deconvolution", [N(1, 2, 3, 4, 3),
                                           N(2, 3, 2, 3, 2)],
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 1), num_filter=3)),
    # Pooling at 1, 2 and 3 spatial dims
    ("Pooling_1d_max", "Pooling", [N(2, 3, 9)],
     dict(kernel=(3,), stride=(2,), pad=(1,))),
    ("Pooling_1d_avg_nwc_full", "Pooling", [N(2, 8, 3)],
     dict(kernel=(3,), stride=(2,), pool_type="avg", layout="NWC",
          pooling_convention="full")),
    ("Pooling_1d_sum", "Pooling", [N(1, 2, 7)],
     dict(kernel=(2,), pool_type="sum")),
    ("Pooling_2d_lp", "Pooling", [N(1, 2, 6, 6)],
     dict(kernel=(2, 3), stride=(2, 1), pool_type="lp")),
    ("Pooling_2d_avg_nhwc_nopad", "Pooling", [N(2, 7, 6, 3)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          count_include_pad=False, layout="NHWC")),
    ("Pooling_3d_max_full", "Pooling", [N(1, 2, 5, 6, 5)],
     dict(kernel=(2, 3, 2), stride=(2, 2, 2), pooling_convention="full")),
    ("Pooling_3d_avg_ndhwc", "Pooling", [N(1, 4, 5, 4, 2)],
     dict(kernel=(3, 3, 2), pad=(1, 1, 0), pool_type="avg",
          layout="NDHWC")),
    ("Pooling_global_1d", "Pooling", [N(2, 3, 7)],
     dict(kernel=(1,), global_pool=True, pool_type="avg")),
    ("Pooling_global_3d_max", "Pooling", [N(2, 3, 3, 2, 4)],
     dict(kernel=(1, 1, 1), global_pool=True)),
    ("_BatchNormStats_nhwc", "_BatchNormStats",
     [N(2, 3, 3, 4), P(4), N(4), N(4), P(4)],
     dict(axis=-1, fix_gamma=False, momentum=0.8)),
    ("_BatchNormStats_global", "_BatchNormStats",
     [N(2, 4, 3), P(4), N(4), N(4), P(4)],
     dict(fix_gamma=False, use_global_stats=True)),
    ("_BatchNormStats_inference", "_BatchNormStats",
     [N(2, 4, 3), P(4), N(4), N(4), P(4)], dict(training=False)),
    ("LayerNorm_axis1", "LayerNorm", [N(2, 3, 4), P(3), N(3)],
     dict(axis=1, eps=1e-3)),
    ("LayerNorm_mean_var", "LayerNorm", [N(3, 6), P(6), N(6)],
     dict(output_mean_var=True)),
    ("InstanceNorm_3d", "InstanceNorm", [N(2, 3, 2, 3, 2), P(3), N(3)],
     dict(eps=1e-5)),
    ("GroupNorm_1d", "GroupNorm", [N(2, 6, 5), P(6), N(6)],
     dict(num_groups=3)),
    ("RMSNorm_axis0", "RMSNorm", [N(5, 3), P(5)], dict(axis=0)),
    ("Embedding", "Embedding", [I(0, 7, 2, 3), N(7, 4)],
     dict(input_dim=7, output_dim=4)),
    ("SoftmaxOutput", "SoftmaxOutput", [N(4, 5), I(0, 5, 4)], {}),
    ("SoftmaxOutput_ignore_valid", "SoftmaxOutput",
     [N(4, 5), ("v", [1., -1., 3., -1.])],
     dict(use_ignore=True, normalization="valid", grad_scale=2.0)),
    ("SoftmaxOutput_multi_smooth", "SoftmaxOutput",
     [N(2, 3, 4), I(0, 3, 2, 4)],
     dict(multi_output=True, smooth_alpha=0.1, normalization="batch")),
    ("SoftmaxOutput_dist_out_grad", "SoftmaxOutput", [N(3, 4), P(3, 4)],
     dict(out_grad=True)),
    ("CTCLoss_padded", "CTCLoss", [N(6, 2, 5), ("v", [[1., 2., 2.],
                                                      [3., -1., -1.]])],
     {}),
    ("CTCLoss_blank_last_lengths", "CTCLoss",
     [N(7, 2, 4), ("v", [[1., 0.], [2., 2.]]), ("v", [5., 7.]),
      ("v", [1., 2.])],
     dict(blank_label="last", use_data_lengths=True,
          use_label_lengths=True)),
    ("MakeLoss", "MakeLoss", [X], dict(grad_scale=2.0)),
    ("UpSampling_bilinear", "UpSampling", [N(1, 2, 3, 4)],
     dict(scale=3, sample_type="bilinear")),
    ("BilinearResize2D_down", "_contrib_BilinearResize2D", [N(1, 2, 8, 7)],
     dict(height=3, width=5)),
    ("BilinearResize2D_scale", "_contrib_BilinearResize2D", [N(2, 1, 4, 6)],
     dict(scale_height=1.5, scale_width=0.5)),
    ("interleaved_qk", "_contrib_interleaved_matmul_selfatt_qk",
     [N(5, 2, 36)], dict(heads=3)),
    ("interleaved_valatt", "_contrib_interleaved_matmul_selfatt_valatt",
     [N(5, 2, 36), P(6, 5, 5)], dict(heads=3)),
    ("hard_sigmoid", "hard_sigmoid", [X], dict(alpha=0.3, beta=0.4)),
    ("log_sigmoid", "log_sigmoid", [X], {}),
    ("mish", "mish", [X], {}),
    ("flash_attention_causal", "flash_attention",
     [N(2, 3, 24, 8), N(2, 3, 24, 8), N(2, 3, 24, 8)],
     dict(causal=True, scale=0.3)),
    ("flash_attention_cross_bias", "flash_attention",
     [N(1, 2, 12, 8), N(1, 2, 20, 8), N(1, 2, 20, 8), N(1, 2, 12, 20)],
     {}),
    ("rope_offset", "rope", [N(2, 2, 6, 8)],
     dict(base=500.0, position_offset=3)),
]


# --------------------------------------------------------------------------- #
# detection and sampling: structured inputs (boxes, ROIs, anchors, labels)
# made once from a seed
# --------------------------------------------------------------------------- #

def box_rows(rs, batch, n, classes=3, ties=True):
    """(batch, n, 6) rows [id, score, x1, y1, x2, y2] in the unit square;
    with ``ties``, scores drawn from a few values, a third of them -1."""
    xy = rs.uniform(0.0, 0.7, (batch, n, 2))
    wh = rs.uniform(0.05, 0.4, (batch, n, 2))
    if ties:
        score = rs.choice([-1.0, -1.0, 0.3, 0.5, 0.5, 0.9], (batch, n))
    else:
        score = rs.uniform(0.0, 1.0, (batch, n))
    ids = rs.randint(0, classes, (batch, n))
    return onp.concatenate([ids[..., None], score[..., None], xy, xy + wh],
                           -1).astype(onp.float32)


def prior(h, w, sizes, ratios):
    """MultiBoxPrior's anchors in numpy (its f32 formula), (1, h*w*A, 4)."""
    cy = (onp.arange(h, dtype=onp.float32) + onp.float32(0.5)) * \
        onp.float32(1.0 / h)
    cx = (onp.arange(w, dtype=onp.float32) + onp.float32(0.5)) * \
        onp.float32(1.0 / w)
    whs = [(s * ratios[0] ** 0.5, s / ratios[0] ** 0.5) for s in sizes]
    whs += [(sizes[0] * r ** 0.5, sizes[0] / r ** 0.5) for r in ratios[1:]]
    half = onp.asarray(whs, onp.float32) / onp.float32(2)
    gy, gx = onp.meshgrid(cy, cx, indexing="ij")
    c = onp.stack([gx, gy], -1).reshape(-1, 1, 2)
    return onp.concatenate([c - half, c + half], -1).reshape(1, -1, 4)


def det_labels(rs, batch, objects, pad):
    """(batch, objects + pad, 5) labels [cls, x1, y1, x2, y2], the last
    ``pad`` rows padding (class -1); the objects keep off the top-left
    corner, so no valid object's best anchor is anchor 0 (where the
    reference's forced-match scatter drops it, ROADMAP §3)."""
    xy = rs.uniform(0.3, 0.6, (batch, objects, 2))
    wh = rs.uniform(0.1, 0.4, (batch, objects, 2))
    cls = rs.randint(0, 4, (batch, objects, 1))
    lab = onp.concatenate([cls, xy, xy + wh], -1)
    padrows = onp.tile([[-1.0, 0, 0, 0, 0]], (batch, pad, 1))
    return onp.concatenate([lab, padrows], 1).astype(onp.float32)


def _softmaxed(rs, shape, axis):
    e = onp.exp(rs.standard_normal(shape) * 2)
    return (e / e.sum(axis, keepdims=True)).astype(onp.float32)


_RS = onp.random.RandomState(19)
_ROIS = onp.array([[0, 0.5, 0.5, 6.2, 6.7], [1, 1, 1, 7, 5],
                   [0, 2.5, 1.2, 5.3, 7.9], [1, 3, 2, 3, 2]], onp.float32)
_ANCHORS = prior(3, 4, (0.5, 0.25), (1.0, 2.0, 0.5))          # A = 48
_A = _ANCHORS.shape[1]
CASES += [
    ("ROIAlign", "_contrib_ROIAlign", [N(2, 3, 8, 8), ("v", _ROIS)],
     dict(pooled_size=(2, 2))),
    ("ROIAlign_aligned_scaled", "_contrib_ROIAlign",
     [N(2, 2, 6, 7), ("v", _ROIS)],
     dict(pooled_size=(3, 2), spatial_scale=0.5, sample_ratio=3,
          aligned=True)),
    ("ROIPooling", "ROIPooling", [N(2, 3, 8, 8), ("v", _ROIS)],
     dict(pooled_size=(2, 3))),
    ("ROIPooling_relu_ties", "ROIPooling", [Z(2, 3, 8, 8), ("v", _ROIS)],
     dict(pooled_size=(3, 2), spatial_scale=0.8)),
    ("box_nms_per_class", "_contrib_box_nms",
     [("v", box_rows(_RS, 2, 24))], dict(overlap_thresh=0.3, id_index=0)),
    ("box_nms_force_topk", "_contrib_box_nms",
     [("v", box_rows(_RS, 2, 24))],
     dict(overlap_thresh=0.2, id_index=0, force_suppress=True, topk=7,
          valid_thresh=0.4)),
    ("GridGenerator", "GridGenerator", [N(2, 6)], dict(target_shape=(5, 7))),
    ("BilinearSampler", "BilinearSampler",
     [N(2, 3, 6, 5), ("v", _RS.uniform(-1.2, 1.2, (2, 2, 4, 7)))], {}),
    ("MultiBoxPrior", "_contrib_MultiBoxPrior", [N(1, 3, 3, 4)],
     dict(sizes=(0.5, 0.25), ratios=(1.0, 2.0, 0.5))),
    ("MultiBoxPrior_steps_clip", "_contrib_MultiBoxPrior", [N(2, 1, 2, 5)],
     dict(sizes=(0.9,), ratios=(1.0, 3.0), clip=True, steps=(0.4, 0.2),
          offsets=(0.25, 0.5))),
    ("MultiBoxTarget", "_contrib_MultiBoxTarget",
     [("v", _ANCHORS), ("v", det_labels(_RS, 2, 3, 2)), N(2, 5, _A)],
     dict(overlap_threshold=0.4)),
    ("MultiBoxDetection", "_contrib_MultiBoxDetection",
     [("v", _softmaxed(_RS, (2, 5, _A), 1)),
      ("v", _RS.standard_normal((2, _A * 4)) * 0.2), ("v", _ANCHORS)],
     dict(nms_threshold=0.45, threshold=0.3)),
    ("MultiBoxDetection_topk_force", "_contrib_MultiBoxDetection",
     [("v", _softmaxed(_RS, (1, 3, _A), 1)),
      ("v", _RS.standard_normal((1, _A * 4)) * 0.2), ("v", _ANCHORS)],
     dict(nms_threshold=0.3, nms_topk=10, force_suppress=True)),
    ("fft", "fft", [N(3, 16)], {}),
    ("ifft", "ifft", [N(2, 3, 32)], {}),
    ("Proposal", "_contrib_Proposal",
     [("v", _softmaxed(_RS, (1, 12, 5, 6), 1)),
      ("v", _RS.standard_normal((1, 24, 5, 6)) * 0.1),
      ("v", [[80, 96, 1.0]])],
     dict(scales=(2, 4), ratios=(0.5, 1, 2), rpn_pre_nms_top_n=60,
          rpn_post_nms_top_n=20, rpn_min_size=4, threshold=0.6)),
    ("DeformableConvolution_groups", "_contrib_DeformableConvolution",
     [N(2, 4, 7, 6), N(2, 36, 7, 6), N(5, 4, 3, 3), N(5)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=5, num_deformable_group=2)),
    ("DeformableConvolution_stride_dilate", "_contrib_DeformableConvolution",
     [N(1, 3, 9, 8), N(1, 8, 4, 3), N(2, 3, 2, 2)],
     dict(kernel=(2, 2), stride=(2, 2), dilate=(2, 2), num_filter=2,
          no_bias=True)),
    ("Correlation", "Correlation", [N(1, 3, 8, 9), N(1, 3, 8, 9)],
     dict(max_displacement=2, pad_size=2, kernel_size=3)),
    ("Correlation_abs_strided", "Correlation", [N(2, 2, 8, 9), N(2, 2, 8, 9)],
     dict(max_displacement=2, stride2=2, pad_size=1, kernel_size=2,
          stride1=2, is_multiply=False)),
]
