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
    raise ValueError(kind)


def N(*shape):
    return ("n", shape)


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
