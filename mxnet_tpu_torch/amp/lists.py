"""AMP cast-policy lists, copied from ``mxnet_tpu/amp/lists.py`` as they
stand (reference ``python/mxnet/contrib/amp/lists/symbol_fp16.py``:
"FP16_FUNCS/FP32_FUNCS/CONDITIONAL lists insert amp_cast/amp_multicast").

The low-precision target defaults to bfloat16 (f32's exponent range, so
loss scaling is optional); ``float16`` needs the loss scaler.
"""

# compute-bound ops that run in low precision (MXU-shaped matmuls/convs)
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution",
    "dot", "batch_dot", "matmul", "linalg_gemm2",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "flash_attention", "fused_rnn",
]

# numerically-sensitive ops pinned to fp32
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxOutput",
    "SoftmaxActivation", "CTCLoss", "MakeLoss",
    "LayerNorm", "InstanceNorm", "GroupNorm", "RMSNorm", "_BatchNormStats",
    "L2Normalization", "norm",
    "exp", "expm1", "log", "log1p", "log2", "log10",
    "erf", "erfinv", "gamma", "gammaln",
    "mean", "sum", "nansum", "prod", "nanprod", "smooth_l1",
]

# elementwise combiners: cast every input to the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "broadcast_hypot", "add_n", "concat", "stack", "where",
]
