"""The cases of the op-corpus tests (``tests/test_torch_extended_ops.py``,
``tests/test_torch_optimizer_ops.py``, ``tests/test_torch_samplers.py``):
every op that the port's ``ops/extended.py``, ``ops/optimizer_ops.py``
and ``ops/samplers.py`` register, at small shapes made from a seed with
numpy.  Kept apart from the tests (which import the JAX package) so that
``chip_smoke.py`` runs the same cases on the card against the CPU.

``conformance_case(name, fn)`` rebuilds, without JAX, the inputs that
``tests/test_op_conformance.py``'s ``build_inputs`` gives the op (the
same seeds, shapes and special inputs); ``EXTRA`` adds the cases that
pin the trouble spots (signs, ties, zeros, NaN, the static sizes).

Each op has one comparison class (``CLASS``): ``exact`` (integer, bool,
index and shape ops, and selections), ``elementwise`` (float
elementwise ops, within 1e-6 relative and 1e-7 absolute in f32),
``reduction`` (reductions, contractions, scans, LRN, norms and LAMB,
within 1e-5) or ``draw`` (random draws: shapes and dtypes only).
``port`` runs a case through the port's registered function on a
device, ``check_case_on_card`` holds the card's run to the CPU's.
"""
import inspect

import numpy as onp
import torch

TOLS = {"elementwise": dict(rtol=1e-6, atol=1e-7),
        "reduction": dict(rtol=1e-5, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# input specs (the conformance sweep's factories, in numpy)
# --------------------------------------------------------------------------- #

def F(*shape):
    """Positive floats: ``rand + 0.1`` (seed 0)."""
    return ("F", shape)


def FN(*shape):
    """Standard normals (seed 1)."""
    return ("FN", shape)


def I(*shape, lo=0, hi=3):  # noqa: E741
    """int32 in [lo, hi) (seed 2)."""
    return ("I", shape, lo, hi)


def B(*shape):
    return ("B", shape)


def U(*shape, lo=0.05, hi=0.85):
    return ("U", shape, lo, hi)


def SORTED(n):
    return ("S", n)


def Z(*shape):
    return ("Z", shape)


def V(value, dtype="float32"):
    """A fixed value."""
    return ("V", value, dtype)


def N(seed, *shape, scale=1.0):
    """Normals of their own seed (distinct inputs of a binary op)."""
    return ("N", seed, shape, scale)


def make(spec):
    kind = spec[0]
    if kind == "neg":
        return -make(spec[1])
    if kind == "abs":
        return onp.abs(make(spec[1]))
    if kind == "F":
        return (onp.random.RandomState(0).rand(*spec[1]) + 0.1).astype(
            onp.float32)
    if kind == "FN":
        return onp.random.RandomState(1).randn(*spec[1]).astype(onp.float32)
    if kind == "I":
        _, shape, lo, hi = spec
        return onp.random.RandomState(2).randint(lo, hi, shape).astype(
            onp.int32)
    if kind == "B":
        return onp.random.RandomState(3).rand(*spec[1]) > 0.5
    if kind == "U":
        _, shape, lo, hi = spec
        return onp.random.RandomState(7).uniform(lo, hi, shape).astype(
            onp.float32)
    if kind == "S":
        return onp.linspace(0.0, 1.0, spec[1]).astype(onp.float32)
    if kind == "Z":
        return onp.zeros(spec[1], onp.float32)
    if kind == "V":
        return onp.asarray(spec[1], dtype=spec[2])
    if kind == "N":
        _, seed, shape, scale = spec
        return (onp.random.RandomState(seed).standard_normal(shape)
                * scale).astype(onp.float32)
    raise ValueError(kind)


KWARG_DEFAULTS = {"lr": 0.05, "axis": 0, "shift": 1, "q": 0.5,
                  "dtype": "float32", "max_norm": 1.0,
                  "indices_or_sections": 2}

_RATE = V([0.05])
_DECAY = V([0.0])

SPECIALS = {
    "LRN": ([F(1, 3, 8, 8)], {}),
    "SpatialTransformer": ([F(1, 3, 8, 8), V([[1, 0, 0, 0, 1, 0]])],
                           dict(target_shape=(8, 8))),
    "log1mexp": ([("neg", F(4, 5))], {}),
    "batch_take": ([F(4, 5), I(4, hi=5)], {}),
    "_contrib_index_add": ([F(4, 5), I(2, hi=4), F(2, 5)], {}),
    "_contrib_index_copy": ([F(4, 5), I(2, hi=4), F(2, 5)], {}),
    "bincount_op": ([I(10, hi=5)], dict(length=5)),
    "searchsorted": ([SORTED(5), F(3)], {}),
    "unravel_index": ([I(4, hi=19)], dict(shape=(4, 5))),
    "ravel_multi_index": ([I(2, 3, hi=3)], dict(shape=(4, 5))),
    "interp_op": ([F(4), SORTED(5), FN(5)], {}),
    "dsplit": ([F(4, 4, 4)], dict(indices_or_sections=2)),
    "hsplit": ([F(4, 4)], dict(indices_or_sections=2)),
    "moveaxis": ([F(4, 5)], dict(source=0, destination=1)),
    "resize_op": ([F(4, 5)], dict(new_shape=(2, 10))),
    "bitwise_and": ([I(4, 5, hi=7), I(4, 5, hi=7)], {}),
    "bitwise_or": ([I(4, 5, hi=7), I(4, 5, hi=7)], {}),
    "bitwise_xor": ([I(4, 5, hi=7), I(4, 5, hi=7)], {}),
    "bitwise_not": ([I(4, 5, hi=7)], {}),
    "left_shift": ([I(4, 5, hi=7), I(4, 5, hi=2)], {}),
    "right_shift": ([I(4, 5, hi=7), I(4, 5, hi=2)], {}),
    "gcd": ([I(4, 5, lo=1, hi=30), I(4, 5, lo=1, hi=30)], {}),
    "lcm": ([I(4, 5, lo=1, hi=12), I(4, 5, lo=1, hi=12)], {}),
    "ldexp": ([F(4, 5), I(4, 5, hi=4)], {}),
    "cross_op": ([F(4, 3), F(4, 3)], {}),
    "rmspropalex_update": ([F(4, 5), FN(4, 5), Z(4, 5), Z(4, 5), Z(4, 5)],
                           dict(lr=0.05)),
    "sample_negative_binomial": ([F(3), U(3)], {}),
    "sample_generalized_negative_binomial": ([F(3), F(3)], {}),
    "dstack": ([F(4, 5), F(4, 5)], {}),
    "meshgrid": ([F(4), F(5)], {}),
    "broadcast_arrays": ([F(4, 1), F(1, 5)], {}),
    "reset_arrays": ([F(4, 5), F(4, 5)], {}),
    "clip_global_norm": ([FN(4, 5), FN(3)], dict(max_norm=1.0)),
    "multi_sgd_update": ([F(4, 5), FN(4, 5), F(3), FN(3)],
                         dict(lrs=(0.05, 0.05), wds=(0.0, 0.0))),
    "multi_sgd_mom_update": ([F(4, 5), FN(4, 5), FN(4, 5)],
                             dict(lrs=(0.05,), wds=(0.0,))),
    "multi_mp_sgd_update": ([F(4, 5), FN(4, 5), F(4, 5)],
                            dict(lrs=(0.05,), wds=(0.0,))),
    "multi_mp_sgd_mom_update": ([F(4, 5), FN(4, 5), FN(4, 5), F(4, 5)],
                                dict(lrs=(0.05,), wds=(0.0,))),
    "multi_adamw_update": ([F(4, 5), FN(4, 5), FN(4, 5), F(4, 5)],
                           dict(lrs=(0.05,), etas=(1.0,))),
    "multi_lamb_update": ([F(4, 5), FN(4, 5), FN(4, 5), F(4, 5)],
                          dict(learning_rates=(0.05,))),
    "preloaded_multi_sgd_update": ([F(4, 5), FN(4, 5), _RATE, _DECAY], {}),
    "preloaded_multi_sgd_mom_update": ([F(4, 5), FN(4, 5), FN(4, 5), _RATE,
                                        _DECAY], {}),
}


def conformance_case(name, fn, variadic):
    """The conformance sweep's inputs for op ``name`` (``fn`` its
    implementation, whose signature is the reference's)."""
    if name in SPECIALS:
        specs, kw = SPECIALS[name]
        return list(specs), dict(kw)
    if variadic:
        return [F(4, 5), F(4, 5)], {}
    specs, kw = [], {}
    for p in inspect.signature(fn).parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is inspect.Parameter.empty:
                specs.append(F(4, 5))
        elif p.kind == p.KEYWORD_ONLY and \
                p.default is inspect.Parameter.empty:
            kw[p.name] = KWARG_DEFAULTS[p.name]
    return specs, kw


# --------------------------------------------------------------------------- #
# the trouble spots (id, op, input specs, kwargs)
# --------------------------------------------------------------------------- #

_A, _Bb = N(11, 4, 5, scale=3.0), N(12, 4, 5, scale=2.0)
_NAN = V([[1.0, float("nan"), 3.0, -2.0], [float("nan")] * 4,
          [0.5, 2.5, -1.0, 4.0]])
_INTS = V([[-7, 7, -8, 9], [5, -5, 0, 12]], "int32")
_DIVS = V([[2, -2, 3, -4], [-3, 3, 7, 5]], "int32")

EXTRA = [
    # statistics: even counts (median averages the middle pair), axes,
    # keepdims, every quantile method, a NaN slice
    ("median_even", "median", [N(21, 4, 6)], dict(axis=1)),
    ("median_flat_even", "median", [N(22, 10)], {}),
    ("median_keepdims", "median", [N(23, 3, 4, 5)],
     dict(axis=(0, 2), keepdims=True)),
    ("median_nan", "median", [_NAN], dict(axis=1)),
    ("quantile_list", "quantile", [N(24, 5, 7)],
     dict(q=[0.1, 0.5, 0.9], axis=1)),
    ("quantile_keepdims", "quantile", [N(25, 3, 4, 5)],
     dict(q=[0.3, 0.7], axis=(1, 2), keepdims=True)),
    ("quantile_flat_keepdims", "quantile", [N(26, 3, 4)],
     dict(q=0.25, keepdims=True)),
    ("percentile_list", "percentile", [N(27, 6, 5)],
     dict(q=[10.0, 50.0, 95.0], axis=0)),
] + [(f"quantile_{m}", "quantile", [N(28, 4, 9)],
      dict(q=[0.15, 0.5, 0.66], axis=1, interpolation=m))
     for m in ("linear", "lower", "higher", "midpoint", "nearest")] + [
    ("var_ddof", "var", [N(29, 4, 6)], dict(axis=1, ddof=1)),
    ("std_keepdims", "std", [N(30, 4, 6)], dict(axis=0, keepdims=True)),
    ("nanvar_nan_row", "nanvar", [_NAN], dict(axis=1, ddof=1)),
    ("nanstd_nan_row", "nanstd", [_NAN], dict(axis=1)),
    ("nanmean_nan_row", "nanmean", [_NAN], dict(axis=1)),
    ("nanmax_nan_row", "nanmax", [_NAN], dict(axis=1)),
    ("nanmin_nan_row", "nanmin", [_NAN], dict(axis=1)),
    ("nanargmax_nan_row", "nanargmax", [_NAN], dict(axis=1)),
    ("nanargmin_flat", "nanargmin", [_NAN], {}),
    ("average_weights", "average", [N(31, 4, 5), F(5)], dict(axis=1)),
    ("moments_axes", "moments", [N(32, 3, 4, 5)], dict(axes=(0, 2))),
    ("moments_keepdims", "moments", [N(33, 3, 4)],
     dict(axes=(1,), keepdims=True)),
    ("count_nonzero_axis", "count_nonzero", [I(4, 5, hi=3)], dict(axis=1)),
    ("ptp_axis", "ptp", [N(34, 4, 5)], dict(axis=1)),
    ("histogram_default", "histogram_op", [U(50, lo=-0.2, hi=1.2)], {}),
    ("histogram_range", "histogram_op", [N(35, 200)],
     dict(bin_cnt=7, range=(-2.0, 1.5))),
    # static sizes
    ("unique_padded", "unique_op", [V([3.0, 1.0, 3.0, 2.0, 1.0])],
     dict(size=7, fill_value=-1)),
    ("unique_cut", "unique_op", [I(20, hi=9)], dict(size=4)),
    ("bincount_weights", "bincount_op",
     [V([0, 1, 1, 3, 7, -2], "int32"), V([0.5, 1.0, 2.0, 4.0, 8.0, 16.0])],
     dict(length=4)),
    ("bincount_minlength", "bincount_op", [I(12, hi=6)],
     dict(minlength=8)),
    # masked softmax: a fully masked row
    ("masked_softmax_full_row", "masked_softmax",
     [N(36, 3, 5), V([[1, 0, 1, 1, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]])],
     dict(temperature=0.7)),
    ("masked_log_softmax_full_row", "masked_log_softmax",
     [N(37, 3, 5), V([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]])],
     {}),
    ("masked_softmax_axis0", "masked_softmax", [N(38, 4, 3), B(4, 3)],
     dict(axis=0)),
    ("alias_softmax_cross_entropy_mask", "softmax_cross_entropy_mask",
     [N(39, 2, 4), V([[1, 1, 0, 1], [1, 0, 1, 1]])], {}),
    ("LRN_n3", "LRN", [N(40, 2, 6, 3, 3)],
     dict(alpha=1e-3, beta=0.75, knorm=2.0, nsize=3)),
    # integer ops and their signs
    ("gcd_signs", "gcd", [_INTS, _DIVS], {}),
    ("lcm_signs", "lcm", [_INTS, _DIVS], {}),
    ("left_shift_wide", "left_shift", [_INTS, V([[0, 1, 31, 32],
                                                 [33, 2, 5, 40]], "int32")],
     {}),
    ("right_shift_wide", "right_shift",
     [_INTS, V([[0, 1, 31, 32], [33, 2, 5, 40]], "int32")], {}),
    ("floor_divide_int", "floor_divide", [_INTS, _DIVS], {}),
    ("remainder_int", "remainder", [_INTS, _DIVS], {}),
    ("fmod_int", "fmod", [_INTS, _DIVS], {}),
    ("floor_divide_signs", "floor_divide", [_A, _Bb], {}),
    ("remainder_signs", "remainder", [_A, _Bb], {}),
    ("fmod_signs", "fmod", [_A, _Bb], {}),
    ("nextafter_signs", "nextafter",
     [V([0.0, 0.0, 1.0, -1.0, 3.5]), V([1.0, -1.0, 2.0, -2.0, 3.5])], {}),
    ("copysign_signs", "copysign", [_A, _Bb], {}),
    ("heaviside_zero", "heaviside", [V([-1.5, 0.0, 2.0, 0.0]),
                                V([0.5, 0.5, 0.5, 1.0])], {}),
    ("hypot_signs", "hypot", [_A, _Bb], {}),
    ("logaddexp_signs", "logaddexp", [_A, _Bb], {}),
    ("squared_difference_signs", "squared_difference", [_A, _Bb], {}),
    ("digamma_poles", "digamma", [V([0.0, -1.0, -2.0, -2.5, 0.5, 3.0])],
     {}),
    ("digamma_negative", "digamma", [V([-2.5, -0.3, 0.7, 4.2, 11.0])], {}),
    ("relu6_ties", "relu6", [V([-1.0, 0.0, 3.0, 6.0, 7.0])], {}),
    ("hard_swish_ties", "hard_swish", [V([-4.0, -3.0, 0.0, 3.0, 4.0])], {}),
    ("ldexp_float", "ldexp", [_A, V([[1.0, -2.0, 3.0, 0.0, 0.5]] * 4)], {}),
    ("nan_to_num_values", "nan_to_num",
     [V([float("nan"), float("inf"), -float("inf"), 1.0])],
     dict(nan=2.0, posinf=9.0)),
    # scans and the gradient of a cumulative product through zeros
    ("cumprod_zeros", "cumprod", [V([[1.5, 0.0, 2.0, -3.0],
                                     [0.0, 0.0, 4.0, 0.5]])], dict(axis=1)),
    ("cumsum_flat", "cumsum", [N(41, 3, 4)], {}),
    ("cumsum_int", "cumsum", [I(3, 4, hi=9)], dict(axis=0)),
    ("logsumexp_axis", "logsumexp", [N(42, 3, 4, 5)],
     dict(axis=(0, 2), keepdims=True)),
    # written out as the reference defines them
    ("interp_outside", "interp_op",
     [V([-1.0, 0.0, 0.25, 1.0, 2.5, 4.0]), V([0.0, 1.0, 1.0, 3.0]),
      V([1.0, 2.0, 5.0, -1.0])], dict(left=-7.0, right=9.0)),
    ("trapz_x", "trapz_op", [N(43, 3, 6), V([0.0, 0.5, 1.5, 2.0, 3.5, 4.0])],
     {}),
    ("trapz_axis", "trapz_op", [N(44, 5, 3)], dict(dx=0.25, axis=0)),
    ("polyval_coeffs", "polyval_op", [V([2.0, -1.0, 0.5, 3.0]), N(45, 3, 4)], {}),
    ("resize_cyclic", "resize_op", [V([[1.0, 2.0, 3.0]])],
     dict(new_shape=(3, 4))),
    ("resize_shrink", "resize_op", [N(46, 3, 5)], dict(new_shape=(2, 2))),
    ("khatri_rao3", "khatri_rao", [N(47, 2, 3), N(48, 4, 3), N(49, 2, 3)],
     {}),
    ("cross_axis", "cross_op", [N(50, 3, 4), N(51, 3, 4)], dict(axis=0)),
    ("cross_2d", "cross_op", [N(52, 4, 2), N(53, 4, 2)], {}),
    ("tensordot_axes", "tensordot", [N(54, 3, 4, 5), N(55, 5, 4, 2)],
     dict(axes=([1, 2], [1, 0]))),
    ("trace_offset", "trace", [N(56, 4, 5, 3)],
     dict(offset=1, axis1=0, axis2=1)),
    ("tril_k", "tril", [N(57, 2, 4, 4)], dict(k=-1)),
    ("unravel_oob", "unravel_index", [V([-3, -1, 0, 7, 19, 20, 45], "int32")],
     dict(shape=(4, 5))),
    ("ravel3", "ravel_multi_index", [V([[1, 0, 2], [3, 1, 0], [2, 4, 1]],
                                       "int32")], dict(shape=(2, 4, 5))),
    ("index_array_axes", "index_array", [F(2, 3, 4)], dict(axes=(2, 0))),
    ("arange_like_repeat", "arange_like", [F(2, 5)],
     dict(start=1.5, step=0.5, repeat=3)),
    ("arange_like_axis", "arange_like", [F(2, 5)], dict(axis=1, step=2.0)),
    ("searchsorted_right", "searchsorted",
     [V([0.0, 1.0, 1.0, 2.0]), V([1.0, -1.0, 3.0, 1.5])], dict(side="right")),
    ("batch_take_neg", "batch_take", [N(58, 3, 4), V([-1, 0, 3], "int32")],
     {}),
    ("rollaxis_start", "rollaxis", [N(59, 2, 3, 4)], dict(axis=2, start=0)),
    ("rot90_k", "rot90", [N(60, 3, 4)], dict(k=3, axes=(1, 0))),
    ("roll_axes", "roll", [N(61, 3, 4)], dict(shift=(1, -2), axis=(0, 1))),
    ("allclose_far", "allclose_op", [_A, _Bb], {}),
    ("allclose_nan", "allclose_op", [_NAN, _NAN], dict(equal_nan=True)),
    ("clip_global_norm_small", "clip_global_norm",
     [N(62, 4, scale=0.01), N(63, 3, scale=0.01)], dict(max_norm=5.0)),
    ("clip_global_norm_scale", "clip_global_norm",
     [N(64, 3, 4), N(65, 5)], dict(max_norm=0.5, scale=2.0)),
    ("spatial_transformer_zoom", "SpatialTransformer",
     [N(66, 2, 3, 8, 8), V([[0.5, 0.1, 0.0, -0.1, 0.5, 0.2],
                            [1.0, 0.0, 0.3, 0.0, 0.8, 0.0]])],
     dict(target_shape=(4, 6))),
    # the sampler module's deterministic ops
    ("gradientmultiplier_negative", "_contrib_gradientmultiplier",
     [N(67, 3, 4)], dict(scalar=-2.0)),
    ("quadratic_coeffs", "quadratic", [N(68, 3, 4)], dict(a=1.5, b=-2.0, c=0.5)),
    ("div_sqrt_dim_3d", "_contrib_div_sqrt_dim", [N(69, 2, 3, 16)], {}),
    ("index_add_dup", "_contrib_index_add",
     [N(70, 5, 2), V([1, 3, 1], "int32"), N(71, 3, 2)], {}),
    ("quantized_act", "quantized_act_int8",
     [V([-100, -5, 0, 50, 127], "int8"), V(-1.0), V(1.0)], {}),
    ("quantized_act_skew", "quantized_act_int8",
     [V([-128, -90, -60, 0, 90], "int8"), V(-0.4), V(2.0)], {}),
    ("quantized_pool_avg", "quantized_pooling_int8",
     [V(onp.arange(-64, 64).reshape(2, 1, 8, 8) % 53 - 20, "int8"), V(-1.0),
      V(1.0)], dict(kernel=(2, 2), pool_type="avg")),
    ("multi_adamw_clip", "multi_adamw_update",
     [N(72, 4, 5), N(73, 4, 5, scale=4.0), N(74, 4, 5, scale=0.1),
      ("abs", N(75, 4, 5, scale=0.1)), N(76, 3), N(77, 3, scale=4.0),
      N(78, 3, scale=0.1), ("abs", N(79, 3, scale=0.1))],
     dict(lrs=[0.01, 0.02], etas=[1.0, 0.5], wds=[0.0, 0.1],
          rescale_grad=0.5, clip_gradient=1.0, step_count=3)),
    ("multi_lamb_bounds", "multi_lamb_update",
     [N(80, 4, 5), N(81, 4, 5), N(82, 4, 5, scale=0.1),
      ("abs", N(83, 4, 5, scale=0.1)), N(84, 6), N(85, 6),
      Z(6), Z(6)],
     dict(learning_rates=[0.01, 0.02], wds=[0.01, 0.0], step_count=4,
          lower_bound=0.5, upper_bound=2.0, clip_gradient=0.5)),
    ("multi_lamb_zero_weight", "multi_lamb_update",
     [Z(4, 5), N(86, 4, 5), Z(4, 5), Z(4, 5)],
     dict(learning_rates=0.01, bias_correction=False)),
    ("preloaded_sgd_two", "preloaded_multi_sgd_update",
     [N(87, 4, 5), N(88, 4, 5), N(89, 3), N(90, 3), V([0.1, 0.05]),
      V([0.0, 0.01])], dict(rescale_grad=2.0, clip_gradient=0.5)),
    ("preloaded_sgd_mom_two", "preloaded_multi_sgd_mom_update",
     [N(91, 4, 5), N(92, 4, 5), N(93, 4, 5), N(94, 3), N(95, 3), N(96, 3),
      V([0.1, 0.05]), V([0.0, 0.01])], dict(momentum=0.8)),
]


# forward only: the gradient at a pole is undefined, and jax's gradient of
# the norm of a zero vector is NaN where torch's is 0
NO_GRAD = {"digamma_poles", "multi_lamb_zero_weight"}


def make_inputs(specs):
    return [make(s) for s in specs]


# --------------------------------------------------------------------------- #
# comparison classes
# --------------------------------------------------------------------------- #

_EXACT = {
    "allclose_op", "arange_like", "atleast_1d", "atleast_2d", "atleast_3d",
    "batch_take", "bincount_op", "bitwise_and", "bitwise_not",
    "bitwise_or", "bitwise_xor", "broadcast_arrays", "column_stack",
    "copysign", "count_nonzero", "dsplit", "dstack", "fliplr", "flipud",
    "gcd", "heaviside", "hsplit", "hstack", "index_array", "isfinite",
    "isinf", "isnan", "isneginf", "isposinf", "lcm", "left_shift",
    "meshgrid", "moveaxis", "nan_to_num", "nanargmax", "nanargmin",
    "nanmax", "nanmin", "nextafter", "ravel_multi_index", "relu6",
    "reset_arrays", "resize_op", "right_shift", "roll", "rollaxis",
    "rot90", "searchsorted", "tril", "triu", "unique_op", "unravel_index",
    "vsplit", "vstack", "_contrib_index_copy", "_contrib_gradientmultiplier",
    "IdentityAttachKLSparseReg", "quantized_act_int8",
    "quantized_pooling_int8",
}
_REDUCTION = {
    "SpatialTransformer", "LRN", "average", "clip_global_norm", "cumprod",
    "cumsum", "inner_op", "logsumexp", "masked_log_softmax",
    "masked_softmax", "median", "moments", "nanmean", "nanstd", "nanvar",
    "percentile", "quantile", "std", "tensordot", "trace", "trapz_op",
    "var", "vdot_op", "multi_lamb_update",
}
DRAWS = {
    "_random_uniform", "_random_normal", "_random_gamma",
    "_random_exponential", "_random_poisson", "_random_negative_binomial",
    "_random_generalized_negative_binomial", "_random_randint",
    "sample_uniform", "sample_normal", "sample_gamma", "sample_exponential",
    "sample_poisson", "sample_negative_binomial",
    "sample_generalized_negative_binomial", "sample_multinomial",
}


def op_class(name):
    if name in DRAWS:
        return "draw"
    if name in _EXACT:
        return "exact"
    if name in _REDUCTION:
        return "reduction"
    return "elementwise"


def module_cases(names, ops):
    """(id, op, specs, kwargs) for every op of ``names``: its
    conformance case, then the ``EXTRA`` cases of those ops (``ops`` is
    the port's registry, for the signatures)."""
    cases = []
    for name in names:
        o = ops[name]
        specs, kw = conformance_case(name, o.fn, o.variadic)
        cases.append((name, name, specs, kw))
    cases += [c for c in EXTRA if _target(c[1]) in set(names)]
    return cases


def _target(name):
    from mxnet_tpu_torch.ops.registry import get_op
    return get_op(name).name


# --------------------------------------------------------------------------- #
# running a case through the port, comparing two runs
# --------------------------------------------------------------------------- #

def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _float_inputs(arrays):
    return [i for i, a in enumerate(arrays) if a.dtype == onp.float32]


def heads_for(shapes, seed):
    rs = onp.random.RandomState(seed)
    return [onp.asarray(rs.standard_normal(tuple(s)), onp.float32)
            for s in shapes]


def port(name, arrays, kwargs, grad_seed=None, device="cpu"):
    """(outputs, input gradients) of the port's registered op, its
    inputs on ``device`` (the draws of a no-input op too)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.registry import get_op

    o = get_op(name)
    ts = [torch.from_numpy(onp.array(a)).to(device) for a in arrays]
    fidx = _float_inputs(arrays) if grad_seed is not None and \
        o.differentiable else []
    for i in fidx:
        ts[i].requires_grad_(True)
    ctx = mx.cpu() if device == "cpu" else mx.gpu(0)
    with ctx, torch.enable_grad():
        outs = _outs(o.fn(*ts, **kwargs))
    grads = []
    if fidx:
        heads = heads_for([t.shape for t in outs], grad_seed)
        terms = [(r * torch.from_numpy(h).to(r.device)).sum()
                 for r, h in zip(outs, heads)
                 if r.is_floating_point() and r.requires_grad]
        if terms:
            got = torch.autograd.grad(sum(terms), [ts[i] for i in fidx],
                                      allow_unused=True)
            grads = [onp.zeros(a.shape, onp.float32) if g is None
                     else g.cpu().numpy()
                     for g, a in zip(got, [arrays[i] for i in fidx])]
        else:
            grads = [onp.zeros(arrays[i].shape, onp.float32) for i in fidx]
    return [r.detach().cpu().numpy() for r in outs], grads


def assert_same(name, got, want, cls=None):
    """The port's outputs ``got`` against ``want`` (dtype, shape, then
    values by the op's class); ``digamma``'s non-finite positions are
    compared as sets (jax gives nan at 0, torch -inf)."""
    cls = cls or op_class(name)
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (name, g.dtype, g.shape, w.dtype, w.shape)
        if cls == "draw":
            continue
        if name == "digamma":
            bad = ~onp.isfinite(w)
            assert (bad == ~onp.isfinite(g)).all()
            g, w = g[~bad], w[~bad]
        if cls == "exact":
            onp.testing.assert_array_equal(g, w)
        else:
            onp.testing.assert_allclose(g, w, **TOLS[cls])


def check_case_on_card(case):
    """One case, the port on the card against the port on the CPU
    (within 1e-5; the draws by shape and dtype)."""
    cid, name, specs, kwargs = case
    arrays = make_inputs(specs)
    seed = None if cid in NO_GRAD else sum(map(ord, cid))
    c_out, c_grad = port(name, arrays, kwargs, seed)
    g_out, g_grad = port(name, arrays, kwargs, seed, device="cuda")
    cls = op_class(name)
    assert_same(name, g_out, c_out,
                cls if cls in ("draw", "exact") else "reduction")
    for g, w in zip(g_grad, c_grad):
        onp.testing.assert_allclose(g, w, **GRAD_TOL)
