"""Every op of ``mxnet_tpu_torch/ops/defs.py`` against the same op of
``mxnet_tpu/ops/defs.py``, on the same seeded numpy inputs (f32 on the
CPU), through each package's ``nd`` wrappers.

Tolerances: outputs within 1e-5 (relative and absolute); for the
differentiable ops, the input gradients under ``autograd.record()`` /
``backward()`` with the same random head gradients within 1e-5 of the
reference's tape.  The two packages sum and round in other orders, so
equality is not asked of float results.
"""
import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu.ops.defs as rdefs
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.ops.defs as pdefs
from mxnet_tpu_torch.ops.registry import OPS

TOL = dict(rtol=1e-5, atol=1e-5)


def _input(rs, spec):
    kind, *rest = spec
    if kind == "n":                     # standard normal
        return rs.standard_normal(rest[0]).astype(onp.float32)
    if kind == "p":                     # positive, away from 0
        return rs.uniform(0.5, 2.0, rest[0]).astype(onp.float32)
    if kind == "u":                     # inside (-1, 1)
        return rs.uniform(-0.9, 0.9, rest[0]).astype(onp.float32)
    if kind == "g":                     # above 1
        return rs.uniform(1.5, 3.0, rest[0]).astype(onp.float32)
    if kind == "b":                     # 0/1 floats
        return rs.randint(0, 2, rest[0]).astype(onp.float32)
    if kind == "k":                     # small integers as floats
        return rs.randint(0, 3, rest[0]).astype(onp.float32)
    if kind == "i":                     # int32 in [lo, hi)
        shape, lo, hi = rest
        return rs.randint(lo, hi, shape).astype(onp.int32)
    if kind == "v":                     # a fixed value
        return onp.asarray(rest[0])
    if kind == "nan":                   # normal with one NaN
        a = rs.standard_normal(rest[0]).astype(onp.float32)
        a.flat[1] = onp.nan
        return a
    if kind == "spd":                   # symmetric positive definite
        m = rs.standard_normal((rest[0], rest[0])).astype(onp.float32)
        return (m @ m.T + rest[0] * onp.eye(rest[0])).astype(onp.float32)
    if kind == "tri":                   # well-conditioned lower triangle
        m = onp.tril(rs.uniform(-0.5, 0.5, (rest[0], rest[0])))
        return (m + 2 * onp.eye(rest[0])).astype(onp.float32)
    raise ValueError(kind)


S = (3, 4)
# (id, op name, input specs, static kwargs)
CASES = [(n, n, [("n", S)], {}) for n in (
    "abs", "sign", "ceil", "floor", "trunc", "fix", "square", "exp",
    "expm1", "sin", "cos", "sinh", "cosh", "tanh", "arcsinh", "arctan",
    "degrees", "radians", "negative", "erf", "sigmoid", "softsign", "relu",
    "identity", "softrelu", "BlockGrad", "shape_array", "size_array",
    "zeros_like", "ones_like", "flatten", "all_finite", "argmax_channel")]
CASES += [(n, n, [("p", S)], {}) for n in (
    "sqrt", "cbrt", "log", "log10", "log2", "log1p", "reciprocal", "rsqrt",
    "rcbrt", "gamma", "gammaln")]
CASES += [(n, n, [("u", S)], {}) for n in (
    "arcsin", "arccos", "arctanh", "erfinv", "tan")]
HALVES = [[0.2, 1.7, -2.6, 3.4], [-0.4, 2.5, 1.5, -1.5]]
CASES += [
    ("round", "round", [("v", HALVES)], {}),
    ("rint", "rint", [("v", HALVES)], {}),
    ("arccosh", "arccosh", [("g", S)], {}),
    ("logical_not", "logical_not", [("b", S)], {}),
    ("cast", "cast", [("n", S)], dict(dtype="int32")),
    ("cast_f16", "cast", [("n", S)], dict(dtype="float16")),
    ("smooth_l1", "smooth_l1", [("n", S)], dict(scalar=2.0)),
]
for n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
          "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
          "arctan2"):
    CASES.append((n, n, [("n", (3, 1, 4)), ("n", (2, 4))], {}))
CASES += [
    ("broadcast_div", "broadcast_div", [("n", (3, 4)), ("p", (4,))], {}),
    ("broadcast_mod", "broadcast_mod", [("n", (3, 4)), ("p", (3, 1))], {}),
    ("broadcast_power", "broadcast_power", [("p", (3, 4)), ("n", (4,))], {}),
]
for n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
          "broadcast_greater_equal", "broadcast_lesser",
          "broadcast_lesser_equal", "broadcast_logical_and",
          "broadcast_logical_or", "broadcast_logical_xor"):
    CASES.append((n, n, [("k", (3, 4)), ("k", (4,))], {}))
CASES += [
    ("broadcast_like", "broadcast_like", [("n", (1, 4)), ("n", (3, 4))], {}),
    ("where", "where", [("b", S), ("n", S), ("n", S)], {}),
    ("clip", "clip", [("n", S)], dict(a_min=-0.5, a_max=0.5)),
    ("add_n", "add_n", [("n", S), ("n", S), ("n", S)], {}),
    ("sum", "sum", [("n", (2, 3, 4))], dict(axis=(0, 2))),
    ("sum_exclude", "sum", [("n", (2, 3, 4))],
     dict(axis=1, keepdims=True, exclude=True)),
    ("sum_int", "sum", [("i", (3, 4), -5, 5)], dict(axis=1)),
    ("mean", "mean", [("n", (2, 3, 4))], dict(axis=1, keepdims=True)),
    ("prod", "prod", [("p", (2, 3, 4))], dict(axis=(0, 2))),
    ("nansum", "nansum", [("nan", S)], dict(axis=1)),
    ("nanprod", "nanprod", [("nan", S)], dict(axis=0)),
    ("max", "max", [("n", (2, 3, 4))], dict(axis=1)),
    ("min", "min", [("n", (2, 3, 4))], dict(axis=(0, 1), keepdims=True)),
    ("norm", "norm", [("n", (2, 3, 4))], dict(axis=2)),
    ("norm_l1", "norm", [("n", S)], dict(ord=1)),
    ("argmax", "argmax", [("n", (2, 3, 4))], dict(axis=1)),
    ("argmin", "argmin", [("n", (2, 3, 4))], dict(axis=2, keepdims=True)),
    ("topk", "topk", [("n", (3, 5))], dict(k=2)),
    ("topk_both", "topk", [("n", (3, 5))],
     dict(k=3, ret_typ="both", is_ascend=True)),
    ("topk_mask", "topk", [("n", (3, 5))], dict(axis=0, k=2, ret_typ="mask")),
    ("sort", "sort", [("n", (3, 5))], dict(is_ascend=False)),
    ("argsort", "argsort", [("n", (3, 5))], dict(axis=0)),
    ("dot", "dot", [("n", (3, 4)), ("n", (4, 5))], {}),
    ("dot_t", "dot", [("n", (4, 3)), ("n", (5, 4))],
     dict(transpose_a=True, transpose_b=True)),
    ("dot_3d", "dot", [("n", (2, 3, 4)), ("n", (4, 5))], {}),
    ("batch_dot", "batch_dot", [("n", (2, 4, 3)), ("n", (2, 4, 5))],
     dict(transpose_a=True)),
    ("matmul", "matmul", [("n", (2, 3, 4)), ("n", (4, 5))], {}),
    ("linalg_gemm2", "linalg_gemm2", [("n", (2, 3, 4)), ("n", (2, 5, 4))],
     dict(transpose_b=True, alpha=0.5)),
    ("linalg_syrk", "linalg_syrk", [("n", (3, 4))],
     dict(transpose=True, alpha=2.0)),
    ("linalg_potrf", "linalg_potrf", [("spd", 4)], {}),
    ("linalg_trsm", "linalg_trsm", [("tri", 4), ("n", (4, 3))],
     dict(alpha=2.0)),
    ("linalg_trsm_right", "linalg_trsm", [("tri", 4), ("n", (3, 4))],
     dict(rightside=True, transpose=True)),
    ("L2Normalization", "L2Normalization", [("n", (2, 3, 4))],
     dict(mode="channel")),
    ("reshape", "reshape", [("n", (2, 3, 4))], dict(shape=(0, -1))),
    ("reshape_codes", "reshape", [("n", (2, 3, 4))],
     dict(shape=(-3, -4, 2, -1))),
    ("reshape_like", "reshape_like", [("n", (2, 6)), ("n", (3, 4))], {}),
    ("unique", "unique", [("k", (3, 4))], {}),
    ("_onnx_expand", "_onnx_expand", [("n", (3, 1))], dict(shape=(2, 1, 4))),
    ("transpose", "transpose", [("n", (2, 3, 4))], dict(axes=(1, 2, 0))),
    ("transpose_rev", "transpose", [("n", (2, 3, 4))], {}),
    ("expand_dims", "expand_dims", [("n", S)], dict(axis=1)),
    ("squeeze", "squeeze", [("n", (3, 1, 4))], dict(axis=1)),
    ("broadcast_to", "broadcast_to", [("n", (3, 1))], dict(shape=(0, 4))),
    ("broadcast_axis", "broadcast_axis", [("n", (3, 1, 1))],
     dict(axis=(1, 2), size=(2, 4))),
    ("swapaxes", "swapaxes", [("n", (2, 3, 4))], dict(dim1=0, dim2=2)),
    ("concat", "concat", [("n", (2, 3)), ("n", (2, 4))], dict(dim=1)),
    ("stack", "stack", [("n", S), ("n", S)], dict(axis=1)),
    ("split", "split", [("n", (2, 6))], dict(num_outputs=3)),
    ("split_squeeze", "split", [("n", (3, 4))],
     dict(num_outputs=3, axis=0, squeeze_axis=True)),
    ("slice", "slice", [("n", (4, 5))], dict(begin=(1, 0), end=(3, 5),
                                              step=(1, 2))),
    ("slice_negative_step", "slice", [("n", (4, 5))],
     dict(begin=(3, None), end=(0, None), step=(-1, None))),
    ("slice_axis", "slice_axis", [("n", (4, 5))], dict(axis=1, begin=1,
                                                       end=4)),
    ("slice_like", "slice_like", [("n", (4, 5)), ("n", (2, 3))],
     dict(axes=(1,))),
    ("tile", "tile", [("n", (2, 3))], dict(reps=(2, 1, 2))),
    ("repeat", "repeat", [("n", (2, 3))], dict(repeats=2, axis=1)),
    ("flip", "flip", [("n", (2, 3))], dict(axis=1)),
    ("pad", "pad", [("n", (1, 2, 3, 4))],
     dict(pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5)),
    ("pad_edge", "pad", [("n", (1, 2, 3, 4))],
     dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 2, 2))),
    ("pad_reflect", "pad", [("n", (1, 2, 3, 4))],
     dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 2))),
    ("diag", "diag", [("n", (4, 4))], dict(k=1)),
    ("diag_1d", "diag", [("n", (3,))], dict(k=-1)),
    ("depth_to_space", "depth_to_space", [("n", (1, 8, 2, 3))],
     dict(block_size=2)),
    ("space_to_depth", "space_to_depth", [("n", (1, 2, 4, 6))],
     dict(block_size=2)),
    ("take", "take", [("n", (5, 3)), ("i", (2, 3), -1, 7)], {}),
    ("take_wrap", "take", [("n", (3, 5)), ("i", (4,), -6, 9)],
     dict(axis=1, mode="wrap")),
    ("pick", "pick", [("n", (3, 5)), ("i", (3,), 0, 5)], dict(axis=1)),
    ("gather_nd", "gather_nd", [("n", (3, 4)), ("i", (2, 5), 0, 3)], {}),
    ("scatter_nd", "scatter_nd", [("n", (5,)), ("i", (2, 5), 0, 3)],
     dict(shape=(3, 3))),
    ("one_hot", "one_hot", [("i", (2, 3), -1, 6)],
     dict(depth=5, on_value=2.0, off_value=-1.0)),
    ("boolean_mask", "boolean_mask", [("n", (4, 3)), ("v", [1., 0., 1., 1.])],
     {}),
    ("sequence_mask", "sequence_mask", [("n", (4, 3, 2)),
                                        ("v", [1., 4., 2.])],
     dict(use_sequence_length=True, value=-1.0)),
    ("sequence_mask_axis1", "sequence_mask", [("n", (3, 4, 2)),
                                              ("v", [2., 4., 1.])],
     dict(use_sequence_length=True, axis=1)),
    ("sequence_last", "sequence_last", [("n", (4, 3, 2)),
                                        ("v", [1., 4., 2.])],
     dict(use_sequence_length=True)),
    ("sequence_reverse", "sequence_reverse", [("n", (4, 3, 2)),
                                              ("v", [1., 4., 2.])],
     dict(use_sequence_length=True)),
    ("full_like", "full_like", [("n", S)], dict(fill_value=2.5)),
    ("multi_all_finite", "multi_all_finite", [("n", S), ("nan", S)],
     dict(num_arrays=2)),
    ("amp_cast", "amp_cast", [("n", S)], dict(dtype="float16")),
    ("amp_multicast", "amp_multicast", [("n", S), ("n", S)],
     dict(num_outputs=2)),
]


def _ids():
    return [c[0] for c in CASES]


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _run(pkg, fn, arrays, kwargs, grad, heads):
    """Outputs and input gradients of ``fn`` in package ``pkg``."""
    nds = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    wants = [grad and a.dtype == onp.float32 for a in arrays]
    for x, w in zip(nds, wants):
        if w:
            x.attach_grad()
    with pkg.autograd.record():
        outs = _outs(fn(*nds, **kwargs))
    if grad:
        hg = [pkg.nd.array(h) for h in heads]
        pkg.autograd.backward(outs, hg)
    grads = [x.grad.asnumpy() for x, w in zip(nds, wants) if w]
    return [o.asnumpy() for o in outs], [(o.dtype, o.shape) for o in outs], \
        grads


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_op_matches_reference(case):
    cid, name, specs, kwargs = case
    rs = onp.random.RandomState(sum(map(ord, cid)))
    arrays = [_input(rs, s).astype(onp.int32 if s[0] == "i" else
                                   onp.float32) for s in specs]
    op = OPS[name]
    assert getattr(mx.nd, name) is getattr(pdefs, name)
    ref_fn, port_fn = getattr(rdefs, name), getattr(pdefs, name)
    # forward once (no tape) to learn the outputs, then the head gradients
    ref_outs = _outs(ref_fn(*[rmx.nd.array(a, dtype=a.dtype)
                              for a in arrays], **kwargs))
    grad = op.differentiable and all(
        onp.issubdtype(o.dtype, onp.floating) for o in ref_outs) and any(
        a.dtype == onp.float32 for a in arrays)
    heads = [rs.standard_normal(o.shape).astype(o.dtype) for o in ref_outs]
    r_out, r_dt, r_grads = _run(rmx, ref_fn, arrays, kwargs, grad, heads)
    with mx.cpu():
        p_out, p_dt, p_grads = _run(mx, port_fn, arrays, kwargs, grad,
                                    heads)
    assert len(p_out) == len(r_out)
    for p, r, pd, rd in zip(p_out, r_out, p_dt, r_dt):
        assert pd == rd, (pd, rd)
        assert p.shape == r.shape, (p.shape, r.shape)
        onp.testing.assert_allclose(p.astype(onp.float64),
                                    r.astype(onp.float64), **TOL)
    for p, r in zip(p_grads, r_grads):
        onp.testing.assert_allclose(p, r, **TOL)


def test_every_op_has_a_case():
    """The parametrised cases above reach every op that ``ops/defs.py``
    registers, and the registry holds the reference's op names."""
    assert {c[1] for c in CASES} == set(OPS)
    from mxnet_tpu.ops.registry import OPS as ROPS
    assert set(OPS) <= set(ROPS)


def test_creation_ops_match_reference():
    with mx.cpu():
        got = [mx.nd.zeros((2, 3)), mx.nd.ones((2,), dtype="int32"),
               mx.nd.full((2, 2), 1.5), mx.nd.arange(1, 7, 2.0, repeat=2),
               mx.nd.arange(5), mx.nd.linspace(0, 1, 5),
               mx.nd.linspace(-1, 2, 4, endpoint=False),
               mx.nd.eye(3, 4, k=1), mx.nd.eye(3)]
    ref = [rmx.nd.zeros((2, 3)), rmx.nd.ones((2,), dtype="int32"),
           rmx.nd.full((2, 2), 1.5), rmx.nd.arange(1, 7, 2.0, repeat=2),
           rmx.nd.arange(5), rmx.nd.linspace(0, 1, 5),
           rmx.nd.linspace(-1, 2, 4, endpoint=False),
           rmx.nd.eye(3, 4, k=1), rmx.nd.eye(3)]
    for p, r in zip(got, ref):
        assert p.dtype == r.dtype and p.shape == r.shape
        onp.testing.assert_allclose(p.asnumpy(), r.asnumpy(), **TOL)


def test_aliases_match_reference():
    """The reference's alias names (Concat, SequenceMask, elemwise_add,
    ...) name the same op in the port."""
    from mxnet_tpu.ops.registry import _ALIASES as RALIASES
    from mxnet_tpu_torch.ops.registry import _ALIASES, get_op

    ref = {k: v for k, v in RALIASES.items() if v in OPS}
    assert ref == {k: v for k, v in _ALIASES.items() if k in ref}
    for new, target in ref.items():
        assert get_op(new) is OPS[target]
        # mx.nd.stop_gradient is a function over BlockGrad's wrapper
        assert getattr(getattr(mx.nd, new), "_op", OPS[target]) is OPS[target]
