"""The port's legacy-surface ops (``mxnet_tpu_torch/ops/legacy.py``)
against ``mxnet_tpu/ops/legacy.py`` on the inputs of
``tests/test_legacy_ops.py`` (seeded numpy, f32 on the CPU), through each
package's ``mx.nd``; and the namespace: every name that the reference's
``ops/rnn.py``, ``ops/linalg.py`` and ``ops/legacy.py`` register, and
their aliases, resolves in the port's ``mx.nd``.

Tolerance: outputs and the gradients of the float inputs within 1e-5
(relative and absolute).  The output heads' gradients are the loss's
(the head gradient is ignored), as the reference's.
"""
import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from _torch_parity import LazyReference
from mxnet_tpu_torch.ops.registry import NOT_PORTED, OPS

rmx = LazyReference()     # the JAX package, imported at first use

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _f(*v):
    return onp.asarray(v, onp.float32)


# (id, op, inputs, kwargs); the gradient of every f32 input is compared
CASES = [
    ("im2col_golden", "im2col",
     [onp.arange(150, dtype=onp.float32).reshape(2, 3, 5, 5)],
     dict(kernel=(3, 3), stride=(1, 1), pad=(0, 0))),
    ("im2col_stride_pad", "im2col", [_rand(0, 1, 2, 6, 6)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("im2col_dilate", "im2col", [_rand(1, 2, 3, 9, 8)],
     dict(kernel=(3, 2), dilate=(2, 1), pad=(1, 0))),
    ("col2im_nonoverlapping", "col2im", [_rand(2, 2, 12, 9)],
     dict(output_size=(6, 6), kernel=(2, 2), stride=(2, 2))),
    ("col2im_overlapping", "col2im", [_rand(3, 1, 9, 4)],
     dict(output_size=(4, 4), kernel=(3, 3), stride=(1, 1))),
    ("col2im_pad", "col2im", [_rand(4, 2, 18, 9)],
     dict(output_size=(6, 6), kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("linear_regression", "LinearRegressionOutput",
     [_rand(0, 4, 3), _rand(1, 4, 3)], {}),
    ("linear_regression_scaled", "LinearRegressionOutput",
     [_rand(0, 4, 3), _rand(1, 4, 3)], dict(grad_scale=2.0)),
    ("logistic_regression", "LogisticRegressionOutput",
     [_rand(0, 5, 2), (onp.random.RandomState(1).rand(5, 2) > 0.5)
      .astype(onp.float32)], {}),
    ("mae_regression", "MAERegressionOutput",
     [_rand(0, 3, 2), onp.zeros((3, 2), onp.float32)], {}),
    ("svm_squared_hinge", "SVMOutput", [_f([2.0, 1.5, -1.0]), _f(0.0)],
     dict(margin=1.0)),
    ("svm_linear", "SVMOutput", [_rand(2, 4, 5), _f(0, 3, 4, 1)],
     dict(margin=0.5, use_linear=True, regularization_coefficient=0.3)),
    ("svm_random", "SVMOutput", [_rand(3, 4, 5), _f(2, 2, 0, 4)], {}),
    ("choose_element", "choose_element_0index",
     [_rand(0, 4, 5), _f(0, 2, 4, 1)], {}),
    ("fill_element", "fill_element_0index",
     [onp.zeros((3, 4), onp.float32), _f(7, 8, 9), _f(1, 0, 3)], {}),
    ("selu", "selu", [_rand(0, 3, 4)], {}),
    ("erfc", "erfc", [_rand(0, 3, 4)], {}),
    ("elu", "elu", [_rand(0, 2, 3)], dict(alpha=0.5)),
    ("prelu", "prelu", [_rand(0, 2, 3), _f(0.1, 0.2, 0.3)], {}),
    ("prelu_4d", "prelu", [_rand(1, 2, 3, 4, 4), _f(0.1, 0.2, 0.3)], {}),
    ("logit", "logit", [_f(0.1, 0.5, 0.9)], {}),
    ("logit_eps", "logit", [_f(0.0, 0.3, 1.0)], dict(eps=1e-3)),
    ("gelu_erf", "gelu", [_rand(0, 5)], {}),
    ("gelu_tanh", "gelu", [_rand(1, 3, 7)], dict(approximation="tanh")),
    ("softmax_cross_entropy", "softmax_cross_entropy",
     [_rand(0, 4, 6), _f(0, 3, 5, 2)], {}),
    ("group_adagrad", "group_adagrad_update",
     [onp.ones((3, 4), onp.float32), _rand(0, 3, 4),
      onp.zeros((3, 1), onp.float32)], dict(lr=0.1)),
    ("group_adagrad_clip", "group_adagrad_update",
     [_rand(1, 3, 4), _rand(0, 3, 4) * 3, onp.full((3, 1), 0.5,
                                                   onp.float32)],
     dict(lr=0.1, clip_gradient=1.0, rescale_grad=0.5)),
    ("group_adagrad_alias", "_contrib_group_adagrad_update",
     [onp.ones((3, 4), onp.float32), _rand(0, 3, 4),
      onp.zeros((3, 1), onp.float32)], dict(lr=0.1)),
    ("lans", "lans_update", [_rand(0, 8, 8), _rand(1, 8, 8),
                             onp.zeros((8, 8), onp.float32),
                             onp.zeros((8, 8), onp.float32)],
     dict(lr=0.01, t=1)),
    ("lans_t3_wd", "lans_update", [_rand(0, 8, 8), _rand(1, 8, 8),
                                   _rand(2, 8, 8) * 0.1,
                                   abs(_rand(3, 8, 8)) * 0.01],
     dict(lr=0.01, t=3, wd=0.01, beta1=0.8)),
    ("rnn_param_concat", "rnn_param_concat",
     [_rand(0, 2, 3), _rand(1, 4)], dict(dim=0)),
]


def _outs(r):
    return list(r) if isinstance(r, (list, tuple)) else [r]


def _call(pkg, name, nds, kwargs):
    fn = getattr(pkg.nd, name)
    if name == "rnn_param_concat":
        return fn(nds, **kwargs)
    return fn(*nds, **kwargs)


def _run(pkg, name, arrays, kwargs, heads):
    nds = [pkg.nd.array(a) for a in arrays]
    if heads is None:
        return [o.asnumpy() for o in _outs(_call(pkg, name, nds, kwargs))], []
    for x in nds:
        x.attach_grad()
    with pkg.autograd.record():
        outs = _outs(_call(pkg, name, nds, kwargs))
    pkg.autograd.backward(outs, [pkg.nd.array(h) for h in heads])
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in nds]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_legacy_op_matches_reference(case):
    """Outputs (dtype and shape too) and, for the differentiable ops, the
    gradients of every input under the same random head gradients."""
    cid, name, arrays, kwargs = case
    rs = onp.random.RandomState(sum(map(ord, cid)))
    ref = _outs(_call(rmx, name, [rmx.nd.array(a) for a in arrays], kwargs))
    grad = OPS[mx.nd.__dict__[name]._op.name].differentiable
    heads = [rs.standard_normal(o.shape).astype(onp.float32)
             for o in ref] if grad else None
    r_out, r_grad = _run(rmx, name, arrays, kwargs, heads)
    with mx.cpu():
        p_out, p_grad = _run(mx, name, arrays, kwargs, heads)
    assert len(p_out) == len(r_out)
    for p, r in zip(p_out, r_out):
        assert p.dtype == r.dtype and p.shape == r.shape, \
            (p.dtype, p.shape, r.dtype, r.shape)
        onp.testing.assert_allclose(p, r, **TOL)
    for p, r in zip(p_grad, r_grad):
        onp.testing.assert_allclose(p, r, **TOL)


def test_im2col_gemm_is_convolution():
    """im2col + GEMM equals ``Convolution`` (the reference's CPU conv
    path), in the port."""
    x, w = _rand(0, 2, 3, 8, 8), _rand(1, 4, 3, 3, 3)
    with mx.cpu():
        ref = mx.nd.Convolution(mx.nd.array(x), mx.nd.array(w), None,
                                kernel=(3, 3), num_filter=4, no_bias=True,
                                pad=(1, 1)).asnumpy()
        cols = mx.nd.im2col(mx.nd.array(x), kernel=(3, 3),
                            pad=(1, 1)).asnumpy()
    gemm = onp.einsum("ok,nkl->nol", w.reshape(4, -1), cols)
    onp.testing.assert_allclose(gemm.reshape(ref.shape), ref, rtol=1e-4,
                                atol=1e-4)


def _reference_names():
    """Every op name and alias of the reference's rnn, linalg and legacy
    modules."""
    from mxnet_tpu.ops import legacy, linalg, rnn
    from mxnet_tpu.ops.registry import _ALIASES

    names = set()
    for mod in (rnn, linalg, legacy):
        for obj in vars(mod).values():
            o = getattr(obj, "_op", None)
            if callable(obj) and o is not None:
                names.add(o.name)
    return sorted(names | {a for a, t in _ALIASES.items() if t in names})


@pytest.mark.parametrize("name", _reference_names())
def test_reference_name_resolves_in_port(name):
    """The reference's name (or alias) is an ``mx.nd`` callable in the
    port, registered and not marked as left out."""
    assert callable(getattr(mx.nd, name))
    from mxnet_tpu_torch.ops.registry import get_op

    assert get_op(name).name not in NOT_PORTED


def test_namespace_counts():
    """The reference's 1 + 13 + 18 registered names (rnn, linalg,
    legacy; legacy's 15 plus its three regression heads) are all
    registered in the port."""
    names = [n for n in _reference_names() if n in rmx.ops.registry.OPS]
    assert len(names) == 32
    assert all(n in OPS for n in names)
