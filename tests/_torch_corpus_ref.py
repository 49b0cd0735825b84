"""Running one op-corpus case through the reference's registered
function (JAX, on the CPU) against the port's
(``_torch_corpus_cases.port``): the outputs by the op's class and, for a
differentiable op, the gradients of its float inputs under the same
seeded head gradients (``jax.vjp`` against ``torch.autograd.grad``),
within ``GRAD_TOL``.  The JAX package is imported at first use, so a
test file that uses this module can also hold ``cuda``-marked tests that
run on the card's machine.
"""
import numpy as onp

from _torch_corpus_cases import (GRAD_TOL, NO_GRAD, _float_inputs, _outs,
                                 assert_same, heads_for, make_inputs, port)


def reference(name, arrays, kwargs, grad_seed=None):
    """(outputs, input gradients) of the reference's registered op."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu.ndarray  # noqa: F401  (registers every op)
    from mxnet_tpu.ops.registry import get_op

    o = get_op(name)
    args = [jnp.asarray(a) for a in arrays]
    fidx = _float_inputs(arrays)
    if grad_seed is None or not o.differentiable or not fidx:
        return [onp.asarray(r) for r in _outs(o.fn(*args, **kwargs))], []

    def f(*d):
        full = list(args)
        for i, a in zip(fidx, d):
            full[i] = a
        return o.fn(*full, **kwargs)

    out, vjp = jax.vjp(f, *[args[i] for i in fidx])
    outs = _outs(out)
    heads = heads_for([onp.shape(r) for r in outs], grad_seed)
    cts = [jnp.asarray(h) if jnp.issubdtype(r.dtype, jnp.floating)
           else onp.zeros(r.shape, jax.dtypes.float0)
           for h, r in zip(heads, outs)]
    grads = vjp(tuple(cts) if isinstance(out, (list, tuple)) else cts[0])
    return [onp.asarray(r) for r in outs], [onp.asarray(g) for g in grads]


def check_case(case):
    """One case, the port against the reference on the CPU."""
    cid, name, specs, kwargs = case
    arrays = make_inputs(specs)
    seed = None if cid in NO_GRAD else sum(map(ord, cid))
    r_out, r_grad = reference(name, arrays, kwargs, seed)
    p_out, p_grad = port(name, arrays, kwargs, seed)
    assert_same(name, p_out, r_out)
    assert len(p_grad) == len(r_grad)
    for g, w in zip(p_grad, r_grad):
        onp.testing.assert_allclose(g, w, **GRAD_TOL)


