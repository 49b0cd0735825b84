"""Fused optimizer update ops of ``mx.nd`` (``sgd_update``,
``adam_update``, ``lamb_update_phase1/2``, the ``mp_*`` multi-precision
variants and the aggregated ``multi_*`` updates).

Port of ``mxnet_tpu/ops/optimizer_ops.py``, formula for formula: every
op is pure and returns the updated tensors (single-output ops take
``out=weight`` for reference-style call sites); the non-``mp_`` ops
compute in the weight's dtype, the ``mp_`` ones in float32 from the
master copy and cast once.  Each applies ``rescale_grad`` then
``clip_gradient`` (when >= 0) to the gradient.  A division by a Python
number whose reciprocal is inexact (``lr``, ``1 - beta ** t``) divides
by a device scalar (``nn._fdiv``): CUDA multiplies by the reciprocal of
a Python divisor.

The aggregated ``multi_sgd_update``, ``multi_sgd_mom_update``,
``multi_mp_sgd_update`` and ``multi_mp_sgd_mom_update`` loop over the
per-tensor bodies of ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update`` and ``mp_sgd_mom_update``, so each equals its loop of
single-tensor ops bit for bit.  ``optimizer/optimizer.py``'s rules do
not call these ops.
"""
from __future__ import annotations

import torch

from .nn import _fdiv
from .registry import op

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "adam_update", "adamw_update",
    "mp_adamw_update", "lamb_update_phase1", "lamb_update_phase2",
    "ftrl_update", "ftml_update", "rmsprop_update", "rmspropalex_update",
    "signsgd_update", "signum_update", "adagrad_update", "adadelta_update",
    "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update",
]


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


# --------------------------------------------------------------------------- #
# the SGD bodies, shared by the single-tensor and the aggregated ops
# --------------------------------------------------------------------------- #

def _sgd(weight, grad, lr, wd, rescale_grad, clip_gradient):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


def _sgd_mom(weight, grad, mom, lr, momentum, wd, rescale_grad,
             clip_gradient):
    g = _prep(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight)
    return weight + mom_new, mom_new


def _mp_sgd(weight, grad, weight32, lr, wd, rescale_grad, clip_gradient):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


def _mp_sgd_mom(weight, grad, mom, weight32, lr, momentum, wd,
                rescale_grad, clip_gradient):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


@op("sgd_update", differentiable=False)
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    return _sgd(weight, grad, lr, wd, rescale_grad, clip_gradient)


@op("sgd_mom_update", differentiable=False)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    return _sgd_mom(weight, grad, mom, lr, momentum, wd, rescale_grad,
                    clip_gradient)


@op("mp_sgd_update", differentiable=False)
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    return _mp_sgd(weight, grad, weight32, lr, wd, rescale_grad,
                   clip_gradient)


@op("mp_sgd_mom_update", differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    return _mp_sgd_mom(weight, grad, mom, weight32, lr, momentum, wd,
                       rescale_grad, clip_gradient)


@op("nag_mom_update", differentiable=False)
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    mom_new = momentum * mom + g
    return weight - lr * (g + momentum * mom_new), mom_new


@op("mp_nag_mom_update", differentiable=False)
def mp_nag_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient) \
        + wd * weight32
    mom_new = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom_new)
    return w32.to(weight.dtype), mom_new, w32


def _moments(g, mean, var, beta1, beta2):
    mean_new = beta1 * mean + (1.0 - beta1) * g
    var_new = beta2 * var + (1.0 - beta2) * g * g
    return mean_new, var_new


@op("adam_update", differentiable=False)
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Bias correction is folded into ``lr`` by the caller, as in the
    reference."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    mean_new, var_new = _moments(g, mean, var, beta1, beta2)
    w = weight - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return w, mean_new, var_new


@op("adamw_update", differentiable=False)
def adamw_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay; ``eta`` is the schedule multiplier."""
    g = _prep(grad, rescale_grad, clip_gradient)
    mean_new, var_new = _moments(g, mean, var, beta1, beta2)
    w = weight - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                        + lr * wd * weight)
    return w, mean_new, var_new


@op("mp_adamw_update", differentiable=False)
def mp_adamw_update(weight, grad, mean, var, weight32, *, lr, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient)
    mean_new, var_new = _moments(g, mean, var, beta1, beta2)
    w32 = weight32 - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                            + lr * wd * weight32)
    return w32.to(weight.dtype), mean_new, var_new, w32


@op("lamb_update_phase1", differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Phase 1: the raw LAMB direction; phase 2 applies the layerwise
    trust ratio."""
    g = _prep(grad, rescale_grad, clip_gradient)
    mean_new, var_new = _moments(g, mean, var, beta1, beta2)
    m_hat, v_hat = mean_new, var_new
    if bias_correction:
        m_hat = _fdiv(mean_new, 1.0 - beta1 ** t)
        v_hat = _fdiv(var_new, 1.0 - beta2 ** t)
    direction = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * weight
    return direction, mean_new, var_new


@op("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """Phase 2: ``w -= lr * (r1 / r2) * g`` with the norms computed
    between the phases (a ratio of 1 unless both are positive)."""
    if lower_bound >= 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound >= 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return weight - lr * ratio * g


@op("ftrl_update", differentiable=False)
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    n_new = n + g * g
    sigma = _fdiv(torch.sqrt(n_new) - torch.sqrt(n), lr)
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(z_new),
        -(z_new - torch.sign(z_new) * lamda1) /
        (_fdiv(beta + torch.sqrt(n_new), lr) + wd))
    return w.to(weight.dtype), z_new, n_new


@op("ftml_update", differentiable=False)
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    g = _prep(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1.0 - beta2) * g * g
    d_new = (1.0 - beta1 ** t) / lr * (
        torch.sqrt(_fdiv(v_new, 1.0 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1.0 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@op("rmsprop_update", differentiable=False)
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = gamma1 * n + (1.0 - gamma1) * g * g
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    return _clip_weights(w, clip_weights), n_new


@op("rmspropalex_update", differentiable=False)
def rmspropalex_update(weight, grad, n, g_state, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013)."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = gamma1 * n + (1.0 - gamma1) * g * g
    g_new = gamma1 * g_state + (1.0 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - g_new * g_new + epsilon)
    w = weight + delta_new
    return _clip_weights(w, clip_weights), n_new, g_new, delta_new


@op("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@op("signum_update", differentiable=False)
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    w = (1.0 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w, mom_new


@op("adagrad_update", differentiable=False)
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    hist_new = history + g * g
    return (weight - lr * (g / (torch.sqrt(hist_new) + epsilon)
                           + wd * weight), hist_new)


@op("adadelta_update", differentiable=False)
def adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    acc_g_new = rho * acc_g + (1.0 - rho) * g * g
    delta = torch.sqrt(acc_delta + epsilon) / \
        torch.sqrt(acc_g_new + epsilon) * g
    acc_delta_new = rho * acc_delta + (1.0 - rho) * delta * delta
    return weight - delta, acc_g_new, acc_delta_new


# --------------------------------------------------------------------------- #
# aggregated multi-tensor updates over interleaved tensor lists (the
# reference's ``Optimizer.aggregate_num`` path): loops over the bodies above
# --------------------------------------------------------------------------- #

@op("multi_sgd_update", differentiable=False, variadic=True)
def multi_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=None):
    """arrays = [w0, g0, w1, g1, ...]; returns the updated weights."""
    n = num_weights if num_weights is not None else len(arrays) // 2
    return tuple(_sgd(arrays[2 * i], arrays[2 * i + 1], lrs[i], wds[i],
                      rescale_grad, clip_gradient) for i in range(n))


@op("multi_sgd_mom_update", differentiable=False, variadic=True)
def multi_sgd_mom_update(*arrays, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=None):
    """arrays = [w0, g0, m0, w1, g1, m1, ...] -> (w0', m0', w1', m1', ...)"""
    n = num_weights if num_weights is not None else len(arrays) // 3
    outs = []
    for i in range(n):
        outs += _sgd_mom(*arrays[3 * i:3 * i + 3], lrs[i], momentum,
                         wds[i], rescale_grad, clip_gradient)
    return tuple(outs)


@op("multi_mp_sgd_update", differentiable=False, variadic=True)
def multi_mp_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    """arrays = [w0, g0, w32_0, ...] -> (w0', w32_0', ...)"""
    n = num_weights if num_weights is not None else len(arrays) // 3
    outs = []
    for i in range(n):
        outs += _mp_sgd(*arrays[3 * i:3 * i + 3], lrs[i], wds[i],
                        rescale_grad, clip_gradient)
    return tuple(outs)


@op("multi_mp_sgd_mom_update", differentiable=False, variadic=True)
def multi_mp_sgd_mom_update(*arrays, lrs, wds, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    """arrays = [w0, g0, m0, w32_0, ...] -> (w0', m0', w32_0', ...)"""
    n = num_weights if num_weights is not None else len(arrays) // 4
    outs = []
    for i in range(n):
        outs += _mp_sgd_mom(*arrays[4 * i:4 * i + 4], lrs[i], momentum,
                            wds[i], rescale_grad, clip_gradient)
    return tuple(outs)
