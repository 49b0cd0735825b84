"""``mx.nd.image``'s registered ops: the device half of an image pipeline.

Port of ``mxnet_tpu/ops/image_ops.py``.  HWC or NHWC input, uint8 or
float, as the reference: ``to_tensor`` gives CHW (NCHW) f32 in [0, 1],
``normalize`` takes float CHW (NCHW) only, the photometric ops return f32
for integer input and the input's dtype for float input, and the random
ops draw once an image (a scalar draw for one HWC image).

``resize`` computes ``jax.image.resize``: ``interp=1`` the triangle filter
at half-pixel centres, widened by the factor when it shrinks
(antialiasing), ``interp=0`` the nearest pixel by ``floor((i + 0.5) * in
/ out)``; integer input is resized in f32 and cast back by truncation,
as ``astype`` does.  ``F.interpolate`` computes neither by default.

The random ops draw from ``random.key_uniform``: counter-based, one fresh
key a call, so a seeded call gives the same images on the card and on
the CPU (the reference's threefry bits are not reproduced).
"""
from __future__ import annotations

import torch

from .. import random as _random
from .nn import _fdiv, _resize_bilinear
from .registry import op

__all__ = ["image_to_tensor", "image_normalize", "image_resize",
           "image_crop", "image_flip_left_right", "image_flip_top_bottom",
           "image_random_flip_left_right", "image_random_flip_top_bottom",
           "image_random_brightness", "image_random_contrast",
           "image_random_saturation"]

_GRAY = (0.299, 0.587, 0.114)


def _is_batch(data):
    return data.dim() == 4


@op("_image_to_tensor", wrap=False)
def image_to_tensor(data):
    """HWC [0, 255] -> CHW f32 [0, 1] (NHWC -> NCHW)."""
    x = _fdiv(data.float(), 255.0)
    return x.permute(0, 3, 1, 2) if _is_batch(data) else x.permute(2, 0, 1)


@op("_image_normalize", wrap=False)
def image_normalize(data, *, mean=(0.0,), std=(1.0,)):
    """CHW (NCHW) channel-wise ``(x - mean) / std``; float input only (a
    cast back to uint8 would saturate)."""
    if not data.is_floating_point():
        raise TypeError(f"image_normalize: float input required, got "
                        f"{data.dtype} (run image.to_tensor first)")
    shape = [1] * data.dim()
    shape[1 if _is_batch(data) else 0] = -1
    mean = torch.tensor(mean, dtype=torch.float32, device=data.device)
    std = torch.tensor(std, dtype=torch.float32, device=data.device)
    return ((data.float() - mean.reshape(shape)) /
            std.reshape(shape)).to(data.dtype)


def _nearest_index(n_in, n_out, device):
    """``jax.image``'s nearest source pixel of each output pixel."""
    at = (torch.arange(n_out, device=device).float() + 0.5) * n_in
    return torch.floor(_fdiv(at, n_out)).long()


@op("_image_resize", wrap=False)
def image_resize(data, *, size=None, keep_ratio=False, interp=1):
    """HWC/NHWC resize to ``size`` ((w, h), or an int: both sides, or with
    ``keep_ratio`` the shorter side), bilinear (``interp=1``) or nearest
    (``interp=0``)."""
    in_h, in_w = data.shape[-3], data.shape[-2]
    if isinstance(size, int):
        if keep_ratio:
            if in_h < in_w:
                h, w = size, max(1, round(in_w * size / in_h))
            else:
                h, w = max(1, round(in_h * size / in_w)), size
        else:
            h = w = size
    else:
        w, h = size
    x = data.float()
    x = x.permute(0, 3, 1, 2) if _is_batch(data) else x.permute(2, 0, 1)[None]
    if interp == 0:
        if h != in_h:
            x = x[:, :, _nearest_index(in_h, h, x.device)]
        if w != in_w:
            x = x[:, :, :, _nearest_index(in_w, w, x.device)]
    else:
        x = _resize_bilinear(x, h, w)
    x = x.permute(0, 2, 3, 1) if _is_batch(data) else x[0].permute(1, 2, 0)
    return x.to(data.dtype)


@op("_image_crop", wrap=False)
def image_crop(data, *, x=0, y=0, width=1, height=1):
    if _is_batch(data):
        return data[:, y:y + height, x:x + width, :]
    return data[y:y + height, x:x + width, :]


@op("_image_flip_left_right", wrap=False)
def image_flip_left_right(data):
    return torch.flip(data, (-2,))


@op("_image_flip_top_bottom", wrap=False)
def image_flip_top_bottom(data):
    return torch.flip(data, (-3,))


def _draws(data):
    """One uniform draw an image: (N, 1, 1, 1) for NHWC, () for HWC."""
    if _is_batch(data):
        return _random.key_uniform(data.shape[0], data.device).reshape(
            -1, 1, 1, 1)
    return _random.key_uniform(1, data.device).reshape(())


@op("_image_random_flip_left_right", differentiable=False, wrap=False)
def image_random_flip_left_right(data):
    return torch.where(_draws(data) < 0.5, torch.flip(data, (-2,)), data)


@op("_image_random_flip_top_bottom", differentiable=False, wrap=False)
def image_random_flip_top_bottom(data):
    return torch.where(_draws(data) < 0.5, torch.flip(data, (-3,)), data)


def _factor(data, lo, hi):
    return lo + (hi - lo) * _draws(data)


def _photometric_dtype(data, x):
    return x.to(data.dtype) if data.is_floating_point() else x


def _gray(x):
    coef = torch.tensor(_GRAY, dtype=torch.float32, device=x.device)
    return torch.tensordot(x, coef, dims=([x.dim() - 1], [0]))


@op("_image_random_brightness", differentiable=False, wrap=False)
def image_random_brightness(data, *, min_factor=0.5, max_factor=1.5):
    f = _factor(data, min_factor, max_factor)
    return _photometric_dtype(data, data.float() * f)


@op("_image_random_contrast", differentiable=False, wrap=False)
def image_random_contrast(data, *, min_factor=0.5, max_factor=1.5):
    """Each image blended with its own mean luminance."""
    f = _factor(data, min_factor, max_factor)
    x = data.float()
    gray = _gray(x).mean(dim=(-2, -1), keepdim=True)[..., None]
    return _photometric_dtype(data, gray * (1 - f) + x * f)


@op("_image_random_saturation", differentiable=False, wrap=False)
def image_random_saturation(data, *, min_factor=0.5, max_factor=1.5):
    """Each pixel blended with its own luminance."""
    f = _factor(data, min_factor, max_factor)
    x = data.float()
    return _photometric_dtype(data, _gray(x)[..., None] * (1 - f) + x * f)
