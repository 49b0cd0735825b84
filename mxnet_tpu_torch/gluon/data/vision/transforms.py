"""Vision transforms (reference
``python/mxnet/gluon/data/vision/transforms.py``; SURVEY.md §3.2).

Port of ``mxnet_tpu/gluon/data/vision/transforms.py``.  Transforms are
Blocks (composable with ``Compose``, usable via
``dataset.transform_first``).  Every transform runs on the host, in numpy
and host ``NDArray``s (they execute in DataLoader workers, before the
batch's one copy to the card), and returns a host ``NDArray``.
"""
from __future__ import annotations

import random as pyrandom

import numpy as onp

from ....ndarray.ndarray import _as_np, _host
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "CropResize",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting", "RandomGray"]


class Compose(Sequential):
    """Sequentially compose transforms (hybridizes contiguous HybridBlocks
    in the reference; here composition is plain sequencing of host
    transforms, called with the sample as it is)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)

    def __call__(self, x, *args):
        for t in self:
            x = t(x)
        return (x,) + args if args else x


class _HostTransform(Block):
    """Host-side transform base: __call__(x [, label]) passthrough."""

    def __call__(self, x, *args):
        out = self.forward(x)
        return (out,) + args if args else out


class Cast(_HostTransform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(_HostTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference ``ToTensor``)."""

    def forward(self, x):
        arr = _as_np(x)
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _host(arr.astype(onp.float32) / 255.0)


class Normalize(_HostTransform):
    """Channel-wise (x - mean) / std on CHW float input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32).reshape(-1, 1, 1)
        self._std = onp.asarray(std, dtype=onp.float32).reshape(-1, 1, 1)

    def forward(self, x):
        arr = _as_np(x)
        return _host((arr - self._mean) / self._std)


class Resize(_HostTransform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        from ....image import imresize, resize_short
        if isinstance(self._size, int):
            if self._keep:
                return resize_short(x, self._size, self._interp)
            return imresize(x, self._size, self._size, self._interp)
        return imresize(x, self._size[0], self._size[1], self._interp)


class CenterCrop(_HostTransform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        from ....image import center_crop
        return center_crop(x, self._size, self._interp)[0]


class RandomResizedCrop(_HostTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4.0, 4 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        from ....image import random_size_crop
        return random_size_crop(x, self._size, self._scale, self._ratio,
                                self._interp)[0]


class CropResize(_HostTransform):
    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        super().__init__()
        self._args = (x0, y0, width, height)
        self._size = size
        self._interp = interpolation

    def forward(self, x):
        from ....image import fixed_crop
        return fixed_crop(x, *self._args, size=self._size,
                          interp=self._interp)


class RandomFlipLeftRight(_HostTransform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if pyrandom.random() < self._p:
            arr = _as_np(x)
            return _host(arr[:, ::-1], arr.dtype)
        return x


class RandomFlipTopBottom(_HostTransform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if pyrandom.random() < self._p:
            arr = _as_np(x)
            return _host(arr[::-1], arr.dtype)
        return x


class RandomBrightness(_HostTransform):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        from ....image import BrightnessJitterAug
        return BrightnessJitterAug(self._b)(x)


class RandomContrast(_HostTransform):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        from ....image import ContrastJitterAug
        return ContrastJitterAug(self._c)(x)


class RandomSaturation(_HostTransform):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        from ....image import SaturationJitterAug
        return SaturationJitterAug(self._s)(x)


class RandomHue(_HostTransform):
    """Hue jitter via RGB rotation approximation (reference uses the same
    YIQ-space trick)."""

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        alpha = pyrandom.uniform(-self._h, self._h)
        arr = _as_np(x).astype(onp.float32)
        u, w = onp.cos(alpha * onp.pi), onp.sin(alpha * onp.pi)
        t_yiq = onp.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]], dtype=onp.float32)
        t_rgb = onp.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]], dtype=onp.float32)
        rot = onp.array([[1, 0, 0], [0, u, -w], [0, w, u]], dtype=onp.float32)
        m = t_rgb @ rot @ t_yiq
        return _host(arr @ m.T)


class RandomColorJitter(_HostTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._augs = []
        if brightness:
            self._augs.append(RandomBrightness(brightness))
        if contrast:
            self._augs.append(RandomContrast(contrast))
        if saturation:
            self._augs.append(RandomSaturation(saturation))
        if hue:
            self._augs.append(RandomHue(hue))

    def forward(self, x):
        augs = list(self._augs)
        pyrandom.shuffle(augs)
        for a in augs:
            x = a(x)
        return x


class RandomLighting(_HostTransform):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        from ....image import LightingAug
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        return LightingAug(self._alpha, eigval, eigvec)(x)


class RandomGray(_HostTransform):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if pyrandom.random() < self._p:
            arr = _as_np(x).astype(onp.float32)
            gray = (arr * onp.array([0.299, 0.587, 0.114], dtype=onp.float32)).sum(
                axis=-1, keepdims=True)
            return _host(onp.repeat(gray, 3, axis=-1))
        return x
