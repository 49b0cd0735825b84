"""Image decode + augmenters + ImageIter.

Port of ``mxnet_tpu/image/image.py`` (reference ``python/mxnet/image/
image.py``).  Decode uses OpenCV when it is installed (the reference's
backend), else PIL, else raises ``MXNetError("imdecode needs cv2 or
PIL")``; the reference's native libjpeg decoder is not ported (ROADMAP
"Not queued").  Every augmenter works on an HWC image on the host and
returns a host (CPU) ``NDArray``: samples and their transforms stay on
the host, and a batch reaches the card once, from the data loader or
``mx.io`` (ROADMAP §3, "where a sample lives").  Random draws come from
Python's ``random`` module and numpy's global generator, in the
reference's order.
"""
from __future__ import annotations

import io as _pyio
import random as pyrandom

import numpy as onp

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import _as_np, _host, array

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover - the card's machine has neither
    _cv2 = None

try:
    from PIL import Image as _PILImage
except ImportError:  # pragma: no cover
    _PILImage = None


def backends():
    """The decoders this process found, in the order ``imdecode`` tries
    them (``"cv2"``, ``"PIL"``)."""
    return [n for n, m in (("cv2", _cv2), ("PIL", _PILImage))
            if m is not None]


# --------------------------------------------------------------------- #
# decode / encode / resize primitives
# --------------------------------------------------------------------- #
def imdecode_np(buf: bytes, iscolor: int = 1, to_rgb: bool = True) -> onp.ndarray:
    """Decode an encoded image to an HWC uint8 numpy array (RGB order when
    ``to_rgb``, matching the reference's ``mx.image.imdecode`` default).

    Backend order: OpenCV, then PIL."""
    if _cv2 is not None:
        flag = _cv2.IMREAD_COLOR if iscolor != 0 else _cv2.IMREAD_GRAYSCALE
        img = _cv2.imdecode(onp.frombuffer(buf, dtype=onp.uint8), flag)
        if img is None:
            raise MXNetError("imdecode failed")
        if img.ndim == 2:
            img = img[:, :, None]
        elif to_rgb:
            img = _cv2.cvtColor(img, _cv2.COLOR_BGR2RGB)
        return img
    if _PILImage is None:
        raise MXNetError("imdecode needs cv2 or PIL")
    img = _PILImage.open(_pyio.BytesIO(buf))
    img = img.convert("L" if iscolor == 0 else "RGB")
    arr = onp.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def imdecode(buf, iscolor: int = 1, to_rgb: bool = True, **kwargs) -> NDArray:
    """``mx.image.imdecode`` — decode to a host ``NDArray`` (HWC uint8)."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    return _host(imdecode_np(bytes(buf), iscolor=iscolor, to_rgb=to_rgb),
                 "uint8")


def imencode(img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 array to JPEG/PNG bytes."""
    img = onp.ascontiguousarray(_as_np(img), dtype=onp.uint8)
    if _cv2 is not None:
        bgr = _cv2.cvtColor(img, _cv2.COLOR_RGB2BGR) if img.shape[-1] == 3 else img
        params = [_cv2.IMWRITE_JPEG_QUALITY, quality] if "jp" in img_fmt else []
        ok, enc = _cv2.imencode(img_fmt, bgr, params)
        if not ok:
            raise MXNetError("imencode failed")
        return enc.tobytes()
    if _PILImage is None:
        raise MXNetError("imencode needs cv2 or PIL")
    fmt = "JPEG" if "jp" in img_fmt.lower() else img_fmt.strip(".").upper()
    b = _pyio.BytesIO()
    _PILImage.fromarray(img.squeeze() if img.shape[-1] == 1 else img).save(
        b, format=fmt, quality=quality)
    return b.getvalue()


def imread(filename: str, iscolor: int = 1, to_rgb: bool = True) -> NDArray:
    with open(filename, "rb") as f:
        return imdecode(f.read(), iscolor=iscolor, to_rgb=to_rgb)


def _resize_np(img: onp.ndarray, w: int, h: int, interp=1) -> onp.ndarray:
    if _cv2 is not None:
        interps = {0: _cv2.INTER_NEAREST, 1: _cv2.INTER_LINEAR,
                   2: _cv2.INTER_CUBIC, 3: _cv2.INTER_AREA,
                   4: _cv2.INTER_LANCZOS4}
        out = _cv2.resize(img, (w, h), interpolation=interps.get(interp, 1))
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    if _PILImage is None:
        raise MXNetError("image resize needs cv2 or PIL")
    pil = _PILImage.fromarray(img.squeeze() if img.shape[-1] == 1 else img)
    out = onp.asarray(pil.resize((w, h),
                                 _PILImage.NEAREST if interp == 0 else _PILImage.BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    img = _as_np(src)
    return _host(_resize_np(img, w, h, interp), img.dtype)


def resize_short(src, size: int, interp: int = 1) -> NDArray:
    """Resize so the SHORTER edge equals ``size`` (aspect preserved)."""
    img = _as_np(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _host(_resize_np(img, new_w, new_h, interp), img.dtype)


def fixed_crop(src, x0: int, y0: int, w: int, h: int, size=None, interp: int = 1):
    img = _as_np(src)
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[0], size[1], interp)
    return _host(out, img.dtype)


def center_crop(src, size, interp: int = 1):
    h, w = _as_np(src).shape[:2]
    cw, ch = size
    x0 = max((w - cw) // 2, 0)
    y0 = max((h - ch) // 2, 0)
    cw, ch = min(cw, w), min(ch, h)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_crop(src, size, interp: int = 1):
    h, w = _as_np(src).shape[:2]
    cw, ch = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - cw)
    y0 = pyrandom.randint(0, h - ch)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_size_crop(src, size, area, ratio, interp: int = 1):
    """Random area-and-aspect crop (the Inception-style augmentation)."""
    h, w = _as_np(src).shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(pyrandom.uniform(*log_ratio))
        cw = int(round(onp.sqrt(target_area * aspect)))
        ch = int(round(onp.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)
    return center_crop(src, size, interp)


def _like(src, values):
    """``values`` as an f32 array beside ``src``: on its context when it
    is an NDArray, else on the host."""
    if isinstance(values, NDArray):
        return values
    ctx = src.context if isinstance(src, NDArray) else None
    a = onp.asarray(values, dtype=onp.float32)
    return array(a, ctx=ctx) if ctx is not None else _host(a)


def color_normalize(src, mean, std=None):
    src = src.astype("float32") if isinstance(src, NDArray) else \
        _host(src, "float32")
    out = src - _like(src, mean)
    if std is not None:
        out = out / _like(src, std)
    return out


# --------------------------------------------------------------------- #
# Augmenter classes (reference: Augmenter hierarchy in image.py)
# --------------------------------------------------------------------- #
class Augmenter:
    """Image augmenter base; ``__call__(src: NDArray) -> NDArray``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [self.__class__.__name__.lower(), self._kwargs]

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=1):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            img = _as_np(src)
            return _host(img[:, ::-1], img.dtype)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src.astype("float32") * alpha


class ContrastJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], dtype=onp.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        img = _as_np(src).astype(onp.float32)
        gray = (img * self._coef).sum() * (3.0 / img.size)
        return _host(img * alpha + gray * (1 - alpha), "float32")


class SaturationJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], dtype=onp.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        img = _as_np(src).astype(onp.float32)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return _host(img * alpha + gray * (1 - alpha), "float32")


class HSVJitterAug(Augmenter):
    """Combined brightness/contrast/saturation jitter in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        pyrandom.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


ColorJitterAug = HSVJitterAug


class LightingAug(Augmenter):
    """PCA-based RGB lighting noise (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, dtype=onp.float32)
        self.eigvec = onp.asarray(eigvec, dtype=onp.float32)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,)).astype(onp.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return src.astype("float32") + _like(src, rgb)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Build the standard augmenter list (reference ``CreateAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(HSVJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53], dtype=onp.float32)
    if std is True:
        std = onp.array([58.395, 57.12, 57.375], dtype=onp.float32)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# --------------------------------------------------------------------- #
# ImageIter — python-side decode+augment pipeline over .rec or .lst
# --------------------------------------------------------------------- #
class ImageIter:
    """Image data iterator reading RecordIO (``path_imgrec``) or an image
    list (``path_imglst`` + ``path_root``); reference ``mx.image.ImageIter``
    (SURVEY.md §4.5).  Yields ``DataBatch`` with NCHW float data on the
    context current when the iterator was made (``gpu(0)`` unless a
    ``with mx.cpu():`` scope says otherwise), one placement a batch."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglst=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 dtype="float32", last_batch_handle="pad", **kwargs):
        import os as _os

        from ..io import DataDesc
        from .. import recordio as rio
        self._ctx = current_context()
        self._ctx.torch_device()
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        self.last_batch_handle = last_batch_handle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_resize", "rand_mirror",
                                                    "mean", "std", "brightness",
                                                    "contrast", "saturation",
                                                    "pca_noise", "inter_method")})
        self.provide_data = [DataDesc(data_name, (batch_size,) + self.data_shape, dtype)]
        lshape = (batch_size,) if label_width == 1 else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape, "float32")]

        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            idx_path = path_imgrec[:-4] + ".idx"
            if _os.path.isfile(idx_path):
                self.imgrec = rio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = rio.MXRecordIO(path_imgrec, "r")
        elif path_imglst or imglist is not None:
            self.imglist = {}
            if imglist is not None:
                for i, (label, fname) in enumerate(imglist):
                    self.imglist[i] = (onp.asarray(label, dtype=onp.float32), fname)
            else:
                with open(path_imglst) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        key = int(parts[0])
                        label = onp.asarray([float(x) for x in parts[1:-1]],
                                            dtype=onp.float32)
                        self.imglist[key] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
            self.path_root = path_root or "."
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglst, or imglist")
        if self.seq is not None and num_parts > 1:
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        import os as _os

        from .. import recordio as rio
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = rio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(_os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = rio.unpack(s)
        return header.label, img

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from ..io import DataBatch
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, h, w, c), dtype=onp.float32)
        batch_label = onp.zeros((self.batch_size, self.label_width), dtype=onp.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                img = _host(imdecode_np(s), "uint8")
                for aug in self.auglist:
                    img = aug(img)
                arr = _as_np(img)
                if arr.shape[:2] != (h, w):
                    arr = _resize_np(arr.astype(onp.uint8), w, h)
                batch_data[i] = arr.astype(onp.float32)
                batch_label[i] = onp.asarray(label, dtype=onp.float32).reshape(-1)[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            if self.last_batch_handle == "discard":
                raise
        # NCHW for the model (reference layout)
        data = array(batch_data.transpose(0, 3, 1, 2), ctx=self._ctx,
                     dtype=self.dtype)
        label = array(batch_label[:, 0] if self.label_width == 1 else
                      batch_label, ctx=self._ctx)
        return DataBatch(data=[data], label=[label], pad=self.batch_size - i)
