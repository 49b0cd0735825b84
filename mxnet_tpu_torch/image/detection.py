"""Detection augmenters + ImageDetIter.

Port of ``mxnet_tpu/image/detection.py`` (reference
``python/mxnet/image/detection.py``; SURVEY.md §3.2 "detection
augmenters").  Images stay host ``NDArray``s, as in ``image.py``.

Labels are ``(N, 5+) [class_id, xmin, ymin, xmax, ymax, ...]`` with
coordinates normalised to [0,1], the reference's SSD convention.
"""
from __future__ import annotations

import random as pyrandom

import numpy as onp

from ..base import MXNetError
from ..ndarray.ndarray import _as_np, _host, array
from .image import ImageIter, imdecode_np, _resize_np


class DetAugmenter:
    """Detection augmenter: ``__call__(src, label) -> (src, label)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [self.__class__.__name__.lower(), self._kwargs]

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only :class:`Augmenter` for detection (label unchanged —
    only safe for color/cast augmenters)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter from a list (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            img = _as_np(src)
            src = _host(img[:, ::-1], img.dtype)
            label = label.copy()
            valid = label[:, 0] >= 0
            xmin = 1.0 - label[valid, 3]
            xmax = 1.0 - label[valid, 1]
            label[valid, 1], label[valid, 3] = xmin, xmax
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop with IoU constraint against ground-truth boxes."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        img = _as_np(src)
        h, w = img.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(w, int(round(onp.sqrt(area * w * h * ratio))))
            ch = min(h, int(round(onp.sqrt(area * w * h / ratio))))
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            crop = (x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h)
            new_label = self._update_labels(label, crop)
            if new_label is not None:
                out = img[y0:y0 + ch, x0:x0 + cw]
                return _host(out, img.dtype), new_label
        return src, label

    def _update_labels(self, label, crop):
        cx0, cy0, cx1, cy1 = crop
        out = []
        for row in label:
            if row[0] < 0:
                continue
            xmin, ymin, xmax, ymax = row[1:5]
            ixmin, iymin = max(xmin, cx0), max(ymin, cy0)
            ixmax, iymax = min(xmax, cx1), min(ymax, cy1)
            iw, ih = max(0.0, ixmax - ixmin), max(0.0, iymax - iymin)
            box_area = max(1e-12, (xmax - xmin) * (ymax - ymin))
            if iw * ih / box_area < self.min_object_covered:
                continue
            nw, nh = cx1 - cx0, cy1 - cy0
            new = row.copy()
            new[1] = (ixmin - cx0) / nw
            new[2] = (iymin - cy0) / nh
            new[3] = (ixmax - cx0) / nw
            new[4] = (iymax - cy0) / nh
            out.append(new)
        if not out:
            return None
        return onp.stack(out)


class DetRandomPadAug(DetAugmenter):
    """Randomly pad (zoom out) with fill value, rescaling boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(area_range=area_range, pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = _as_np(src)
        h, w, c = img.shape
        scale = pyrandom.uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        nw, nh = int(w * onp.sqrt(scale)), int(h * onp.sqrt(scale))
        x0 = pyrandom.randint(0, nw - w)
        y0 = pyrandom.randint(0, nh - h)
        canvas = onp.empty((nh, nw, c), dtype=img.dtype)
        canvas[...] = onp.asarray(self.pad_val, dtype=img.dtype)[:c]
        canvas[y0:y0 + h, x0:x0 + w] = img
        label = label.copy()
        valid = label[:, 0] >= 0
        label[valid, 1] = (label[valid, 1] * w + x0) / nw
        label[valid, 2] = (label[valid, 2] * h + y0) / nh
        label[valid, 3] = (label[valid, 3] * w + x0) / nw
        label[valid, 4] = (label[valid, 4] * h + y0) / nh
        return _host(canvas, img.dtype), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), pad_val=(127, 127, 127),
                       inter_method=2, **kwargs):
    """Build the standard detection augmenter list (reference
    ``CreateDetAugmenter``)."""
    from .image import (CastAug, ColorNormalizeAug, HSVJitterAug,
                        ForceResizeAug)
    auglist = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])))
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), 50, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2], data_shape[1]),
                                               inter_method)))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(HSVJitterAug(brightness, contrast,
                                                 saturation)))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53], dtype=onp.float32)
    if std is True:
        std = onp.array([58.395, 57.12, 57.375], dtype=onp.float32)
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: labels are padded ``(batch, max_objects, 5)``
    tensors (reference ``mx.image.ImageDetIter``)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglst=None, path_root=None, shuffle=False,
                 aug_list=None, data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglst=path_imglst,
                         path_root=path_root, shuffle=shuffle, aug_list=[],
                         data_name=data_name, label_name=label_name,
                         last_batch_handle=last_batch_handle)
        self.det_auglist = aug_list
        self._label_shape = None

    @staticmethod
    def _parse_label(raw):
        """Reference label layout: [header_width, obj_width, ...objects]."""
        raw = onp.asarray(raw, dtype=onp.float32).reshape(-1)
        if raw.size < 2:
            raise MXNetError("invalid detection label")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        body = raw[header_width:]
        n = body.size // obj_width
        return body[:n * obj_width].reshape(n, obj_width)

    def next(self):
        from ..io import DataBatch
        c, h, w = self.data_shape
        batch_data = onp.zeros((self.batch_size, h, w, c), dtype=onp.float32)
        labels = []
        i = 0
        try:
            while i < self.batch_size:
                raw_label, s = self.next_sample()
                img = _host(imdecode_np(s), "uint8")
                label = self._parse_label(raw_label)
                for aug in self.det_auglist:
                    img, label = aug(img, label)
                arr = _as_np(img)
                if arr.shape[:2] != (h, w):
                    arr = _resize_np(arr.astype(onp.uint8), w, h)
                batch_data[i] = arr.astype(onp.float32)
                labels.append(label)
                i += 1
        except StopIteration:
            if i == 0:
                raise
        max_obj = max((l.shape[0] for l in labels), default=1)
        obj_w = labels[0].shape[1] if labels else 5
        batch_label = onp.full((self.batch_size, max_obj, obj_w), -1.0,
                               dtype=onp.float32)
        for j, l in enumerate(labels):
            batch_label[j, :l.shape[0]] = l
        data = array(batch_data.transpose(0, 3, 1, 2), ctx=self._ctx,
                     dtype=self.dtype)
        return DataBatch(data=[data], label=[array(batch_label,
                                                   ctx=self._ctx)],
                         pad=self.batch_size - i)
