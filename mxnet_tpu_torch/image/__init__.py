"""``mx.image`` — image decode, resize/crop/color augmenters, ImageIter.

Port of ``mxnet_tpu/image`` (reference ``python/mxnet/image/image.py`` +
``image/detection.py``).  Decode and augmentation run on the host, in
numpy and in host ``NDArray``s; a batch reaches the card once.
"""
from .image import (imdecode, imdecode_np, imencode, imread, imresize,
                    resize_short, fixed_crop, center_crop, random_crop,
                    random_size_crop, color_normalize, HSVJitterAug,
                    Augmenter, ResizeAug, ForceResizeAug, RandomCropAug,
                    CenterCropAug, RandomSizedCropAug, HorizontalFlipAug,
                    CastAug, ColorNormalizeAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, LightingAug,
                    ColorJitterAug, CreateAugmenter, ImageIter, backends)
from .detection import (DetBorrowAug, DetRandomSelectAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug, CreateDetAugmenter,
                        ImageDetIter)
