"""Vision datasets + transforms (reference
``python/mxnet/gluon/data/vision/``); port of
``mxnet_tpu/gluon/data/vision``."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset,
                       ImageListDataset)
from . import transforms
from . import datasets
