"""SqueezeNet 1.0 and 1.1 (Iandola et al. 2016), port of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: the reference's
layers in its name scopes.  Its ``MaxPool2D(3, 2, ceil_mode=True)`` pools
take the "full" convention (``gluon/nn/conv_layers.py``), so the last
map is 13 x 13 at 224².  NCHW only; ``pretrained=True`` raises."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from .resnet import _no_store

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError("squeezenet version must be '1.0' or '1.1'")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, **kwargs):
    _no_store(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, **kwargs):
    _no_store(pretrained)
    return SqueezeNet("1.1", **kwargs)
