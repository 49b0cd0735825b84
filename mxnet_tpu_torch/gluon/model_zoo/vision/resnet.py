"""ResNet v1 and v2.

Port of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``, whole: v1 (He et
al. 2015, post-activation, the stride on the first convolution of a
block) and v2 (He et al. 2016, pre-activation), basic and bottleneck
blocks, ``thumbnail`` (a 3x3 stem for 32x32 inputs), ``layout``,
``get_resnet`` and the ten presets.  ``layout="NHWC"`` keeps the NCHW
input contract and runs the whole feature stack channels-last after one
transpose at the stem (BatchNorm over axis -1); there every 1x1
stride-1 convolution may take the fused backward K6
(``MXNET_FUSED_CONV_BWD=1``).

The reference infers the input channels of several layers from the
first forward; the port gives every layer its size when it is built
(images have 3 channels).  Layers are built in the reference's order,
so ``models/convert.py`` can name the parameters as the reference does.
Every layer is created on ``device`` (``cuda:0`` by default) in
``dtype``.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "get_resnet"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, layout, **dev):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout,
                     **dev)


def _bn_axis(layout):
    # BatchNorm normalizes the C axis wherever the layout puts it
    return 1 if layout[1] == "C" else -1


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout, **dev))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, **dev))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels, **dev))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout, **dev))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                             **dev))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        ax = _bn_axis(layout)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                layout=layout, in_channels=in_channels,
                                **dev))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout, **dev))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout, in_channels=mid, **dev))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels, **dev))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout, **dev))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                             **dev))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax, in_channels=in_channels, **dev)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, **dev)
        self.bn2 = nn.BatchNorm(axis=ax, in_channels=channels, **dev)
        self.conv2 = _conv3x3(channels, 1, channels, layout, **dev)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout, **dev)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, dtype=None):
        super().__init__()
        dev = dict(device=device, dtype=dtype)
        ax = _bn_axis(layout)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(axis=ax, in_channels=in_channels, **dev)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1,
                               use_bias=False, layout=layout,
                               in_channels=in_channels, **dev)
        self.bn2 = nn.BatchNorm(axis=ax, in_channels=mid, **dev)
        self.conv2 = _conv3x3(mid, stride, mid, layout, **dev)
        self.bn3 = nn.BatchNorm(axis=ax, in_channels=mid, **dev)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout,
                               in_channels=mid, **dev)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout, **dev)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        x = self.conv3(x)
        return x + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels,
                layout, dev):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout, **dev))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout, **dev))
    return layer


def _stem(features, channels, thumbnail, layout, ax, dev):
    if thumbnail:
        features.add(_conv3x3(channels, 1, _IMAGE_CHANNELS, layout, **dev))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               in_channels=_IMAGE_CHANNELS, layout=layout,
                               **dev))
        features.add(nn.BatchNorm(axis=ax, in_channels=channels, **dev))
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1, layout=layout))


class ResNetV1(HybridBlock):
    """``layout="NHWC"`` runs the feature stack channels-last while
    keeping the NCHW input contract: one transpose at the stem."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, dtype=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNet: len(layers) must be "
                             "len(channels) - 1")
        dev = dict(device=device, dtype=dtype)
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        _stem(self.features, channels[0], thumbnail, layout, ax, dev)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, i + 1,
                channels[i], layout, dev))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1], **dev)

    def forward(self, x):
        if self._layout == "NHWC":
            x = x.permute(0, 2, 3, 1)
        x = self.features(x)
        return self.output(x.reshape(x.shape[0], -1))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, dtype=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNet: len(layers) must be "
                             "len(channels) - 1")
        dev = dict(device=device, dtype=dtype)
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.BatchNorm(scale=False, center=False, axis=ax,
                                       in_channels=_IMAGE_CHANNELS, **dev))
        _stem(self.features, channels[0], thumbnail, layout, ax, dev)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, i + 1,
                in_channels, layout, dev))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax, in_channels=in_channels,
                                       **dev))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels, **dev)

    def forward(self, x):
        if self._layout == "NHWC":
            x = x.permute(0, 2, 3, 1)
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """The reference's ``get_resnet``; ``kwargs`` go to the net
    (``classes``, ``thumbnail``, ``layout``, ``device``, ``dtype``).
    There is no model store in the port: ``pretrained=True`` raises."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    if pretrained:
        raise MXNetError("pretrained weights: the port has no model store; "
                         "carry weights with models.resnet_from_mxnet_tpu")
    block_type, layers, channels = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    block_cls = resnet_block_versions[version - 1][block_type]
    return net_cls(block_cls, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
