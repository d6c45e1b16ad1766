"""ResNet v1/v2 model family for the port.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``
(BasicBlockV1, BottleneckV1, BasicBlockV2, BottleneckV2, ResNetV1,
ResNetV2, ``resnet_spec``, ``get_resnet``, resnet18_v1 ... resnet152_v2):
the same blocks and the same structural parameter names
(``features.4.0.body.0.weight``, ``features.1.running_mean``,
``output.weight``).  Every channel count that the reference infers at the
first forward is passed at construction here: each BatchNorm's, the
bottleneck's 1x1 convs' and the stem's 3 input channels.  As in the
reference, BottleneckV1's 1x1 body convs have a bias and every other conv
has none.  A network is built on the ``meta`` device; ``initialize`` or
``load_dict`` puts it on a device (the GPU unless told otherwise).
"""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]

#: the image channels the stem reads
IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    """Two 3x3 convs with BatchNorm, ReLU after the residual sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BottleneckV1(HybridBlock):
    """1x1 (strided) - 3x3 - 1x1 bottleneck, ReLU after the residual
    sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BasicBlockV2(HybridBlock):
    """Pre-activation residual block (He et al. 2016)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
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
    """Pre-activation bottleneck: 1x1 - 3x3 (strided) - 1x1."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                               in_channels=in_channels)
        self.bn2 = nn.BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = nn.BatchNorm(in_channels=mid)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
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


def _stem(features, channels, thumbnail):
    """The 7x7/2 conv, BN, ReLU and 3x3/2 max pool, or with ``thumbnail``
    (CIFAR-sized inputs) one 3x3 conv."""
    if thumbnail:
        features.add(_conv3x3(channels, 1, IMAGE_CHANNELS))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               in_channels=IMAGE_CHANNELS))
        features.add(nn.BatchNorm(in_channels=channels))
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    """ResNet v1: ``layers[i]`` blocks of ``channels[i + 1]`` channels per
    stage, global average pool, ``classes`` outputs."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV1: len(layers) %d != len(channels) - 1 "
                             "%d" % (len(layers), len(channels) - 1))
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], thumbnail)
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(block, num_layer,
                                               channels[i + 1], stride,
                                               in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet v2: an input BatchNorm (no scale, no shift), pre-activation
    stages, BN and ReLU before the pool."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV2: len(layers) %d != len(channels) - 1 "
                             "%d" % (len(layers), len(channels) - 1))
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False,
                                       in_channels=IMAGE_CHANNELS))
        _stem(self.features, channels[0], thumbnail)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(ResNetV1._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(in_channels=in_channels))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


# block type / layer spec tables (reference: resnet_spec)
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


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152).  The port ships no weight store: ``pretrained=True`` raises, as
    the reference does without local weight files; carry weights in with
    :func:`mxnet_tpu_torch.convert.params_from_mxnet_tpu` instead."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2"
                         % version)
    if pretrained:
        load_pretrained("resnet%d_v%d" % (num_layers, version))
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, **kwargs)


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
