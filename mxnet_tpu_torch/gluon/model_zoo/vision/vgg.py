"""VGG 11/13/16/19 and their ``_bn`` variants (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: the same layers and
parameter names; sizes inferred at the first call)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """Stages of 3 x 3 convolutions (with BatchNorm when ``batch_norm``),
    each closed by a 2 x 2 max pool, then three dense layers."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("VGG: %d stages of layers, %d of filters"
                             % (len(layers), len(filters)))
        self.features = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], kernel_size=3,
                                            padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(strides=2))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(rate=0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(rate=0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16, 19), built on the ``meta``
    device."""
    layers, filters = vgg_spec[num_layers]
    if pretrained:
        load_pretrained("vgg%d%s" % (num_layers, "_bn" if kwargs.get(
            "batch_norm") else ""))
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
