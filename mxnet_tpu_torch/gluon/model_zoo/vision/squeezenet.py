"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: the same fire modules
and parameter names; sizes inferred at the first call)."""
from __future__ import annotations

from ....ops.registry import dispatch
from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    """A 1 x 1 squeeze, then 1 x 1 and 3 x 3 expands concatenated."""

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return dispatch("concat", self.expand1x1(x), self.expand3x3(x),
                        dim=1)


# (channels of the stem, its kernel, the fire modules with the max pools
# between them as None)
_SPEC = {"1.0": (96, 7, [(16, 64, 64), (16, 64, 64), (32, 128, 128), None,
                         (32, 128, 128), (48, 192, 192), (48, 192, 192),
                         (64, 256, 256), None, (64, 256, 256)]),
         "1.1": (64, 3, [(16, 64, 64), (16, 64, 64), None, (32, 128, 128),
                         (32, 128, 128), None, (48, 192, 192),
                         (48, 192, 192), (64, 256, 256), (64, 256, 256)])}


class SqueezeNet(HybridBlock):
    """SqueezeNet ``version`` '1.0' or '1.1'."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _SPEC:
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)
        stem, kernel, fires = _SPEC[version]
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(stem, kernel_size=kernel, strides=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                       ceil_mode=True))
        for fire in fires:
            self.features.add(
                nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)
                if fire is None else _Fire(*fire))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, root=None, ctx=None, **kwargs):
    if pretrained:
        load_pretrained("squeezenet1.0")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, root=None, ctx=None, **kwargs):
    if pretrained:
        load_pretrained("squeezenet1.1")
    return SqueezeNet("1.1", **kwargs)
