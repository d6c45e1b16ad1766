"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``: the same branch
blocks A-E and parameter names; sizes inferred at the first call).
``pretrained=True`` raises ``FileNotFoundError``, as the other builders
do (the reference's raises ``NameError`` before it reaches its store)."""
from __future__ import annotations

from ....ops.registry import dispatch
from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel_size, strides, padding,
                      use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Branches run on one input, their outputs concatenated on the
    channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        for i, b in enumerate(branches):
            self.register_child(b, str(i))

    def forward(self, x):
        return dispatch("concat", *[b(x) for b in self._modules.values()],
                        dim=1)


def _seq(*blocks):
    out = nn.HybridSequential()
    out.add(*blocks)
    return out


def _make_A(pool_features):
    return _Branches([
        _conv(64, 1),
        _seq(_conv(48, 1), _conv(64, 5, padding=2)),
        _seq(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, padding=1)),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1),
             _conv(pool_features, 1)),
    ])


def _make_B():
    return _Branches([
        _conv(384, 3, strides=2),
        _seq(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, strides=2)),
        _seq(nn.MaxPool2D(pool_size=3, strides=2)),
    ])


def _make_C(channels_7x7):
    c = channels_7x7
    return _Branches([
        _conv(192, 1),
        _seq(_conv(c, 1), _conv(c, (1, 7), padding=(0, 3)),
             _conv(192, (7, 1), padding=(3, 0))),
        _seq(_conv(c, 1), _conv(c, (7, 1), padding=(3, 0)),
             _conv(c, (1, 7), padding=(0, 3)),
             _conv(c, (7, 1), padding=(3, 0)),
             _conv(192, (1, 7), padding=(0, 3))),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1), _conv(192, 1)),
    ])


def _make_D():
    return _Branches([
        _seq(_conv(192, 1), _conv(320, 3, strides=2)),
        _seq(_conv(192, 1), _conv(192, (1, 7), padding=(0, 3)),
             _conv(192, (7, 1), padding=(3, 0)), _conv(192, 3, strides=2)),
        _seq(nn.MaxPool2D(pool_size=3, strides=2)),
    ])


def _make_E():
    return _Branches([
        _conv(320, 1),
        _seq(_conv(384, 1),
             _Branches([_conv(384, (1, 3), padding=(0, 1)),
                        _conv(384, (3, 1), padding=(1, 0))])),
        _seq(_conv(448, 1), _conv(384, 3, padding=1),
             _Branches([_conv(384, (1, 3), padding=(0, 1)),
                        _conv(384, (3, 1), padding=(1, 0))])),
        _seq(nn.AvgPool2D(pool_size=3, strides=1, padding=1), _conv(192, 1)),
    ])


class Inception3(HybridBlock):
    """Inception V3 for 299 x 299 inputs."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(_conv(32, 3, strides=2))
        self.features.add(_conv(32, 3))
        self.features.add(_conv(64, 3, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_conv(80, 1))
        self.features.add(_conv(192, 3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Inception V3, built on the ``meta`` device."""
    if pretrained:
        load_pretrained("inceptionv3")
    return Inception3(**kwargs)
