"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: the same dense layers,
transitions and parameter names; sizes inferred at the first call).
``pretrained=True`` raises ``FileNotFoundError``, as the other builders
do (the reference's raises ``NameError`` before it reaches its store)."""
from __future__ import annotations

from ....ops.registry import dispatch
from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-ReLU-1x1 conv, BN-ReLU-3x3 conv; the input and the new
    ``growth_rate`` channels concatenated."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return dispatch("concat", x, self.body(x), dim=1)


class _Transition(HybridBlock):
    """BN-ReLU-1x1 conv to ``num_output_features``, then a 2 x 2 average
    pool."""

    def __init__(self, num_output_features, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(num_output_features, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.AvgPool2D(pool_size=2, strides=2))

    def forward(self, x):
        return self.body(x)


class DenseNet(HybridBlock):
    """A stem, dense blocks of ``block_config`` layers with transitions
    between them, and a dense classifier."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                    strides=2, padding=3, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            block = nn.HybridSequential()
            for _ in range(num_layers):
                block.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(block)
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(_Transition(num_features // 2))
                num_features = num_features // 2
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


# (init_features, growth_rate, block_config)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _get(num_layers, pretrained, ctx=None, root=None, **kwargs):
    if pretrained:
        load_pretrained("densenet%d" % num_layers)
    init_f, growth, config = densenet_spec[num_layers]
    return DenseNet(init_f, growth, config, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _get(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _get(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _get(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _get(201, pretrained, **kwargs)
