"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``:
the same layers and parameter names; the sizes the reference infers at
the first call are inferred here too)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import load_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """Five convolutions, three max pools and three dense layers."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """AlexNet, built on the ``meta`` device."""
    if pretrained:
        load_pretrained("alexnet")
    return AlexNet(**kwargs)
