"""The deterministic demo models of the serving tests and smokes.

Counterpart of ``mxnet_tpu/serve/demo.py``: the same shapes, seeds and
entry points.  Both sides of a run build the model on their own (the
replicas host it, a load generator recomputes the expected outputs), so an
answer's correctness, not just its arrival, is assertable across
processes.  The port draws its initial weights from its own generators,
so they are not the reference's; a test that holds the two packages to
one model copies the reference's parameters in by name
(``convert.params_from_mxnet_tpu``).  The decode demo model is
:func:`~mxnet_tpu_torch.serve.decode.demo_lm_params`, seeded with numpy,
so both packages build the same weights there.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..device import DeviceLike, resolve

DEMO_SEED = 42
DEMO_IN = 16
DEMO_HIDDEN = 32
DEMO_OUT = 8


def demo_block(device: DeviceLike = None):
    """The demo MLP: 16 -> 32 (relu) -> 8, Xavier from seed 42, on
    ``device`` (default: the GPU).  A ``HybridSequential``, as in the
    reference."""
    from .. import initializer
    from ..gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(DEMO_HIDDEN, in_units=DEMO_IN, activation="relu"))
    net.add(nn.Dense(DEMO_OUT, in_units=DEMO_HIDDEN))
    net.initialize(initializer.Xavier(), device=resolve(device),
                   seed=DEMO_SEED)
    return net


def demo_example(rows: int = 1) -> list:
    """A warm/probe input batch of the demo signature."""
    return [_np.zeros((rows, DEMO_IN), _np.float32)]


# The conv demo: a real convnet, for the serving paths whose cost is the
# model's, not the host's.  Seeded like the MLP.
DEMO_CONV_SHAPE = (3, 64, 64)
DEMO_CONV_CLASSES = 100


def demo_conv_block(device: DeviceLike = None):
    """Seeded resnet18 at 3x64x64 -> 100 classes, on ``device``."""
    from .. import initializer
    from ..gluon.model_zoo import vision
    net = vision.resnet18_v1(classes=DEMO_CONV_CLASSES)
    net.initialize(initializer.Xavier(), device=resolve(device),
                   seed=DEMO_SEED)
    return net


def demo_conv_example(rows: int = 1) -> list:
    return [_np.zeros((rows,) + DEMO_CONV_SHAPE, _np.float32)]


def demo_requests(n: int, rows: int = 1, seed: int = 0) -> list:
    """Deterministic request stream: n single-input requests (the
    reference's draws, from numpy)."""
    rng = _np.random.RandomState(seed)
    return [[rng.randn(rows, DEMO_IN).astype(_np.float32)]
            for _ in range(n)]


def demo_expected(x: _np.ndarray, net=None,
                  device: DeviceLike = None) -> _np.ndarray:
    """The demo block's forward on ``x`` (local, eager): what a correct
    replica answers.  Pass ``net`` to reuse one block; the forward runs
    on that block's device."""
    if net is None:
        net = demo_block(device)
    dev = next(net.parameters()).device
    with torch.no_grad():
        out = net(torch.as_tensor(_np.asarray(x, _np.float32), device=dev))
    return out.detach().cpu().numpy()
