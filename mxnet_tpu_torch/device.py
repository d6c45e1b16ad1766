"""Devices of the PyTorch port.

Counterpart of ``mxnet_tpu/device.py``.  The JAX package's first-class
accelerator context ``mx.tpu(i)`` maps to the GPU: :func:`gpu` names
``torch.device("cuda", i)`` and is the default device of every entry point.
Only an explicit CPU device (``device="cpu"``) runs on the CPU; asking for
the GPU on a machine without one raises rather than moving to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve"]

DeviceLike = Union[str, torch.device, None]


def cpu() -> torch.device:
    return torch.device("cpu")


def gpu(i: int = 0) -> torch.device:
    return torch.device("cuda", int(i))


def default_device() -> torch.device:
    """The device an entry point uses when none is given: the GPU."""
    return gpu(0)


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (default: :func:`default_device`).
    Raises :class:`MXNetError` for a CUDA device when CUDA is unavailable."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "device %s requested%s but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
                % (dev, " (the default)" if device is None else ""))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cpu or cuda)" % dev)
    return dev
