"""Weight initializers over an explicit ``torch.Generator``.

Counterpart of ``mxnet_tpu/initializer.py``.  An initializer is called
with a parameter's structural name and its tensor and dispatches on the
name's suffix as the JAX package does: ``*weight`` (and anything not
listed) draws from the initializer, ``*bias``, ``*beta`` and
``*running_mean`` / ``*moving_mean`` (and ``*moving_inv_var``,
``*moving_avg``) are zero, ``*gamma`` and
``*running_var`` / ``*moving_var`` are one.  The JAX package draws from
``jax.random`` and PyTorch cannot reproduce those bits; tests carry
parameters across by name (:mod:`mxnet_tpu_torch.convert`) instead of
seeding both.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "create"]


class Initializer:
    """Base initializer: ``init(name, tensor, generator)`` fills in place."""

    @torch.no_grad()
    def __call__(self, name: str, arr: torch.Tensor,
                 generator: torch.Generator) -> None:
        lname = name.lower()
        if lname.endswith(("bias", "beta", "running_mean", "moving_mean",
                           "moving_inv_var", "moving_avg")):
            arr.zero_()
        elif lname.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("%s does not define _init_weight"
                                  % type(self).__name__)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, ", ".join(
            "%s=%r" % kv for kv in sorted(vars(self).items())))


class Zero(Initializer):
    """Zeros."""

    def _init_weight(self, name, arr, generator):
        arr.zero_()


class One(Initializer):
    """Ones."""

    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


class Constant(Initializer):
    """A given value, broadcast to the parameter's shape (``Constant``'s
    value, or a number)."""

    def __init__(self, value):
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(np.asarray(self.value)).to(arr.dtype)
                  .broadcast_to(arr.shape))


class Uniform(Initializer):
    """U(-scale, scale); the default initializer (scale 0.07)."""

    def __init__(self, scale: float = 0.07):
        self.scale = float(scale)

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma: float = 0.01):
        self.sigma = float(sigma)

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor) with factor the
    average, fan-in or fan-out of the weight; uniform or gaussian."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3):
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("Unknown random type %r" % rnd_type)
        if factor_type not in ("avg", "in", "out"):
            raise ValueError("Incorrect factor type %r" % factor_type)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires at least 2D weight, got %s for "
                             "%s" % (tuple(shape), name))
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)


def create(init) -> Initializer:
    """An initializer from an instance or a name ('uniform', 'normal',
    'xavier', 'zeros', 'ones'); None gives the default :class:`Uniform`."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        table = {"uniform": Uniform, "normal": Normal, "xavier": Xavier,
                 "zeros": Zero, "zero": Zero, "ones": One, "one": One}
        if init.lower() in table:
            return table[init.lower()]()
    raise ValueError("unknown initializer %r" % (init,))
