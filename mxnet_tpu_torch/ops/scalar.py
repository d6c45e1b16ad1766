"""Scalar-operand elementwise ops (the reference's ``_plus_scalar`` family).

Counterpart of ``mxnet_tpu/ops/scalar.py``.  ``NDArray`` arithmetic with a
Python number dispatches here.  As in the reference, the scalar takes the
data's type first (``jnp.asarray(scalar, data.dtype)``): truncated for an
integer tensor, rounded for a half-precision one.  Integer powers and
remainders follow the reference's (``elemwise.power``, ``elemwise.mod``).
A comparison gives 0/1 in the data's own dtype (an integer tensor gives
integers, unlike ``broadcast_equal``'s float32); the logical ops read the
scalar's truth as given (0.5 is true even for an integer tensor).
"""
from __future__ import annotations

import torch

from .elemwise import hypot, mod, power
from .registry import register


def _typed(scalar, data: torch.Tensor):
    """``scalar`` in data's dtype, as a Python number (no device copy)."""
    if data.dtype == torch.bool:
        return bool(scalar)
    if not data.is_floating_point():
        return int(scalar)
    if data.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(float(scalar), dtype=data.dtype))
    return float(scalar)


@register("_plus_scalar", aliases=["plus_scalar"])
def _plus_scalar(data, scalar=0.0):
    return data + _typed(scalar, data)


@register("_minus_scalar", aliases=["minus_scalar"])
def _minus_scalar(data, scalar=0.0):
    return data - _typed(scalar, data)


@register("_rminus_scalar", aliases=["rminus_scalar"])
def _rminus_scalar(data, scalar=0.0):
    return _typed(scalar, data) - data


@register("_mul_scalar", aliases=["mul_scalar"])
def _mul_scalar(data, scalar=1.0):
    return data * _typed(scalar, data)


@register("_div_scalar", aliases=["div_scalar"])
def _div_scalar(data, scalar=1.0):
    return data / _typed(scalar, data)


@register("_rdiv_scalar", aliases=["rdiv_scalar"])
def _rdiv_scalar(data, scalar=1.0):
    return _typed(scalar, data) / data


@register("_mod_scalar", aliases=["mod_scalar"], differentiable=False)
def _mod_scalar(data, scalar=1.0):
    return mod(data, _typed(scalar, data))


@register("_rmod_scalar", aliases=["rmod_scalar"], differentiable=False)
def _rmod_scalar(data, scalar=1.0):
    return mod(torch.full_like(data, _typed(scalar, data)), data)


@register("_power_scalar", aliases=["power_scalar"])
def _power_scalar(data, scalar=1.0):
    return power(data, _typed(scalar, data))


@register("_rpower_scalar", aliases=["rpower_scalar"])
def _rpower_scalar(data, scalar=1.0):
    return power(_typed(scalar, data), data)


def _full(scalar, data):
    """The typed scalar as a tensor of data's shape, dtype and device."""
    return torch.full_like(data, _typed(scalar, data))


@register("_maximum_scalar", aliases=["maximum_scalar"])
def _maximum_scalar(data, scalar=0.0):
    # torch.maximum, not clamp: a tie's gradient is halved, as jnp's
    return torch.maximum(data, _full(scalar, data))


@register("_minimum_scalar", aliases=["minimum_scalar"])
def _minimum_scalar(data, scalar=0.0):
    return torch.minimum(data, _full(scalar, data))


@register("_hypot_scalar", aliases=["hypot_scalar"])
def _hypot_scalar(data, scalar=0.0):
    return hypot(data, _full(scalar, data))


def _compare(f):
    def cmp(data, scalar=0.0):
        return f(data, _typed(scalar, data)).to(data.dtype)
    return cmp


def _logical(f):
    def op(data, scalar=0.0):
        return f(data, torch.tensor(bool(scalar), device=data.device)) \
            .to(data.dtype)
    return op


for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("greater", torch.gt), ("greater_equal", torch.ge),
                   ("lesser", torch.lt), ("lesser_equal", torch.le)):
    register("_%s_scalar" % _name, _compare(_fn), differentiable=False,
             aliases=["%s_scalar" % _name])

for _name, _fn in (("and", torch.logical_and), ("or", torch.logical_or),
                   ("xor", torch.logical_xor)):
    register("_logical_%s_scalar" % _name, _logical(_fn),
             differentiable=False, aliases=["logical_%s_scalar" % _name])


@register("smooth_l1_scalar", aliases=["_smooth_l1_scalar"])
def _smooth_l1_scalar(data, scalar=1.0):
    """``smooth_l1`` with sigma squared in data's dtype, as the reference
    computes it here (``elemwise.smooth_l1`` squares the Python float)."""
    s2 = torch.tensor(_typed(scalar, data), dtype=data.dtype,
                      device=data.device) ** 2
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)
