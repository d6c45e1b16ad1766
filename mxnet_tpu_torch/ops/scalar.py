"""Scalar-operand elementwise ops (the reference's ``_plus_scalar`` family).

Counterpart of ``mxnet_tpu/ops/scalar.py``.  ``NDArray`` arithmetic with a
Python number dispatches here.  As in the reference, the scalar takes the
data's type first (``jnp.asarray(scalar, data.dtype)``): truncated for an
integer tensor, rounded for a half-precision one.  Integer powers and
remainders follow the reference's (``elemwise.power``, ``elemwise.mod``).
"""
from __future__ import annotations

import torch

from .elemwise import mod, power
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
