"""Elementwise binary (broadcasting) and unary ops.

Counterpart of the matching entries of ``mxnet_tpu/ops/elemwise.py``, on
``torch.Tensor``s.  Only the ops the imperative front end's users call are
registered here; the rest of the reference's table is later work.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _int_operands(a, b):
    """(a, b) as tensors of their integer result type on one device, or
    None when the result type is not an integer one."""
    dt = torch.result_type(a, b)
    if dt.is_floating_point or dt.is_complex or dt == torch.bool:
        return None
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    return (torch.as_tensor(a, dtype=dt, device=dev),
            torch.as_tensor(b, dtype=dt, device=dev))


def power(a, b):
    """``jnp.power``: on integers the reference's binary exponentiation
    over the low six bits of the exponent (jnp's ``_pow_int_int``), the
    products wrapping in the integer type, so a negative exponent gives the
    wrapped power of its low bits (``torch.pow`` raises or gives 0) and
    0 ** e = 0 for e != 0; ``torch.pow`` otherwise."""
    ints = _int_operands(a, b)
    if ints is None:
        return torch.pow(a, b)
    a, b = torch.broadcast_tensors(*ints)
    acc = torch.where((a == 0) & (b != 0), 0, 1).to(a.dtype)
    for _ in range(6):
        acc = torch.where((b & 1) != 0, acc * a, acc)
        a = a * a
        b = b >> 1          # the low bits shift alike, arithmetic or not
    return acc


def mod(a, b):
    """``jnp.mod``: the remainder takes the divisor's sign (as
    ``torch.remainder``); an integer divisor of 0 gives 0, as the reference
    divides by 1 there, where torch raises."""
    ints = _int_operands(a, b)
    if ints is not None:
        a, b = ints
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.remainder(a, b)


_BINARY = {
    "broadcast_add": (torch.add, ["elemwise_add", "_plus", "_add"]),
    "broadcast_sub": (torch.sub, ["elemwise_sub", "_minus", "_sub"]),
    "broadcast_mul": (torch.mul, ["elemwise_mul", "_mul"]),
    "broadcast_div": (torch.true_divide, ["elemwise_div", "_div"]),
    "broadcast_mod": (mod, ["_mod"]),
    "broadcast_power": (power, ["_power", "pow"]),
}

for _name, (_fn, _aliases) in _BINARY.items():
    register(_name, _fn, aliases=_aliases)

_COMPARE = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
}


def _comparison(f):
    def cmp(a, b):
        """MXNet comparisons return 0/1 in a's float type (float32 for
        integer inputs), not bool."""
        want = a.dtype if a.is_floating_point() else torch.float32
        return f(a, b).to(want)
    return cmp


for _name, _fn in _COMPARE.items():
    register(_name, _comparison(_fn), differentiable=False,
             aliases=[_name.replace("broadcast_", "")])

_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "sin": torch.sin,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,        # gradient 0 at x == 0, as the reference's
}

for _name, _fn in _UNARY.items():
    register(_name, _fn)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@register("cast", aliases=["Cast"])
def _cast(x, dtype="float32"):
    """``x`` in ``dtype``.  A floating-point x cast to an integer type
    saturates, NaN giving 0, as the reference's conversion does (-1.7 to
    uint8 is 0, 300.2 is 255); torch's conversion wraps there.  The bounds
    are applied in float64, which holds every int32 bound exactly."""
    dt = torch_dtype(dtype)
    if x.is_floating_point() and not (dt.is_floating_point or dt.is_complex
                                      or dt == torch.bool):
        info = torch.iinfo(dt)
        x = x.double().nan_to_num(0.0, posinf=info.max, neginf=info.min) \
            .clamp(info.min, info.max)
    return x.to(dt)
