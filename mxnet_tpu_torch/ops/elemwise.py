"""Elementwise binary (broadcasting) and unary ops.

Counterpart of the matching entries of ``mxnet_tpu/ops/elemwise.py``, on
``torch.Tensor``s.  Only the ops the imperative front end's users call are
registered here; the rest of the reference's table is later work.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

_BINARY = {
    "broadcast_add": (torch.add, ["elemwise_add", "_plus", "_add"]),
    "broadcast_sub": (torch.sub, ["elemwise_sub", "_minus", "_sub"]),
    "broadcast_mul": (torch.mul, ["elemwise_mul", "_mul"]),
    "broadcast_div": (torch.true_divide, ["elemwise_div", "_div"]),
    # jnp.mod: the result takes the divisor's sign, as torch.remainder
    "broadcast_mod": (torch.remainder, ["_mod"]),
    "broadcast_power": (torch.pow, ["_power", "pow"]),
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
    return x.to(torch_dtype(dtype))
