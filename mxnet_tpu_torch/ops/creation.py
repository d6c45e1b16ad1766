"""Creation ops: arrays made from a shape and a value, with no array input.

Counterpart of the matching entries of ``mxnet_tpu/ops/creation.py``.  An
op with no array input gets its output device from dispatch as ``device``
(``ndarray.invoke`` resolves ``ctx=``, else the current context).  The
dtype defaults to float32, as in the reference.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _dtype(dtype):
    return torch.float32 if dtype is None else torch_dtype(dtype)


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


@register("_zeros", aliases=["zeros_op"], differentiable=False)
def _zeros(shape=(), dtype=None, device=None):
    return torch.zeros(_shape(shape), dtype=_dtype(dtype), device=device)


@register("_ones", aliases=["ones_op"], differentiable=False)
def _ones(shape=(), dtype=None, device=None):
    return torch.ones(_shape(shape), dtype=_dtype(dtype), device=device)


@register("_full", aliases=["full_op"], differentiable=False)
def _full(shape=(), value=0.0, dtype=None, device=None):
    return torch.full(_shape(shape), value, dtype=_dtype(dtype),
                      device=device)


@register("_arange", aliases=["arange_op"], differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype=None,
            device=None):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=_dtype(dtype), device=device)
    return torch.repeat_interleave(out, int(repeat)) if repeat != 1 else out
