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


@register("_linspace", aliases=["linspace_op"], differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype=None,
              device=None):
    """``num`` evenly spaced values from ``start``; the last is ``stop``
    with ``endpoint``, else one step short of it."""
    num = int(num)
    div = num - 1 if endpoint else num
    out = torch.linspace(start, stop if endpoint or num == 0
                         else start + (stop - start) * (num - 1) / div,
                         num, dtype=torch.float64, device=device)
    return out.to(_dtype(dtype))


@register("_eye", aliases=["eye_op"], differentiable=False)
def _eye(N=1, M=0, k=0, dtype=None, device=None):
    """An N x M (N x N when M is 0) matrix of ones on the k-th diagonal."""
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(m, device=device)[None, :]
    return (cols - rows == int(k)).to(_dtype(dtype))
