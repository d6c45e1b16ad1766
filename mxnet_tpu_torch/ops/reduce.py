"""Reductions, norms, argmax and topk.

Counterpart of the matching entries of ``mxnet_tpu/ops/reduce.py``.
Half-precision sums and means accumulate in float32 and return the input's
dtype, as the reference's ``_acc_reduce`` does; so does the mean of an
integer or bool array (``jnp.mean`` averages those in float32), which the
cast back truncates toward zero.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _axes(x, axis, exclude=False):
    """``axis`` (None, int or sequence) as a tuple of dims, or None for
    all; ``exclude`` reduces over every other axis."""
    if axis is None:
        return None
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % x.dim() for a in ax)
    if exclude:
        ax = tuple(i for i in range(x.dim()) if i not in ax)
    return ax


def _reduce(fn, x, axis, keepdims, exclude):
    dims = _axes(x, axis, exclude)
    if dims is None:
        dims = tuple(range(x.dim()))
    if not dims:
        return x
    return fn(x, dim=dims, keepdim=keepdims)


@register("sum", aliases=["sum_axis"])
def _sum(x, axis=None, keepdims=False, exclude=False):
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else None
    return _reduce(lambda t, dim, keepdim: torch.sum(
        t, dim=dim, keepdim=keepdim, dtype=acc), x, axis, keepdims,
        exclude).to(x.dtype)


@register("mean")
def _mean(x, axis=None, keepdims=False, exclude=False):
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) or \
        not (x.is_floating_point() or x.is_complex()) else None
    return _reduce(lambda t, dim, keepdim: torch.mean(
        t, dim=dim, keepdim=keepdim, dtype=acc), x, axis, keepdims,
        exclude).to(x.dtype)


@register("max", aliases=["max_axis"])
def _max(x, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amax, x, axis, keepdims, exclude)


@register("min", aliases=["min_axis"])
def _min(x, axis=None, keepdims=False, exclude=False):
    return _reduce(torch.amin, x, axis, keepdims, exclude)


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    """The L1 (``ord`` 1) or L2 norm over ``axis`` (all axes when None),
    half precision accumulated in float32, in x's dtype."""
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype
    xf = x.to(acc)
    dims = _axes(x, axis)
    dims = tuple(range(x.dim())) if dims is None else dims
    if ord == 1:
        out = xf.abs().sum(dim=dims, keepdim=keepdims)
    else:
        out = torch.sqrt(xf.square().sum(dim=dims, keepdim=keepdims))
    return out.to(x.dtype)


@register("L2Normalization")
def _l2_normalization(x, eps=1e-10, mode="instance"):
    """x over ``sqrt(sum(x^2) + eps)``, the sum over every axis but the
    first ('instance'), over axis 1 ('channel') or over the axes after
    the second ('spatial')."""
    if mode == "instance":
        dims = tuple(range(1, x.dim()))
    elif mode == "channel":
        dims = (1,)
    else:
        dims = tuple(range(2, x.dim()))
    return x / torch.sqrt(x.square().sum(dim=dims, keepdim=True) + eps)


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims=False):
    """Index of the largest entry (of the flattened array when ``axis``
    is None), as float32 like MXNet's."""
    if axis is None:
        out = torch.argmax(x.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = torch.argmax(x, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("topk", differentiable=False)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The k largest (smallest with ``is_ascend``) entries along ``axis``:
    their indices (in ``dtype``), values, both, or a 0/1 mask of x's
    shape.  Equal entries come lowest index first, as the reference's
    ``lax.top_k`` orders them (``torch.topk`` leaves their order open): a
    stable descending sort of x (of -x with ``is_ascend``, as the reference
    negates), cut to k."""
    if axis is None:
        x = x.reshape(-1)
        axis = -1
    src = -x if is_ascend else x
    idx = torch.sort(src, dim=axis, descending=True, stable=True)[1] \
        .narrow(axis, 0, int(k))
    vals = torch.gather(x, axis, idx)
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1.0)
    raise ValueError("unknown ret_typ %r" % ret_typ)
