"""Reductions, norms, argmin/argmax, sort, topk and the cumulative ops.

Counterpart of ``mxnet_tpu/ops/reduce.py``.
Half-precision sums and means accumulate in float32 and return the input's
dtype, as the reference's ``_acc_reduce`` does; so does the mean of an
integer or bool array (``jnp.mean`` averages those in float32), which the
cast back truncates toward zero.  Sorts are stable, as ``jnp.argsort``
is; a descending ``sort``/``argsort`` is the ascending one reversed, as
in the reference, so equal entries come highest index first there.
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


def _half_acc(x):
    """float32 for a half-precision x (its accumulator), else None."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else None


@register("sum", aliases=["sum_axis"])
def _sum(x, axis=None, keepdims=False, exclude=False):
    return _reduce(lambda t, dim, keepdim: torch.sum(
        t, dim=dim, keepdim=keepdim, dtype=_half_acc(x)), x, axis, keepdims,
        exclude).to(x.dtype)


@register("mean")
def _mean(x, axis=None, keepdims=False, exclude=False):
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) or \
        not (x.is_floating_point() or x.is_complex()) else None
    return _reduce(lambda t, dim, keepdim: torch.mean(
        t, dim=dim, keepdim=keepdim, dtype=acc), x, axis, keepdims,
        exclude).to(x.dtype)


def _prod_dims(t, dim, keepdim):
    """The product over the dims ``dim`` (torch's ``prod`` takes one): the
    reduced dims are moved last and flattened into one."""
    rest = [d for d in range(t.dim()) if d not in dim]
    flat = t.permute(rest + list(dim)).reshape(
        [t.shape[d] for d in rest] + [-1])
    out = flat.prod(dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dim else t.shape[d]
                           for d in range(t.dim())])
    return out


@register("prod")
def _prod(x, axis=None, keepdims=False, exclude=False):
    acc = _half_acc(x)
    xa = x if acc is None else x.to(acc)
    return _reduce(_prod_dims, xa, axis, keepdims, exclude).to(x.dtype)


@register("nansum")
def _nansum(x, axis=None, keepdims=False, exclude=False):
    acc = _half_acc(x)
    return _reduce(lambda t, dim, keepdim: torch.nansum(
        t, dim=dim, keepdim=keepdim, dtype=acc), x, axis, keepdims,
        exclude).to(x.dtype)


@register("nanprod")
def _nanprod(x, axis=None, keepdims=False, exclude=False):
    """The product with NaN entries taken as 1."""
    acc = _half_acc(x)
    xa = x if acc is None else x.to(acc)
    if xa.is_floating_point():
        xa = torch.where(torch.isnan(xa), torch.ones_like(xa), xa)
    return _reduce(_prod_dims, xa, axis, keepdims, exclude).to(x.dtype)


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


def _arg_index(f, x, axis, keepdims):
    """``f``'s index (torch's argmax or argmin: the first of equal
    entries) along ``axis``, of the flattened array when ``axis`` is None,
    as float32 like MXNet's."""
    if axis is None:
        out = f(x.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = f(x, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax", differentiable=False)
def _argmax(x, axis=None, keepdims=False):
    return _arg_index(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def _argmin(x, axis=None, keepdims=False):
    return _arg_index(torch.argmin, x, axis, keepdims)


@register("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("sort", differentiable=False)
def _sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True)[0]
    return out if is_ascend else out.flip(axis)


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """The stable ascending order's indices, reversed for ``is_ascend``
    False (equal entries highest index first, as the reference's flip of
    ``jnp.argsort`` gives them), in ``dtype``."""
    out = torch.sort(x, dim=axis, stable=True)[1]
    if not is_ascend:
        out = out.flip(axis)
    return out.to(torch_dtype(dtype))


def _cumulative(f, x, axis, dtype):
    """``jnp.cumsum``/``cumprod``: over the flattened array when ``axis``
    is None; an integer type keeps its width and bool counts in int32
    (torch would widen both to int64)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    if dtype is not None:
        dt = torch_dtype(dtype)
    elif x.dtype == torch.bool:
        dt = torch.int32
    else:
        dt = x.dtype
    return f(x, dim=axis, dtype=dt)


@register("cumsum")
def _cumsum(x, axis=None, dtype=None):
    return _cumulative(torch.cumsum, x, axis, dtype)


@register("cumprod")
def _cumprod(x, axis=None, dtype=None):
    return _cumulative(torch.cumprod, x, axis, dtype)


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
