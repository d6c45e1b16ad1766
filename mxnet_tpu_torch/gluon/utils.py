"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference:
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load`` and
``clip_global_norm``.  ``check_sha1`` and ``download`` are not ported:
the port fetches nothing.
"""
from __future__ import annotations

import math
import warnings
from typing import List

from ..device import Context
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """Split ``data`` along ``batch_axis`` into ``num_slice`` slices (the
    last takes the remainder; fewer than ``num_slice`` samples give one
    slice each)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's a multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    if not even_split and size < num_slice:
        num_slice = size
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list: List[Context], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Split ``data`` (an NDArray or anything ``nd.array`` takes) and put
    each slice on its context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a host sync)."""
    if not arrays:
        raise ValueError("arrays must not be empty")

    def _norm(a):
        x = a.reshape(-1)
        return (x * x).sum()

    total = _norm(arrays[0])
    for a in arrays[1:]:
        total = total + _norm(a)
    total_norm = float(total.sqrt().asscalar())
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total_norm
