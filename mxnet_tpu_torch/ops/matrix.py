"""Matrix product, shape and indexing ops.

Counterpart of the matching entries of ``mxnet_tpu/ops/matrix.py``.  The
matrix product stays with PyTorch's library kernel, as the JAX package left
it to XLA.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """MXNet ``dot``: contract a's last axis with b's first, after swapping
    the last two axes of a (b) when ``transpose_a`` (``transpose_b``)."""
    if transpose_a and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_b and b.dim() > 1:
        b = b.transpose(-1, -2)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("transpose")
def _transpose(x, axes=None):
    axes = tuple(axes) if axes else tuple(reversed(range(x.dim())))
    return x.permute(axes)


@register("swapaxes", aliases=["SwapAxis"])
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


def infer_reshape(old_shape, new_shape):
    """MXNet reshape codes: 0 keeps the input's extent at that position,
    -1 is inferred."""
    out = [old_shape[i] if d == 0 else int(d) for i, d in enumerate(new_shape)]
    if out.count(-1) > 1:
        raise ValueError("can only specify one unknown dimension")
    if -1 in out:
        known, total = 1, 1
        for d in out:
            if d != -1:
                known *= d
        for d in old_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("reshape", aliases=["Reshape"])
def _reshape(x, shape=None, reverse=False):
    return x.reshape(infer_reshape(tuple(x.shape), shape))


@register("flatten", aliases=["Flatten"])
def _flatten(x):
    return x.reshape(x.shape[0], -1) if x.dim() > 1 else x


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def _squeeze(x, axis=None):
    """Drop size-1 axes: all of them, or those of ``axis``, each of which
    must have size 1 (``torch.squeeze`` would keep a larger one; the
    reference raises, as here)."""
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError("cannot select an axis to squeeze out which has "
                         "size not equal to one, got shape=%s and "
                         "dimensions=%s" % (tuple(x.shape), axes))
    return x.squeeze(axes)


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    tgt = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return x.expand(tgt)


@register("broadcast_axis", aliases=["broadcast_axes"])
def _broadcast_axis(x, axis=None, size=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt))


@register("concat", aliases=["Concat"])
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=dim)


@register("stack")
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=axis)


@register("split", aliases=["SliceChannel"], num_outputs=0)
def _split(x, num_outputs=2, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise ValueError("split: axis %d of extent %d does not divide into "
                         "%d" % (axis, x.shape[axis], num_outputs))
    parts = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    """``jnp.repeat``: each entry ``repeats`` times, over the flattened
    array when ``axis`` is None."""
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, left, right, mode, device):
    """Source indices of an axis of extent ``n`` padded by (left, right):
    the nearest edge entry ('edge'), or the mirror image without the edge
    repeated ('reflect', ``jnp.pad``'s)."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("pad", aliases=["Pad"])
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """Pad axis i by (pad_width[2i], pad_width[2i+1]): with
    ``constant_value``, by the edge entry ('edge'), or by reflection
    ('reflect', the edge not repeated)."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [p for lr in reversed(pw) for p in lr]  # F.pad: last axis first
        return torch.nn.functional.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("bad pad mode %r" % mode)
    for axis, (left, right) in enumerate(pw):
        if left or right:
            x = x.index_select(axis, _pad_index(x.shape[axis], left, right,
                                                mode, x.device))
    return x


@register("flip")
def _flip(x, axis=0):
    return torch.flip(x, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """``jax.nn.one_hot`` semantics: indices truncate to integers, and an
    index outside [0, depth) gives a row of ``off_value``."""
    hot = indices.long().unsqueeze(-1) == torch.arange(
        int(depth), device=indices.device)
    d = torch_dtype(dtype)
    return (hot.to(d) * (on_value - off_value) + off_value).to(d)


@register("sequence_mask", aliases=["SequenceMask"])
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Entries at steps >= ``sequence_length`` (one per batch entry) along
    ``axis`` become ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    steps = torch.arange(data.shape[axis], device=data.device) \
        .reshape(bshape)
    batch_axis = 1 - axis if data.dim() > 1 else 0
    lshape = [1] * data.dim()
    lshape[batch_axis] = data.shape[batch_axis]
    lens = sequence_length.reshape(lshape)
    return torch.where(steps < lens, data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))
