"""Matrix products, linear algebra, shape and indexing ops.

Counterpart of ``mxnet_tpu/ops/matrix.py``.  The matrix products and the
factorisations stay with PyTorch's library kernels, as the JAX package
left them to XLA.  Slices follow Python's rules, negative steps included
(torch's basic indexing refuses those, so they become index lists).
Where several writes meet one place (``scatter_nd`` with a repeated
index), the last one wins, as on the reference's CPU, and never by a
scatter with duplicate indices, whose winner CUDA leaves open.
"""
from __future__ import annotations

import math

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


@register("batch_dot", aliases=["_npx_batch_dot"])
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * _batch_dot(a, b, transpose_a, transpose_b)


@register("linalg_syrk")
def _linalg_syrk(a, transpose=False, alpha=1.0):
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else
                    torch.matmul(a, at))


@register("linalg_potrf")
def _linalg_potrf(a):
    """The lower Cholesky factor, zeros above the diagonal.  A matrix that
    is not positive definite gives NaN on and below the diagonal and
    keeps the zeros above it, as the reference answers (torch raises)."""
    low, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(info.shape + (1, 1))
    lower = torch.ones(a.shape[-2:], dtype=torch.bool,
                       device=a.device).tril()
    return torch.where(bad & lower, torch.full_like(low, float("nan")), low)


@register("linalg_trsm")
def _linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    """Solve the triangular system of ``a`` against ``alpha * b`` (with
    ``rightside``, against its last two axes swapped, the solution swapped
    back), as the reference composes it."""
    if transpose:
        a = a.transpose(-1, -2)
        lower = not lower
    rhs = alpha * b
    if rightside:
        rhs = rhs.transpose(-1, -2)
    sol = torch.linalg.solve_triangular(a, rhs, upper=not lower)
    return sol.transpose(-1, -2) if rightside else sol


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


@register("split_v2", aliases=["_split_v2"], num_outputs=0)
def _split_v2(x, indices=(), axis=0, squeeze_axis=False, sections=0):
    """``jnp.split``: into ``sections`` equal parts, or at ``indices``."""
    if sections:
        parts = _split(x, num_outputs=sections, axis=axis)
    else:
        parts = torch.tensor_split(x, [int(i) for i in indices], dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _positions(n, sl, device):
    """The indices a Python slice picks from an axis of extent ``n``."""
    return torch.arange(*sl.indices(n), device=device)


def _slices(begin, end, step):
    step = step or (None,) * len(begin)
    return [slice(b, e, s) for b, e, s in zip(begin, end, step)]


def take_slices(x, slices):
    """x[slices] for a list of Python slices over the leading axes, any
    step's sign; a negative step becomes an index list."""
    for axis, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            x = x.index_select(axis, _positions(x.shape[axis], sl, x.device))
        else:
            x = x[(slice(None),) * axis + (sl,)]
    return x


@register("slice", aliases=["crop"])
def _slice(x, begin=(), end=(), step=()):
    return take_slices(x, _slices(begin, end, step))


@register("slice_like")
def _slice_like(x, like, axes=()):
    axes = axes or tuple(range(min(x.dim(), like.dim())))
    sl = [slice(None)] * x.dim()
    for a in axes:
        sl[a] = slice(0, like.shape[a])
    return x[tuple(sl)]


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


@register("diag")
def _diag(x, k=0):
    """A 1-D x on the k-th diagonal of a square matrix; else the k-th
    diagonal of the last two axes (a copy)."""
    if x.dim() == 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, offset=int(k), dim1=-2, dim2=-1).clone()


@register("zeros_like_op", aliases=["zeros_like"])
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like_op", aliases=["ones_like"])
def _ones_like(x):
    return torch.ones_like(x)


@register("space_to_depth")
def _space_to_depth(x, block_size=2):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * bs * bs, h // bs, w // bs)


@register("depth_to_space")
def _depth_to_space(x, block_size=2):
    n, c, h, w = x.shape
    bs = block_size
    y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (bs * bs), h * bs, w * bs)


@register("take")
def _take(x, indices, axis=0, mode="clip"):
    """Entries of x along ``axis`` at ``indices`` (truncated to integers):
    wrapped modulo the extent (``wrap``) or clipped into it (any other
    mode, as the reference reads them)."""
    n = x.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@register("gather_nd")
def _gather_nd(x, indices):
    """x[indices[0], ..., indices[m-1]]: the first axis of ``indices``
    addresses x's first m axes."""
    idx = indices.to(torch.int64)
    return x[tuple(idx[i] for i in range(idx.shape[0]))]


def _last_writes(linear):
    """For flat target positions ``linear`` (one per write, in order), a
    mask of the writes that no later write to the same position
    overrides."""
    order = torch.arange(linear.numel(), device=linear.device)
    last = torch.full((int(linear.max()) + 1 if linear.numel() else 1,), -1,
                      dtype=torch.int64, device=linear.device)
    last = last.scatter_reduce(0, linear, order, reduce="amax")
    return last[linear] == order


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None):
    """A zero array of ``shape`` with ``data`` written at ``indices`` (the
    first axis addressing its leading axes); of writes to one place the
    last wins, and only it receives a gradient, as on the reference."""
    shape = tuple(shape)
    idx = indices.to(torch.int64)
    m = idx.shape[0]
    lead = torch.tensor(shape[:m], device=idx.device)
    pos = torch.remainder(idx.reshape(m, -1), lead.reshape(m, 1))
    strides = torch.tensor([math.prod(shape[i + 1:m]) for i in range(m)],
                           device=idx.device)
    linear = (pos * strides.reshape(m, 1)).sum(0)
    keep = _last_writes(linear)
    rows = data.reshape((linear.numel(),) + shape[m:])
    out = torch.zeros((math.prod(shape[:m]),) + shape[m:], dtype=data.dtype,
                      device=data.device)
    out = out.index_put((linear[keep],), rows[keep])
    return out.reshape(shape)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """``jax.nn.one_hot`` semantics: indices truncate to integers, and an
    index outside [0, depth) gives a row of ``off_value``."""
    hot = indices.long().unsqueeze(-1) == torch.arange(
        int(depth), device=indices.device)
    d = torch_dtype(dtype)
    return (hot.to(d) * (on_value - off_value) + off_value).to(d)


@register("where_op")
def _where_op(cond, a, b):
    return torch.where(cond.bool(), a, b)


@register("boolean_mask", aliases=["_contrib_boolean_mask"],
          differentiable=False)
def _boolean_mask(data, index, axis=0):
    """The slices along ``axis`` whose ``index`` entry is nonzero."""
    keep = torch.nonzero(index.reshape(-1).bool()).reshape(-1)
    return data.index_select(int(axis), keep)


@register("shape_array", differentiable=False)
def _shape_array(x):
    """x's shape as int32 (the reference asks for int64, which JAX
    narrows to int32 as the port's dtypes do)."""
    return torch.tensor(tuple(x.shape), dtype=torch_dtype("int64"),
                        device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch_dtype("int64"),
                        device=x.device)


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """The last step along ``axis``, or each batch entry's step at its
    ``sequence_length`` - 1."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    moved = data.movedim(axis, 0)
    last = sequence_length.to(torch.int64) - 1
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Reverse along ``axis`` the first ``sequence_length`` steps of each
    batch entry (axis 1 of the time-major layout); later steps stay."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = data.movedim(axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2)).expand(
        moved.shape)
    return torch.gather(moved, 0, src).movedim(0, axis)


def _assign_index(x, begin, end, step):
    """Index tensors (broadcast against each other) of the region
    x[begin:end:step] over x's leading axes, the rest whole."""
    sls = _slices(begin, end, step)
    sls += [slice(None)] * (x.dim() - len(sls))
    n = len(sls)
    return tuple(_positions(x.shape[i], sl, x.device).reshape(
        [-1 if j == i else 1 for j in range(n)]) for i, sl in enumerate(sls))


@register("_slice_assign", aliases=["_crop_assign"])
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """lhs with lhs[begin:end:step] = rhs (any step's sign);
    differentiable in both."""
    return lhs.index_put(_assign_index(lhs, begin, end, step),
                         rhs.to(lhs.dtype))


@register("_slice_assign_scalar", aliases=["_crop_assign_scalar"])
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    return data.index_put(_assign_index(data, begin, end, step),
                          torch.tensor(scalar, dtype=data.dtype,
                                       device=data.device))


def _basic_index(x, key):
    """x[key] for a basic index (ints, slices of any step, None,
    Ellipsis): slices with a negative step are taken whole by torch's
    indexing and then by an index list."""
    key = key if isinstance(key, tuple) else (key,)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        used = sum(k is not None for k in key) - 1
        key = key[:i] + (slice(None),) * (x.dim() - used) + key[i + 1:]
    plain, flips, dim, out_dim = [], [], 0, 0
    for k in key:
        if k is None:
            plain.append(None)
            out_dim += 1
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            plain.append(slice(None))
            flips.append((out_dim, _positions(x.shape[dim], k, x.device)))
        else:
            plain.append(k)
        if isinstance(k, slice):
            out_dim += 1
        dim += 1
    out = x[tuple(plain)]
    for d, pos in flips:
        out = out.index_select(d, pos)
    return out


@register("_internal_getitem")
def _internal_getitem(x, key=None):
    """A basic-index read as a recorded op, so that a gradient reaches x
    through it."""
    return _basic_index(x, key)


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
