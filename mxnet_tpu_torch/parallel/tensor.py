"""Sharded compute: parameters split over mesh axes, used explicitly.

The reference has no module here: under ``jax.jit`` over a mesh, GSPMD
inserts the collectives that a parameter's placement needs.  The port
runs one process a rank and issues them itself, each an autograd
Function of :mod:`.collectives` with JAX's transpose:

* **Storage to use** (:func:`to_use`).  A parameter is stored on its
  storage spec (``SpecLayout.param_spec``) and used on its *use spec*:
  the compute spec (fsdp dropped) where its layer computes split (the
  weight of a ``Dense`` or ``Embedding`` split on tp), else the whole
  value (gather at use: conv weights under ``rules``, fsdp sheets, an
  embedding split on its feature axis, a bias split by a rule).  Where
  the use spec's entries are prefixes of the storage spec's, the change
  is a chain of all-gathers, minor axes first: over a batch axis (fsdp)
  the backward is a reduce-scatter (each rank's cotangent is a partial
  sum over its share of the batch), over a model axis (tp) it is this
  rank's slice (every tp rank repeats the computation alike).  Otherwise
  (the default embedding spec ``(fsdp, tp)`` used as ``(tp,)``) the
  whole value is assembled and sliced, and the backward pads the
  cotangent into the whole shape, sums it over the use spec's axes
  (disjoint pieces) and the storage spec's batch axes, and slices.
* **Column-parallel Dense** (weight ``(out/tp, in)``): the input is
  ``pvary``'d (its cotangent sums over tp), each rank computes its output
  columns, and an all-gather (backward: slice) joins them; the bias is
  added after.
* **Row-parallel Dense** (weight ``(out, in/tp)``): each rank takes its
  slice of the input features (backward: all-gather), computes a partial
  product, and ``psum`` adds them over tp; the bias is added once, after
  the sum.
* **Vocab-parallel Embedding** (table ``(vocab/tp, dim)``): a masked
  lookup of the ids this rank's rows hold, then ``psum``.

:class:`placement_scope` is the scope in which ``nn.Dense`` and
``nn.Embedding`` read their weight's placement; ``TrainStep`` and
``CompiledStep`` enter it around the forward.  Outside it the layers are
unchanged.  A column-parallel layer's output is always gathered before
the next layer (no Megatron pairing of a column- with a row-parallel
layer yet), so any placement computes the reference's function.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..base import MXNetError
from . import collectives as C
from .speclayout import PartitionSpec, _entry_axes, shard_slices

__all__ = ["placement_scope", "placement", "to_use", "assemble",
           "use_plan", "dense_forward", "embedding_forward"]

_LOCAL = threading.local()


class placement_scope:
    """``with placement_scope({(id(module), "weight"): (mode, mesh,
    axis)}):`` - inside it, a ``Dense`` or ``Embedding`` whose weight has
    an entry computes split over ``axis``: ``mode`` is ``"column"`` or
    ``"row"`` (Dense) or ``"vocab"`` (Embedding)."""

    def __init__(self, placements: Dict[Tuple[int, str], Tuple]):
        self.placements = placements

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self.placements)
        return self

    def __exit__(self, *exc):
        _LOCAL.stack.pop()
        return False


def placement(module, attr: str) -> Optional[Tuple]:
    """The innermost scope's placement of ``module``'s ``attr``, or
    None."""
    stack = getattr(_LOCAL, "stack", None)
    if not stack:
        return None
    return stack[-1].get((id(module), attr))


# ---------------------------------------------------------------------------
# storage -> use
# ---------------------------------------------------------------------------


def _entries(spec, ndim):
    spec = tuple(spec)
    return [_entry_axes(spec[d]) if d < len(spec) else ()
            for d in range(ndim)]


def assemble(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole value of which ``local`` is this rank's shard under
    ``spec`` (no autograd): all-gathers, the minor axis of each dimension
    first."""
    out = local
    for d, axes in enumerate(_entries(spec, local.dim())):
        for a in reversed(axes):
            out = C.gather_along(out, mesh, a, d)
    return out


def _is_prefix_change(src, dst) -> bool:
    return all(len(t) <= len(s) and s[:len(t)] == t
               for s, t in zip(src, dst))


class _Reshard(torch.autograd.Function):
    """Storage spec -> use spec through the whole value (the general
    change); see the module's note for the backward."""

    @staticmethod
    def forward(ctx, local, mesh, src, dst, batch_axes, shape):
        ctx.args = mesh, src, dst, batch_axes, shape
        whole = assemble(local, src, mesh)
        return whole[shard_slices(shape, dst, mesh)].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, src, dst, batch_axes, shape = ctx.args
        whole = g.new_zeros(shape)
        whole[shard_slices(shape, dst, mesh)] = g
        axes = set(PartitionSpec(*dst).axes())
        axes |= set(PartitionSpec(*src).axes()) & set(batch_axes)
        for a in sorted(axes):
            if mesh.axis_size(a) > 1:
                dist.all_reduce(whole, group=mesh.group(a))
        return (whole[shard_slices(shape, src, mesh)].contiguous(), None,
                None, None, None, None)


def to_use(local: torch.Tensor, src, dst, mesh, shape,
           batch_axes=("data", "fsdp")) -> torch.Tensor:
    """This rank's piece of a parameter under its use spec ``dst``, from
    its shard ``local`` under its storage spec ``src`` (``shape`` is the
    whole one), differentiably; see the module's note."""
    s, t = _entries(src, len(shape)), _entries(dst, len(shape))
    if s == t:
        return local
    if not _is_prefix_change(s, t):
        return _Reshard.apply(local, mesh, PartitionSpec(*src),
                              PartitionSpec(*dst), tuple(batch_axes),
                              tuple(shape))
    out = local
    for d, (sa, ta) in enumerate(zip(s, t)):
        for a in reversed(sa[len(ta):]):
            out = C.all_gather(out, a, d, mesh,
                               backward="reduce_scatter"
                               if a in batch_axes else "slice")
    return out


def use_plan(block, storage: Dict[str, PartitionSpec], compute, mesh,
             tp_axis: str = "tp"):
    """For each parameter of ``block`` (name -> storage spec), its use
    spec, and the scope's placements: a ``Dense`` weight whose compute
    spec splits ``out`` or ``in`` over ``tp_axis`` computes column- or
    row-parallel, an ``Embedding`` weight split on its rows over
    ``tp_axis`` vocab-parallel; every other parameter is used whole.
    ``compute`` maps a storage spec to its compute spec."""
    from ..gluon.nn.basic_layers import Dense, Embedding
    owners = {}
    for mname, m in block.named_modules():
        for attr, p in m.__dict__.get("_parameters", {}).items():
            if p is not None:
                owners[(mname + "." if mname else "") + attr] = (m, attr)
    use, places = {}, {}
    for name, spec in storage.items():
        comp = tuple(compute(spec))
        use[name] = PartitionSpec()
        if not comp:
            continue
        m, attr = owners.get(name, (None, None))
        mode = None
        if attr == "weight" and isinstance(m, Dense):
            if comp == (tp_axis,):
                mode = "column"
            elif comp == (None, tp_axis):
                mode = "row"
        elif attr == "weight" and isinstance(m, Embedding) and \
                comp == (tp_axis,):
            mode = "vocab"
        if mode is not None:
            use[name] = PartitionSpec(*comp)
            places[(id(m), attr)] = (mode, mesh, tp_axis)
    return use, places


# ---------------------------------------------------------------------------
# the layers' split forms
# ---------------------------------------------------------------------------


def dense_forward(x, weight, bias, units: int, flatten: bool, place):
    """``Dense``'s op under a column- or row-parallel placement; the
    activation is the caller's."""
    from ..ops.registry import dispatch
    mode, mesh, axis = place
    if mode == "column":
        out = dispatch("FullyConnected", C.pvary(x, axis, mesh), weight,
                       None, num_hidden=weight.shape[0], no_bias=True,
                       flatten=flatten)
        out = C.all_gather(out, axis, -1, mesh, backward="slice")
    elif mode == "row":
        xf = x.reshape(x.shape[0], -1) if flatten and x.dim() > 2 else x
        part = dispatch("FullyConnected", C.axis_slice(xf, axis, -1, mesh),
                        weight, None, num_hidden=units, no_bias=True,
                        flatten=False)
        out = C.psum(part, axis, mesh)
    else:
        raise MXNetError("Dense: no %r placement" % (mode,))
    if bias is not None:
        out = out + bias
    return out


def embedding_forward(x, weight, place):
    """``Embedding``'s row gather with the table split on its rows over
    the placement's axis: each rank looks up the ids its rows hold (the
    others give 0) and ``psum`` adds the pieces.  Ids wrap and an id
    outside [-vocab, vocab) gives NaN, as the whole table's op does."""
    mode, mesh, axis = place
    if mode != "vocab":
        raise MXNetError("Embedding: no %r placement" % (mode,))
    rows, n, i = weight.shape[0], mesh.axis_size(axis), \
        mesh.axis_index(axis)
    vocab = rows * n
    idx = x.long()
    idx = torch.where(idx < 0, idx + vocab, idx)
    valid = (idx >= 0) & (idx < vocab)
    local = idx - i * rows
    mine = (local >= 0) & (local < rows)
    out = torch.nn.functional.embedding(local.clamp(0, rows - 1), weight)
    out = out * mine.unsqueeze(-1).to(out.dtype)
    out = C.psum(out, axis, mesh)
    return torch.where(valid.unsqueeze(-1), out,
                       torch.full_like(out, float("nan")))
