"""Pipeline parallelism: the GPipe (fill-drain) schedule over a ``pp`` axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` axis owns one stage's parameters; activations move stage to stage
by :func:`~.collectives.ppermute` while microbatches fill and drain the
pipe: ``n_micro + n - 1`` ticks, a bubble of ``(n - 1) / ticks``.  Every
stage maps activations of one shape to the same shape, and the stage
function is shared code with per-stage parameters.

Every rank runs every tick with the same graph (stage 0's inject and the
last stage's writes are selections by ``torch.where``, not branches), so
autograd issues the same collectives in the same order on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree

from . import collectives as C
from .mesh import Mesh

__all__ = ["pipeline_apply", "pipeline_parallel"]


def pipeline_apply(stage_params, xs: torch.Tensor, *, stage_fn: Callable,
                   mesh: Mesh, axis_name: str = "pp") -> torch.Tensor:
    """Run the fill-drain schedule on this rank's stage.

    ``stage_params``: this rank's stage parameters; ``xs``: (n_micro,
    micro_batch, ...) microbatched input, alike on every rank;
    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``.  Returns
    (n_micro, micro_batch, ...) outputs, valid on the last stage (the
    others hold zeros)."""
    n, idx = C.axis_size(axis_name, mesh), C.axis_index(axis_name, mesh)
    n_micro = xs.shape[0]
    ticks = n_micro + n - 1
    first = torch.tensor(idx == 0, device=xs.device)
    last = torch.tensor(idx == n - 1, device=xs.device)
    state = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    outputs = [torch.zeros_like(state) for _ in range(n_micro)]
    for t in range(ticks):
        # stage 0 injects microbatch t (past the last, the last again:
        # those results never reach an output)
        x_in = torch.where(first, xs[min(t, n_micro - 1)], state)
        y = stage_fn(stage_params, x_in)
        # the last stage finishes microbatch t - (n - 1) at tick t
        if t >= n - 1:
            slot = t - (n - 1)
            outputs[slot] = torch.where(last, y, outputs[slot])
        if t != ticks - 1:
            # to the next stage; the wrap-around n-1 -> 0 carries what
            # stage 0 replaces with its inject
            state = C.ppermute(y, axis_name, mesh)
    return torch.stack(outputs)


def pipeline_parallel(stage_fn: Callable, mesh: Mesh, *,
                      pp_axis: str = "pp",
                      n_microbatches: Optional[int] = None) -> Callable:
    """``apply(stacked_params, x)``: ``stacked_params`` has a leading
    stage axis of ``mesh.shape[pp_axis]`` (each rank uses its own stage's
    row), ``x`` is (batch, ...), alike on every rank.  The batch splits
    into microbatches, runs the schedule, and the last stage's (batch, ...)
    outputs come back alike on every rank."""
    n_stages = mesh.shape[pp_axis]
    n_micro = n_microbatches or n_stages

    def apply(stacked_params, x: torch.Tensor) -> torch.Tensor:
        n_given = _pytree.tree_leaves(stacked_params)[0].shape[0]
        if n_given != n_stages:
            raise ValueError(
                "pipeline_parallel: %d stacked stages but the %r mesh axis "
                "has %d devices (one stage per device)"
                % (n_given, pp_axis, n_stages))
        batch = x.shape[0]
        if batch % n_micro != 0:
            raise ValueError("batch (%d) must divide into %d microbatches"
                             % (batch, n_micro))
        idx = C.axis_index(pp_axis, mesh)
        params = _pytree.tree_map(lambda p: p[idx], stacked_params)
        xs = C.pvary(x, pp_axis, mesh).reshape(
            (n_micro, batch // n_micro) + tuple(x.shape[1:]))
        out = pipeline_apply(params, xs, stage_fn=stage_fn,
                             axis_name=pp_axis, mesh=mesh)
        # only the last stage holds the outputs: their sum over pp gives
        # them to every stage
        last = torch.tensor(idx == n_stages - 1, device=out.device)
        out = C.psum(torch.where(last, out, torch.zeros_like(out)), pp_axis,
                     mesh)
        return out.reshape((batch,) + tuple(out.shape[2:]))

    return apply
