"""Expert parallelism: top-1 mixture of experts over an ``ep`` axis.

Counterpart of ``mxnet_tpu/parallel/moe.py``.  Experts are split over the
``ep`` axis (``e_local`` a rank); each rank routes its own tokens top-1,
packs them to a fixed capacity per expert, exchanges them with two
:func:`~.collectives.all_to_all` (dispatch and return) and combines the
results scaled by the gate probability.  A token past its expert's
capacity gets zero output (GShard / Switch); gradients reach the gate
through the combine weights and the Switch auxiliary loss.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree

from . import collectives as C
from .mesh import Mesh

__all__ = ["moe_apply", "moe_parallel", "top1_dispatch"]


def top1_dispatch(gate_logits: torch.Tensor, n_experts: int, capacity: int):
    """Dispatch and combine tensors of top-1 routing.

    gate_logits: (T, E).  Returns (dispatch (T, E, C), the one-hot
    placement; combine (T, E, C) = dispatch * the gate probability;
    aux_loss, the Switch load-balancing loss)."""
    probs = torch.softmax(gate_logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(expert, n_experts).to(probs.dtype)
    gate = (probs * onehot).sum(dim=-1)
    # each token's 1-based place in its expert's queue (0 elsewhere)
    pos = torch.cumsum(onehot, dim=0) * onehot
    keep = (pos <= capacity) & (onehot > 0)
    position = pos.sum(dim=-1).to(torch.int64) - 1
    loc = (position[:, None] == torch.arange(
        capacity, device=position.device)[None, :]).to(probs.dtype)
    dispatch = loc[:, None, :] * keep.to(probs.dtype)[:, :, None]
    combine = dispatch * gate[:, None, None]
    # E * sum_e (share of tokens to e) * (mean probability of e)
    aux = n_experts * (onehot.mean(dim=0) * probs.mean(dim=0)).sum()
    return dispatch, combine, aux


def moe_apply(x: torch.Tensor, gate_w: torch.Tensor, expert_params, *,
              expert_fn: Callable, mesh: Mesh, axis_name: str = "ep",
              capacity_factor: float = 2.0):
    """This rank's tokens ``x`` (T_local, d) through the experts:
    ``gate_w`` (d, E) alike on every rank, ``expert_params`` this rank's
    experts stacked on a leading axis of ``e_local``.  Returns (y
    (T_local, d), the auxiliary loss averaged over the axis)."""
    n = C.axis_size(axis_name, mesh)
    e_local = _pytree.tree_leaves(expert_params)[0].shape[0]
    n_experts = n * e_local
    if gate_w.shape[-1] != n_experts:
        raise ValueError(
            "moe: gate_w routes to %d experts but %d are stacked "
            "(%d devices x %d local)" % (gate_w.shape[-1], n_experts, n,
                                         e_local))
    capacity = max(1, int(capacity_factor * x.shape[0] / n_experts))
    dispatch, combine, aux = top1_dispatch(x @ gate_w, n_experts, capacity)
    # (E, C, d) expert-major buffers; the dispatch leaves each rank its
    # e_local experts' buffers from every rank, (e_local, n*C, d)
    xin = torch.einsum("tec,td->ecd", dispatch, x)
    xin = C.all_to_all(xin, axis_name, 0, 1, mesh)
    yout = torch.stack([
        expert_fn(_pytree.tree_map(lambda p: p[e], expert_params), xin[e])
        for e in range(e_local)])
    # the return: back to (E, C, d) in the tokens' origin layout
    yout = C.all_to_all(yout, axis_name, 1, 0, mesh)
    y = torch.einsum("tec,ecd->td", combine, yout)
    return y, C.pmean(aux, axis_name, mesh)


def moe_parallel(expert_fn: Callable, mesh: Mesh, *, ep_axis: str = "ep",
                 capacity_factor: float = 2.0) -> Callable:
    """``apply(x, gate_w, stacked_expert_params)``: ``x`` this rank's
    tokens (T_local, d), ``gate_w`` alike on every rank, the experts
    stacked on a leading axis of n * e_local (each rank uses its own
    e_local).  Returns (this rank's y, the auxiliary loss)."""
    n = mesh.shape[ep_axis]

    def apply(x: torch.Tensor, gate_w: torch.Tensor, stacked_expert_params):
        total = _pytree.tree_leaves(stacked_expert_params)[0].shape[0]
        if total % n:
            raise ValueError("moe: %d stacked experts do not split over the "
                             "%r axis of %d" % (total, ep_axis, n))
        e_local = total // n
        lo = C.axis_index(ep_axis, mesh) * e_local
        local = _pytree.tree_map(lambda p: p[lo:lo + e_local],
                                 stacked_expert_params)
        return moe_apply(x, C.pvary(gate_w, ep_axis, mesh), local,
                         expert_fn=expert_fn, axis_name=ep_axis,
                         capacity_factor=capacity_factor, mesh=mesh)

    return apply
