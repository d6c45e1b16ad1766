"""The training step of the port.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` ``TrainStep`` on a one-device
mesh: forward in training mode, the loss, the gradient and an SGD-momentum
update, over a block lifted by :func:`~..gluon.block.functionalize`.
PyTorch runs the step eagerly; the attention backward inside it is the
flash Function's (``ops/attention.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..gluon.block import functionalize

__all__ = ["TrainStep"]


class TrainStep:
    """One training step of ``block`` under ``loss_fn(outputs, label)`` on
    one device (default: the GPU).

    ``step(*inputs, label)`` runs ``block`` on ``inputs`` in training mode,
    takes ``loss_fn`` of its outputs and ``label``, differentiates it with
    ``torch.autograd.grad`` and updates, in each parameter's dtype and in
    the JAX package's order, ``m = momentum * m - learning_rate * g`` then
    ``p = p + m``; it returns the loss.  The step holds its own ``params``
    and ``opt_state`` (the momentum, zeros in each parameter's dtype) by
    structural name, copied from the block at construction;
    :meth:`write_back` copies ``params`` into a block.  A parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it.

    One device only: the JAX step's mesh, batch sharding, tensor-parallel
    rules and sharded checkpoint (``save``/``restore``) come with the
    distributed slice.
    """

    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 device: DeviceLike = None, learning_rate: float = 0.01,
                 momentum: float = 0.9):
        pure_fn, params = functionalize(block)
        self.device = resolve(device)
        self.params = OrderedDict(
            (n, p.to(self.device, copy=True)) for n, p in params.items())
        self.opt_state = OrderedDict(
            (n, torch.zeros_like(p)) for n, p in self.params.items())
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self._pure_fn = pure_fn
        self._loss_fn = loss_fn

    def _place(self, batch) -> List[torch.Tensor]:
        return [torch.from_numpy(np.asarray(a)).to(self.device)
                if not isinstance(a, torch.Tensor) else a.to(self.device)
                for a in batch]

    def _step(self, batch: List[torch.Tensor]) -> torch.Tensor:
        names = list(self.params)
        leaves = [self.params[n].detach().requires_grad_(True)
                  for n in names]
        with torch.enable_grad():
            out = self._pure_fn(dict(zip(names, leaves)), *batch[:-1],
                                training=True)
            loss = self._loss_fn(out, batch[-1])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        moms = [self.opt_state[n] for n in names]
        params = [self.params[n] for n in names]
        # in place: the step owns these tensors, and a second copy of the
        # parameters and momenta would double the step's memory
        with torch.no_grad():
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, torch._foreach_mul(
                grads, self.learning_rate))
            torch._foreach_add_(params, moms)
        return loss.detach()

    def __call__(self, *batch) -> torch.Tensor:
        return self._step(self._place(batch))

    def run_steps(self, k: int, *batch) -> torch.Tensor:
        """Run ``k`` steps on the same batch; returns the last loss as
        float32 (the JAX package runs them under one dispatch)."""
        if k < 1:
            raise ValueError("run_steps needs k >= 1, got %d" % k)
        placed = self._place(batch)
        for _ in range(k):
            loss = self._step(placed)
        return loss.float()

    def write_back(self, block: torch.nn.Module) -> None:
        """Copy the step's parameters into ``block``'s by name."""
        named = dict(block.named_parameters())
        with torch.no_grad():
            for name, value in self.params.items():
                named[name].copy_(value)
