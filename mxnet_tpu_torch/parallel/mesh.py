"""The process group, the data-parallel mesh and the training step.

Counterpart of ``mxnet_tpu/parallel/mesh.py``:

* :func:`init_process_group` starts ``torch.distributed`` from the
  launcher's environment (``mxnet_tpu_torch.tools.launch``), where the
  reference starts ``jax.distributed``: NCCL for the GPU, gloo for the
  CPU.
* :func:`make_mesh` is a mesh over the group's ranks with one ``dp``
  axis; :func:`replicated` and :func:`batch_sharded` name its two
  layouts.  Tensor parallelism (a second axis of size above 1) comes with
  its own slice.
* :class:`TrainStep` is the step: forward in training mode, the loss, the
  gradient and an SGD-momentum update, over a block lifted by
  :func:`~..gluon.block.functionalize`.  Over a dp mesh of W ranks each
  rank passes its own shard of the batch and the step all-reduces the
  gradients (a sum divided by W, on fusion buckets) before the update.
"""
from __future__ import annotations

import datetime
import inspect
from collections import OrderedDict
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, dtype_name, get_env
from ..device import DeviceLike, resolve
from ..gluon.block import functionalize

__all__ = ["init_process_group", "Mesh", "Sharding", "make_mesh",
           "replicated", "batch_sharded", "TrainStep"]


def init_process_group(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       initialization_timeout: Optional[int] = None,
                       backend: Optional[str] = None,
                       device: DeviceLike = None) -> torch.device:
    """Join the job's process group; returns this rank's device.

    The arguments default to the launcher's environment, as the
    reference's do: ``MX_COORDINATOR`` (host:port of rank 0),
    ``MX_NUM_PROCESSES``, ``MX_PROCESS_ID`` and ``MX_INIT_TIMEOUT``
    (seconds; 300 without it).  ``backend=None`` is ``nccl`` when
    ``device`` (default: the current context, the GPU) is a GPU, and
    ``gloo`` when it is the CPU; an explicit backend is taken as given
    (``gloo`` on GPU tensors runs the collectives through the host).  On
    the GPU rank r takes ``cuda:(r % torch.cuda.device_count())`` and
    makes it the current device.  An NCCL that fails to start raises; it
    never turns into gloo.
    """
    if coordinator_address is None:
        coordinator_address = get_env("MX_COORDINATOR") or None
    if num_processes is None and get_env("MX_NUM_PROCESSES"):
        num_processes = int(get_env("MX_NUM_PROCESSES"))
    if process_id is None and get_env("MX_PROCESS_ID"):
        process_id = int(get_env("MX_PROCESS_ID"))
    if initialization_timeout is None:
        initialization_timeout = get_env("MX_INIT_TIMEOUT", 300, int)
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise MXNetError(
            "init_process_group: no coordinator, world size or rank; start "
            "the workers with 'python -m mxnet_tpu_torch.tools.launch' or "
            "pass coordinator_address, num_processes and process_id")
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        # bind the communicator to the rank's card now, so that an NCCL
        # that cannot start fails here and not at the first collective
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method="tcp://" + coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=int(initialization_timeout)),
        **kwargs)
    return dev


class Mesh(NamedTuple):
    """Ranks laid out on named axes: ``devices`` holds ranks."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


class Sharding(NamedTuple):
    """A layout on a mesh: the mesh axis each leading array axis is split
    over (an empty ``spec`` replicates)."""
    mesh: Mesh
    spec: Tuple[str, ...]


def make_mesh(axes: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: the process group's ranks, or
    rank 0 alone without a group), all on the first axis unless ``shape``
    says otherwise (-1 infers one size).  Only the first axis may exceed
    1: tensor parallelism comes with its own slice."""
    if devices is None:
        n = dist.get_world_size() if dist.is_available() and \
            dist.is_initialized() else 1
        devices = list(range(n))
    n = len(devices)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if any(s > 1 for s in shape[1:]):
        raise MXNetError("make_mesh: shape %s splits a second axis; tensor "
                         "parallelism is still to come (ROADMAP: tensor, "
                         "sequence, pipeline and expert parallelism)"
                         % (shape,))
    arr = np.asarray(devices[:int(np.prod(shape))]).reshape(shape)
    return Mesh(arr, tuple(axes))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharded(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Axis 0 (the batch) split over the data-parallel axis."""
    return Sharding(mesh, (axis,))


def _batch_norms(block: torch.nn.Module) -> List[str]:
    from ..gluon.nn.basic_layers import BatchNorm
    kinds = (BatchNorm, torch.nn.modules.batchnorm._BatchNorm)
    return [n or type(block).__name__ for n, m in block.named_modules()
            if isinstance(m, kinds)]


class TrainStep:
    """One training step of ``block`` under ``loss_fn(outputs, label)``.

    ``step(*inputs, label)`` runs ``block`` on ``inputs`` in training mode,
    takes ``loss_fn`` of its outputs and ``label``, differentiates it with
    ``torch.autograd.grad`` and updates, in each parameter's dtype and in
    the JAX package's order, ``m = momentum * m - learning_rate * g`` then
    ``p = p + m``; it returns the loss.  The step holds its own ``params``
    and ``opt_state`` (the momentum, zeros in each parameter's dtype) by
    structural name, copied from the block at construction;
    :meth:`write_back` copies ``params`` into a block.  A parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it.

    With ``mesh=None`` or a mesh of one rank the step runs on ``device``
    (default: the GPU).  Over a dp mesh of W ranks (the process group's)
    every rank starts from rank 0's parameters (a broadcast at
    construction) and passes its own shard of the global batch, as the
    reference's ``shard_batch`` takes it; the gradients are all-reduced as
    a sum divided by W, on fusion buckets of ``MX_KVSTORE_BUCKET_KB``,
    before the momentum update, and the step returns the loss averaged
    over the ranks.  For a loss that is a mean over the batch axis (every
    step in the repo uses one) and equal shards, that is the reference's
    mean over the global batch.  Batch statistics would differ (each rank
    would normalise by its own shard), so a block holding a BatchNorm
    raises over more than one rank until a synchronised batch norm is
    ported.  The reference's tensor-parallel rules come with a later
    slice.

    :meth:`save` and :meth:`restore` checkpoint ``{"params",
    "opt_state"}`` through :mod:`..checkpoint` (crash-safe; over a dp mesh
    every rank calls both, collectively), so a restored step continues
    bitwise where the saved one stopped.
    """

    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 mesh: Optional[Mesh] = None, device: DeviceLike = None,
                 learning_rate: float = 0.01, momentum: float = 0.9,
                 dp_axis: str = "dp"):
        self.mesh = mesh
        self._world = 1 if mesh is None else mesh.shape[dp_axis]
        if self._world > 1:
            if not (dist.is_available() and dist.is_initialized()) or \
                    dist.get_world_size() != self._world:
                raise MXNetError(
                    "TrainStep: a dp mesh of %d ranks needs a process group "
                    "of that size (parallel.init_process_group)"
                    % self._world)
            norms = _batch_norms(block)
            if norms:
                raise MXNetError(
                    "TrainStep over %d dp ranks: %s hold a BatchNorm, whose "
                    "batch statistics would be each rank's and not the "
                    "global batch's; a synchronised batch norm is still to "
                    "come" % (self._world, norms[:3]))
        pure_fn, params = functionalize(block)
        self.device = resolve(device)
        self.params = OrderedDict(
            (n, p.to(self.device, copy=True)) for n, p in params.items())
        if self._world > 1:
            # every rank starts from rank 0's weights, as the Trainer's
            # store makes it: blocks initialised apart would train apart
            for p in self.params.values():
                dist.broadcast(p, src=0)
        self.opt_state = OrderedDict(
            (n, torch.zeros_like(p)) for n, p in self.params.items())
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self._pure_fn = pure_fn
        self._loss_fn = loss_fn
        self._buckets = None
        if self._world > 1:
            from ..kvstore.bucketing import bucket_bytes, plan_buckets
            names = list(self.params)
            ps = [self.params[n] for n in names]
            self._buckets = plan_buckets(
                names, [tuple(p.shape) for p in ps],
                [dtype_name(p.dtype) for p in ps],
                [p.element_size() for p in ps], ["default"] * len(ps),
                bucket_bytes())

    def _place(self, batch) -> List[torch.Tensor]:
        return [torch.from_numpy(np.asarray(a)).to(self.device)
                if not isinstance(a, torch.Tensor) else a.to(self.device)
                for a in batch]

    shard_batch = _place

    def _allreduce_mean(self, grads: List[torch.Tensor]) -> None:
        """Replace each gradient by its mean over the ranks: one
        ``all_reduce`` a fusion bucket (or solo tensor), in place."""
        def mean(flat):
            dist.all_reduce(flat)
            return flat.div_(self._world)

        buckets, solo = self._buckets
        for b in buckets:
            out = b.exchange([grads[p] for p in b.positions], mean)
            for p, g in zip(b.positions, out):
                grads[p] = g
        for p in solo:
            grads[p] = mean(grads[p].contiguous())

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
        loss = loss.detach()
        if self._world > 1:
            self._allreduce_mean(grads)
            loss = loss.clone()
            dist.all_reduce(loss)
            loss.div_(self._world)
        moms = [self.opt_state[n] for n in names]
        params = [self.params[n] for n in names]
        # in place: the step owns these tensors, and a second copy of the
        # parameters and momenta would double the step's memory
        with torch.no_grad():
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, torch._foreach_mul(
                grads, self.learning_rate))
            torch._foreach_add_(params, moms)
        return loss

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

    def _mesh(self) -> Mesh:
        """The mesh the state lives on: a step without one runs on one
        device, the reference's one-device mesh."""
        if self.mesh is not None:
            return self.mesh
        return Mesh(np.asarray([0]), ("dp",))

    def save(self, path: str) -> None:
        """Checkpoint ``{"params", "opt_state"}`` to ``path``
        (:func:`..checkpoint.save_sharded`; every leaf replicated on the
        step's mesh)."""
        from ..checkpoint import save_sharded
        save_sharded(path, {"params": self.params,
                            "opt_state": self.opt_state}, mesh=self._mesh())

    def restore(self, path: str) -> None:
        """Load a checkpoint of :meth:`save` in place into this step's
        tensors, on its device and in its dtypes."""
        from ..checkpoint import restore_sharded
        restore_sharded(path, template={"params": self.params,
                                        "opt_state": self.opt_state})

    def write_back(self, block: torch.nn.Module) -> None:
        """Copy the step's parameters into ``block``'s by name."""
        named = dict(block.named_parameters())
        with torch.no_grad():
            for name, value in self.params.items():
                named[name].copy_(value)
