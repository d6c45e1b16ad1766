"""The process group, the data-parallel mesh and the training step.

Counterpart of ``mxnet_tpu/parallel/mesh.py``:

* :func:`init_process_group` starts ``torch.distributed`` from the
  launcher's environment (``mxnet_tpu_torch.tools.launch``), where the
  reference starts ``jax.distributed``: NCCL for the GPU, gloo for the
  CPU.
* :func:`make_mesh` lays the group's ranks out on named axes of any size,
  row-major as the reference lays out its devices, and makes one process
  group for every line of every axis (:meth:`Mesh.group`); a rank reads
  its place with :meth:`Mesh.axis_index` and :meth:`Mesh.axis_size`.
  :func:`replicated` and :func:`batch_sharded` name two layouts.  The
  collectives over an axis's group are in :mod:`.collectives`.
* :class:`TrainStep` is the step: forward in training mode, the loss, the
  gradient and an SGD-momentum update, over a block lifted by
  :func:`~..gluon.block.functionalize`.  Over a dp axis of W ranks each
  rank passes its own shard of the batch and the step all-reduces the
  gradients over that axis's group (a sum divided by W, on fusion
  buckets) before the update.  Over a tp axis the step stores each
  parameter on its :func:`~.speclayout.tp_alternation_specs` shard and
  computes through :mod:`.tensor`'s column- and row-parallel layers.
* :func:`shard_params_tp` is the reference's deprecated alias of
  :func:`.speclayout.shard_params_tp`.
"""
from __future__ import annotations

import datetime
import inspect
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, dtype_name, get_env
from ..device import DeviceLike, resolve
from ..gluon.block import functionalize

__all__ = ["init_process_group", "Mesh", "Sharding", "make_mesh",
           "replicated", "batch_sharded", "shard_params_tp", "TrainStep",
           "end_process_group"]


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


def end_process_group(exit_code: Optional[int] = None) -> None:
    """End this worker's process group explicitly: a barrier (every rank
    is past its last collective), then ``destroy_process_group``.  With
    ``exit_code`` the process then flushes its standard streams and leaves
    through ``os._exit``, without the interpreter's teardown: a two-rank
    gloo worker that printed its last line could abort in that teardown
    ("terminate called without an active exception", a C++ thread still
    joinable), which failed its exit code after the work was done."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    if exit_code is not None:
        import os
        import sys
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(exit_code))


def _my_rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Mesh(NamedTuple):
    """Ranks laid out on named axes: ``devices`` holds ranks.

    ``groups`` maps each axis to the process group of this rank's line
    along it: None for a line of one rank, and for a line of the whole
    world in rank order, whose group is the default one (``group=None``
    in every ``torch.distributed`` call).  :func:`make_mesh` fills it; a
    mesh built by hand has none, and its axes of more than one rank have
    no group."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    groups: Optional[Dict[str, Any]] = None

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """A rank's (default: this process's) index along every axis."""
        rank = _my_rank() if rank is None else int(rank)
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise MXNetError("rank %d is not on the mesh %s"
                             % (rank, dict(self.shape)))
        return OrderedDict(zip(self.axis_names, map(int, where[0])))

    def axis_size(self, axis: str) -> int:
        return int(self.shape[axis])

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self.coords()[axis]

    def line(self, axis: str) -> Tuple[int, ...]:
        """The ranks along ``axis`` through this rank, in axis order."""
        c = self.coords()
        idx = tuple(slice(None) if a == axis else c[a]
                    for a in self.axis_names)
        return tuple(int(r) for r in self.devices[idx])

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``, None for
        the default group (the whole world) or a line of one rank."""
        if self.axis_size(axis) == 1:
            return None
        if self.groups is None:
            raise MXNetError("the mesh %s has no process groups: build it "
                             "with make_mesh inside a process group"
                             % dict(self.shape))
        self.coords()                       # raises: not on the mesh
        return self.groups[axis]


class Sharding(NamedTuple):
    """A layout on a mesh: the mesh axis each leading array axis is split
    over (an empty ``spec`` replicates)."""
    mesh: Mesh
    spec: Tuple[str, ...]


def _line_groups(devices: np.ndarray, axes: Sequence[str]):
    """One process group for every line of every axis, made by every rank
    in the same order (``new_group`` is collective over the world); the
    group of this rank's line on each axis.  A line of one rank has no
    group, and a line of the whole world in rank order the default one
    (None: the mesh keeps no reference to it past the group's end)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices.size and int(devices.max()) >= world:
        raise MXNetError("make_mesh: rank %d is not in the process group of "
                         "%d" % (int(devices.max()), world))
    mine = {}
    for i, axis in enumerate(axes):
        size = devices.shape[i]
        for line in np.moveaxis(devices, i, -1).reshape(-1, size):
            ranks = tuple(int(r) for r in line)
            if size == 1 or ranks == tuple(range(world)):
                group = None
            else:
                group = dist.new_group(list(ranks))
            if rank in ranks:
                mine[axis] = group
    return mine


def make_mesh(axes: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: the process group's ranks, or
    rank 0 alone without a group), all on the first axis unless ``shape``
    says otherwise (-1 infers one size).  Ranks fill the shape row-major,
    as the reference's devices do.  Inside a process group every rank
    calls it with the same arguments: it makes the groups of every axis's
    lines collectively."""
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
    if len(shape) != len(axes):
        raise MXNetError("make_mesh: %d axes %s but a shape of %d %s"
                         % (len(axes), tuple(axes), len(shape), shape))
    if int(np.prod(shape)) > n:
        raise MXNetError("make_mesh: shape %s needs %d ranks, %d given"
                         % (shape, int(np.prod(shape)), n))
    arr = np.asarray(devices[:int(np.prod(shape))]).reshape(shape)
    groups = None
    if dist.is_available() and dist.is_initialized():
        groups = _line_groups(arr, tuple(axes))
    return Mesh(arr, tuple(axes), groups)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharded(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Axis 0 (the batch) split over the data-parallel axis."""
    return Sharding(mesh, (axis,))


def shard_params_tp(param_values, mesh: Mesh, tp_axis: str = "tp",
                    rules: Optional[Dict[str, Any]] = None):
    """Deprecated alias: tensor-parallel placement of Dense weights, now
    owned by :mod:`.speclayout` (the one source of parameter
    placements): explicit ``rules`` ({name-substring: spec}; a parameter
    no rule matches replicates), else column/row alternation of
    consecutive 2-D '...weight' parameters.  Returns this rank's shards;
    new code builds a :class:`~.speclayout.SpecLayout` and calls
    :func:`~.speclayout.shard_params`."""
    from .speclayout import shard_params_tp as _impl
    return _impl(param_values, mesh, tp_axis=tp_axis, rules=rules)


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
    (default: the GPU).  Over a dp axis of W ranks every rank of the axis's
    line starts from its first rank's parameters (a broadcast over the
    axis's group at construction) and passes its own shard of the global
    batch, as the reference's ``shard_batch`` takes it; the gradients are
    all-reduced over that group as a sum divided by W, on fusion buckets of
    ``MX_KVSTORE_BUCKET_KB``, before the momentum update, and the step
    returns the loss averaged over the axis.  For a loss that is a mean over the batch axis (every
    step in the repo uses one) and equal shards, that is the reference's
    mean over the global batch.  Every ``nn.BatchNorm`` (and so
    ``SyncBatchNorm``) in training mode normalises by the global batch's
    statistics (:func:`~.collectives.global_batch_norm` over the dp
    line's group, as XLA's psum gives them in the reference); the last
    step's (mean, variance) of each are in :attr:`batch_stats`.  The
    running statistics stay as they are, as the single-device step and the
    reference's leave them (the forward runs on tensors).  A tp rank of a
    line holds the same batch shard as the others, so it computes the
    same statistics.

    Over a ``tp_axis`` of more than one rank (the reference's tensor
    parallelism) each parameter and its momentum are stored as this
    rank's shard of its :func:`~.speclayout.tp_alternation_specs` spec
    (``tp_rules``, or column- and row-parallel in turn for consecutive
    2-D weights; the rest replicate), and every rank of a tp line passes
    the same batch shard (the batch splits over dp only).  The forward
    runs in a :class:`~.tensor.placement_scope`: a ``Dense`` weight split
    on its output computes column-parallel, one split on its input
    row-parallel, an ``Embedding`` split on its rows vocab-parallel, and
    any other split parameter is gathered at its use.  A split leaf's
    gradient stays its shard; every leaf is all-reduced over dp.  Another
    axis of more than one rank raises: sequence, pipeline and expert
    parallelism run through :mod:`.ring`, :mod:`.pipeline` and
    :mod:`.moe` with an update of the caller's.

    :meth:`save` and :meth:`restore` checkpoint ``{"params",
    "opt_state"}`` through :mod:`..checkpoint` (crash-safe; over a mesh
    every rank calls both, collectively; split leaves are saved as their
    shards with their specs), so a restored step continues bitwise where
    the saved one stopped.

    ``donate`` is accepted and ignored: the reference donates the
    parameter and state buffers to XLA so that its step updates them in
    place; this step already updates its tensors in place.
    """

    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 mesh: Optional[Mesh] = None, device: DeviceLike = None,
                 learning_rate: float = 0.01, momentum: float = 0.9,
                 dp_axis: str = "dp", tp_axis: str = "tp",
                 tp_rules: Optional[Dict[str, Any]] = None,
                 donate: bool = True):
        self.mesh = mesh
        self._world = 1 if mesh is None else mesh.shape.get(dp_axis, 1)
        self._tp = 1 if mesh is None else mesh.shape.get(tp_axis, 1)
        others = {} if mesh is None else {
            a: n for a, n in mesh.shape.items()
            if a not in (dp_axis, tp_axis) and n > 1}
        if others:
            raise MXNetError(
                "TrainStep trains over the %r and %r axes, and the mesh "
                "also splits %s: sequence, pipeline and expert parallelism "
                "run through parallel.ring, pipeline and moe with an update "
                "of the caller's" % (dp_axis, tp_axis, others))
        self._dp_axis, self._tp_axis = dp_axis, tp_axis
        self._group = self._root = None
        if (self._world > 1 or self._tp > 1) and mesh.groups is None:
            raise MXNetError(
                "TrainStep: a mesh of %s needs a process group "
                "(parallel.init_process_group, then make_mesh)"
                % dict(mesh.shape))
        if self._world > 1:
            self._group = mesh.group(dp_axis)
            self._root = mesh.line(dp_axis)[0]
        #: each BatchNorm's global (mean, variance) of the last step
        self.batch_stats: List[Tuple[torch.Tensor, torch.Tensor]] = []
        pure_fn, params = functionalize(block)
        self.device = resolve(device)
        whole = OrderedDict(
            (n, p.to(self.device, copy=True)) for n, p in params.items())
        for axis, n in ((dp_axis, self._world), (tp_axis, self._tp)):
            if n > 1:
                # every rank starts from the line's first rank's weights,
                # as the Trainer's store makes it: blocks initialised
                # apart would train apart
                for p in whole.values():
                    dist.broadcast(p, src=mesh.line(axis)[0],
                                   group=mesh.group(axis))
        from .speclayout import P, place_value, tp_alternation_specs
        if self._tp > 1:
            self.specs = tp_alternation_specs(whole, mesh, tp_axis, tp_rules)
        else:
            self.specs = OrderedDict((n, P()) for n in whole)
        self._shapes = {n: tuple(p.shape) for n, p in whole.items()}
        self.params = OrderedDict(
            (n, place_value(p, Sharding(mesh, self.specs[n]))
             if tuple(self.specs[n]) else p) for n, p in whole.items())
        del whole
        self._use, self._places = {}, {}
        if self._tp > 1:
            from .tensor import use_plan
            self._use, self._places = use_plan(
                block, self.specs, lambda spec: spec, mesh, tp_axis)
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
        # the program registry: one step, and a window of k steps, keyed
        # by the batch's signature (the parameters are the step's own)
        from ..programs import register_program
        self._step_prog = register_program("mesh.train_step", self._step,
                                           mode="light")
        self._window_prog = register_program("mesh.train_window",
                                             self._window, mode="light")

    def _place(self, batch) -> List[torch.Tensor]:
        return [torch.from_numpy(np.asarray(a)).to(self.device)
                if not isinstance(a, torch.Tensor) else a.to(self.device)
                for a in batch]

    shard_batch = _place

    def _allreduce_mean(self, grads: List[torch.Tensor]) -> None:
        """Replace each gradient by its mean over the dp ranks: one
        ``all_reduce`` a fusion bucket (or solo tensor), in place."""
        def mean(flat):
            dist.all_reduce(flat, group=self._group)
            return flat.div_(self._world)

        buckets, solo = self._buckets
        for b in buckets:
            out = b.exchange([grads[p] for p in b.positions], mean)
            for p, g in zip(b.positions, out):
                grads[p] = g
        for p in solo:
            grads[p] = mean(grads[p].contiguous())

    def _uses(self, names, leaves):
        """The tensors the forward takes: each leaf on its use spec."""
        if self._tp == 1:
            return dict(zip(names, leaves))
        from .tensor import to_use
        return {n: to_use(leaf, self.specs[n], self._use.get(n, ()),
                          self.mesh, self._shapes[n],
                          batch_axes=(self._dp_axis,))
                for n, leaf in zip(names, leaves)}

    def _step(self, batch: List[torch.Tensor]) -> torch.Tensor:
        import contextlib
        from .collectives import batch_stats_scope
        from .tensor import placement_scope
        names = list(self.params)
        leaves = [self.params[n].detach().requires_grad_(True)
                  for n in names]
        stats = batch_stats_scope(self.mesh, self._dp_axis) \
            if self._world > 1 else contextlib.nullcontext()
        with torch.enable_grad(), placement_scope(self._places), stats:
            out = self._pure_fn(self._uses(names, leaves), *batch[:-1],
                                training=True)
            loss = self._loss_fn(out, batch[-1])
        if self._world > 1:
            self.batch_stats = stats.stats
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss = loss.detach()
        if self._world > 1:
            self._allreduce_mean(grads)
            loss = loss.clone()
            dist.all_reduce(loss, group=self._group)
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
        return self._step_prog(self._place(batch))

    def _window(self, k: int, placed: List[torch.Tensor]) -> torch.Tensor:
        for _ in range(k):
            loss = self._step(placed)
        return loss.float()

    def run_steps(self, k: int, *batch) -> torch.Tensor:
        """Run ``k`` steps on the same batch; returns the last loss as
        float32 (the JAX package runs them under one dispatch)."""
        if k < 1:
            raise ValueError("run_steps needs k >= 1, got %d" % k)
        return self._window_prog(int(k), self._place(batch))

    def _mesh(self) -> Mesh:
        """The mesh the state lives on: a step without one runs on one
        device, the reference's one-device mesh."""
        if self.mesh is not None:
            return self.mesh
        return Mesh(np.asarray([0]), ("dp",))

    def _state(self):
        return ({"params": self.params, "opt_state": self.opt_state},
                {"params": self.specs, "opt_state": self.specs})

    def save(self, path: str) -> None:
        """Checkpoint ``{"params", "opt_state"}`` to ``path``
        (:func:`..checkpoint.save_sharded`; split leaves as their shards,
        with their specs in the sidecar)."""
        from ..checkpoint import save_sharded
        state, specs = self._state()
        save_sharded(path, state, mesh=self._mesh(), specs=specs)

    def restore(self, path: str) -> None:
        """Load a checkpoint of :meth:`save` (on this mesh or another: the
        leaves are re-sharded by axis name) in place into this step's
        tensors, on its device and in its dtypes."""
        from ..checkpoint import restore_sharded
        state, specs = self._state()
        restore_sharded(path, template=state, mesh=self._mesh(),
                        specs=specs)

    def gathered(self) -> "OrderedDict[str, torch.Tensor]":
        """The whole parameters (a gather of the split ones over the mesh;
        collective: every rank calls it)."""
        from .tensor import assemble
        return OrderedDict(
            (n, assemble(v, self.specs[n], self.mesh)
             if tuple(self.specs[n]) else v) for n, v in self.params.items())

    def write_back(self, block: torch.nn.Module) -> None:
        """Copy the step's parameters into ``block``'s by name (split ones
        gathered first: every rank calls it)."""
        named = dict(block.named_parameters())
        with torch.no_grad():
            for name, value in self.gathered().items():
                named[name].copy_(value)
