"""The whole training step of a Gluon ``Trainer``, as one call.

Counterpart of ``mxnet_tpu/step.py``.  The reference traces the loss
forward, the backward, the bucketed (error-feedback quantized) gradient
exchange, the fused optimizer apply and the metric into one donated
``jax.jit``, with a ``lax.scan`` window over several micro-batches.  Here
each call runs the same pieces eagerly, in the same order and with the
reference's results: a CUDA-graph capture of the step is ROADMAP item 3,
a ``perf_opt`` that builds on this module.

Semantics kept from the reference:

* Every call reads the Trainer's parameters, its updater's states and the
  error-feedback residuals of its compression, and writes them back, so
  eager ``Trainer.step``, ``save_states`` and checkpoints interoperate
  with it mid-run.  lr and wd come from the optimizer each step
  (schedulers apply), through the Trainer's own updater.
* Configurations the step cannot run fall back to the eager pipeline
  (``record``/``backward``/``Trainer.step``) with a one-time warning and
  their reason in :attr:`CompiledStep.fallback_reason`: a server-side
  optimizer (``update_on_kvstore``), an optimizer with no fused form
  (no tree kernel), ``grad_req='add'``, row-sparse gradients, and a
  multi-process store without a layout.
* ``run_window(data, label, accum=k)`` takes ``(n_micro, B, ...)``
  leaves: every ``accum`` consecutive micro-batches accumulate into one
  optimizer step.

**Several contexts.**  Over a Trainer whose parameters have a copy on each
of several contexts in one process, each micro-batch splits over the
contexts (the last takes the remainder), each copy runs forward and
backward on its slice on its own device (a BatchNorm writes that copy's
statistics), the Trainer's store merges the copies' gradients as the eager
``Trainer.step`` does (its compression and error-feedback residuals
included), and every context's updater applies the merged gradient to its
copy, advancing that context's update counts, so that an eager <->
compiled switch continues one trajectory.  The reference traces the same
exchange body over one copy and writes the result to every copy; a
``layout`` with several contexts falls back, with the reference's reason.

**The sharded lane.**  With a :class:`~.parallel.speclayout.SpecLayout`
(or ``MX_MESH_AXES`` / ``MX_FSDP``) the step spans the layout's mesh, one
process a rank.  Every rank calls it with the same global batch and each
computes on its slice of the batch (``batch_spec``: split over data x
fsdp).  The Trainer's trainable parameters are *adopted*: each
parameter's slot holds this rank's shard of its ``param_spec`` and its
updater states their ``state_spec`` shards (ZeRO), so a rank's state
bytes fall with the fsdp axis (:meth:`CompiledStep.state_bytes`).  Each
use goes through :mod:`.parallel.tensor` (the fsdp gather at use, tp's
column- and row-parallel layers); gradients are reduce-scattered onto the
shards, or, with ``compression_params``, summed and int8-quantized per
fusion bucket on the reduce-scatter grain
(:meth:`~.kvstore.kvstore.KVStore.build_exchange_body` with the layout),
and the optimizer applies on the shards.  Inside a process group the
Trainer's own store spans the world; here the layout's mesh owns the
exchange, and a process-local store lends the Trainer's compression
settings and keeps the residuals.  :meth:`CompiledStep.release` gathers
the whole parameters and states back into the Trainer (collectively),
after which the block runs outside the step again; the next call adopts
anew and picks up whatever was set meanwhile.  A layout the step cannot
honour (this rank not on the mesh, a mesh of several ranks without
process groups, a batch that does not split over data x fsdp) raises.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import torch

from .base import MXNetError, get_env
from .ndarray.ndarray import NDArray

__all__ = ["CompiledStep", "scan_window", "step_compile_enabled",
           "metric_trace_kernel", "metric_cache_key"]


def step_compile_enabled() -> bool:
    """``MX_STEP_COMPILE=1``: the whole-step lane is on (read by no code
    of the port yet: its reader, ``Module.fit``, is not ported)."""
    return bool(get_env("MX_STEP_COMPILE", dtype=bool))


def scan_window() -> int:
    """``MX_STEP_SCAN``: micro-batches a window call takes; 0/1 = one
    step a call (read by no code of the port yet: its reader,
    ``Module.fit``, is not ported)."""
    try:
        n = int(get_env("MX_STEP_SCAN", 0, int) or 0)
    except (TypeError, ValueError):
        n = 0
    return max(n, 0)


def metric_trace_kernel(metric):
    """``(kernel, argspec)`` of a metric that folds into the step, or None
    (the step hands the metric its outputs instead).  The port's metrics
    have no such kernel yet, so every metric is updated from the outputs,
    as the reference does for a metric without one."""
    if metric is None:
        return None
    get = getattr(metric, "_trace_kernel", None)
    return get() if get is not None else None


def metric_cache_key(metric, metric_info):
    """The identity of a folded metric: class, argspec and the
    kernel-affecting configuration."""
    if metric_info is None:
        return None
    cfg = tuple(sorted((k, repr(v)) for k, v in
                       getattr(metric, "_kwargs", {}).items()))
    return (type(metric).__name__, metric_info[1], cfg)


def _tensor_of(x, device) -> torch.Tensor:
    if isinstance(x, NDArray):
        x = x.data
    elif not isinstance(x, torch.Tensor):
        import numpy as np
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def _dev_of(x) -> torch.device:
    """Where a batch leaf lies (numpy data: the host)."""
    if isinstance(x, NDArray):
        return x.data.device
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _fused(opt) -> bool:
    """Whether the optimizer has a fused (tree) form."""
    from .optimizer.optimizer import Optimizer
    return type(opt).fused_update is not Optimizer.fused_update


def _state_arrays(state) -> List[NDArray]:
    """The NDArrays of an updater state (None, an NDArray, or nested
    tuples/lists of them), in order."""
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    if isinstance(state, (tuple, list)):
        out = []
        for s in state:
            out.extend(_state_arrays(s))
        return out
    return []


def _clone_state(state):
    """A copy of an updater state (an NDArray, or nested tuples or lists
    of them)."""
    if isinstance(state, NDArray):
        return state.copy()
    if isinstance(state, (tuple, list)):
        return type(state)(_clone_state(s) for s in state)
    return state


def _slices(n: int, parts: int) -> List[slice]:
    """``n`` samples over ``parts`` contexts, the last taking the
    remainder (the reference's eager split)."""
    per = n // parts
    return [slice(d * per, (d + 1) * per if d < parts - 1 else n)
            for d in range(parts)]


def _local_shape(whole, spec, mesh):
    """The shape of a rank's shard of a ``whole``-shaped value."""
    from .parallel.speclayout import shard_slices
    return tuple(len(range(*sl.indices(n)))
                 for sl, n in zip(shard_slices(whole, spec, mesh), whole))


class CompiledStep:
    """One Gluon training step (forward, backward, exchange, update,
    metric) over a live ``gluon.Trainer`` as one call; see the module's
    note.  ``step(data, label)`` is the drop-in for the eager
    record/backward/``Trainer.step``/metric sequence and returns the
    per-sample loss of the whole batch; ``run_window(data, label,
    accum=k)`` runs a window of micro-batches."""

    def __init__(self, net, loss_fn, trainer, metric=None, layout=None):
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._metric = metric
        if layout is None:
            from .parallel.speclayout import layout_from_env
            layout = layout_from_env()
        self._layout = layout
        self._shard_kv = None
        self._fallback_reason: Optional[str] = None
        self._warned = False
        self._plan_cached = None
        self._plan_sig = None
        #: index -> (whole shape, storage spec) of each adopted parameter
        self._adopted: Dict[int, tuple] = {}
        #: ({name: storage spec}, {name: whole shape}) of the layout
        self._specs = None

    # -- cache control -----------------------------------------------------
    @property
    def compiled(self) -> bool:
        return self._fallback_reason is None

    @property
    def fallback_reason(self) -> Optional[str]:
        return self._fallback_reason

    def invalidate(self) -> None:
        """Drop the cached plan: the next call plans from the current
        configuration."""
        self._plan_cached = None
        self._plan_sig = None

    def _fall(self, reason: str):
        self._fallback_reason = reason
        if not self._warned:
            self._warned = True
            warnings.warn("CompiledStep: falling back to the eager "
                          "pipeline (%s)" % reason, stacklevel=3)
        return None

    # -- plan --------------------------------------------------------------
    def _plan_signature(self):
        tr = self._trainer
        kv = tr._kvstore if self._layout is None else self._ensure_shard_kv()
        gc = getattr(kv, "_gc", None) if kv is not None else None
        from .kvstore.bucketing import bucket_bytes
        opt = tr._optimizer
        return (id(kv), tr._update_on_kvstore, id(opt),
                None if self._layout is None else self._layout.signature(),
                tuple(p.grad_req for p in tr._params),
                None if gc is None else (gc.type, gc.block, gc.threshold),
                getattr(kv, "_compress_bf16", False) if kv else False,
                bucket_bytes())

    def _plan(self):
        if self._fallback_reason is not None:
            return None
        tr = self._trainer
        if not tr._kv_initialized:
            tr._init_kvstore()
        if tr._params_to_init and len(tr._contexts) <= 1:
            # over several contexts the first broadcast waits for the first
            # forward, as in the eager Trainer.step (:meth:`_run_copies`)
            tr._init_params()
        sig = self._plan_signature()
        if self._plan_cached is not None and sig == self._plan_sig:
            return self._plan_cached
        if tr._update_on_kvstore:
            return self._fall("server-side optimizer (update_on_kvstore)")
        opt = tr._optimizer
        if not _fused(opt):
            return self._fall("optimizer %s has no pure tree kernel"
                              % type(opt).__name__)
        kv = tr._kvstore
        if self._layout is None and kv is not None and kv.num_workers > 1:
            return self._fall("multi-process exchange needs the SPMD mesh "
                              "lane (parallel.TrainStep)")
        from .gluon.parameter import DeferredInitializationError
        trainable_idx, frozen = [], []
        for i, p in enumerate(tr._params):
            if p._tensor().is_meta:
                raise DeferredInitializationError(
                    "Parameter %s is not initialized yet" % p.name)
            if p.grad_req == "add":
                return self._fall("grad_req='add' (use run_window(accum=k) "
                                  "for compiled gradient accumulation)")
            if p.grad_req == "null":
                frozen.append(i)
            elif getattr(p, "_grad_stype", "default") == "row_sparse":
                return self._fall("row_sparse gradients take the per-key "
                                  "gather/scatter path")
            else:
                trainable_idx.append(i)
        ctxs = list(tr._contexts)
        if self._layout is not None and len(ctxs) > 1:
            return self._fall(
                "SpecLayout sharded lane is SPMD over the mesh — use ONE "
                "Trainer context (the mesh owns the devices)")
        names = self._names()
        plan = {"trainable_idx": trainable_idx, "frozen": frozen,
                "ctxs": ctxs,
                "names": [names[i] for i in trainable_idx],
                "layout": self._layout, "exchange": None}
        if self._layout is not None:
            self._plan_layout(plan)
        self._plan_cached = plan
        self._plan_sig = sig
        return plan

    def _names(self) -> List[str]:
        """Each Trainer parameter's structural name in the net."""
        by_slot = {}
        for mname, m in self._net.named_modules():
            for attr in m.__dict__.get("_parameters", {}):
                by_slot[(id(m), attr)] = (mname + "." if mname else "") + attr
        out = []
        for p in self._trainer._params:
            name = by_slot.get((id(p._owner), p._attr))
            if name is None:
                raise MXNetError("CompiledStep: Parameter %s is not in the "
                                 "net" % p.name)
            out.append(name)
        return out

    def _plan_layout(self, plan) -> None:
        """The sharded lane's part of the plan: each trainable parameter's
        whole shape, storage, compute and use specs, the layers'
        placements, and the exchange body."""
        layout = self._layout
        mesh = layout.mesh
        try:
            mesh.coords()
        except MXNetError as e:
            raise MXNetError("CompiledStep: this rank cannot take part in "
                             "the layout: %s" % e) from None
        if mesh.size > 1 and mesh.groups is None:
            raise MXNetError("CompiledStep: the layout's mesh %s has no "
                             "process groups (make it with make_mesh "
                             "inside the process group)" % dict(mesh.shape))
        tr = self._trainer
        if self._specs is None:
            # resolved once, on the whole shapes: adopted slots hold shards
            self._specs = (layout.resolve(self._net), {
                n: tuple(p.shape) for n, p in self._net.named_parameters()})
        specs, whole = self._specs
        storage = {n: specs[n] for n in plan["names"]}
        shapes = {n: whole[n] for n in plan["names"]}
        from .parallel.tensor import use_plan
        use, places = use_plan(self._net, storage, layout.compute_spec,
                               mesh, layout.tp_axis)
        plan.update(shapes=shapes, storage=storage, use=use, places=places)
        kvx = self._ensure_shard_kv()
        if kvx is not None:
            templates = [NDArray(torch.empty(shapes[n], dtype=tr._params[
                i]._tensor().dtype, device="meta"))
                for i, n in zip(plan["trainable_idx"], plan["names"])]
            plan["exchange"] = kvx.build_exchange_body(
                plan["trainable_idx"], templates, layout=layout)
            plan["gc"] = kvx._gc

    def _ensure_shard_kv(self):
        """The sharded lane's exchange store: a process-local store with
        the Trainer's compression settings (the residuals live there), or
        None without compression."""
        if self._layout is None:
            return None
        if self._shard_kv is None and self._trainer._compression_params:
            from .kvstore import create as _kv_create
            kv = _kv_create("local")
            kv.set_gradient_compression(self._trainer._compression_params)
            self._shard_kv = kv
        return self._shard_kv

    # -- adoption (the sharded lane) --------------------------------------
    def _adopt(self, plan) -> None:
        """Each trainable parameter's slot and updater states onto this
        rank's shards; a slot that holds the whole value again (released,
        or set meanwhile) is sliced anew."""
        from .parallel.speclayout import place_value
        layout, tr = self._layout, self._trainer
        upd = tr._updaters[0]
        for i, name in zip(plan["trainable_idx"], plan["names"]):
            p = tr._params[i]
            whole, spec = plan["shapes"][name], plan["storage"][name]
            t = p._tensor()
            if i not in self._adopted or tuple(t.shape) == whole:
                if tuple(t.shape) != whole:
                    raise MXNetError("CompiledStep: Parameter %s holds %s, "
                                     "neither its shape %s nor its shard"
                                     % (p.name, tuple(t.shape), whole))
                if tuple(spec):
                    with torch.no_grad():
                        p._replace(place_value(t.detach(),
                                               layout.sharding(spec)))
                self._adopted[i] = (whole, spec)
            if i not in upd.states:
                upd.states[i] = tr._optimizer.create_state_multi_precision(
                    i, p.data())
                upd.states_synced[i] = True
            for s in _state_arrays(upd.states[i]):
                sspec = layout.state_spec(spec, tuple(s.shape))
                if tuple(sspec) and tuple(s.shape) == whole:
                    s._data = place_value(s.data, layout.sharding(sspec))

    def release(self) -> None:
        """Gather the adopted parameters and their updater states back to
        whole values in the Trainer (every rank of the layout calls it),
        so that the block runs outside the step and eager
        ``Trainer.step`` works on it; the next call adopts anew."""
        if not self._adopted:
            return
        from .parallel.tensor import assemble
        mesh = self._layout.mesh
        tr = self._trainer
        upd = tr._updaters[0]
        for i, (whole, spec) in sorted(self._adopted.items()):
            p = tr._params[i]
            t = p._tensor()
            if tuple(spec) and tuple(t.shape) != whole:
                with torch.no_grad():
                    p._replace(assemble(t.detach(), spec, mesh))
            sspec = self._layout.state_spec(spec, tuple(whole))
            local = _local_shape(whole, sspec, mesh)
            for s in _state_arrays(upd.states.get(i)):
                if tuple(sspec) and tuple(s.shape) == local != whole:
                    s._data = assemble(s.data, sspec, mesh)
        self._adopted.clear()

    def state_bytes(self) -> int:
        """This rank's bytes of trainable parameters plus their optimizer
        state (momenta, moments, float32 masters): what the fsdp axis
        divides."""
        plan = self._plan()
        tr = self._trainer
        idxs = plan["trainable_idx"] if plan is not None else [
            i for i, p in enumerate(tr._params) if p.grad_req != "null"]
        total = 0
        upd = tr._updaters[0]
        for i in idxs:
            t = tr._params[i]._tensor()
            total += t.numel() * t.element_size()
            for s in _state_arrays(upd.states.get(i)):
                total += s.data.numel() * s.data.element_size()
        return total

    # -- checkpoints --------------------------------------------------------
    def checkpoint_state(self):
        """``(state, specs)``: ``{"params": {name: tensor}, "opt_state":
        {name: {"0": tensor, ...}}, "update_counts": {name: tensor}}`` of
        the trainable parameters as this rank holds them (the counts are
        the optimizer's per-parameter update counts, which Adam's bias
        correction reads), and the same tree of partition specs (the
        shards' under a layout), for :func:`~.checkpoint.save_sharded`."""
        plan = self._plan()
        if plan is None:
            raise MXNetError("CompiledStep.checkpoint_state: the step fell "
                             "back to the eager pipeline (%s)"
                             % self._fallback_reason)
        if self._layout is not None:
            self._adopt(plan)
        tr = self._trainer
        upd = tr._updaters[0]
        state = {"params": {}, "opt_state": {}, "update_counts": {}}
        specs = {"params": {}, "opt_state": {}, "update_counts": {}}
        counts = self._update_counts()
        for i, name in zip(plan["trainable_idx"], plan["names"]):
            state["update_counts"][name] = torch.tensor(
                [counts.get(i, tr._optimizer.begin_num_update)],
                dtype=torch.int64)
            specs["update_counts"][name] = ()
            if i not in upd.states:
                upd.states[i] = tr._optimizer.create_state_multi_precision(
                    i, tr._params[i].list_data()[0])
                upd.states_synced[i] = True
            state["params"][name] = tr._params[i]._tensor().data
            sts = _state_arrays(upd.states[i])
            state["opt_state"][name] = {str(j): s.data
                                        for j, s in enumerate(sts)}
            specs["params"][name] = ()
            specs["opt_state"][name] = {str(j): () for j in range(len(sts))}
            if self._layout is None:
                continue
            spec, whole = plan["storage"][name], plan["shapes"][name]
            sspec = self._layout.state_spec(spec, whole)
            local = _local_shape(whole, sspec, self._layout.mesh)
            specs["params"][name] = spec
            for j, st in enumerate(sts):
                if tuple(st.shape) == local:
                    specs["opt_state"][name][str(j)] = sspec
        return state, specs

    def _update_counts(self, d: int = 0) -> Dict[int, int]:
        """The optimizer's update counts of the parameters' ``d``-th
        context, by which the updaters key them."""
        opt = self._trainer._optimizer
        ctx = self._trainer._params[0].list_ctx()[d]
        opt._set_current_context((ctx.device_type, ctx.device_id))
        return opt._index_update_count

    def _mesh(self):
        from .parallel.mesh import Mesh
        import numpy as np
        if self._layout is not None:
            return self._layout.mesh
        return Mesh(np.asarray([0]), ("data",))

    def save(self, path: str) -> None:
        """Checkpoint the trainable parameters and their optimizer state
        (:func:`~.checkpoint.save_sharded`: shards as they are held, their
        specs in the sidecar); every rank of the layout calls it."""
        from .checkpoint import save_sharded
        state, specs = self.checkpoint_state()
        save_sharded(path, state, mesh=self._mesh(), specs=specs)

    def restore(self, path: str) -> None:
        """Load a checkpoint of :meth:`save`, taken on this layout or any
        other (sharded or not, of any world size: the leaves are
        re-sharded by axis name), into the Trainer's parameters and
        updater states."""
        from .checkpoint import restore_sharded
        state, specs = self.checkpoint_state()
        restore_sharded(path, template=state, mesh=self._mesh(),
                        specs=specs)
        plan, tr = self._plan(), self._trainer
        opt = tr._optimizer
        for d in range(len(plan["ctxs"])):
            counts = self._update_counts(d)
            for i, name in zip(plan["trainable_idx"], plan["names"]):
                counts[i] = int(state["update_counts"][name][0])
            if counts:
                opt.num_update = max(opt.num_update, max(counts.values()))
        # the other contexts' copies and updater states take the first's
        from .optimizer.optimizer import _on_context
        for i in plan["trainable_idx"]:
            p = tr._params[i]
            with torch.no_grad():
                for t in list(p._tensors().values())[1:]:
                    t.copy_(p._tensor())
            for c, upd in zip(plan["ctxs"][1:], tr._updaters[1:]):
                upd.states[i] = _on_context(_clone_state(
                    tr._updaters[0].states[i]), c)
                upd.states_synced[i] = True

    # -- the step -----------------------------------------------------------
    def _device(self):
        return self._trainer._params[0]._tensor().device

    def _batch_slices(self, shape, batch_dim):
        """This rank's slice of a global batch leaf; raises where the
        batch does not split over data x fsdp."""
        layout = self._layout
        spec = layout.batch_spec_for(tuple(shape), batch_dim)
        want = layout.batch_spec()
        if tuple(want) and tuple(spec) != (None,) * batch_dim + tuple(want):
            raise MXNetError(
                "CompiledStep: a batch of %d does not split over the "
                "layout's %s" % (shape[batch_dim], dict(layout.mesh.shape)))
        from .parallel.speclayout import shard_slices
        return shard_slices(tuple(shape), spec, layout.mesh)

    def _gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch of a per-rank batch-leading result."""
        layout = self._layout
        if layout is None or not tuple(layout.batch_spec()):
            return x
        from .parallel.tensor import assemble
        return assemble(x.contiguous(), layout.batch_spec(), layout.mesh)

    def _micro(self, plan, leaves, uses, x_list, y, ctx=None):
        """Forward and backward of one micro-batch (on context ``ctx``'s
        copies): (per-sample loss, first output, gradients of the
        leaves)."""
        from . import autograd
        from .parallel.tensor import placement_scope
        x_nds = [NDArray(x, ctx) for x in x_list]
        y_nd = NDArray(y, ctx)
        with autograd.record(), placement_scope(plan.get("places", {})):
            if uses is None:
                out = self._net(*x_nds)
            else:
                out = torch.func.functional_call(
                    self._net, uses, tuple(x_nds), strict=False)
            loss = self._loss_fn(out, y_nd)
        losses = loss if isinstance(loss, (list, tuple)) else [loss]
        total = sum(l.data.sum() for l in losses)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
        out0 = out[0] if isinstance(out, (list, tuple)) else out
        return losses[0].data.detach(), out0.data.detach(), grads

    def _leaves(self, plan):
        """(leaves, uses) of one step: the Trainer's tensors themselves
        without a layout; with one, this rank's shards (or, under a
        compressed exchange, their use tensors) and the tensors the
        forward takes."""
        tr = self._trainer
        idxs = plan["trainable_idx"]
        if self._layout is None:
            return [tr._params[i]._tensor() for i in idxs], None
        from .parallel.tensor import to_use
        layout = self._layout
        batch = (layout.data_axis, layout.fsdp_axis)
        leaves, uses = [], {}
        for i, name in zip(idxs, plan["names"]):
            shard = tr._params[i]._tensor().detach()
            args = (plan["storage"][name], plan["use"][name], layout.mesh,
                    plan["shapes"][name])
            if plan["exchange"] is None:
                leaf = shard.requires_grad_(True)
                uses[name] = to_use(leaf, *args, batch_axes=batch)
            else:
                with torch.no_grad():
                    leaf = to_use(shard, *args, batch_axes=batch)
                leaf = leaf.detach().requires_grad_(True)
                uses[name] = leaf
            leaves.append(leaf)
        return leaves, uses

    def _reduce(self, plan, grads):
        """Gradients onto this rank's shards, summed over the whole
        batch."""
        layout = self._layout
        if layout is None:
            return grads
        mesh = layout.mesh
        batch = [a for a in (layout.data_axis, layout.fsdp_axis)
                 if layout.axis_size(a) > 1]
        names = plan["names"]
        if plan["exchange"] is not None:
            return self._reduce_exchanged(plan, grads)
        # the use's backward summed over the axes of each storage spec;
        # the rest of the batch axes, one all-reduce a fusion bucket
        from .kvstore.bucketing import Bucket, bucket_bytes, plan_buckets
        from .base import dtype_name
        groups: Dict[tuple, List[int]] = {}
        for pos, name in enumerate(names):
            axes = tuple(a for a in batch
                         if a not in plan["storage"][name].axes())
            if axes:
                groups.setdefault(axes, []).append(pos)
        out = list(grads)
        for axes, poss in groups.items():
            gs = [out[p] for p in poss]

            def allreduce(flat, axes=axes):
                import torch.distributed as dist
                for a in axes:
                    dist.all_reduce(flat, group=mesh.group(a))
                return flat
            buckets, solo = plan_buckets(
                list(range(len(gs))), [tuple(g.shape) for g in gs],
                [dtype_name(g.dtype) for g in gs],
                [g.element_size() for g in gs], ["default"] * len(gs),
                bucket_bytes())
            for b in buckets:
                for q, g in zip(b.positions, b.exchange(
                        [gs[q] for q in b.positions], allreduce)):
                    out[poss[q]] = g
            for q in solo:
                out[poss[q]] = allreduce(gs[q].contiguous().clone())
        return out

    def _reduce_exchanged(self, plan, grads):
        """The compressed lane: each use gradient padded into the whole
        shape (summed over the use spec's axes, whose pieces are
        disjoint), the exchange body (sum over data x fsdp, int8 on the
        reduce-scatter grain), then this rank's storage shard of each."""
        import torch.distributed as dist
        from .parallel.speclayout import shard_slices
        layout = self._layout
        mesh = layout.mesh
        wholes = []
        for g, name in zip(grads, plan["names"]):
            shape, use = plan["shapes"][name], plan["use"][name]
            if tuple(use):
                w = g.new_zeros(shape)
                w[shard_slices(shape, use, mesh)] = g
                for a in use.axes():
                    if mesh.axis_size(a) > 1:
                        dist.all_reduce(w, group=mesh.group(a))
            else:
                w = g
            wholes.append(w)
        ex, gc = plan["exchange"], plan["gc"]
        device = wholes[0].device if wholes else None
        residuals = [gc.peek_residual(wk, ex.residual_local_shape(j), dt,
                                      device)
                     for j, (wk, _s, dt) in enumerate(ex.residual_specs)]
        wholes, new_res = ex(wholes, residuals)
        for (wk, _s, _d), r in zip(ex.residual_specs, new_res):
            gc.put_residual(wk, r)
        out = []
        for w, name in zip(wholes, plan["names"]):
            spec = plan["storage"][name]
            out.append(w[shard_slices(tuple(w.shape), spec, mesh)]
                       .contiguous() if tuple(spec) else w)
        return out

    def _apply(self, plan, grads, batch_size):
        tr = self._trainer
        tr._check_and_rescale_grad(tr._scale / batch_size)
        idxs = plan["trainable_idx"]
        ws = [tr._params[i].data() for i in idxs]
        tr._updaters[0](idxs, [NDArray(g) for g in grads], ws)

    def _run(self, plan, n_steps, accum, xs, y, batch_size):
        """``n_steps`` optimizer steps of ``accum`` micro-batches each
        over ``xs``/``y`` leaves shaped ``(n_steps * accum, B, ...)``;
        returns the per-micro-batch losses and first outputs (whole
        batch)."""
        if len(plan["ctxs"]) > 1:
            return self._run_copies(plan, n_steps, accum, xs, y, batch_size)
        if self._layout is not None:
            self._adopt(plan)
        losses, outs = [], []
        for t in range(n_steps):
            leaves, uses = self._leaves(plan)
            acc = None
            for m in range(accum):
                k = t * accum + m
                loss, out, grads = self._micro(
                    plan, leaves, uses, [x[k] for x in xs], y[k])
                acc = grads if acc is None else [a + g for a, g in
                                                 zip(acc, grads)]
                losses.append(self._gather_batch(loss))
                outs.append(out)
            acc = self._reduce(plan, [g.detach() for g in acc])
            self._apply(plan, acc, batch_size)
        return losses, outs

    def _run_copies(self, plan, n_steps, accum, xs, y, batch_size):
        """:meth:`_run` over a Trainer with a copy on each of several
        contexts; see the module's note."""
        tr = self._trainer
        ctxs, idxs = plan["ctxs"], plan["trainable_idx"]
        copies = [list(tr._params[i]._tensors().values()) for i in idxs]
        losses, outs = [], []
        for t in range(n_steps):
            acc = None
            for m in range(accum):
                k = t * accum + m
                parts = _slices(int(y[k].shape[0]), len(ctxs))
                step_loss, step_out, grads = [], [], []
                for d, (c, sl) in enumerate(zip(ctxs, parts)):
                    dev = c.torch_device
                    loss, out, g = self._micro(
                        plan, [cp[d] for cp in copies], None,
                        [x[k][sl].to(dev) for x in xs], y[k][sl].to(dev),
                        ctx=c)
                    step_loss.append(loss.to(xs[0].device))
                    step_out.append(out.to(xs[0].device))
                    grads.append(g)
                acc = grads if acc is None else [
                    [a + g for a, g in zip(ad, gd)]
                    for ad, gd in zip(acc, grads)]
                losses.append(torch.cat(step_loss))
                outs.append(torch.cat(step_out))
            if tr._params_to_init:
                tr._init_params()
            merged = [[NDArray(acc[d][p].detach(), c)
                       for d, c in enumerate(ctxs)] for p in range(len(idxs))]
            self._exchange(idxs, merged)
            tr._check_and_rescale_grad(tr._scale / batch_size)
            for d, upd in enumerate(tr._updaters):
                upd(idxs, [g[d] for g in merged],
                    [NDArray(cp[d], ctxs[d]) for cp in copies])
        return losses, outs

    def _exchange(self, idxs, vlists) -> None:
        """The Trainer store's merge of each key's copies, written into
        every copy: the exchange the eager ``Trainer.step`` runs when no
        overlap session is armed (buckets packed as it packs them)."""
        tr = self._trainer
        kv = tr._kvstore
        sess = kv.begin_exchange(idxs, vlists, reverse=tr._overlap)
        if sess is not None:
            sess.drain()
            return
        kv.push(idxs, vlists)
        kv.pull(idxs, vlists)

    def _split_batch(self, xs, y, batch_dim):
        """This rank's slices of the batch leaves, on the device (on the
        host as given, for several contexts: each takes its slice)."""
        if len(self._trainer._contexts) > 1:
            return [_tensor_of(x, _dev_of(x)) for x in xs], \
                _tensor_of(y, _dev_of(y))
        dev = self._device()
        xs = [_tensor_of(x, dev) for x in xs]
        y = _tensor_of(y, dev)
        if self._layout is None:
            return xs, y
        xs = [x[self._batch_slices(x.shape, batch_dim)] for x in xs]
        y = y[self._batch_slices(y.shape, batch_dim)]
        return xs, y

    def _update_metric(self, ys, outs):
        if self._metric is None:
            return
        for y, out in zip(ys, outs):
            self._metric.update([NDArray(self._gather_batch(y))],
                                [NDArray(self._gather_batch(out))])

    def step(self, data, label, batch_size=None):
        """One training step; returns the per-sample loss of the whole
        batch (the eager shape)."""
        from .gluon.parameter import DeferredInitializationError
        datas = data if isinstance(data, (list, tuple)) else (data,)
        batch_size = batch_size or int(datas[0].shape[0])
        try:
            plan = self._plan()
        except DeferredInitializationError:
            plan = None
        if plan is None:
            return self._eager_step(datas, label, batch_size)
        xs, y = self._split_batch(datas, label, 0)
        losses, outs = self._run(plan, 1, 1, [x[None] for x in xs],
                                 y[None], batch_size)
        self._update_metric([y], outs)
        return NDArray(losses[0], plan["ctxs"][0])

    def run_window(self, data, label, batch_size=None, accum=1):
        """A window of ``n_micro = n_steps * accum`` micro-batches: ``data``
        leaves are ``(n_micro, B, ...)``, and every ``accum`` consecutive
        micro-batches accumulate into one optimizer step.  Returns the
        per-micro-batch losses, ``(n_micro, B, ...)``."""
        from .gluon.parameter import DeferredInitializationError
        datas = data if isinstance(data, (list, tuple)) else (data,)
        accum = max(1, int(accum))
        n_micro = int(datas[0].shape[0])
        if n_micro % accum:
            raise MXNetError("run_window: %d micro-batches do not divide "
                             "into accum=%d groups" % (n_micro, accum))
        n_steps = n_micro // accum
        B = int(datas[0].shape[1])
        batch_size = batch_size or B * accum
        try:
            plan = self._plan()
        except DeferredInitializationError:
            plan = None
        if plan is None:
            if accum > 1:
                raise MXNetError(
                    "run_window(accum=%d) has no eager fallback (%s); use "
                    "grad_req='add' accumulation on the eager path"
                    % (accum, self._fallback_reason))
            dev = self._device()
            losses = [self._eager_step(
                tuple(NDArray(_tensor_of(x, dev)[t]) for x in datas),
                NDArray(_tensor_of(label, dev)[t]), batch_size).data
                for t in range(n_micro)]
            return NDArray(torch.stack(losses))
        xs, y = self._split_batch(datas, label, 1)
        losses, outs = self._run(plan, n_steps, accum, xs, y, batch_size)
        self._update_metric(list(y), outs)
        return NDArray(torch.stack(losses), plan["ctxs"][0])

    # -- the debug path -----------------------------------------------------
    def _eager_step(self, datas, label, batch_size):
        """record/backward/``Trainer.step``; over several contexts the
        batch splits over them, each copy runs its own forward and
        backward, and the Trainer's exchange merges (the classic Gluon
        data-parallel loop).  Returns the first context's loss."""
        from . import autograd
        ctxs = self._trainer._contexts
        n = int(label.shape[0])
        losses, first = [], None
        with autograd.record():
            for c, sl in zip(ctxs, _slices(n, len(ctxs))):
                dev = c.torch_device
                x_nds = [NDArray(_tensor_of(d, dev)[sl], c) for d in datas]
                y_nd = NDArray(_tensor_of(label, dev)[sl], c)
                out = self._net(*x_nds)
                loss = self._loss_fn(out, y_nd)
                losses.append(loss)
                if first is None:
                    first = (out, y_nd)
        autograd.backward(losses)
        self._trainer.step(batch_size)
        if self._metric is not None:
            out, y_nd = first
            out0 = out[0] if isinstance(out, (list, tuple)) else out
            self._metric.update([y_nd], [out0])
        return losses[0]
