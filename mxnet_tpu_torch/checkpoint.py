"""Checkpoints of training state, and the resume that the failure posture
rests on.

Counterpart of ``mxnet_tpu/checkpoint.py``, written on
``torch.distributed.checkpoint`` (DCP) where the reference writes orbax.
The failure posture is the reference's: fail fast and restart from the
last checkpoint.  A lost rank wedges a collective, so within one world the
job relies on the launcher's supervisor restarting its processes
(``python -m mxnet_tpu_torch.tools.launch --restart on-failure``) and on
:meth:`CheckpointManager.latest_step` to resume.  An elastic resize
happens between epochs, through this module: the supervisor drains every
rank at an epoch boundary, the checkpoint is the hand-off, and the resized
world restores it (:func:`resume_or_init`).

* :func:`save_sharded` writes a tree (nested dicts) of tensors; every
  rank of a process group calls it (DCP's collective save writes each
  replicated tensor once).  The write goes to ``<name>.saving-tmp``, the
  ``checkpoint.commit`` fault site fires, and rank 0 commits with two
  renames through ``<name>.replaced``, so a process killed at any point
  leaves the last complete checkpoint restorable (:func:`_recover_commit`
  heals a kill between the renames).
* A leaf split over the mesh (``specs`` gives its partition spec, and
  the leaf is this rank's shard) is saved as the shards the ranks hold,
  **one key a shard**: ``<leaf>#shard[i,j,...]`` with the shard's block
  index along each dimension.  Ranks that hold the same shard (replicas
  over the other axes) write the same key, which DCP writes once; a
  replicated leaf keeps its plain key.
* The ``<name>.speclayout.json`` sidecar, written after the commit,
  records the leaves' layout as the reference's ``_spec_to_json`` /
  ``_sidecar_doc`` do: ``schema``, ``mesh_axes`` (the saving mesh's
  axis sizes), ``leaf_specs`` (one entry a leaf in the tree's order: its
  spec as a list of None, an axis or a list of axes, ``[]`` for a
  replicated leaf on a mesh, ``null`` without a mesh) and ``world_size``
  (the process group's size, 1 without one, which tells a resize from a
  plain restart).
* :func:`restore_sharded` loads into a template's tensors (their devices
  and dtypes), or without a template builds the tree of whole values on
  the CPU.  With ``mesh`` (and no explicit ``specs``) each leaf is
  re-sharded by axis **name** from the sidecar onto that mesh, of any
  world size: an axis the mesh lacks, or that no longer divides the
  dimension, drops out, so a sharded save restores whole on a
  data-parallel mesh and onto the shards of another fsdp mesh; a leaf
  whose target shard differs in shape from the template's is returned as
  a new tensor in the template's place.
* :class:`CheckpointManager` keeps step-numbered checkpoints in
  ``<dir>/<step>`` (orbax's names) with ``max_to_keep`` retention and a
  ``speclayout.json`` for the directory; :func:`resume_or_init` is the
  recovery loop's entry point.

A checkpoint of one package cannot be read by the other (DCP's files are
not orbax's).  Parameters cross between the packages as numpy arrays, by
name, through :mod:`.convert`.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from collections.abc import Mapping
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import fault as _fault
from .base import MXNetError
from .parallel.mesh import Mesh, Sharding

__all__ = ["save_sharded", "restore_sharded", "CheckpointManager",
           "resume_or_init", "saved_specs", "saved_world_size",
           "shardings_from_saved"]

SPEC_SCHEMA = 1
_SPEC_SIDECAR = ".speclayout.json"
_TMP_MARK = ".saving-"      # an in-progress save: <name>.saving-tmp (one
                            # name, so every rank of a collective save
                            # hands DCP the same directory)
_METADATA = ".metadata"     # the file DCP writes last


def _group() -> Tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _sync(world: int) -> None:
    if world > 1:
        dist.barrier()


def _check_state(state, where="state") -> None:
    """A checkpoint holds nested mappings of tensors, nothing else."""
    if not isinstance(state, Mapping):
        raise TypeError("%s: a checkpoint holds a mapping of tensors, got "
                        "%s" % (where, type(state).__name__))
    for k, v in state.items():
        if isinstance(v, Mapping):
            _check_state(v, "%s[%r]" % (where, k))
        elif not isinstance(v, torch.Tensor):
            raise TypeError("%s[%r]: a checkpoint leaf is a tensor, got %s"
                            % (where, k, type(v).__name__))


def _leaves(state, specs=None, path=()):
    """(path, leaf, spec) in the tree's order; ``specs`` is a tree of the
    same structure with a partition spec a leaf (or None: replicated)."""
    if isinstance(state, Mapping):
        for k, v in state.items():
            sub = specs.get(k) if isinstance(specs, Mapping) else None
            yield from _leaves(v, sub, path + (k,))
    else:
        yield path, state, tuple(specs) if specs is not None else ()


def _spec_to_json(spec) -> list:
    """A partition spec as JSON entries (None | axis | [axes])."""
    out = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def _sidecar_doc(state, mesh: Optional[Mesh] = None, specs=None) -> dict:
    return {"schema": SPEC_SCHEMA,
            "mesh_axes": {} if mesh is None else
            {str(k): int(v) for k, v in mesh.shape.items()},
            "leaf_specs": [None if mesh is None else _spec_to_json(spec)
                           for _, _, spec in _leaves(state, specs)],
            "world_size": _group()[0]}


def _sidecar_path(path: str) -> str:
    return os.path.abspath(path) + _SPEC_SIDECAR


def _write_sidecar(target: str, state, mesh: Optional[Mesh],
                   specs=None) -> None:
    """Atomic (temp and rename) sidecar write; rank 0 only."""
    doc = _sidecar_doc(state, mesh, specs)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.write("\n")
    os.replace(tmp, target)


def _validate_sidecar(doc) -> Optional[dict]:
    """None on anything but a well-formed schema-1 document."""
    if not isinstance(doc, dict) or doc.get("schema") != SPEC_SCHEMA:
        return None
    if not isinstance(doc.get("leaf_specs"), list):
        return None
    return doc


def _read_sidecar(target: str) -> Optional[dict]:
    try:
        with open(target) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return _validate_sidecar(doc)


def saved_specs(path: str) -> Optional[dict]:
    """The sidecar document saved beside checkpoint ``path``, or None
    (absent, unreadable or of another schema: advisory metadata)."""
    return _read_sidecar(_sidecar_path(path))


def saved_world_size(path: str) -> Optional[int]:
    """How many processes wrote checkpoint ``path`` (the sidecar's
    ``world_size``), or None without a sidecar.  An elastic resume
    compares it with the current world to tell a resize from a
    restart."""
    doc = saved_specs(path)
    if doc is None:
        return None
    try:
        w = int(doc.get("world_size", 0))
    except (TypeError, ValueError):
        return None
    return w if w > 0 else None


def _spec_onto_mesh(entries, shape, mesh: Mesh) -> Sharding:
    """One leaf's saved spec rebuilt onto ``mesh``: axes are matched by
    name, and an axis the mesh lacks, or that no longer divides the
    dimension, drops out (the reference's elastic-restore rule)."""
    sizes = {str(k): int(v) for k, v in mesh.shape.items()}
    out = []
    for dim, entry in zip(tuple(shape), tuple(entries or ())):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, list) else [entry]
        kept, whole = [], 1
        for a in axes:
            sz = sizes.get(str(a), 1)
            if sz > 1 and int(dim) % (whole * sz) == 0:
                kept.append(str(a))
                whole *= sz
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return Sharding(mesh, tuple(out))


def _shardings_from_doc(doc, template, mesh: Mesh):
    """Per-leaf shardings for ``template`` on ``mesh`` from a sidecar, in
    the template's structure; leaves past the saved list replicate."""
    specs = doc["leaf_specs"]
    i = [0]

    def walk(node):
        if isinstance(node, Mapping):
            return type(node)((k, walk(v)) for k, v in node.items())
        entries = specs[i[0]] if i[0] < len(specs) else None
        i[0] += 1
        shape = tuple(getattr(node, "shape", ()) or ())
        return _spec_onto_mesh(entries, shape, mesh) if entries \
            else Sharding(mesh, ())
    return walk(template)


def shardings_from_saved(path: str, template, mesh: Optional[Mesh]):
    """Per-leaf :class:`~.parallel.mesh.Sharding` for restoring checkpoint
    ``path`` onto ``mesh``, from its sidecar; None without a sidecar or a
    mesh."""
    doc = saved_specs(path)
    if doc is None or mesh is None:
        return None
    return _shardings_from_doc(doc, template, mesh)


def _dcp(fn: str, state, path: str, world: int) -> None:
    """DCP's ``save`` or ``load`` of ``state`` at ``path``: collective in a
    process group, single-process without one (whose warning, that it
    found no group, says what is meant here)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="torch.distributed is disabled")
            getattr(dcp, fn)(state, checkpoint_id=path, no_dist=world == 1)
    except CheckpointException as e:
        # DCP's error derives from BaseException: raise one that a
        # caller's `except Exception` sees
        raise MXNetError("checkpoint %s: %s failed: %s" % (path, fn, e)) \
            from e


_SHARD = "#shard["


def _shard_key(key: str, spec, shape, mesh: Mesh) -> str:
    """``<key>#shard[i,j,...]``: the block index, along each dimension, of
    this rank's shard of a leaf of whole ``shape`` under ``spec``."""
    from .parallel.speclayout import shard_slices
    idx = []
    for sl, dim in zip(shard_slices(shape, spec, mesh), shape):
        step = (sl.stop - sl.start) if sl.start is not None else dim
        idx.append(0 if sl.start is None or not step else sl.start // step)
    return "%s%s%s]" % (key, _SHARD, ",".join(map(str, idx)))


def _split_tree(state, specs, mesh: Optional[Mesh]):
    """The tree DCP writes: a split leaf under its shard's key, in its
    parent mapping (a plain dict of the same keys otherwise)."""
    if specs is None or mesh is None:
        return state

    def walk(node, sp):
        out = {}
        for k, v in node.items():
            sub = sp.get(k) if isinstance(sp, Mapping) else None
            if isinstance(v, Mapping):
                out[k] = walk(v, sub)
            elif sub is not None and tuple(sub):
                from .parallel.speclayout import PartitionSpec
                spec = PartitionSpec(*tuple(sub))
                whole = _whole_shape(tuple(v.shape), spec, mesh)
                out[_shard_key(str(k), spec, whole, mesh)] = v
            else:
                out[k] = v
        return out
    return walk(state, specs)


def _whole_shape(local_shape, spec, mesh: Mesh):
    sizes = dict(mesh.shape)
    spec = tuple(spec)
    out = []
    for d, n in enumerate(local_shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        parts = 1
        for a in axes:
            parts *= int(sizes[a])
        out.append(int(n) * parts)
    return tuple(out)


def _commit(path: str, state, force: bool, sidecar: Optional[str],
            mesh: Optional[Mesh], specs=None) -> None:
    _check_state(state)
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    _recover_commit(path)
    # force=False fails before the collective write, on every rank
    if not force and os.path.exists(path):
        raise FileExistsError("checkpoint %s exists (force=False)" % path)
    world, rank = _group()
    tmp = os.path.join(parent, name + _TMP_MARK + "tmp")
    old = os.path.join(parent, name + ".replaced")
    if rank == 0:
        for stale in (tmp, old):
            if os.path.exists(stale):
                shutil.rmtree(stale)
    _sync(world)                # the stale directories are gone everywhere
    _dcp("save", _split_tree(state, specs, mesh), tmp, world)
    _sync(world)                # every rank's files are closed
    # a kill here leaves `path` untouched: exactly the contract
    _fault.fire("checkpoint.commit")
    if rank == 0:
        had_old = os.path.exists(path)
        if had_old:
            os.rename(path, old)
        os.rename(tmp, path)    # `path` is briefly absent: a kill here is
        if had_old:             # healed by _recover_commit
            shutil.rmtree(old, ignore_errors=True)
        if sidecar is not None:
            # after the commit: a crash between the two leaves a whole
            # checkpoint without (or with an older) sidecar, never a torn
            # one
            try:
                _write_sidecar(sidecar, state, mesh, specs)
            except OSError:
                pass            # advisory metadata only
    _sync(world)                # the rename is visible everywhere


def save_sharded(path: str, state: Any, force: bool = True,
                 mesh: Optional[Mesh] = None, specs: Any = None) -> None:
    """Write ``state`` (nested mappings of tensors) to ``path``; inside a
    process group every rank calls it with the same tree.  ``mesh`` is
    the mesh the leaves live on, recorded in the sidecar; ``specs`` (a
    tree of the same structure, a partition spec a leaf; None or a
    missing leaf: replicated) says which leaves are this rank's shards of
    a split value, saved one key a shard.

    Crash-safe: the tree is written to ``<name>.saving-tmp`` and renamed
    into place, so a process killed during the write leaves ``path`` as
    it was, and one killed between the two renames leaves the previous
    checkpoint at ``<name>.replaced``, which the next save or restore puts
    back.  The ``checkpoint.commit`` fault site sits between the write and
    the renames."""
    _commit(path, state, force, _sidecar_path(path), mesh, specs)


def _recover_commit(path: str) -> None:
    """Heal a crash inside the two-rename commit: ``path`` missing but
    ``<name>.replaced`` (the complete previous checkpoint) present puts
    the latter back."""
    old = path + ".replaced"
    if not os.path.exists(path) and os.path.exists(old):
        try:
            os.rename(old, path)
        except OSError:
            pass            # another rank won the race


def _unflatten(flat: dict, paths: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        path = paths.get(key, (key,))
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def _join_shards(node):
    """A loaded tree with every leaf whole: the ``#shard[...]`` keys of a
    split leaf joined, block by block, into its value."""
    if not isinstance(node, Mapping):
        return node
    out, shards = {}, {}
    for k, v in node.items():
        if isinstance(k, str) and _SHARD in k and k.endswith("]"):
            base, _, idx = k.rpartition(_SHARD)
            shards.setdefault(base, {})[tuple(
                int(i) for i in idx[:-1].split(","))] = v
        else:
            out[k] = _join_shards(v)
    for base, blocks in shards.items():
        out[base] = _join_blocks(blocks, 0)
    return out


def _join_blocks(blocks, dim):
    """The value whose (dim, ...) blocks ``blocks`` holds by index."""
    ndim = len(next(iter(blocks)))
    if dim == ndim:
        return next(iter(blocks.values()))
    idxs = sorted({i[dim] for i in blocks})
    return torch.cat([_join_blocks({i: v for i, v in blocks.items()
                                    if i[dim] == j}, dim + 1)
                      for j in idxs], dim=dim)


def _has_shards(meta) -> bool:
    return any(_SHARD in k for k in meta.state_dict_metadata)


def _load_whole(path: str, meta, world: int):
    flat = {}
    for key, md in meta.state_dict_metadata.items():
        if not hasattr(md, "properties"):
            raise TypeError("checkpoint %s: entry %r is not a tensor"
                            % (path, key))
        flat[key] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
    _dcp("load", flat, path, world)
    return _join_shards(_unflatten(flat, meta.planner_data or {}))


def restore_sharded(path: str, template: Optional[Any] = None,
                    mesh: Optional[Mesh] = None, specs: Any = None) -> Any:
    """Restore a tree saved by :func:`save_sharded`.

    With ``template`` (the same nested mappings of tensors) each leaf is
    loaded onto its target spec: ``specs`` (a tree of partition specs,
    as :func:`save_sharded` takes) when given, else with ``mesh`` the
    saved spec re-sharded onto ``mesh`` by axis name (the sidecar), else
    whole.  A template tensor whose shape is the target shard's is loaded
    in place (on its own device, in its own dtype); another takes a new
    tensor in the template mapping.  The template is returned; inside a
    process group every rank calls it.  Without a template the tree of
    whole values is built from the checkpoint's metadata, as CPU
    tensors.  A checkpoint that is missing or cannot be read raises."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    _recover_commit(path)       # heal a crash in the commit before reading
    if not os.path.exists(os.path.join(path, _METADATA)):
        raise FileNotFoundError("no checkpoint at %s" % path)
    world = _group()[0]
    meta = dcp.FileSystemReader(path).read_metadata()
    if template is None:
        return _load_whole(path, meta, world)
    _check_state(template, "template")
    if specs is None and mesh is not None:
        specs = _specs_from_saved(path, template, mesh)
    if not _has_shards(meta) and not any(
            spec for _, _, spec in _leaves(template, specs)):
        _dcp("load", template, path, world)      # whole onto whole, in place
        return template
    from .parallel.speclayout import shard_slices
    whole = _load_whole(path, meta, world)

    def walk(node, saved, sp, where):
        for k, v in list(node.items()):
            sub = sp.get(k) if isinstance(sp, Mapping) else None
            if k not in saved:
                raise KeyError("checkpoint %s has no %s" % (
                    path, "/".join(map(str, where + (k,)))))
            if isinstance(v, Mapping):
                walk(v, saved[k], sub, where + (k,))
                continue
            value = saved[k]
            if sub is not None and tuple(sub):
                value = value[shard_slices(tuple(value.shape), sub, mesh)]
            if tuple(v.shape) == tuple(value.shape):
                with torch.no_grad():
                    v.copy_(value)
            else:
                node[k] = value.to(device=v.device, dtype=v.dtype,
                                   copy=True).contiguous()
    walk(template, whole, specs, ())
    return template


def _specs_from_saved(path: str, template, mesh: Mesh):
    """The saved spec of each template leaf re-sharded onto ``mesh`` by
    name (a tree of specs), or None without a sidecar."""
    shardings = shardings_from_saved(path, template, mesh)
    if shardings is None:
        return None

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return node.spec
    return walk(shardings)


class CheckpointManager:
    """Step-numbered checkpoints in ``<directory>/<step>`` with retention
    of the newest ``max_to_keep`` and latest-step resume (the reference's
    orbax manager: a save whose step is not above the latest is skipped,
    as orbax skips it)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def save(self, step: int, state: Any, mesh: Optional[Mesh] = None,
             specs: Any = None) -> bool:
        """Save ``state`` as step ``step`` (``mesh`` and ``specs`` as
        :func:`save_sharded` takes them); returns False (and writes
        nothing) when ``step`` is not above :meth:`latest_step`."""
        latest = self.latest_step()
        if latest is not None and int(step) <= latest:
            return False
        _commit(self._path(step), state, True,
                os.path.join(self._dir, "speclayout.json"), mesh, specs)
        # a mesh's save keeps the step's own sidecar too, for a restore by
        # name onto another mesh
        if mesh is not None and _group()[1] == 0:
            try:
                _write_sidecar(_sidecar_path(self._path(step)), state, mesh,
                               specs)
            except OSError:
                pass
        world, rank = _group()
        if rank == 0 and self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        _sync(world)
        return True

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint, oldest first (a crash
        inside a commit is healed first)."""
        for entry in os.listdir(self._dir):
            if entry.endswith(".replaced"):
                _recover_commit(os.path.join(self._dir, entry[:-9]))
        return sorted(int(e) for e in os.listdir(self._dir) if e.isdigit()
                      and os.path.exists(os.path.join(self._dir, e,
                                                      _METADATA)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None, mesh: Optional[Mesh] = None,
                specs: Any = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints in %s" % self._dir)
        return restore_sharded(self._path(step), template, mesh=mesh,
                               specs=specs)

    def close(self) -> None:
        """Nothing to release: every save is finished when it returns."""


def resume_or_init(directory: str, init_fn: Callable[[], Any], *,
                   max_to_keep: int = 3,
                   manager: Optional[CheckpointManager] = None,
                   mesh: Optional[Mesh] = None,
                   ) -> Tuple[Any, int, CheckpointManager]:
    """The recovery loop's entry point: restore the latest checkpoint if
    one exists, else start fresh.

    ``init_fn`` builds the fresh state (nested mappings of tensors); it
    always runs, and its tensors are either returned as they are (a cold
    start) or loaded in place from the latest checkpoint.  Returns
    ``(state, start_step, manager)``: ``start_step`` is 0 on a cold start
    and ``latest_step() + 1`` after a resume, so a training loop runs ``for
    step in range(start_step, total)`` and calls ``manager.save(step,
    state)``,
    and a job restarted after a crash continues where its last save left
    off.  With ``mesh`` the restored leaves are re-sharded by axis name
    onto it from the checkpoint's sidecar (:func:`restore_sharded`): a
    resized world resumes on ``parallel.mesh_for_world(n)``."""
    mgr = manager or CheckpointManager(directory, max_to_keep=max_to_keep)
    state = init_fn()
    step = mgr.latest_step()
    if step is None:
        return state, 0, mgr
    return mgr.restore(step, template=state, mesh=mesh), step + 1, mgr
