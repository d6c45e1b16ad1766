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
* The ``<name>.speclayout.json`` sidecar, written after the commit,
  records the leaves' layout as the reference's does (``schema``,
  ``mesh_axes``, ``leaf_specs``, ``world_size``).  The port's meshes are
  data-parallel only, so every leaf is whole on every rank: a leaf saved
  over a mesh records the reference's replicated spec (``[]``), one saved
  without a mesh ``null``.  ``world_size`` is the process group's size
  (1 without a group), which tells a resize from a plain restart.
* :func:`restore_sharded` loads in place into a template's tensors (their
  devices and dtypes), or without a template builds the tree from DCP's
  metadata, on the CPU.
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


def _count_leaves(state) -> int:
    if isinstance(state, Mapping):
        return sum(_count_leaves(v) for v in state.values())
    return 1


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


def _sidecar_doc(state, mesh: Optional[Mesh] = None) -> dict:
    n = _count_leaves(state)
    return {"schema": SPEC_SCHEMA,
            "mesh_axes": {} if mesh is None else
            {str(k): int(v) for k, v in mesh.shape.items()},
            "leaf_specs": [None if mesh is None else []] * n,
            "world_size": _group()[0]}


def _sidecar_path(path: str) -> str:
    return os.path.abspath(path) + _SPEC_SIDECAR


def _write_sidecar(target: str, state, mesh: Optional[Mesh]) -> None:
    """Atomic (temp and rename) sidecar write; rank 0 only."""
    doc = _sidecar_doc(state, mesh)
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


def _commit(path: str, state, force: bool, sidecar: Optional[str],
            mesh: Optional[Mesh]) -> None:
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
    _dcp("save", state, tmp, world)
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
                _write_sidecar(sidecar, state, mesh)
            except OSError:
                pass            # advisory metadata only
    _sync(world)                # the rename is visible everywhere


def save_sharded(path: str, state: Any, force: bool = True,
                 mesh: Optional[Mesh] = None) -> None:
    """Write ``state`` (nested mappings of tensors) to ``path``; inside a
    process group every rank calls it with the same tree.  ``mesh`` is
    the mesh the leaves live on (every leaf is whole on every rank of a
    port mesh), recorded in the sidecar.

    Crash-safe: the tree is written to ``<name>.saving-tmp`` and renamed
    into place, so a process killed during the write leaves ``path`` as
    it was, and one killed between the two renames leaves the previous
    checkpoint at ``<name>.replaced``, which the next save or restore puts
    back.  The ``checkpoint.commit`` fault site sits between the write and
    the renames."""
    _commit(path, state, force, _sidecar_path(path), mesh)


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


def restore_sharded(path: str, template: Optional[Any] = None) -> Any:
    """Restore a tree saved by :func:`save_sharded`.

    With ``template`` (the same nested mappings of tensors) every tensor
    is loaded in place, on its own device and in its own dtype, and the
    template is returned; inside a process group every rank calls it.
    Without one the tree is built from the checkpoint's metadata, as CPU
    tensors.  A checkpoint that is missing or cannot be read raises."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    _recover_commit(path)       # heal a crash in the commit before reading
    if not os.path.exists(os.path.join(path, _METADATA)):
        raise FileNotFoundError("no checkpoint at %s" % path)
    world = _group()[0]
    if template is not None:
        _check_state(template, "template")
        _dcp("load", template, path, world)
        return template
    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {}
    for key, md in meta.state_dict_metadata.items():
        if not hasattr(md, "properties"):
            raise TypeError("checkpoint %s: entry %r is not a tensor"
                            % (path, key))
        flat[key] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
    _dcp("load", flat, path, world)
    return _unflatten(flat, meta.planner_data or {})


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

    def save(self, step: int, state: Any) -> bool:
        """Save ``state`` as step ``step``; returns False (and writes
        nothing) when ``step`` is not above :meth:`latest_step`."""
        latest = self.latest_step()
        if latest is not None and int(step) <= latest:
            return False
        _commit(self._path(step), state, True,
                os.path.join(self._dir, "speclayout.json"), None)
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
                template: Optional[Any] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints in %s" % self._dir)
        return restore_sharded(self._path(step), template)

    def close(self) -> None:
        """Nothing to release: every save is finished when it returns."""


def resume_or_init(directory: str, init_fn: Callable[[], Any], *,
                   max_to_keep: int = 3,
                   manager: Optional[CheckpointManager] = None,
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
    off."""
    mgr = manager or CheckpointManager(directory, max_to_keep=max_to_keep)
    state = init_fn()
    step = mgr.latest_step()
    if step is None:
        return state, 0, mgr
    return mgr.restore(step, template=state), step + 1, mgr
