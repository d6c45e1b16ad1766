"""SpecLayout: canonical partition specs over named data/fsdp/tp mesh axes.

Counterpart of ``mxnet_tpu/parallel/speclayout.py``: one object owns the
mapping from a parameter's identity to its placement, so that every
consumer (the sharded :class:`~..step.CompiledStep`, the kvstore exchange
body, :mod:`..checkpoint` and the per-rank byte count) derives the same
layout from the same three named axes:

``data``
    data parallelism: batches split, parameters replicated.
``fsdp``
    ZeRO/FSDP: batches split and parameters + optimizer state
    sheet-sharded; each use gathers the parameter, and its gradient is
    reduce-scattered back onto the shards.
``tp``
    tensor parallelism: weight matrices split within a layer (embeddings
    and linears).

Resolution order for one parameter's spec (first hit wins): explicit
``rules`` ({name-substring: spec}); the owning block's
:meth:`~..gluon.block.Block.sharding_spec` hook; the kind defaults
(embedding weights shard the vocabulary axis over ``fsdp x tp``, Dense
weights split ``(out, in)`` over ``(tp, fsdp)``); everything else
sheet-shards its largest divisible axis over ``fsdp``.  Axes absent from
the mesh, of size 1 or not dividing the dimension drop out of every spec,
so one model runs unchanged on ``data``, ``data x fsdp`` and ``data x fsdp
x tp`` meshes.  Every resolved spec equals the reference's, by name.

What differs: the reference's specs are ``jax.sharding.PartitionSpec`` on
a mesh of devices, and ``NamedSharding`` places a whole array on it.  The
port runs one process a rank: :class:`PartitionSpec` is its own small
tuple type, a placement is :class:`~.mesh.Sharding` (a mesh and a spec),
and :func:`place_value` returns this rank's shard of a whole value (every
rank holds the same whole value, as the reference's same-seed
initialisation gives it).  The collectives that the reference's
partitioner inserts are explicit in :mod:`.tensor`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import get_env
from .mesh import Mesh, Sharding

__all__ = ["PartitionSpec", "P", "SpecLayout", "tp_alternation_specs",
           "shard_params", "shard_params_tp", "place_value", "shard_slices",
           "layout_from_env", "mesh_from_env", "mesh_for_world",
           "parse_mesh_axes"]


class PartitionSpec(tuple):
    """A partition spec: one entry a leading dimension, each None (not
    split), an axis name, or a tuple of axis names (split over their
    product, the first the major); trailing dimensions not listed are not
    split.  ``tuple(spec)`` compares with ``tuple(jax PartitionSpec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)

    def axes(self) -> Tuple[str, ...]:
        """Every axis name the spec uses, in order."""
        out = []
        for e in self:
            if e is None:
                continue
            out.extend(e if isinstance(e, tuple) else (e,))
        return tuple(out)


P = PartitionSpec

# block-class-name -> {parameter attribute: kind}: the kind defaults of
# resolution step 3, as the reference's table
_BLOCK_PARAM_KINDS = {
    "Dense": {"weight": "linear"},
    "Embedding": {"weight": "embedding"},
}


def _dim_divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class SpecLayout:
    """Canonical specs for parameters, state and batches on ``mesh``.

    ``rules`` maps parameter-name substrings to explicit specs (checked
    first, in insertion order).  Axis names default to
    ``data``/``fsdp``/``tp``; any subset may be on the mesh -
    :meth:`infer` accepts ``dp`` or ``batch`` for the data axis."""

    __slots__ = ("mesh", "data_axis", "fsdp_axis", "tp_axis", "rules",
                 "_sig")

    def __init__(self, mesh: Mesh, data_axis: str = "data",
                 fsdp_axis: str = "fsdp", tp_axis: str = "tp",
                 rules: Optional[Dict[str, Any]] = None):
        self.mesh = mesh
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        self.rules = dict(rules or {})
        self._sig = (tuple(mesh.axis_names),
                     tuple(int(s) for s in mesh.shape.values()),
                     tuple(int(d) for d in np.asarray(mesh.devices).flat),
                     data_axis, fsdp_axis, tp_axis,
                     tuple((k, repr(tuple(v)))
                           for k, v in sorted(self.rules.items())))

    @classmethod
    def infer(cls, mesh: Mesh, rules: Optional[Dict[str, Any]] = None
              ) -> "SpecLayout":
        """Layout over ``mesh`` with the data axis found: the first axis
        named ``data``/``dp``/``batch``, else the first that is neither
        ``fsdp`` nor ``tp``."""
        names = list(mesh.axis_names)
        data = next((n for n in names if n in ("data", "dp", "batch")),
                    None)
        if data is None:
            data = next((n for n in names if n not in ("fsdp", "tp")),
                        "data")
        return cls(mesh, data_axis=data, rules=rules)

    # -- axis helpers ------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return int(dict(self.mesh.shape).get(axis, 1))

    def _present(self, axis: str) -> bool:
        return self.axis_size(axis) > 1

    @property
    def fsdp(self) -> int:
        return self.axis_size(self.fsdp_axis)

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    def signature(self) -> Tuple:
        """The layout's identity: mesh topology, axis names and rules."""
        return self._sig

    # -- specs -------------------------------------------------------------
    def _batch_axes(self):
        return [a for a in (self.data_axis, self.fsdp_axis)
                if self._present(a)]

    def batch_spec(self) -> PartitionSpec:
        """Batch axis 0 splits over every data-parallel axis present: the
        fsdp ranks each take their own micro-shard (ZeRO is data
        parallelism), so the spec is ``(data, fsdp)``."""
        axes = self._batch_axes()
        if not axes:
            return P()
        return P(tuple(axes) if len(axes) > 1 else axes[0])

    def batch_sharding(self) -> Sharding:
        return Sharding(self.mesh, self.batch_spec())

    def batch_spec_for(self, shape, batch_dim: int = 0) -> PartitionSpec:
        """The batch spec on dimension ``batch_dim`` of ``shape`` (a
        window's stacked leaves carry (n_micro, B, ...)), replicated where
        the dimension does not divide the data x fsdp extent."""
        if not shape or batch_dim >= len(shape):
            return P()
        axes = self._batch_axes()
        if not axes:
            return P()
        entries = [None] * len(shape)
        entries[batch_dim] = tuple(axes) if len(axes) > 1 else axes[0]
        return self._fit(tuple(entries), shape)

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, P())

    def sharding(self, spec) -> Sharding:
        return Sharding(self.mesh, P(*tuple(spec)))

    def _fit(self, spec_entries, shape) -> PartitionSpec:
        """Drop the axes a shape cannot honour (missing from the mesh, of
        size 1, or not dividing the dimension): that dimension replicates
        instead of erroring, so one layout serves every mesh."""
        out = []
        for dim, entry in zip(shape, spec_entries):
            if entry is None:
                out.append(None)
                continue
            kept, whole = [], 1
            for a in _entry_axes(entry):
                sz = self.axis_size(a)
                if sz > 1 and int(dim) % (whole * sz) == 0:
                    kept.append(a)
                    whole *= sz
            out.append(tuple(kept) if len(kept) > 1
                       else (kept[0] if kept else None))
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def embedding_spec(self, shape) -> PartitionSpec:
        """Embedding tables shard the vocabulary axis over fsdp x tp."""
        if len(shape) < 1:
            return P()
        return self._fit(((self.fsdp_axis, self.tp_axis),)
                         + (None,) * (len(shape) - 1), shape)

    def linear_spec(self, shape) -> PartitionSpec:
        """Dense ``(out, in)`` weights: column-parallel over ``tp`` on the
        output dimension, ``fsdp``-sharded on the input one."""
        if len(shape) != 2:
            return self.sheet_spec(shape)
        return self._fit((self.tp_axis, self.fsdp_axis), shape)

    def sheet_spec(self, shape) -> PartitionSpec:
        """The default: the largest fsdp-divisible dimension over
        ``fsdp``; replicated when none divides."""
        fsdp = self.fsdp
        if fsdp <= 1 or not shape:
            return P()
        best = None
        for i, d in enumerate(shape):
            if _dim_divisible(int(d), fsdp):
                if best is None or int(d) > int(shape[best]):
                    best = i
        if best is None:
            return P()
        entries = [None] * len(shape)
        entries[best] = self.fsdp_axis
        return self._fit(tuple(entries), shape)

    def param_spec(self, name: str, shape, dtype=None,
                   kind: Optional[str] = None,
                   hook_spec=None) -> PartitionSpec:
        """One parameter's spec: rules > block hook > kind default > fsdp
        sheet."""
        shape = tuple(shape)
        for frag, spec in self.rules.items():
            if frag in name:
                spec = tuple(spec)
                return self._fit(spec + (None,) * (len(shape) - len(spec)),
                                 shape)
        if hook_spec is not None:
            spec = tuple(hook_spec)
            return self._fit(spec + (None,) * (len(shape) - len(spec)),
                             shape)
        if kind == "embedding":
            return self.embedding_spec(shape)
        if kind == "linear":
            return self.linear_spec(shape)
        return self.sheet_spec(shape)

    def compute_spec(self, spec) -> PartitionSpec:
        """The spec a parameter computes under: its storage spec without
        the fsdp axis (fsdp stores sheets and uses the whole; tp splits
        stay, they are the layer's compute layout)."""
        out = []
        for entry in tuple(spec):
            if entry is None:
                out.append(None)
                continue
            kept = [a for a in _entry_axes(entry) if a != self.fsdp_axis]
            out.append(tuple(kept) if len(kept) > 1
                       else (kept[0] if kept else None))
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def state_spec(self, param_spec, shape) -> PartitionSpec:
        """Optimizer state lives on its parameter's shards (a moment of
        the parameter's shape takes its spec); another shape takes the
        sheet default."""
        entries = tuple(param_spec)
        shape = tuple(shape)
        if len(entries) <= len(shape):
            return self._fit(entries + (None,) * (len(shape) -
                                                  len(entries)), shape)
        return self.sheet_spec(shape)

    # -- block resolution --------------------------------------------------
    def resolve(self, block=None, params: Optional[Dict[str, Any]] = None
                ) -> Dict[str, PartitionSpec]:
        """{structural name: spec} for every parameter: of ``block``'s
        tree (hooks and kind defaults apply), or of a bare ``params``
        mapping (name -> array-like; rules and shape defaults only)."""
        hook_specs: Dict[int, Any] = {}
        kinds: Dict[int, str] = {}
        named: Dict[str, Any] = {}
        if block is not None:
            self._walk(block, hook_specs, kinds)
            named = dict(block.named_parameters())
        elif params is not None:
            named = dict(params)
        out: Dict[str, PartitionSpec] = {}
        for name, p in named.items():
            shape = tuple(getattr(p, "shape", ()) or ())
            out[name] = self.param_spec(
                name, shape, getattr(p, "dtype", None),
                kind=kinds.get(id(p)), hook_spec=hook_specs.get(id(p)))
        return out

    def _walk(self, block, hook_specs, kinds) -> None:
        own = block.__dict__.get("_parameters", {})
        by_kind = _BLOCK_PARAM_KINDS.get(type(block).__name__)
        if by_kind:
            for attr, kind in by_kind.items():
                p = own.get(attr)
                if p is not None:
                    kinds[id(p)] = kind
        hook = getattr(block, "sharding_spec", None)
        if callable(hook):
            declared = hook(self) or {}
            for key, spec in declared.items():
                p = own.get(key) if isinstance(key, str) else \
                    getattr(key, "_tensor", lambda: key)()
                if p is not None and spec is not None:
                    hook_specs[id(p)] = spec
        for child in block.__dict__.get("_modules", {}).values():
            if child is not None:
                self._walk(child, hook_specs, kinds)


# ---------------------------------------------------------------------------
# placement: this rank's shard of a whole value
# ---------------------------------------------------------------------------


def shard_slices(shape, spec, mesh: Mesh,
                 coords: Optional[Dict[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The slices of a whole value of ``shape`` that the rank at
    ``coords`` (default: this process) holds under ``spec``.  An entry of
    several axes splits its dimension over their product, the first the
    major (block index = sum of index x the later axes' sizes)."""
    spec = tuple(spec)
    if not spec:
        return tuple(slice(None) for _ in shape)
    if coords is None:
        coords = mesh.coords()
    sizes = dict(mesh.shape)
    out = []
    for d, dim in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        parts, block = 1, 0
        for a in axes:
            parts *= sizes[a]
            block = block * sizes[a] + coords[a]
        if parts == 1:
            out.append(slice(None))
            continue
        if dim % parts:
            raise ValueError("a dimension of %d does not split into %d "
                             "(%s)" % (dim, parts, spec))
        step = dim // parts
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


def place_value(value, sharding: Sharding) -> torch.Tensor:
    """This rank's shard of ``value`` (a whole tensor or array, which
    every rank holds alike) under ``sharding``: a new contiguous tensor
    (on the value's device; numpy goes to the CPU)."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    sl = shard_slices(tuple(value.shape), sharding.spec, sharding.mesh)
    return value[sl].contiguous().clone() if tuple(sharding.spec) \
        else value.clone()


def shard_params(param_values: Dict[str, Any], layout: SpecLayout,
                 specs: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Each value of a name -> whole value mapping as this rank's shard
    under the layout's resolved spec."""
    specs = specs or layout.resolve(params=param_values)
    return {name: place_value(v, layout.sharding(specs.get(name, P())))
            for name, v in param_values.items()}


# ---------------------------------------------------------------------------
# the tensor-parallel alternation (parallel/mesh.py keeps an alias)
# ---------------------------------------------------------------------------


def tp_alternation_specs(param_values: Dict[str, Any], mesh: Mesh,
                         tp_axis: str = "tp",
                         rules: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, PartitionSpec]:
    """The ``shard_params_tp`` layout as specs: explicit rules (a
    parameter no rule matches replicates), else column-parallel ``(tp,
    None)`` and row-parallel ``(None, tp)`` in turn for consecutive 2-D
    '...weight' parameters; biases and everything else replicate."""
    tp = int(dict(mesh.shape).get(tp_axis, 1))
    specs: Dict[str, PartitionSpec] = {}
    col = True
    for name, v in param_values.items():
        if rules is not None:
            spec = P()
            for frag, s in rules.items():
                if frag in name:
                    spec = P(*tuple(s))
                    break
        elif tp > 1 and name.endswith("weight") and \
                len(getattr(v, "shape", ())) == 2:
            spec = P(tp_axis, None) if col else P(None, tp_axis)
            col = not col
        else:
            spec = P()
        specs[name] = spec
    return specs


def shard_params_tp(param_values: Dict[str, Any], mesh: Mesh,
                    tp_axis: str = "tp",
                    rules: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Deprecated tp-only placement: :func:`tp_alternation_specs` and
    :func:`place_value`, this rank's shards; new code builds a
    :class:`SpecLayout` and calls :func:`shard_params`."""
    specs = tp_alternation_specs(param_values, mesh, tp_axis, rules)
    return {name: place_value(v, Sharding(mesh, specs[name]))
            for name, v in param_values.items()}


# ---------------------------------------------------------------------------
# MX_MESH_AXES / MX_FSDP
# ---------------------------------------------------------------------------


def parse_mesh_axes(text: str, fsdp_override: Optional[int] = None
                    ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Parse ``MX_MESH_AXES``: comma-separated ``name[=size]`` tokens,
    e.g. ``data,fsdp=2,tp=2``.  An unsized data axis is -1 (inferred),
    an unsized model axis 2; ``fsdp_override`` (``MX_FSDP``) wins for the
    fsdp axis; a size below 1 is 1 (the axis drops out)."""
    axes, sizes = [], []
    for tok in (text or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            name, _, sz = tok.partition("=")
            name = name.strip()
            size = int(sz)
        else:
            name = tok
            size = -1 if name in ("data", "dp", "batch") else 2
        if name == "fsdp" and fsdp_override is not None:
            size = int(fsdp_override)
        if size != -1 and size < 1:
            size = 1
        axes.append(name)
        sizes.append(size)
    if not axes:
        raise ValueError("MX_MESH_AXES is empty")
    return tuple(axes), tuple(sizes)


def _fsdp_env() -> Optional[int]:
    fsdp = get_env("MX_FSDP")
    try:
        return int(fsdp) if fsdp else None
    except ValueError:
        return None


def mesh_from_env(devices: Optional[Sequence[int]] = None
                  ) -> Optional[Mesh]:
    """The mesh ``MX_MESH_AXES``/``MX_FSDP`` describe, over ``devices``
    (default: the process group's ranks), or None when both are unset.
    ``MX_FSDP=N`` alone means ``data,fsdp=N``."""
    axes_text = get_env("MX_MESH_AXES")
    fsdp_n = _fsdp_env()
    if not axes_text:
        if not fsdp_n or fsdp_n <= 1:
            return None
        axes_text = "data,fsdp"
    from .mesh import make_mesh
    axes, sizes = parse_mesh_axes(axes_text, fsdp_n)
    return make_mesh(axes=axes, shape=sizes, devices=devices)


def _world_ranks(devices):
    if devices is not None:
        return list(devices)
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    return list(range(n))


def mesh_for_world(world: int, devices: Optional[Sequence[int]] = None
                   ) -> Mesh:
    """The mesh of an incarnation with ``world`` data-parallel members:
    the env-described axes (default plain ``data``) with the data axis
    forced to ``world``; a model axis that no longer fits the ranks
    degrades to 1, innermost first, rather than failing the resize."""
    world = int(world)
    if world < 1:
        raise ValueError("mesh_for_world needs world >= 1, got %d" % world)
    devices = _world_ranks(devices)
    fsdp_n = _fsdp_env()
    axes_text = get_env("MX_MESH_AXES")
    if not axes_text:
        axes_text = "data,fsdp" if fsdp_n and fsdp_n > 1 else "data"
    axes, sizes = parse_mesh_axes(axes_text, fsdp_n)
    sizes = list(sizes)
    di = next((i for i, a in enumerate(axes)
               if a in ("data", "dp", "batch")), 0)
    sizes[di] = world

    def _prod(xs):
        p = 1
        for x in xs:
            p *= max(1, int(x))
        return p
    for i in range(len(sizes) - 1, -1, -1):
        if _prod(sizes) <= len(devices):
            break
        if i != di:
            sizes[i] = 1
    if _prod(sizes) > len(devices):
        raise ValueError("mesh_for_world: world %d needs %d ranks, only %d"
                         % (world, _prod(sizes), len(devices)))
    from .mesh import make_mesh
    return make_mesh(axes=axes, shape=sizes, devices=devices)


def layout_from_env(devices: Optional[Sequence[int]] = None, rules=None
                    ) -> Optional[SpecLayout]:
    """The :class:`SpecLayout` of the env knobs, or None when they are
    unset (the replicated step)."""
    mesh = mesh_from_env(devices)
    if mesh is None:
        return None
    return SpecLayout.infer(mesh, rules=rules)
