"""Program registry, retrace explainer and device-buffer census.

Counterpart of ``mxnet_tpu/programs.py``: the registry, the census and
the program contracts.  What PyTorch has in place of XLA's ahead-of-time
compile, and how each record is measured:

* **A program is a torch callable keyed by its input signature.**
  :func:`register_program` wraps a site's callable in a :class:`Program`.
  The signature (:func:`signature_of`) is the argument tree's structure
  plus each leaf's identity: a tensor's shape, dtype (numpy's name) and
  device, an ndarray's shape and dtype, a Python scalar's value.

* **Its "compile" is the first dispatch of a signature**: the build, the
  first run, the library's autotuning and the allocator's growth.  It is
  timed on the host clock with the device synchronised at both ends.  A
  signature dispatched again is a hit and is not measured.

* **Memory.**  On CUDA, ``temp_bytes`` is the allocator's peak during
  that first dispatch, less the bytes allocated before it, less its new
  outputs; argument and output bytes are the tensors' ``nbytes``.
  ``torch.cuda.reset_peak_memory_stats`` is process-global, so the
  measurements are serialised under one lock, and a phase that reads the
  peak for itself resets it first.  On the CPU memory is ``None``.

* **Cost** is ``None``: nothing counts a torch program's operations, and
  the reference reports ``None`` where a backend gives no
  ``cost_analysis``, so ``program_flops`` stays unset.

Per-program numbers feed the telemetry registry:
``program_compile_seconds{program}``, ``program_temp_bytes{program}``,
``program_retraces{program}`` (and ``program_flops{program}``, which no
port program sets).

**The retrace explainer.**  Each record keeps the last signature; a first
dispatch whose signature differs is a retrace, and the structured diff
(:func:`diff_signatures`: which argument's shape, dtype or device changed,
or that the tree itself did) is logged and kept on the record.

**The persistent compile cache.**  A torch program has no executable to
serialize; what a cold process pays and a warm one need not is the
``nvcc`` build of its kernel libraries (:mod:`.compile_cache`).  A first
dispatch that loaded at least one library from that cache and built none
is a cache hit (:meth:`ProgramRecord.note_cache_hit`): it counts in
``cache_hits`` and its seconds in ``deserialize_seconds_total``, not as a
compile.  :meth:`Program.ensure_compiled` loads or builds the libraries
without dispatching and answers ``"ready"`` only for a signature already
dispatched, so callers keep their first dispatch.

**Program contracts.**  :func:`declare_contract` records a program
family's declared invariants (donated arguments, a temp-byte budget, a
trace closure) at import time, a dict insert; its cases are built only by
the verifier (``python -m mxnet_tpu_torch.tools.contracts``), which
dispatches each :class:`ContractCase` once inside :func:`isolated`.  torch
has no donation: a donated argument's tensors must be written in place
(same storage, version counter advanced).

**The buffer census.**  torch has no ``jax.live_arrays()``: owners
register themselves through :func:`track_buffers` (held weakly) and
:func:`buffer_census` buckets their tensors by owner, deduplicated by
storage (``untyped_storage().data_ptr()``), each storage attributed to the
first owner in :data:`CENSUS_OWNERS` order.  ``other`` is
``torch.cuda.memory_allocated()`` less the owned bytes on the card, and
``None`` on the CPU; ``bytes_per_chip`` is this rank's local bytes.
:class:`LeakDetector` turns step-over-step growth beyond
``MX_LEAK_WARN_BYTES`` into a gauge and a warning; the step observer runs
it every 16th recorded step, and crash dumps carry ``buffer_census`` and
``programs`` sections.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .base import get_env
from . import telemetry as _telemetry

__all__ = [
    "register_program", "Program", "ProgramRecord", "census_enabled",
    "program_table", "program_summary", "program_memory_bytes",
    "program_count", "find_record", "reset_records",
    "signature_of", "diff_signatures",
    "track_buffers", "buffer_census", "leak_detector", "LeakDetector",
    "CENSUS_OWNERS",
    "CONTRACT_SCHEMA", "ContractCase", "ContractClosure", "ProgramContract",
    "declare_contract", "contracts", "contract_manifest",
    "reset_contracts", "contract_device", "contract_scope", "isolated",
]

logger = logging.getLogger("mxnet_tpu_torch.programs")


def census_enabled() -> bool:
    """MX_PROGRAM_CENSUS (default on): program registry + buffer census."""
    return bool(get_env("MX_PROGRAM_CENSUS", dtype=bool))


# ---------------------------------------------------------------------------
# Signatures + the retrace explainer
# ---------------------------------------------------------------------------

_LEAF = "*"


def _dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("float32", "int64")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _leaf_sig(x, scalar_values: bool = True):
    """One leaf's identity: a tensor's (shape, dtype, device), an
    ndarray-like's (shape, dtype), a Python scalar's value (its type
    alone when ``scalar_values`` is off), else its type."""
    x = getattr(x, "_data", x) if not isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        # torch's own hashable objects here; _leaf_desc names them
        return ("tensor", x.shape, x.dtype, x.device)
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):
        return ("arr", tuple(int(s) for s in shape), _dtype_name(x.dtype))
    if isinstance(x, (bool, int, float, complex, str, bytes)):
        return ("py", type(x).__name__, x if scalar_values else None)
    return ("obj", type(x).__name__)


def _flatten(tree, leaves: list):
    """The tree's structure as a hashable node, and its leaves, in the
    reference's conventions: tuples, lists and dicts are nodes (dict keys
    sorted), None is an empty node, anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return ("tuple", tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, list):
        return ("list", tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return _LEAF


def _paths(node, path: str = ""):
    """Each leaf's path under ``node``, in leaf order: ``[0]['w']``."""
    if node is None:
        return
    if node == _LEAF:
        yield path
    elif node[0] == "dict":
        for k, c in zip(node[1], node[2]):
            yield from _paths(c, "%s[%r]" % (path, k))
    else:
        for i, c in enumerate(node[1]):
            yield from _paths(c, "%s[%d]" % (path, i))


def _treedef_str(node) -> str:
    if node is None:
        return "None"
    if node == _LEAF:
        return "*"
    kind = node[0]
    if kind == "tuple":
        inner = ", ".join(_treedef_str(c) for c in node[1])
        return "(%s,)" % inner if len(node[1]) == 1 else "(%s)" % inner
    if kind == "list":
        return "[%s]" % ", ".join(_treedef_str(c) for c in node[1])
    return "{%s}" % ", ".join("%r: %s" % (k, _treedef_str(c))
                              for k, c in zip(node[1], node[2]))


class _TreeDef:
    """A hashable argument-tree structure that prints as JAX's
    ``PyTreeDef(...)`` does."""

    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node

    def __eq__(self, other):
        return isinstance(other, _TreeDef) and self.node == other.node

    def __hash__(self):
        return hash(self.node)

    def __str__(self):
        return "PyTreeDef(%s)" % _treedef_str(self.node)

    __repr__ = __str__


def signature_of(args: tuple, kwargs: Optional[dict] = None,
                 scalar_values: bool = True) -> Tuple:
    """(treedef, per-leaf identity) of a call: the program cache key.
    Reads shapes and dtypes only; never touches device data.  A Python
    scalar keys by its value, as a static argument of the reference's
    does; with ``scalar_values`` off, by its type alone (a program that
    takes it as data)."""
    leaves: list = []
    node = _flatten((tuple(args), dict(kwargs or {})), leaves)
    return (_TreeDef(node), tuple(_leaf_sig(x, scalar_values)
                                  for x in leaves))


def _leaf_desc(sig) -> Dict[str, Any]:
    """Human/JSON form of one leaf signature."""
    if isinstance(sig, tuple) and sig and sig[0] == "tensor":
        return {"shape": tuple(int(d) for d in sig[1]),
                "dtype": _dtype_name(sig[2]), "weak_type": False,
                "device": str(sig[3])}
    if isinstance(sig, tuple) and sig and sig[0] == "arr":
        return {"shape": sig[1], "dtype": sig[2], "weak_type": False}
    if isinstance(sig, tuple) and sig and sig[0] == "py":
        return {"py": sig[1], "value": sig[2]}
    return {"opaque": str(sig)}


def diff_signatures(old: Tuple, new: Tuple) -> Optional[Dict[str, Any]]:
    """Structured explanation of why ``new`` could not reuse ``old``'s
    program: either the argument tree changed, or named leaves changed
    shape, dtype or device.  None when identical."""
    if old == new:
        return None
    old_td, old_sigs = old
    new_td, new_sigs = new
    if old_td != new_td:
        return {"kind": "tree_structure",
                "before": str(old_td), "after": str(new_td)}
    changed = []
    for path, a, b in zip(_paths(new_td.node), old_sigs, new_sigs):
        if a == b:
            continue
        da, db = _leaf_desc(a), _leaf_desc(b)
        if da.get("dtype") != db.get("dtype") and \
                da.get("shape") == db.get("shape"):
            change = "dtype"
        elif da.get("shape") != db.get("shape") and \
                da.get("dtype") == db.get("dtype"):
            change = "shape"
        elif da.get("shape") == db.get("shape") and \
                da.get("dtype") == db.get("dtype") and \
                da.get("device") != db.get("device"):
            change = "device"
        else:
            change = "leaf"
        changed.append({"arg": path, "change": change,
                        "before": da, "after": db})
    return {"kind": "leaves", "changed": changed}


def _format_diff(diff: Dict[str, Any]) -> str:
    if diff["kind"] == "tree_structure":
        return "argument tree structure changed: %s -> %s" % (
            diff["before"], diff["after"])
    parts = ["%s %s: %s -> %s" % (c["arg"], c["change"], c["before"],
                                  c["after"])
             for c in diff["changed"][:8]]
    more = len(diff["changed"]) - 8
    if more > 0:
        parts.append("(+%d more)" % more)
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# Program records
# ---------------------------------------------------------------------------

class ProgramRecord:
    """Aggregated accounting for one named program (all its wrappers).

    A ``specializing`` record expects many signatures under one name: a
    fresh signature counts as a specialization and ``retraces`` counts
    only a rebuild of a signature already seen.  A strict record (the
    default) counts every signature change as a retrace."""

    def __init__(self, name: str, mode: str, specializing: bool = False):
        self.name = name
        self.mode = mode
        self.specializing = bool(specializing)
        self._lock = threading.Lock()
        self.compiles = 0
        self.retraces = 0
        self.specializations = 0
        #: first dispatches whose kernel libraries all came from the
        #: persistent compile cache (see note_cache_hit)
        self.cache_hits = 0
        self.deserialize_seconds_total = 0.0
        self._seen_sigs: set = set()
        self.compile_seconds_total = 0.0
        self.compile_seconds_max = 0.0
        self.last_compile_seconds: Optional[float] = None
        self.memory: Optional[Dict[str, Any]] = None
        self.cost: Optional[Dict[str, Any]] = None
        self.temp_bytes_peak: Optional[int] = None
        self.last_sig: Optional[Tuple] = None
        self.last_retrace: Optional[Dict[str, Any]] = None
        labels = {"program": name}
        reg = _telemetry.registry
        self._h_compile = reg.histogram(
            "program_compile_seconds",
            doc="host seconds of a program's first dispatch of a "
                "signature (build, first run, autotuning, allocator "
                "growth; device synchronised at both ends)",
            labels=labels)
        self._c_retrace = reg.counter(
            "program_retraces",
            doc="program rebuilds whose input signature changed vs the "
                "previous one (see the retrace explainer log)",
            labels=labels)
        self._g_temp = reg.gauge(
            "program_temp_bytes",
            doc="allocator peak during the latest first dispatch, less "
                "the bytes before it and its new outputs", labels=labels)
        self._g_flops = reg.gauge(
            "program_flops",
            doc="floating-point operations of one dispatch, where the "
                "site counts them", labels=labels)

    def note_compile(self, seconds: float, sig: Tuple,
                     memory: Optional[Dict[str, Any]] = None) -> None:
        """Record one first dispatch: timing, memory and the retrace
        explainer's signature diff."""
        diff = None
        is_retrace = False
        with self._lock:
            self.compiles += 1
            self.compile_seconds_total += seconds
            self.compile_seconds_max = max(self.compile_seconds_max,
                                           seconds)
            self.last_compile_seconds = seconds
            if self.last_sig is not None:
                diff = diff_signatures(self.last_sig, sig)
                if diff is not None:
                    if self.specializing and sig not in self._seen_sigs:
                        self.specializations += 1
                    else:
                        is_retrace = True
                        self.retraces += 1
                        self.last_retrace = {"diff": diff,
                                             "compile_seconds": seconds}
            self._seen_sigs.add(sig)
            self.last_sig = sig
            if memory is not None:
                self.memory = memory
                tb = memory["temp_bytes"]
                if self.temp_bytes_peak is None or tb > self.temp_bytes_peak:
                    self.temp_bytes_peak = tb
        self._h_compile.observe(seconds)
        if memory is not None:
            self._g_temp.set(memory["temp_bytes"])
        if is_retrace:
            self._c_retrace.inc()
            logger.info("program %r retraced (first dispatch %.3fs): %s",
                        self.name, seconds, _format_diff(diff))
        elif diff is not None:
            logger.debug("program %r specialized (first dispatch %.3fs): "
                         "%s", self.name, seconds, _format_diff(diff))

    def note_cache_hit(self, seconds: float, sig: Tuple,
                       memory: Optional[Dict[str, Any]] = None) -> None:
        """Record one first dispatch whose kernel libraries came from the
        persistent compile cache (at least one loaded, none built): no
        compile and no retrace is charged, its seconds accumulate in
        ``deserialize_seconds_total``, and its memory is kept as a
        compile's is (the packer reads the temp bytes).  The signature
        joins the seen set, so a later rebuild of it is attributed as
        one."""
        with self._lock:
            self.cache_hits += 1
            self.deserialize_seconds_total += seconds
            self._seen_sigs.add(sig)
            self.last_sig = sig
            if memory is not None:
                self.memory = memory
                tb = memory["temp_bytes"]
                if self.temp_bytes_peak is None or tb > self.temp_bytes_peak:
                    self.temp_bytes_peak = tb
        if memory is not None:
            self._g_temp.set(memory["temp_bytes"])

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "mode": self.mode,
                "specializing": self.specializing,
                "compiles": self.compiles,
                "retraces": self.retraces,
                "specializations": self.specializations,
                "cache_hits": self.cache_hits,
                "deserialize_seconds": round(
                    self.deserialize_seconds_total, 6),
                "compile_seconds": {
                    "total": round(self.compile_seconds_total, 6),
                    "max": round(self.compile_seconds_max, 6),
                    "last": None if self.last_compile_seconds is None
                    else round(self.last_compile_seconds, 6),
                },
                "memory": dict(self.memory) if self.memory else None,
                "cost": dict(self.cost) if self.cost else None,
                "temp_bytes_peak": self.temp_bytes_peak,
                "last_retrace": self.last_retrace,
            }


_records_lock = threading.Lock()
_records: Dict[str, ProgramRecord] = {}


def _record(name: str, mode: str,
            specializing: bool = False) -> ProgramRecord:
    with _records_lock:
        rec = _records.get(name)
        if rec is None:
            rec = ProgramRecord(name, mode, specializing=specializing)
            _records[name] = rec
    return rec


def find_record(name: str) -> Optional[ProgramRecord]:
    with _records_lock:
        return _records.get(name)


def program_table() -> Dict[str, Dict[str, Any]]:
    """{program name: record snapshot}: what crash dumps carry."""
    with _records_lock:
        recs = list(_records.values())
    return {rec.name: rec.snapshot() for rec in recs}


def program_summary() -> Dict[str, Any]:
    """Roll-up across every registered program."""
    table = program_table()
    peak_temp = [t["temp_bytes_peak"] for t in table.values()
                 if t["temp_bytes_peak"] is not None]
    return {
        "programs": len(table),
        "compiles": sum(t["compiles"] for t in table.values()),
        "retraces": sum(t["retraces"] for t in table.values()),
        "specializations": sum(t["specializations"]
                               for t in table.values()),
        "cache_hits": sum(t["cache_hits"] for t in table.values()),
        "deserialize_seconds_total": round(
            sum(t["deserialize_seconds"] for t in table.values()), 6),
        "compile_seconds_total": round(
            sum(t["compile_seconds"]["total"] for t in table.values()), 6),
        "peak_temp_bytes": max(peak_temp) if peak_temp else None,
    }


def program_memory_bytes(prefix: str) -> Dict[str, int]:
    """Memory over every registered program whose name starts with
    ``prefix``: the HBM packer's program-side footprint of one model.
    ``temp_bytes_peak`` is the largest transient any one of them needs
    (programs run one at a time per replica); argument and output bytes
    are informational, the tensors they name being counted by
    :func:`buffer_census`."""
    out = {"programs": 0, "temp_bytes_peak": 0,
           "argument_bytes_max": 0, "output_bytes_max": 0}
    for name, t in program_table().items():
        if not name.startswith(prefix):
            continue
        out["programs"] += 1
        tb = t.get("temp_bytes_peak")
        if tb:
            out["temp_bytes_peak"] = max(out["temp_bytes_peak"], int(tb))
        mem = t.get("memory") or {}
        for src, dst in (("argument_bytes", "argument_bytes_max"),
                         ("output_bytes", "output_bytes_max")):
            b = mem.get(src)
            if b:
                out[dst] = max(out[dst], int(b))
    return out


def program_count() -> int:
    with _records_lock:
        return len(_records)


def reset_records() -> None:
    """Drop every record (tests).  Telemetry instruments persist."""
    with _records_lock:
        _records.clear()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

# torch.cuda.reset_peak_memory_stats is process-global: one measurement
# at a time
_measure_lock = threading.Lock()


def _tensor_leaves(tree) -> List[torch.Tensor]:
    leaves: list = []
    _flatten(tree, leaves)
    out = []
    for x in leaves:
        x = getattr(x, "_data", x)
        if isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _storage_key(t: torch.Tensor):
    try:
        ptr = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    return (str(t.device), ptr) if ptr else None


def _cuda_device(tensors, device) -> Optional[torch.device]:
    if device is not None:
        dev = torch.device(device)
        return dev if dev.type == "cuda" else None
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return None


class Program:
    """A census-wrapped torch callable.  The first dispatch of each input
    signature is this program's "compile": timed with the device
    synchronised at both ends and, on CUDA, its transient memory read off
    the allocator's peak.  Later dispatches of a seen signature call the
    function directly."""

    def __init__(self, name: str, mode: str, fn: Callable,
                 specializing: bool = False, device=None,
                 scalar_values: bool = True):
        self._name = name
        self._scalar_values = bool(scalar_values)
        self._mode = mode
        self._fn = fn
        self._specializing = bool(specializing)
        self._device = device
        self._record: Optional[ProgramRecord] = None
        self._seen: set = set()
        self._build_lock = threading.Lock()

    @property
    def record(self) -> ProgramRecord:
        """Created at the first dispatch: a wrapper never dispatched adds
        no row to the table."""
        if self._record is None:
            self._record = _record(self._name, self._mode,
                                   specializing=self._specializing)
        return self._record

    @property
    def executables(self) -> int:
        """Signatures dispatched so far."""
        return len(self._seen)

    def _note(self, seconds, sig, events0, memory=None) -> None:
        """A compile, or a cache hit when this thread's libraries of the
        dispatch all came from the persistent cache."""
        from . import compile_cache as _cc
        loaded, built = (a - b for a, b in zip(_cc.library_events(),
                                                events0))
        if loaded > 0 and built == 0:
            self.record.note_cache_hit(seconds, sig, memory=memory)
        else:
            self.record.note_compile(seconds, sig, memory=memory)

    def _first_dispatch(self, sig, args, kwargs):
        from . import compile_cache as _cc
        arg_tensors = _tensor_leaves((args, kwargs))
        dev = _cuda_device(arg_tensors, self._device)
        events0 = _cc.library_events()
        if dev is None:
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            self._note(time.perf_counter() - t0, sig, events0)
            return out
        with _measure_lock:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
        in_keys = {_storage_key(t) for t in arg_tensors}
        arg_bytes = sum(int(t.nbytes) for t in arg_tensors)
        out_bytes = new_bytes = alias_bytes = 0
        for t in _tensor_leaves(out):
            n = int(t.nbytes)
            out_bytes += n
            if t.device == dev and _storage_key(t) not in in_keys:
                new_bytes += n
            elif _storage_key(t) in in_keys:
                alias_bytes += n
        memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                  "temp_bytes": max(0, int(peak - before - new_bytes)),
                  "generated_code_bytes": None,
                  "alias_bytes": alias_bytes}
        self._note(seconds, sig, events0, memory=memory)
        return out

    def ensure_compiled(self, *args, **kwargs):
        """Load (from the persistent compile cache) or build the process's
        kernel libraries without dispatching.  Returns ``"ready"`` for a
        signature already dispatched and False otherwise: a torch program
        has no executable apart from its first dispatch, so the caller
        dispatches (the reference's answer in light mode)."""
        dev = _cuda_device(_tensor_leaves((args, kwargs)), self._device)
        if dev is not None:
            from .ops import _kernels
            _kernels.build_all()
        sig = signature_of(args, kwargs, self._scalar_values)
        return "ready" if sig in self._seen else False

    def __call__(self, *args, **kwargs):
        sig = signature_of(args, kwargs, self._scalar_values)
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        with self._build_lock:
            if sig not in self._seen:
                out = self._first_dispatch(sig, args, kwargs)
                self._seen.add(sig)
                return out
        return self._fn(*args, **kwargs)


def register_program(name: str, fn: Callable, mode: str = "aot",
                     specializing: bool = False, device=None,
                     scalar_values: bool = True) -> Callable:
    """Route one program site through the census; returns a callable.

    ``name`` is the program's registry identity (wrappers sharing a name
    aggregate into one record).  ``device`` names the device the program
    runs on when its arguments do not say (host inputs copied inside);
    ``scalar_values=False`` keys Python scalar arguments by type (data,
    not static).  With ``MX_PROGRAM_CENSUS=0`` this returns ``fn``
    itself.  With ``MX_COMPILE_CACHE`` set it arms the persistent compile
    cache first (idempotent)."""
    from . import compile_cache as _cc
    if _cc.enabled():
        _cc.activate()
    if not census_enabled():
        return fn
    return Program(name, mode, fn, specializing=specializing,
                   device=device, scalar_values=scalar_values)


# ---------------------------------------------------------------------------
# Program contracts: the registry's declarative face
# ---------------------------------------------------------------------------

#: bumped when the manifest's JSON layout changes
CONTRACT_SCHEMA = 1

_contract_device = [torch.device("cpu")]


def contract_device() -> torch.device:
    """The device the contracts build their cases on: the
    verifier's ``--device`` (set by :func:`contract_scope`)."""
    return _contract_device[0]


class contract_scope:
    """``with contract_scope("cuda"):`` contracts build their cases on that
    device for the duration."""

    def __init__(self, device):
        self._dev = torch.device(device)
        self._prev = None

    def __enter__(self):
        self._prev = _contract_device[0]
        _contract_device[0] = self._dev
        return self._dev

    def __exit__(self, *exc):
        _contract_device[0] = self._prev
        return False


def _seeded_leaf(x, device, rng):
    """A real tensor (or host array) for an abstract leaf: a ``meta``
    tensor becomes seeded values on ``device``, an ndarray seeded values
    on the host (a program that takes host inputs); every other leaf (a
    live tensor of the site's own state, a scalar) passes as it is.
    Floats are normal draws, integers 0 or 1 (a valid slot, page or token
    id in every table), booleans False."""
    if isinstance(x, torch.Tensor) and x.is_meta:
        a = _seeded_array(tuple(x.shape), _dtype_name(x.dtype), rng)
        if x.dtype == torch.bfloat16:
            return torch.from_numpy(a).to(device=device, dtype=x.dtype)
        return torch.from_numpy(a).to(device)
    if isinstance(x, np.ndarray):
        return _seeded_array(x.shape, str(x.dtype), rng)
    return x


def _seeded_array(shape, dtype: str, rng) -> np.ndarray:
    if dtype == "bfloat16":
        dtype = "float32"
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (0.1 * rng.standard_normal(shape)).astype(dt)
    if dt.kind in "iu":
        return rng.integers(0, 2, size=shape).astype(dt)
    return np.zeros(shape, dt)


def _map_tree(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_map_tree(c, fn) for c in tree)
    if isinstance(tree, list):
        return [_map_tree(c, fn) for c in tree]
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


class ContractCase:
    """One concrete dispatch of a contracted program.

    ``args``/``kwargs`` are the argument tree with abstract leaves:
    tensors on the ``meta`` device (shape and dtype, no storage), ndarrays
    for host inputs, and the site's own state tensors as they are (the
    body must write those in place).  ``target`` is the site's registered
    :class:`Program`, so the verifier dispatches exactly what the runtime
    does; alternatively ``fn`` hands it a raw body, which it registers
    under ``program`` itself (the kvstore and optimizer bodies, which no
    site registers).  ``state`` lists tensors the body reaches through its
    site (closed over, not passed), which count as donated too.
    :meth:`make_args` makes the real tensors and :meth:`run` dispatches
    them once."""

    __slots__ = ("program", "label", "target", "fn", "args", "kwargs",
                 "state")

    def __init__(self, program: str, args: tuple, kwargs=None,
                 label: Optional[str] = None, target=None,
                 fn: Optional[Callable] = None,
                 state: Optional[Callable] = None):
        if (target is None) == (fn is None):
            raise ValueError("ContractCase needs exactly one of "
                             "target= (a registered program) or fn= (a "
                             "raw body)")
        self.program = str(program)
        self.label = str(label if label is not None else program)
        self.target = target
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        #: the state the body reads through its site rather than its
        #: arguments (a Trainer's parameters and updater states), which it
        #: must write in place too: a callable listing those tensors now
        self.state = state

    @property
    def scalar_values(self) -> bool:
        """How the program keys Python scalars (its signature rule)."""
        return bool(getattr(self.target, "_scalar_values", True))

    def signature(self) -> Tuple:
        return signature_of(self.args, self.kwargs, self.scalar_values)

    def make_args(self, device, seed: int = 0):
        """(args, kwargs) with every abstract leaf made real from ``seed``
        (meta tensors on ``device``, ndarrays on the host)."""
        rng = np.random.default_rng(seed)
        dev = torch.device(device)
        leaf = (lambda x: _seeded_leaf(x, dev, rng))
        return _map_tree(self.args, leaf), _map_tree(self.kwargs, leaf)

    def program_object(self, device=None) -> "Program":
        """The :class:`Program` the case dispatches through: the target,
        or the raw body registered under the case's program name."""
        if isinstance(self.target, Program):
            return self.target
        return Program(self.program, "aot", self.target or self.fn,
                       device=device)

    def run(self, args, kwargs, device=None):
        """Dispatch once through :meth:`program_object`."""
        return self.program_object(device)(*args, **kwargs)

    def dispatch(self, device, seed: int = 0):
        """Make the tensors and dispatch once; returns the output."""
        args, kwargs = self.make_args(device, seed)
        return self.run(args, kwargs, device)


class ContractClosure:
    """The zero-retrace proof's workload: ``points`` enumerates the
    dispatch points the runtime can reach (every admissible batch size,
    every configured window, ...) and ``resolve(point)`` returns the
    argument tree that point dispatches with, or None when the runtime
    refuses the point before any dispatch.  Every resolved signature must
    be one of the cases'."""

    __slots__ = ("points", "resolve")

    def __init__(self, points, resolve: Callable):
        self.points = list(points)
        self.resolve = resolve


class ProgramContract:
    """Declared invariants of one program family.

    ``build()`` is lazy: declaring costs a dict insert, and only the
    verifier builds the cases.  ``donate_argnums`` index the port's own
    argument tuple: each tensor of those arguments must be written in
    place (torch has no donation, so a rebound tensor keeps two
    generations alive).  ``reference_argnums`` says, where the port's
    argument order differs from the reference's, which of the reference's
    argument indices each donated port index stands for; its key
    ``"state"`` names the reference arguments that the port's body reaches
    through its site instead (a case's ``state``).
    ``temp_budget_bytes`` caps the allocator's temp bytes of a case's
    first dispatch on the card."""

    __slots__ = ("name", "build", "donate_argnums", "temp_budget_bytes",
                 "closure", "description", "origin", "reference_argnums")

    def __init__(self, name: str, build: Callable,
                 donate_argnums: Tuple[int, ...] = (),
                 temp_budget_bytes: Optional[int] = None,
                 closure=None, description: str = "",
                 origin: Optional[Tuple[str, int]] = None,
                 reference_argnums: Optional[Dict[int, Tuple[int, ...]]]
                 = None):
        self.name = str(name)
        self.build = build
        self.donate_argnums = tuple(sorted(int(i) for i in donate_argnums))
        self.temp_budget_bytes = None if temp_budget_bytes is None \
            else int(temp_budget_bytes)
        self.closure = closure
        self.description = str(description)
        #: (file, line) of the declaring site: findings anchor there
        self.origin = origin
        self.reference_argnums = None if reference_argnums is None else {
            (k if k == "state" else int(k)): tuple(int(i) for i in v)
            for k, v in reference_argnums.items()}

    def manifest_entry(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "donate_argnums": list(self.donate_argnums),
            "reference_argnums": None if self.reference_argnums is None
            else {str(k): list(v)
                  for k, v in self.reference_argnums.items()},
            "temp_budget_bytes": self.temp_budget_bytes,
            "closure_points": (
                None if self.closure is None
                else [str(p) for p in self.closure.points]
                if isinstance(self.closure, ContractClosure)
                # a lazy closure is built with the cases, by the verifier
                else "deferred"),
            "description": self.description,
        }


_contracts_lock = threading.Lock()
_contracts: Dict[str, ProgramContract] = {}


def declare_contract(name: str, build: Callable, *,
                     donate_argnums: Tuple[int, ...] = (),
                     temp_budget_bytes: Optional[int] = None,
                     closure=None, description: str = "",
                     reference_argnums=None) -> ProgramContract:
    """Declare the contract of one program family: ``build`` returns the
    :class:`ContractCase` list when the verifier runs; the rest is
    metadata recorded now.  Redeclaring a name replaces it."""
    import sys as _sys
    frame = _sys._getframe(1)
    origin = (frame.f_code.co_filename, frame.f_lineno)
    c = ProgramContract(name, build, donate_argnums=donate_argnums,
                        temp_budget_bytes=temp_budget_bytes,
                        closure=closure, description=description,
                        origin=origin, reference_argnums=reference_argnums)
    with _contracts_lock:
        _contracts[c.name] = c
    return c


def contracts() -> List[ProgramContract]:
    with _contracts_lock:
        return [_contracts[k] for k in sorted(_contracts)]


def contract_manifest() -> Dict[str, Any]:
    """The declared (not built) manifest: what
    ``mxnet_tpu_torch/tools/contracts.json`` holds."""
    return {"schema": CONTRACT_SCHEMA,
            "contracts": [c.manifest_entry() for c in contracts()]}


def reset_contracts() -> None:
    with _contracts_lock:
        _contracts.clear()


# ---------------------------------------------------------------------------
# Device-buffer census
# ---------------------------------------------------------------------------

# Owner buckets, in attribution order: a storage several owners claim
# counts for the first.  serve: a servable's parameters; kv_cache: a flat
# decode engine's KV pool and token/length state (flat across
# generations); kv_pages: a paged engine's page heap; ef_residuals:
# gradient compression's error feedback; optimizer_state: updater states;
# params: gluon parameters and their gradients.
CENSUS_OWNERS = ("serve", "kv_cache", "kv_pages", "ef_residuals",
                 "optimizer_state", "params")

_owners_lock = threading.Lock()
# obj -> (kind, extract(obj) -> iterable of tensors / NDArrays)
_owners: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def track_buffers(kind: str, obj, extract: Callable) -> None:
    """Register ``obj`` as a buffer owner: ``extract(obj)`` yields its
    current tensors when the census runs.  Held weakly, so the census
    never keeps an owner alive (``extract`` must not close over it)."""
    try:
        with _owners_lock:
            _owners[obj] = (str(kind), extract)
    except TypeError:
        pass            # not weakref-able: its bytes count as "other"


def _owned_tensors() -> Dict[str, List[torch.Tensor]]:
    with _owners_lock:
        items = list(_owners.items())
    by_kind: Dict[str, List[torch.Tensor]] = {k: [] for k in CENSUS_OWNERS}
    for obj, (kind, extract) in items:
        out = by_kind.setdefault(kind, [])
        try:
            arrays = extract(obj)
        except Exception:
            continue
        for a in arrays or ():
            a = getattr(a, "_data", a)
            if isinstance(a, torch.Tensor) and not a.is_meta:
                out.append(a)
    return by_kind


def _cuda_allocated() -> Optional[int]:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return sum(int(torch.cuda.memory_allocated(d))
               for d in range(torch.cuda.device_count()))


def buffer_census() -> Dict[str, Any]:
    """Bucket the tracked owners' tensors by owner, each storage once.

    Host metadata only (storage pointers and sizes): no device sync.
    Each bucket reports ``count`` (storages), ``bytes`` and
    ``bytes_per_chip`` (this rank's local bytes).  ``other`` is the CUDA
    allocator's bytes less the owned bytes on the card: activations in
    flight, caches, leaks; ``None`` without CUDA."""
    by_kind = _owned_tensors()
    order = [k for k in CENSUS_OWNERS if k in by_kind] + \
        [k for k in by_kind if k not in CENSUS_OWNERS]
    out: Dict[str, Any] = {k: {"count": 0, "bytes": 0, "bytes_per_chip": 0}
                           for k in order}
    seen = set()
    owned = owned_cuda = n = 0
    for kind in order:
        slot = out[kind]
        for t in by_kind[kind]:
            key = _storage_key(t)
            if key is None:
                key = ("id", id(t))
            if key in seen:
                continue
            seen.add(key)
            try:
                nbytes = int(t.untyped_storage().nbytes())
            except (RuntimeError, NotImplementedError):
                nbytes = int(t.nbytes)
            slot["count"] += 1
            slot["bytes"] += nbytes
            slot["bytes_per_chip"] += nbytes
            owned += nbytes
            n += 1
            if t.device.type == "cuda":
                owned_cuda += nbytes
    alloc = _cuda_allocated()
    if alloc is None:
        out["other"] = {"count": None, "bytes": None, "bytes_per_chip": None}
        other = 0
    else:
        other = max(0, alloc - owned_cuda)
        out["other"] = {"count": None, "bytes": other,
                        "bytes_per_chip": other}
    out["total_bytes"] = owned + other
    out["total_bytes_per_chip"] = owned + other
    out["n_arrays"] = n
    return out


class LeakDetector:
    """Step-over-step live-byte growth detector.

    Each :meth:`check` takes the census, publishes per-owner
    ``census_live_bytes{owner}`` gauges and accumulates consecutive total
    growth; when the streak exceeds ``MX_LEAK_WARN_BYTES`` the
    ``census_leak_bytes`` gauge latches the streak, ``census.leak_trips``
    increments and a warning names the growing buckets.  Only a shrink
    resets the streak."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev_total: Optional[int] = None
        self._prev_census: Optional[Dict[str, Any]] = None
        self._growth = 0
        self._tripped = False
        reg = _telemetry.registry
        self._g_leak = reg.gauge(
            "census_leak_bytes",
            doc="consecutive step-over-step live-byte growth "
                "(0 until it exceeds MX_LEAK_WARN_BYTES)")
        self._c_trips = reg.counter(
            "census.leak_trips",
            doc="times the buffer-census leak detector tripped")

    def reset(self) -> None:
        with self._lock:
            self._prev_total = None
            self._prev_census = None
            self._growth = 0
            self._tripped = False
        self._g_leak.set(0)

    def check(self) -> Dict[str, Any]:
        census = buffer_census()
        reg = _telemetry.registry
        for kind, slot in census.items():
            if isinstance(slot, dict) and slot["bytes"] is not None:
                reg.gauge("census_live_bytes",
                          doc="live device bytes by owner bucket",
                          labels={"owner": kind}).set(slot["bytes"])
        try:
            warn_bytes = int(get_env("MX_LEAK_WARN_BYTES", 64 << 20, int)
                             or 0)
        except (TypeError, ValueError):
            warn_bytes = 64 << 20
        total = census["total_bytes"]
        growers = []
        with self._lock:
            if self._prev_total is not None:
                delta = total - self._prev_total
                if delta > 0:
                    self._growth += delta
                    prev = self._prev_census or {}
                    for kind, slot in census.items():
                        if not isinstance(slot, dict) or \
                                slot["bytes"] is None:
                            continue
                        before = (prev.get(kind) or {}).get("bytes") or 0
                        if slot["bytes"] > before:
                            growers.append((kind, slot["bytes"] - before))
                elif delta < 0:
                    # only a shrink resets the streak: a flat plateau
                    # between growth steps must not hide a leak
                    self._growth = 0
                    self._tripped = False
            self._prev_total = total
            self._prev_census = census
            growth = self._growth
            tripped = warn_bytes > 0 and growth >= warn_bytes
            first_trip = tripped and not self._tripped
            self._tripped = tripped
        self._g_leak.set(growth if tripped else 0)
        if first_trip:
            self._c_trips.inc()
            logger.warning(
                "buffer-census leak suspect: live bytes grew %d over "
                "consecutive checks (MX_LEAK_WARN_BYTES=%d); growing "
                "buckets this check: %s; census: %s",
                growth, warn_bytes,
                ", ".join("%s+%d" % g for g in growers) or "other",
                {k: v for k, v in census.items() if isinstance(v, dict)})
        return {"census": census, "growth_bytes": growth,
                "tripped": tripped}


leak_detector = LeakDetector()

# Flight-recorder wiring: every 16th step record carries the census total
# and the leak streak
_CENSUS_EVERY = 16
_census_tick = [0]
_census_tick_lock = threading.Lock()


def _step_census_observer() -> Optional[Dict[str, Any]]:
    if not census_enabled():
        return None
    with _census_tick_lock:
        _census_tick[0] += 1
        due = _census_tick[0] % _CENSUS_EVERY == 1
    if not due:
        return None
    chk = leak_detector.check()
    return {"live_bytes": chk["census"]["total_bytes"],
            "leak_bytes": chk["growth_bytes"]}


# ---------------------------------------------------------------------------
# Isolation: what a verifier run leaves behind
# ---------------------------------------------------------------------------

class isolated:
    """A registry scope for a verifier run: on exit the program records,
    the census's owners, the telemetry instruments and the leak detector
    are as they were on entry (instruments made inside are dropped, the
    others' values put back).  What other threads record meanwhile is
    lost with them, so the verifier runs in a process of its own
    (``python -m mxnet_tpu_torch.tools.contracts``): the scope refuses to
    open while ``serve_forever`` answers in this process.  The CUDA
    allocator's peak is process-global and cannot be set back; whoever
    reads it resets it first."""

    def __enter__(self):
        global _records
        server = sys.modules.get(__package__ + ".serve.server")
        if server is not None and server.serving():
            raise RuntimeError(
                "programs.isolated: serve_forever answers in this process, "
                "and a verifier run would take back what its threads "
                "record; run python -m mxnet_tpu_torch.tools.contracts in "
                "a process of its own")
        with _records_lock:
            self._records = _records
            _records = {}
        with _owners_lock:
            self._owners = set(id(o) for o in _owners.keys())
        reg = _telemetry.registry
        with reg._lock:
            self._insts = dict(reg._instruments)
        self._states = {k: _inst_state(v) for k, v in self._insts.items()}
        ld = leak_detector
        with ld._lock:
            self._leak = (ld._prev_total, ld._prev_census, ld._growth,
                          ld._tripped)
        return self

    def __exit__(self, *exc):
        global _records
        with _records_lock:
            _records = self._records
        with _owners_lock:
            for o in [o for o in _owners.keys()
                      if id(o) not in self._owners]:
                _owners.pop(o, None)
        reg = _telemetry.registry
        with reg._lock:
            reg._instruments = dict(self._insts)
        for k, inst in self._insts.items():
            _inst_restore(inst, self._states[k])
        ld = leak_detector
        with ld._lock:
            (ld._prev_total, ld._prev_census, ld._growth,
             ld._tripped) = self._leak
        return False


def _inst_state(inst):
    with inst._lock:
        if isinstance(inst, _telemetry.Histogram):
            return (list(inst._counts), inst._sum, inst._count, inst._min,
                    inst._max)
        return inst._value


def _inst_restore(inst, state) -> None:
    with inst._lock:
        if isinstance(inst, _telemetry.Histogram):
            (counts, inst._sum, inst._count, inst._min,
             inst._max) = state
            inst._counts = list(counts)
        else:
            inst._value = state


_telemetry.register_step_observer(_step_census_observer)
_telemetry.register_crash_section("buffer_census", buffer_census)
_telemetry.register_crash_section("programs", program_table)
