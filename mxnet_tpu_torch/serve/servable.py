"""Servables: versioned models behind a table of bucket programs.

Counterpart of ``mxnet_tpu/serve/servable.py``.  A :class:`Servable` holds
one immutable model version: the module on its device in ``eval()`` mode,
and one program per (bucket, input signature), registered with the
program registry as ``serve.<name>.b<bucket>`` (:mod:`..programs`).  A
program is the bucket's forward under ``torch.inference_mode``; its first
dispatch is its "compile" (kernel builds, library autotuning, allocator
growth), which the registry times and whose transient device bytes it
reads off the allocator.  :meth:`Servable.warm` builds and runs every
bucket before the version goes live, so the first real request pays
none of it; ``retraces`` counts program builds and ``bucket_hits``
dispatches answered by a built program.  The servable's parameters are a
``serve`` owner in the buffer census, and :meth:`Servable.footprint_bytes`
(live bytes plus the largest temp bytes of its programs) is what the HBM
packer admits.

:class:`ModelHost` owns the version lifecycle of several named models:
warm, admit against ``MX_SERVE_HBM_BUDGET`` (:class:`BudgetExceeded`),
flip, drain the predecessor.  :meth:`Servable.from_block` hosts a block
after loading a ``save_parameters`` file into it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..device import DeviceLike, resolve
from .. import fault as _fault
from .. import programs as _programs
from .. import telemetry as _telemetry

__all__ = ["BucketTable", "Servable", "ModelHost", "BudgetExceeded"]


class BudgetExceeded(MXNetError):
    """Admitting a servable would pass the host's HBM budget
    (``MX_SERVE_HBM_BUDGET``).  The wire answers it in-band as
    ``(False, "budget: ...")``, so a client can tell "this replica is
    full" from a crash."""


class BucketTable:
    """The configured batch-size buckets, ascending.  ``bucket_for(n)`` is
    the smallest bucket >= n, or None when n exceeds the top bucket."""

    def __init__(self, sizes: Sequence[int]):
        uniq = sorted({int(s) for s in sizes})
        if not uniq or uniq[0] < 1:
            raise MXNetError("BucketTable needs positive bucket sizes, "
                             "got %r" % (sizes,))
        self.sizes: Tuple[int, ...] = tuple(uniq)

    @classmethod
    def from_env(cls) -> "BucketTable":
        raw = get_env("MX_SERVE_BUCKETS") or "1,2,4,8,16"
        return cls([int(p) for p in str(raw).split(",") if p.strip()])

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> Optional[int]:
        for s in self.sizes:
            if s >= n:
                return s
        return None

    def __iter__(self):
        return iter(self.sizes)

    def __repr__(self):
        return "BucketTable%r" % (self.sizes,)


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    raise MXNetError("servable output %r is not a tensor or a tuple of "
                     "tensors" % (type(out),))


def _counter(name, doc, labels=None):
    return _telemetry.registry.counter(name, doc=doc, labels=labels)


def _servable_census_tensors(sv) -> List[torch.Tensor]:
    return list(sv.block.parameters()) + list(sv.block.buffers())


class Servable:
    """One immutable model version: the module and its program table.

    ``block`` maps row-batched inputs to row-batched outputs (leading axis
    = batch on every input and output), so padding rows never changes real
    rows.  It is moved to ``device`` (default: the GPU) and put in eval
    mode.  Programs are keyed ``(bucket, input signature)``, the signature
    being the per-input (trailing shape, dtype)."""

    def __init__(self, block: torch.nn.Module, name: str = "model",
                 version: int = 1, buckets: Optional[BucketTable] = None,
                 device: DeviceLike = None):
        self.device = resolve(device)
        for pname, p in block.named_parameters():
            if p.device.type == "meta":
                raise MXNetError("Servable: parameter %r was never "
                                 "initialized (initialize() or load_dict())"
                                 % pname)
        self.block = block.to(self.device).eval()
        self.name = str(name)
        self.version = int(version)
        self.buckets = buckets or BucketTable.from_env()
        # the buffer census: this version's parameters are the "serve"
        # owner's
        _programs.track_buffers("serve", self, _servable_census_tensors)
        self._lock = threading.Lock()
        self._programs: Dict[Tuple, object] = {}
        self._warm_sig: Optional[Tuple] = None
        self.retraces = 0            # program builds (warm pays them)
        self.bucket_hits = 0         # dispatches answered by the table
        self.batches = 0             # dispatches that were not warm-ups
        self.warm_seconds: Optional[float] = None
        self._c_retrace = _counter(
            "serve.retraces", "serve-side program builds (0 after warm-up; "
            "warm() pays them at deploy)")
        self._c_hits = _counter(
            "serve.bucket_hits", "dispatches answered by a pre-built "
            "bucket program")
        self._c_batches = _counter("serve.batches",
                                   "micro-batch dispatches")
        self._c_batches_m = _counter("serve.batches",
                                     "micro-batch dispatches",
                                     labels={"model": self.name})
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._closed = False

    @staticmethod
    def from_block(block: torch.nn.Module, params_file: Optional[str] = None,
                   ctx: DeviceLike = None, **kwargs) -> "Servable":
        """Host a live gluon block, after loading a ``save_parameters``
        file into it (on ``ctx``: default the current context, the GPU
        unless the caller says otherwise) when one is given; ``kwargs``
        go to :class:`Servable`."""
        if params_file:
            block.load_parameters(params_file, ctx=ctx)
        return Servable(block, **kwargs)

    @staticmethod
    def from_checkpoint(prefix: str, epoch: int = 0,
                        input_names: Sequence[str] = ("data",),
                        **kwargs) -> "Servable":
        """Not ported: an exported ``<prefix>-symbol.json`` loads through
        ``gluon.SymbolBlock``, which waits for the symbol API (Queue 1
        item 8)."""
        raise MXNetError("Servable.from_checkpoint(%r) needs "
                         "gluon.SymbolBlock, which waits for the symbol API "
                         "(Queue 1 item 8); build the block and use "
                         "Servable.from_block(block, params_file)" % prefix)

    @staticmethod
    def signature_of(arrays: Sequence) -> Tuple:
        """Per-input (trailing shape, dtype): what the bucket does not
        normalise."""
        return tuple((tuple(int(s) for s in a.shape[1:]), str(a.dtype))
                     for a in arrays)

    # -- program table ------------------------------------------------------
    def _build(self, key):
        """One program per (bucket, signature), registered as
        ``serve.<model>.b<bucket>``: host inputs in, output leaves on the
        device out."""
        block, device = self.block, self.device

        def run_infer(padded_inputs):
            with torch.inference_mode():
                xs = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in padded_inputs]
                return tuple(_leaves(block(*xs)))

        return _programs.register_program(
            "serve.%s.b%d" % (self.name, int(key[0])), run_infer,
            device=device)

    def program(self, bucket: int, sig: Tuple):
        """The program of ``(bucket, sig)``, built on a miss (counted as a
        retrace; warm() builds every bucket)."""
        key = (int(bucket), sig)
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self.bucket_hits += 1
        if prog is not None:
            self._c_hits.inc()
            return prog
        with _telemetry.phase("retrace"):
            prog = self._build(key)
        with self._lock:
            prog = self._programs.setdefault(key, prog)
            self.retraces += 1
        self._c_retrace.inc()
        return prog

    def warm(self, example: Sequence) -> "Servable":
        """Build and run every bucket for ``example``'s signature (each
        program's first dispatch, which the registry measures); returns
        self.

        Every bucket keeps its proving run, with or without
        ``MX_COMPILE_CACHE``: the reference skips a bucket whose
        executable deserialized (``ensure_compiled(...) == "hit"``), but
        a torch program has no executable apart from its first dispatch,
        so ``Program.ensure_compiled`` never answers "hit" and that
        dispatch is the warm-up itself (the cache saves the kernels'
        ``nvcc`` builds inside it)."""
        t0 = time.perf_counter()
        sig = self.signature_of([np.asarray(a) for a in example])
        for bucket in self.buckets:
            zeros = [np.zeros((bucket,) + trail, dtype=dt)
                     for trail, dt in sig]
            prog = self.program(bucket, sig)
            self.to_host(self.dispatch(bucket, zeros, warming=True,
                                       _prog=prog))
        with self._lock:
            self._warm_sig = sig
        self.warm_seconds = time.perf_counter() - t0
        return self

    @property
    def warmed_signature(self) -> Optional[Tuple]:
        with self._lock:
            return self._warm_sig

    def dispatch(self, bucket: int, padded_inputs: Sequence[np.ndarray],
                 warming: bool = False, _prog=None
                 ) -> Tuple[torch.Tensor, ...]:
        """Run the bucket program over already-padded host inputs; returns
        the output leaves on the device (the caller syncs when it reads).
        One forward counts one dispatch (``engine.dispatch_count``).
        ``_prog`` is a program warm() already resolved, so the warm-up
        does not count a bucket hit."""
        from ..engine import engine as _engine
        prog = _prog
        if prog is None:
            prog = self.program(bucket, self.signature_of(padded_inputs))
        with self._device_scope():
            outs = prog(list(padded_inputs))
        _engine.count_dispatch(1)
        if not warming:
            with self._lock:
                self.batches += 1
            self._c_batches.inc()
            self._c_batches_m.inc()
        return outs

    def _device_scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @staticmethod
    def to_host(outs: Sequence[torch.Tensor]) -> List[np.ndarray]:
        """Device outputs -> host numpy (waits for the device)."""
        host = []
        for o in outs:
            if o.dtype == torch.bfloat16:
                raise MXNetError("servable output is bfloat16, which has no "
                                 "numpy dtype for the NPX wire; serve in "
                                 "float32")
            host.append(o.detach().cpu().numpy())
        return host

    # -- footprint (the HBM packer's measurement) ---------------------------
    def program_prefix(self) -> str:
        """The registry prefix this servable's programs register under."""
        return "serve.%s." % self.name

    def live_bytes(self) -> int:
        """Bytes of the tensors this servable holds (the ones its
        ``serve`` census owner claims)."""
        return sum(int(t.nbytes) for t in _servable_census_tensors(self))

    def footprint_bytes(self) -> int:
        """Measured device footprint for admission: live bytes plus the
        largest transient any of its programs needed at its first
        dispatch.  Meaningful after :meth:`warm`, which is why the packer
        admits after the warm."""
        mem = _programs.program_memory_bytes(self.program_prefix())
        return self.live_bytes() + int(mem["temp_bytes_peak"])

    # -- lifecycle ----------------------------------------------------------
    def begin(self) -> bool:
        """Claim one in-flight dispatch slot; False once retired."""
        with self._inflight_cv:
            if self._closed:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._inflight_cv:
            self._inflight = max(0, self._inflight - 1)
            self._inflight_cv.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) until no dispatch is in flight, then retire: new
        begin() calls fail and the program table is dropped.  Returns
        False if in-flight work outlived ``timeout``."""
        deadline = _fault.Deadline(timeout)
        ok = True
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline.remaining()
                if remaining <= 0:
                    ok = False
                    break
                self._inflight_cv.wait(timeout=min(0.05, remaining))
            self._closed = True
        with self._lock:
            self._programs.clear()
        return ok


class ModelHost:
    """Versioned servable lifecycle for several named models on one
    replica, each with its own version chain (load v(N+1), warm, flip,
    drain v(N)), under one HBM budget.

    ``active(model)`` is what a batcher reads per batch: one lock, never
    blocked by a deploy (warming happens before the flip, draining
    after).  ``active()`` with no argument reads the default model (the
    first deployed).

    With ``MX_SERVE_HBM_BUDGET`` > 0 bytes, :meth:`deploy` measures the
    candidate's footprint after its warm and refuses it with
    :class:`BudgetExceeded` when hosted + new would pass the budget (a
    same-name redeploy gets its predecessor's bytes back first); nothing
    of a refused servable is kept."""

    def __init__(self, hbm_budget: Optional[int] = None):
        self._lock = threading.Lock()
        self._servables: Dict[str, Servable] = {}
        self._default: Optional[str] = None
        self._history: List[Tuple[int, str]] = []
        self.hbm_budget = int(
            hbm_budget if hbm_budget is not None else
            get_env("MX_SERVE_HBM_BUDGET", 0, int) or 0)
        #: per-model engines (a micro-batcher per non-default model, the
        #: decode engines), kept by the serving layer
        self.engines: Dict[str, object] = {}

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._servables)

    def active(self, model: Optional[str] = None) -> Servable:
        with self._lock:
            name = model if model is not None else self._default
            sv = self._servables.get(name) if name is not None else None
            hosted = sorted(self._servables)
        if sv is None:
            if model is None:
                raise MXNetError("ModelHost: no servable deployed")
            raise MXNetError("ModelHost: unknown model %r (hosted: %s)"
                             % (model, ", ".join(hosted) or "none"))
        return sv

    @property
    def default_model(self) -> Optional[str]:
        with self._lock:
            return self._default

    @property
    def version(self) -> int:
        """The default model's live version (0 when none is deployed)."""
        with self._lock:
            sv = self._servables.get(self._default) \
                if self._default is not None else None
            return sv.version if sv is not None else 0

    def version_of(self, model: str) -> int:
        with self._lock:
            sv = self._servables.get(model)
            return sv.version if sv is not None else 0

    def _engine_servables(self) -> Dict[str, object]:
        """The decode engines' models on this replica (a speculative
        pair's target and draft), except names already deployed as
        servables: they share the budget with the PREDICT models."""
        with self._lock:
            hosted = set(self._servables)
            engines = list(self.engines.values())
        out: Dict[str, object] = {}
        for eng in engines:
            for sv in (getattr(eng, "servable", None),
                       getattr(eng, "draft", None)):
                if sv is None or not hasattr(sv, "footprint_bytes"):
                    continue
                if sv.name in hosted or sv.name in out:
                    continue
                out[sv.name] = sv
        return out

    def used_bytes(self) -> int:
        """Measured footprint of every hosted servable and decode model
        (recomputed, so it tracks what is resident now)."""
        with self._lock:
            svs = list(self._servables.values())
        svs.extend(self._engine_servables().values())
        return sum(sv.footprint_bytes() for sv in svs)

    def packing_report(self) -> Dict[str, object]:
        """The packer's face on HEALTH: per-model footprints against the
        budget."""
        with self._lock:
            svs = dict(self._servables)
            default = self._default
        per_model = {name: {"version": sv.version,
                            "footprint_bytes": sv.footprint_bytes()}
                     for name, sv in svs.items()}
        for name, sv in self._engine_servables().items():
            per_model[name] = {"version": sv.version,
                               "footprint_bytes": sv.footprint_bytes(),
                               "engine": getattr(sv, "engine", "decode")}
        used = sum(m["footprint_bytes"] for m in per_model.values())
        return {
            "hbm_budget_bytes": self.hbm_budget,
            "used_bytes": used,
            "free_bytes": (self.hbm_budget - used
                           if self.hbm_budget > 0 else None),
            "default_model": default,
            "models": per_model,
        }

    def deploy(self, servable: Servable, example: Optional[Sequence] = None,
               drain_timeout: float = 30.0) -> Servable:
        """Warm ``servable`` (when ``example`` is given and it is not warm
        yet), admit it against the budget, flip it live under its name,
        drain the same-name predecessor.  Raises :class:`BudgetExceeded`
        (nothing kept) when it does not fit."""
        if example is not None and servable.warmed_signature is None:
            servable.warm(example)
        name = servable.name
        with self._lock:
            prev = self._servables.get(name)
        if prev is not None and servable.version <= prev.version:
            raise MXNetError("ModelHost: version %d is not newer than the "
                             "active %d" % (servable.version, prev.version))
        if self.hbm_budget > 0:
            # admission after the warm: the footprint is measured
            new_bytes = servable.footprint_bytes()
            with self._lock:
                others = [sv for n, sv in self._servables.items()
                          if n != name]
            others.extend(sv for n, sv in self._engine_servables().items()
                          if n != name)
            used = sum(sv.footprint_bytes() for sv in others)
            if used + new_bytes > self.hbm_budget:
                raise BudgetExceeded(
                    "ModelHost: admitting %r v%d (%d bytes) would use %d "
                    "of %d budget bytes (MX_SERVE_HBM_BUDGET; %d hosted: "
                    "%s)" % (name, servable.version, new_bytes,
                             used + new_bytes, self.hbm_budget, len(others),
                             ", ".join(sorted(sv.name for sv in others))
                             or "none"))
        with self._lock:
            prev = self._servables.get(name)
            if prev is not None and servable.version <= prev.version:
                raise MXNetError("ModelHost: version %d is not newer than "
                                 "the active %d"
                                 % (servable.version, prev.version))
            self._servables[name] = servable
            if self._default is None:
                self._default = name
            self._history.append((servable.version, name))
        if prev is not None:
            prev.drain(timeout=drain_timeout)
        return servable

    def history(self) -> List[Tuple[int, str]]:
        with self._lock:
            return list(self._history)


# ---------------------------------------------------------------------------
# Program contracts: the bucket table's declared closure.  One contract
# covers every ``serve.demo.b<N>`` bucket program of the demo servable under
# the configured bucket table (MX_SERVE_BUCKETS): every admissible batch
# pads to a bucket whose signature is a case's, and a batch past the top
# bucket is refused at admission.  The cases are built only in the verifier.
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=4)
def _demo_contract_built(device: str, sizes: Tuple[int, ...]):
    """Keyed by the bucket sizes, so a process that changes
    MX_SERVE_BUCKETS between verifier runs gets cases and a closure over
    the new table."""
    from ..programs import ContractCase, ContractClosure
    from .demo import DEMO_IN, demo_block
    table = BucketTable(sizes)
    sv = Servable(demo_block(device), name="demo", version=1, buckets=table,
                  device=device)
    sig = (((DEMO_IN,), "float32"),)

    def args_for(bucket):
        # the program takes the padded host batch, as dispatch() gives it
        return ([np.empty((bucket, DEMO_IN), np.float32)],)

    cases = [ContractCase("serve.demo.b%d" % b, args_for(b),
                          label="b%d" % b, target=sv.program(b, sig))
             for b in table]

    def resolve(rows):
        # the batcher pads a batch to bucket_for(rows); a batch past the
        # top bucket is refused at admission, before any dispatch
        bucket = table.bucket_for(int(rows))
        return None if bucket is None else args_for(bucket)

    closure = ContractClosure(range(1, table.max_size + 3), resolve)
    return cases, closure


def _demo_contract(part: int):
    from ..programs import contract_device
    return _demo_contract_built(str(contract_device()),
                                BucketTable.from_env().sizes)[part]


def _declare_serve_contracts():
    from ..programs import declare_contract
    declare_contract(
        "serve.demo", lambda: _demo_contract(0),
        donate_argnums=(),
        # 4,608 temp bytes at most on an NVIDIA H100 80GB HBM3 at
        # 700.00 W (the verifier, phase_launch_tier); x 4, a power of 2
        temp_budget_bytes=1 << 15,
        closure=lambda: _demo_contract(1),
        description="demo servable's bucket table: no donations (the "
                    "parameters are shared across dispatches), signatures "
                    "closed over the MX_SERVE_BUCKETS admission set")


_declare_serve_contracts()
