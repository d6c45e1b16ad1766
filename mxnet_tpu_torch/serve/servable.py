"""Servables: one model version behind a table of batch buckets.

Counterpart of ``mxnet_tpu/serve/servable.py``.  A :class:`Servable` holds
one immutable model version: the module on its device in ``eval()`` mode.
Dispatch pads to a bucket (by the batcher) and runs the forward under
``torch.inference_mode`` on the servable's device; :meth:`Servable.warm`
runs every bucket once before the version goes live, so the first real
request pays no first-call cost (allocator growth, kernel build and
library autotuning).  :class:`ModelHost` owns the version lifecycle: warm,
flip, drain the predecessor.  :meth:`Servable.from_block` hosts a block
after loading a ``save_parameters`` file into it.

PyTorch runs eagerly, so there are no per-bucket programs to compile;
``bucket_hits`` counts dispatches whose (bucket, signature) was warmed and
``batches`` counts every dispatch that was not a warm-up.
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

__all__ = ["BucketTable", "Servable", "ModelHost"]


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


class Servable:
    """One immutable model version.

    ``block`` maps row-batched inputs to row-batched outputs (leading axis
    = batch on every input and output), so padding rows never changes real
    rows.  It is moved to ``device`` (default: the GPU) and put in eval
    mode."""

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
        self._lock = threading.Lock()
        self._warm_keys = set()
        self._warm_sig: Optional[Tuple] = None
        self.bucket_hits = 0
        self.batches = 0
        self.warm_seconds: Optional[float] = None
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

    def warm(self, example: Sequence) -> "Servable":
        """Dispatch zeros of ``example``'s signature at every bucket;
        returns self."""
        t0 = time.perf_counter()
        sig = self.signature_of([np.asarray(a) for a in example])
        for bucket in self.buckets:
            zeros = [np.zeros((bucket,) + trail, dtype=dt)
                     for trail, dt in sig]
            self.to_host(self.dispatch(bucket, zeros, warming=True))
            with self._lock:
                self._warm_keys.add((bucket, sig))
        with self._lock:
            self._warm_sig = sig
        self.warm_seconds = time.perf_counter() - t0
        return self

    @property
    def warmed_signature(self) -> Optional[Tuple]:
        with self._lock:
            return self._warm_sig

    def dispatch(self, bucket: int, padded_inputs: Sequence[np.ndarray],
                 warming: bool = False) -> Tuple[torch.Tensor, ...]:
        """Run the forward over already-padded host inputs; returns the
        output leaves on the device (the caller syncs when it reads).  One
        forward counts one dispatch (``engine.dispatch_count``), as the
        reference's bucket program does."""
        from ..engine import engine as _engine
        key = (int(bucket), self.signature_of(padded_inputs))
        with torch.inference_mode(), self._device_scope():
            xs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in padded_inputs]
            outs = tuple(_leaves(self.block(*xs)))
        _engine.count_dispatch(1)
        if not warming:
            with self._lock:
                self.batches += 1
                if key in self._warm_keys:
                    self.bucket_hits += 1
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
        """Wait (bounded) until no dispatch is in flight, then retire.
        Returns False if in-flight work outlived ``timeout``."""
        deadline = time.monotonic() + timeout
        ok = True
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    ok = False
                    break
                self._inflight_cv.wait(timeout=min(0.05, remaining))
            self._closed = True
        return ok


class ModelHost:
    """Versioned servable lifecycle for named models.  ``active(model)`` is
    what the batcher reads per batch; :meth:`deploy` warms a new version
    entirely before the flip and drains the old one after it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._servables: Dict[str, Servable] = {}
        self._default: Optional[str] = None
        #: engines hosted beside the servables, by model name (a decode
        #: engine joins here when a server is given one)
        self.engines: Dict[str, object] = {}

    def active(self, model: Optional[str] = None) -> Servable:
        with self._lock:
            name = model if model is not None else self._default
            sv = self._servables.get(name) if name is not None else None
        if sv is None:
            if model is None:
                raise MXNetError("ModelHost: no servable deployed")
            raise MXNetError("ModelHost: unknown model %r" % (model,))
        return sv

    @property
    def version(self) -> int:
        """The default model's live version (0 when none is deployed)."""
        with self._lock:
            sv = self._servables.get(self._default) \
                if self._default is not None else None
            return sv.version if sv is not None else 0

    def deploy(self, servable: Servable, example: Optional[Sequence] = None,
               drain_timeout: float = 30.0) -> Servable:
        """Warm ``servable`` (when ``example`` is given and it is not warm
        yet), flip it live under its name, drain the predecessor."""
        with self._lock:
            prev = self._servables.get(servable.name)
        if prev is not None and servable.version <= prev.version:
            raise MXNetError("ModelHost: version %d is not newer than the "
                             "active %d" % (servable.version, prev.version))
        if example is not None and servable.warmed_signature is None:
            servable.warm(example)
        with self._lock:
            prev = self._servables.get(servable.name)
            if prev is not None and servable.version <= prev.version:
                raise MXNetError("ModelHost: version %d is not newer than "
                                 "the active %d"
                                 % (servable.version, prev.version))
            self._servables[servable.name] = servable
            if self._default is None:
                self._default = servable.name
        if prev is not None:
            prev.drain(timeout=drain_timeout)
        return servable
