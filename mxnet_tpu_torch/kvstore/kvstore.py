"""KVStore: data-parallel gradient aggregation.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py`` (reference:
python/mxnet/kvstore/kvstore.py, src/kvstore/kvstore_local.h, comm.h,
kvstore_nccl.h).

* ``local`` / ``device``: one process; ``push`` sums a key's list of
  values (each process in the port has one device a parameter, so the
  list is usually one value).
* ``ici``: the collective store.  Inside a ``torch.distributed`` process
  group (:func:`~..parallel.init_process_group`: NCCL on the GPU, gloo on
  the CPU) every push is also an ``all_reduce(SUM)`` across the ranks,
  coalesced into fusion buckets (:mod:`.bucketing`), so a pull after W
  workers push gives their sum.  A group of one rank runs the same
  collectives.  ``nccl``, ``dist``, ``dist_sync``, ``dist_device_sync``
  and ``horovod`` are its aliases.
* ``dist_async`` without a parameter server falls back to ``ici`` with
  the reference's warning; the parameter server itself is not ported
  yet.

Compression (``set_gradient_compression``): ``2bit`` quantizes each
worker's payload to +-t/0 levels with error feedback and sums the levels
at full width; ``int8`` quantizes each bucket per block with error
feedback and exchanges the codes and scales by ``all_gather``, every rank
then dequantizing, summing and requantizing the same way, so the wire is
int8 in both directions; ``bf16`` casts the payload for the sum.

Not ported: the traceable exchange of the compiled step
(``build_exchange_body``; it comes with the CUDA-graph step),
``row_sparse_pull`` (with sparse storage) and the reference's wire-byte
counters.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
import torch.distributed as dist

from ..base import MXNetError, dtype_name, get_env
from ..ndarray.ndarray import NDArray

__all__ = ["KVStore", "create", "KVStoreLocal", "KVStoreDevice",
           "KVStoreICI"]


def _key(k):
    # int keys stay ints: the Trainer numbers its parameters and the
    # optimizer looks up lr_mult/wd_mult by that int
    return k if isinstance(k, int) else str(k)


def _nd(v) -> NDArray:
    return v if isinstance(v, NDArray) else NDArray(v)


def _floating(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _owned(merged: NDArray, values) -> torch.Tensor:
    """``merged``'s tensor, copied when it is one of the pushed values:
    the store must not alias a tensor its caller may write later."""
    t = merged.data
    return t.clone() if any(t is v.data for v in values) else t


class KVStore:
    """Base interface (reference: python/mxnet/kvstore/kvstore.py)."""

    def __init__(self):
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._gc = None
        self._compress_bf16 = False
        # key->bucket layouts, by the ordered (key, shape, dtype, stype)
        # signature of a batched exchange, the cap and the packing order
        self._bucket_cache: Dict = {}

    # -- identity ----------------------------------------------------------
    @property
    def type(self) -> str:
        raise NotImplementedError

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # -- data path ---------------------------------------------------------
    def init(self, key, value):
        """Register the initial value of each key (a list: its first)."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = _nd(vv).copy()

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        vlists = [[_nd(x) for x in v] if isinstance(v, (list, tuple))
                  else [_nd(v)] for v in values]
        merged = self._reduce_many(keys, vlists)
        stored_list = []
        for k in keys:
            stored = self._store.get(k)
            if stored is None:
                raise MXNetError("key %s has not been initialized" % k)
            stored_list.append(stored)
        if self._updater is not None:
            # one updater call for the whole push: an optimizer with
            # aggregate_num applies it fused
            self._updater(list(keys), merged, stored_list)
        else:
            for stored, m, vl in zip(stored_list, merged, vlists):
                stored._data = _owned(m, vl).to(stored.data.device)

    def _reduce_many(self, keys, vlists) -> List[NDArray]:
        """Merge each key's values (and, in the collective store, exchange
        them across the ranks in fusion buckets)."""
        return [self._reduce(v, key=k) for k, v in zip(keys, vlists)]

    # -- the overlapped exchange -------------------------------------------
    def begin_exchange(self, keys, vlists, reverse=True):
        """Open an overlap-scheduled batched exchange (see
        :class:`_ExchangeSession`).  A value list may be given as a
        callable that returns it when the exchange reads it: a gluon
        parameter's gradient is a new tensor after each backward.
        ``reverse=False`` packs the buckets in key order, as a batched
        :meth:`push` does: a session drained at once is then that push's
        exchange."""
        return _ExchangeSession(self, [_key(k) for k in keys], list(vlists),
                                reverse=reverse)

    def _exchange_unit(self, kind, obj, keys, vals):
        """Launch one exchange unit and return its result.  The base stores
        have no wire: a unit is its keys' local merge."""
        if kind == "solo":
            return self._reduce(vals(obj), key=keys[obj])
        return [self._reduce(vals(p), key=keys[p]) for p in obj.positions]

    def _commit_unit(self, kind, obj, result, keys, vals):
        """Write a launched unit's result into the store and every pull
        target (deferred to the drain, so that gradients read between
        backward and the step keep their own values)."""
        if kind == "solo":
            self._commit_key(keys[obj], result, vals(obj))
            return
        for p, m in zip(obj.positions, result):
            self._commit_key(keys[p], m, vals(p))

    def _commit_key(self, k, merged, targets):
        stored = self._store.get(k)
        if stored is None:
            raise MXNetError("key %s has not been initialized" % k)
        stored._data = _owned(merged, targets).to(stored.data.device)
        for t in targets:
            stored.copyto(t)

    def _bucket_plans(self, keys, arrays, reverse=False):
        """The cached key->bucket layout of a batched exchange: ``(buckets,
        solo_positions)``.  The cache key holds the bucket capacity and
        the packing order, so a change of ``MX_KVSTORE_BUCKET_KB`` plans
        anew (and 0 leaves every key solo)."""
        from .bucketing import bucket_bytes, plan_buckets
        cap = bucket_bytes()
        # the numpy dtype names, as the reference's descriptors spell them
        sig = tuple((k, tuple(a.shape), dtype_name(a.data.dtype),
                     a.stype) for k, a in zip(keys, arrays))
        cache_key = (sig, cap, bool(reverse))
        cached = self._bucket_cache.get(cache_key)
        if cached is None:
            cached = plan_buckets(
                keys, [s[1] for s in sig], [s[2] for s in sig],
                [a.data.element_size() for a in arrays],
                [s[3] for s in sig], cap, reverse=reverse)
            self._bucket_cache[cache_key] = cached
        return cached

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            stored = self._store[k]
            targets = o if isinstance(o, (list, tuple)) else [o]
            for t in targets:
                stored.copyto(_nd(t))

    def pushpull(self, key, value, out=None, priority=0):
        """Push and pull in one call: the data-parallel allreduce."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("KVStore.row_sparse_pull is not ported: it comes "
                         "with sparse storage (ROADMAP Queue 1 item 8)")

    # -- optimizer ---------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store's values at every push (the
        reference's update_on_kvstore)."""
        from ..optimizer import get_updater
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """``{'type': '2bit', 'threshold': t}``, ``{'type': 'int8',
        'block': b}`` (``MX_GRAD_COMPRESS_BLOCK`` by default) or
        ``{'type': 'bf16'}``; any other type raises ``ValueError``, as in
        upstream MXNet."""
        params = dict(compression_params or {})
        ctype = params.get("type")
        self._gc = None
        self._compress_bf16 = False
        if ctype in ("2bit", "int8"):
            from .gradient_compression import GradientCompression
            self._gc = GradientCompression(
                type=ctype, threshold=float(params.get("threshold", 0.5)),
                block=params.get("block"))
            return
        if ctype == "bf16":
            self._compress_bf16 = True
            return
        if ctype is not None:
            raise ValueError(
                "Unsupported gradient compression type %r (supported: "
                "'2bit', 'int8', 'bf16')" % (ctype,))

    def _maybe_compress(self, x: torch.Tensor):
        """The bf16 cast of a payload before its sum: ``(payload, dtype to
        cast back to or None)``."""
        if self._compress_bf16 and _floating(x) and x.dtype != torch.bfloat16:
            return x.to(torch.bfloat16), x.dtype
        return x, None

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, \
            "Cannot save states for fused optimizer"
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, \
            "Cannot load states for fused optimizer"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _barrier(self):
        pass

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return [_key(k) for k in key], list(value)
        return [_key(key)], [value]

    def _reduce(self, values: List[NDArray], key=None) -> NDArray:
        merged = self._reduce_local(values)
        # error feedback on the process's merged gradient, before the
        # wire (kvstore_dist.h PushImpl): 2-bit levels, or int8's
        # quantize-dequantize roundtrip
        if self._gc is not None and key is not None and \
                _floating(merged.data):
            merged = NDArray(self._gc.quantize(key, merged.data))
        return merged

    def _reduce_local(self, values: List[NDArray]) -> NDArray:
        if len(values) == 1:
            return values[0]
        target = values[0].data.device
        comp = [self._maybe_compress(v.data) for v in values]
        orig_dtype = comp[0][1]
        out = comp[0][0].to(target)
        for x, _ in comp[1:]:
            out = out + x.to(target)
        if orig_dtype is not None:
            out = out.to(orig_dtype)
        return NDArray(out)


class _ExchangeSession:
    """One overlap-scheduled batched exchange.

    Made by :meth:`KVStore.begin_exchange` before backward runs.  The
    Trainer's gradient hooks call :meth:`notify_key` as each gradient is
    written, and a fusion bucket's exchange launches the moment its last
    member lands.  Buckets are packed in reverse key order
    (``plan_buckets(reverse=True)``): backward gives the last layers'
    gradients first, so their buckets close (and their collectives are
    queued) while earlier layers are still being differentiated.

    Results are written (store and pull targets) only at :meth:`drain`,
    which the Trainer calls before the update.  A second notify for a unit
    already launched (a second backward, ``grad_req='add'``) marks the
    session stale, and a gradient written in place after its unit was
    launched (its tensor's version moved) relaunches that unit: overlap
    falls back to the serialized exchange, never to wrong gradients.
    """

    def __init__(self, store: KVStore, keys, vlists, reverse=True):
        from .bucketing import ReadinessPlanner
        self._store = store
        self._keys = keys
        self._vlists = vlists
        first = [self._vals(p) for p in range(len(keys))]
        buckets: List = []
        solo = range(len(keys))
        if len(keys) > 1 and store._optimizer is None:
            buckets, solo = store._bucket_plans(
                keys, [v[0] for v in first], reverse=reverse)
        copies = max(len(v) for v in first) if first else 1
        self._planner = ReadinessPlanner(buckets, list(solo), copies=copies)
        self._pos_of_key = {k: i for i, k in enumerate(keys)}
        self._results: Dict[int, object] = {}
        self._snaps: Dict[int, List] = {}
        self._launched: set = set()

    def _vals(self, p: int) -> List[NDArray]:
        v = self._vlists[p]
        v = v() if callable(v) else v
        return [_nd(x) for x in (v if isinstance(v, (list, tuple)) else [v])]

    def notify_key(self, key, copy: int = 0) -> None:
        """The gradient of ``key`` (copy ``copy``) is final: launch any unit
        this closes."""
        pos = self._pos_of_key.get(_key(key))
        if pos is None:
            return
        for u in self._planner.note(pos, copy):
            self._launch(u)

    def _unit_inputs(self, u: int) -> List:
        """The tensors a unit reads, each with its version counter: a
        gradient replaced or written in place since the launch shows as a
        change."""
        kind, obj = self._planner.unit(u)
        poss = obj.positions if kind == "bucket" else [obj]
        return [(v.data, v.data._version) for p in poss
                for v in self._vals(p)]

    def _wire_keys(self, u: int) -> List:
        """The wire keys a unit's exchange may quantize under: the
        bucket's name and its members' keys."""
        kind, obj = self._planner.unit(u)
        if kind == "solo":
            return [self._keys[obj]]
        return [obj.name] + [self._keys[p] for p in obj.positions]

    def _launch(self, u: int) -> None:
        kind, obj = self._planner.unit(u)
        gc = self._store._gc
        if gc is not None:
            # error feedback makes a launch stateful: keep the residuals it
            # consumes, so a relaunch undoes the discarded one's step
            wk = self._wire_keys(u)
            if u in self._launched:
                gc.rollback(wk)
            else:
                gc.checkpoint(wk)
        self._launched.add(u)
        self._snaps[u] = self._unit_inputs(u)
        self._results[u] = self._store._exchange_unit(
            kind, obj, self._keys, self._vals)

    def _inputs_unchanged(self, u: int) -> bool:
        snap, cur = self._snaps[u], self._unit_inputs(u)
        return len(snap) == len(cur) and all(
            a is b and va == vb for (a, va), (b, vb) in zip(snap, cur))

    def abort(self) -> None:
        """Discard the session without writing anything; the residuals
        every launched unit consumed are rolled back."""
        gc = self._store._gc
        if gc is not None:
            for u in self._launched:
                wk = self._wire_keys(u)
                gc.rollback(wk)
                gc.commit(wk)
        self._launched.clear()
        self._results.clear()
        self._snaps.clear()

    def drain(self) -> None:
        """Launch every remaining unit, then write all results."""
        if self._planner.stale:
            self._results.clear()
            for u in self._planner.all_units():
                self._launch(u)
        else:
            for u in self._planner.pending():
                self._launch(u)
            for u in sorted(self._results):
                if not self._inputs_unchanged(u):
                    self._launch(u)
        for u in sorted(self._results):
            kind, obj = self._planner.unit(u)
            self._store._commit_unit(kind, obj, self._results[u],
                                     self._keys, self._vals)
        gc = self._store._gc
        if gc is not None:
            for u in self._launched:
                gc.commit(self._wire_keys(u))
        self._launched.clear()
        self._results.clear()
        self._snaps.clear()


class KVStoreLocal(KVStore):
    """One process; a key's values are summed on the first one's device
    (reference: KVStoreLocal + CommCPU)."""

    @property
    def type(self):
        return "local"


class KVStoreDevice(KVStoreLocal):
    """As ``local``: the reference's reduce on the device (CommDevice)."""

    @property
    def type(self):
        return "device"


class KVStoreICI(KVStoreLocal):
    """The collective store over the ``torch.distributed`` process group
    (reference role: KVStoreNCCL and KVStoreDist's dist_sync contract: a
    pull after W workers push gives the W-worker sum).

    Outside a process group it is the local store.  Inside one, every
    push crosses the ranks: ``all_reduce(SUM)`` of each fusion bucket (or
    solo key), ``broadcast`` from rank 0 at ``init``.  NCCL takes CUDA
    tensors on the rank's device; gloo takes CPU tensors, and CUDA
    tensors for these two collectives.
    """

    def __init__(self):
        super().__init__()
        self._group = dist.group.WORLD if dist.is_available() and \
            dist.is_initialized() else None
        self._rank = dist.get_rank() if self._group is not None else 0
        self._size = dist.get_world_size() if self._group is not None else 1

    @property
    def type(self):
        return "ici"

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def init(self, key, value):
        """In a process group the stored value is rank 0's (the
        reference's dist contract: one worker's init reaches the server),
        so every worker pulls the same weights."""
        super().init(key, value)
        if self._group is not None:
            keys, _ = self._normalize(key, value)
            for k in keys:
                dist.broadcast(self._store[k].data, src=0)

    # -- the cross-process allreduce ---------------------------------------
    def _cross_reduce_one(self, merged: NDArray,
                          fresh: bool = False) -> NDArray:
        """The allreduce of one locally merged value.  It is summed in
        place only when ``fresh`` (a bucket's own payload): otherwise it
        may be a gradient the caller still reads."""
        payload, orig_dtype = self._maybe_compress(merged.data)
        if orig_dtype is None and not fresh:
            payload = payload.clone()
        dist.all_reduce(payload)
        if orig_dtype is not None:
            payload = payload.to(orig_dtype)
        return NDArray(payload)

    # -- the int8 collective -------------------------------------------------
    def _int8_active(self, x=None) -> bool:
        return self._gc is not None and self._gc.type == "int8" and \
            (x is None or _floating(x))

    def _cross_sum_quantized(self, q: torch.Tensor, scales: torch.Tensor):
        """The allreduce of the compact payload: every rank's int8 codes
        and float32 scales by ``all_gather``, then on every rank the same
        dequantize-sum-requantize, so both directions stay int8."""
        from ..ops.quantization import dequant_sum_requant_int8
        qs = [torch.empty_like(q) for _ in range(self._size)]
        ss = [torch.empty_like(scales) for _ in range(self._size)]
        dist.all_gather(qs, q.contiguous())
        dist.all_gather(ss, scales.contiguous())
        return dequant_sum_requant_int8(torch.stack(qs), torch.stack(ss))

    def _exchange_flat(self, wire_key, x: torch.Tensor) -> torch.Tensor:
        """The int8 exchange of one flat float payload: quantize with error
        feedback under ``wire_key``, exchange compact, dequantize once."""
        gc = self._gc
        if self._size <= 1:
            return gc.quantize(wire_key, x)
        q, scales = gc.compress_device(wire_key, x)
        qo, so = self._cross_sum_quantized(q, scales)
        return gc.decompress_device((qo, so), x.numel()).to(x.dtype)

    def _reduce(self, values: List[NDArray], key=None) -> NDArray:
        if key is not None and self._int8_active(values[0].data):
            merged = self._reduce_local(values)
            out = self._exchange_flat(key, merged.data.reshape(-1))
            return NDArray(out.reshape(merged.shape))
        merged = super()._reduce(values, key=key)
        if self._group is not None:
            merged = self._cross_reduce_one(merged)
        return merged

    def _exchange_payload(self, wire_key, flat: torch.Tensor) -> torch.Tensor:
        """The exchange of a bucket's own flat payload: int8-quantized under
        the bucket's name, or summed in place."""
        if self._int8_active(flat):
            return self._exchange_flat(wire_key, flat)
        if self._group is not None:
            return self._cross_reduce_one(NDArray(flat), fresh=True).data
        return flat

    def _merge(self, vals: List[NDArray], key) -> NDArray:
        """A key's local merge before its bucket's exchange, with the 2-bit
        error feedback (int8 quantizes the whole bucket instead)."""
        if self._int8_active():
            return self._reduce_local(vals)
        return KVStore._reduce(self, vals, key=key)

    def _exchange_bucket(self, b, merged: List[NDArray]) -> List[NDArray]:
        """One fusion bucket's exchange, split back into its members."""
        return [NDArray(t) for t in b.exchange(
            [m.data for m in merged],
            functools.partial(self._exchange_payload, b.name))]

    def _reduce_many(self, keys, vlists) -> List[NDArray]:
        """The batched exchange: the local merge of each key (and its 2-bit
        error feedback), then the cross-rank sum coalesced into fusion
        buckets, one collective a bucket; under int8 each bucket is
        quantized under its own name."""
        merged = [self._merge(v, k) for k, v in zip(keys, vlists)]
        if self._group is None and not self._int8_active():
            return merged
        buckets, solo = [], range(len(keys))
        if len(keys) > 1 and self._optimizer is None:
            buckets, solo = self._bucket_plans(keys, merged)
        for b in buckets:
            out = self._exchange_bucket(b, [merged[p] for p in b.positions])
            for p, m in zip(b.positions, out):
                merged[p] = m
        for p in solo:
            if self._int8_active(merged[p].data):
                merged[p] = self._reduce([merged[p]], key=keys[p])
            elif self._group is not None:
                merged[p] = self._cross_reduce_one(merged[p])
        return merged

    def _exchange_unit(self, kind, obj, keys, vals):
        """An overlap session's unit: a bucket is merged, exchanged and
        split; a solo key takes the per-key exchange."""
        if kind == "solo":
            return self._reduce(vals(obj), key=keys[obj])
        return self._exchange_bucket(
            obj, [self._merge(vals(p), keys[p]) for p in obj.positions])

    def _barrier(self):
        if self._group is not None:
            dist.barrier()


def _ps_addrs() -> List[str]:
    """The parameter servers' addresses the launcher would set
    (``MX_PS_ROOTS``, comma-separated, or ``MX_PS_ROOT`` /
    ``DMLC_PS_ROOT_URI``)."""
    import os
    roots = get_env("MX_PS_ROOTS")
    if roots:
        return [a.strip() for a in roots.split(",") if a.strip()]
    addr = get_env("MX_PS_ROOT") or os.environ.get("DMLC_PS_ROOT_URI")
    if not addr:
        return []
    if ":" not in addr:
        addr = "%s:%s" % (addr, os.environ.get("DMLC_PS_ROOT_PORT", "9600"))
    return [addr]


_STORES = {
    "local": KVStoreLocal,
    "device": KVStoreDevice,
    "ici": KVStoreICI,
    # the collective path covers these transports
    "nccl": KVStoreICI,
    "dist": KVStoreICI,
    "dist_sync": KVStoreICI,
    "dist_device_sync": KVStoreICI,
    "horovod": KVStoreICI,
}


def create(name: str = "local") -> KVStore:
    """Reference: kvstore.create / KVStore::Create."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    key = name.lower()
    if key == "dist_async":
        if not _ps_addrs():
            import warnings
            warnings.warn("kvstore 'dist_async' requested without a "
                          "parameter server (launch with tools/launch.py "
                          "-s <servers>); using the synchronous collective "
                          "store instead")
            return KVStoreICI()
        raise MXNetError("kvstore 'dist_async' with a parameter server is "
                         "not ported yet (ROADMAP: the parameter-server "
                         "slice)")
    if key not in _STORES:
        raise MXNetError("unknown KVStore type %r (have %s)"
                         % (name, sorted(list(_STORES) + ["dist_async"])))
    return _STORES[key]()

