"""KVStore: data-parallel gradient aggregation.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py`` (reference:
python/mxnet/kvstore/kvstore.py, src/kvstore/kvstore_local.h, comm.h,
kvstore_nccl.h).

* ``local`` / ``device``: one process; ``push`` sums a key's list of
  values (one a context of a parameter with copies on several) on the
  first value's context, and ``pull(out=[...])`` writes every copy.
  Every array the stores make keeps its context.
* ``ici``: the collective store.  Inside a ``torch.distributed`` process
  group (:func:`~..parallel.init_process_group`: NCCL on the GPU, gloo on
  the CPU) every push is also an ``all_reduce(SUM)`` across the ranks,
  coalesced into fusion buckets (:mod:`.bucketing`), so a pull after W
  workers push gives their sum.  A group of one rank runs the same
  collectives.  ``nccl``, ``dist``, ``dist_sync``, ``dist_device_sync``
  and ``horovod`` are its aliases.
* ``dist_async``: the asynchronous parameter-server store
  (:class:`KVStoreDistAsync`, its server in :mod:`.server`), when the
  launcher's ``-s`` has set a server address; without one it warns and
  gives ``ici``, as the reference does.

Compression (``set_gradient_compression``): ``2bit`` quantizes each
worker's payload to +-t/0 levels with error feedback and sums the levels
at full width; ``int8`` quantizes each bucket per block with error
feedback and exchanges the codes and scales by ``all_gather``, every rank
then dequantizing, summing and requantizing the same way, so the wire is
int8 in both directions; ``bf16`` casts the payload for the sum.

Every exchange counts its wire bytes and dispatches in
``engine.wire_bytes`` and ``engine.dispatch_count`` at the reference's
sites.

Not ported: the traceable exchange of the compiled step
(``build_exchange_body``; it comes with the CUDA-graph step) and
``row_sparse_pull`` (with sparse storage).
"""
from __future__ import annotations

import functools
import time as _real_time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, dtype_name, get_env
from ..engine import engine as _engine
from ..ndarray.ndarray import NDArray
from ..ops import quantization as _qops

__all__ = ["KVStore", "create", "KVStoreLocal", "KVStoreDevice",
           "KVStoreICI", "KVStoreDistAsync"]


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
        out = []
        for k, v in zip(keys, vlists):
            m = self._reduce(v, key=k)
            self._note_wire_value(m)
            out.append(m)
        return out

    # -- wire accounting (engine.wire_bytes) --------------------------------
    def _wire_nbytes(self, n_elems: int, itemsize: int,
                     floating: bool = True) -> int:
        """Bytes an n-element gradient payload occupies in its exchange
        representation: the compressed wire format, the bf16 cast, or
        full width."""
        if self._gc is not None and floating:
            return self._gc.wire_nbytes(int(n_elems))
        if self._compress_bf16 and floating and itemsize == 4:
            return 2 * int(n_elems)
        return int(n_elems) * int(itemsize)

    def _note_wire_value(self, m: NDArray) -> None:
        _engine.count_wire_bytes(self._wire_nbytes(
            m.data.numel(), m.data.element_size(), _floating(m.data)))

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
        out = []
        for p in ([obj] if kind == "solo" else obj.positions):
            m = self._reduce(vals(p), key=keys[p])
            self._note_wire_value(m)
            out.append(m)
        return out[0] if kind == "solo" else out

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
        solo_positions)``.  The cache key holds the bucket capacity, the
        packing order and the store's bucket salt (an elastic job's
        membership epoch, which renames every bucket), so a change of
        ``MX_KVSTORE_BUCKET_KB`` plans anew (and 0 leaves every key
        solo)."""
        from .bucketing import bucket_bytes, plan_buckets
        cap = bucket_bytes()
        salt = getattr(self, "_bucket_salt", None) or None
        # the numpy dtype names, as the reference's descriptors spell them
        sig = tuple((k, tuple(a.shape), dtype_name(a.data.dtype),
                     a.stype) for k, a in zip(keys, arrays))
        cache_key = (sig, cap, bool(reverse), salt)
        cached = self._bucket_cache.get(cache_key)
        if cached is None:
            cached = plan_buckets(
                keys, [s[1] for s in sig], [s[2] for s in sig],
                [a.data.element_size() for a in arrays],
                [s[3] for s in sig], cap, reverse=reverse, salt=salt)
            self._bucket_cache[cache_key] = cached
        return cached

    # -- the compiled step's exchange body --------------------------------
    def build_exchange_body(self, keys, arrays, layout=None):
        """The int8 gradient exchange of :class:`~..step.CompiledStep`:
        what one worker's batched push and pull observe of this store's
        int8 wire, as a callable ``(grads, residuals) -> (grads,
        residuals)`` (:class:`ExchangeBody`), or None when the store runs
        the optimizer.  ``arrays`` are per-key templates (NDArrays; shapes
        and dtypes).

        Without ``layout`` the body takes each key's summed gradient and
        quantizes per fusion bucket (the store's :meth:`_bucket_plans`:
        concatenated, an error-feedback roundtrip keyed by the bucket's
        name, split) and per solo key, as the reference's ICI body does.
        With ``layout`` (a :class:`~..parallel.speclayout.SpecLayout`
        whose mesh this rank is on) it is the **reduce-scatter** variant:
        the body takes this rank's partial gradients (its share of the
        batch), pads each flat payload to the block x fsdp grain
        (:func:`~..ops.quantization.rs_block_bytes`), sums it over the
        data axis (``all_reduce``) and reduce-scatters it over fsdp; each
        rank quantizes its whole blocks against its own residual shard
        (:func:`~..ops.quantization.rs_roundtrip_int8`), and the
        dequantized shards are all-gathered back into whole gradients.
        Its residuals live split per rank (``residual_shardings``).  The
        two variants compute the same values.  The reference's bodies
        for 2-bit and bf16 compression are not ported: they raise."""
        if self._updater is not None or self._optimizer is not None:
            return None
        if self._gc is None or self._gc.type != "int8":
            raise MXNetError(
                "build_exchange_body: the port's compiled exchange carries "
                "int8 compression; %s is the eager store's"
                % ("bf16" if self._compress_bf16 else
                   getattr(self._gc, "type", "no compression")))
        return ExchangeBody(self, [_key(k) for k in keys], list(arrays),
                            layout)

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
            _engine.count_dispatch()
            merged = NDArray(self._gc.quantize(key, merged.data),
                             merged.context)
        return merged

    def _reduce_local(self, values: List[NDArray]) -> NDArray:
        if len(values) == 1:
            return values[0]
        target = values[0].data.device
        comp = [self._maybe_compress(v.data) for v in values]
        orig_dtype = comp[0][1]
        _engine.count_dispatch()
        out = comp[0][0].to(target)
        for x, _ in comp[1:]:
            out = out + x.to(target)
        if orig_dtype is not None:
            out = out.to(orig_dtype)
        return NDArray(out, values[0].context)


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


class ExchangeBody:
    """The callable of :meth:`KVStore.build_exchange_body`.

    ``residual_specs`` lists ``(wire key, whole shape, dtype)`` of each
    error-feedback residual the body reads and returns, in order;
    ``residual_shardings`` their placements (a
    :class:`~..parallel.mesh.Sharding`, or None without a layout): split
    over fsdp on the reduce-scatter grain, where each rank holds the
    slice of its index.  ``wire_bytes`` is one call's payload on the
    wire."""

    def __init__(self, store: KVStore, keys, arrays, layout):
        self.store, self.layout = store, layout
        gc = store._gc
        floating = [torch.is_floating_point(a.data) for a in arrays]
        buckets, solo = [], list(range(len(keys)))
        if len(keys) > 1:
            buckets, solo = store._bucket_plans(keys, arrays)
        self.sizes = [int(a.data.numel()) for a in arrays]
        self.fsdp = 0 if layout is None else int(layout.fsdp)
        self.use_rs = self.fsdp > 1
        # (positions, payload length, padded length) of each payload
        units = [(b.positions, b.name, b.total) for b in buckets]
        units += [([p], keys[p], self.sizes[p]) for p in solo
                  if floating[p]]
        self.payloads, self.residual_specs = [], []
        self.wire_bytes = sum(self.sizes[p] * a.data.element_size()
                              for p, a in enumerate(arrays)
                              if not floating[p])
        for poss, wk, n in units:
            npad = _qops.rs_block_bytes(n, gc.block, self.fsdp) \
                if self.use_rs else n
            self.payloads.append((list(poss), n, npad))
            self.residual_specs.append((wk, (npad,), torch.float32))
            self.wire_bytes += gc.wire_nbytes(n)
        if layout is None:
            sh = None
        elif self.use_rs:
            from ..parallel.speclayout import P
            sh = layout.sharding(P(layout.fsdp_axis))
        else:
            sh = layout.replicated()
        self.residual_shardings = [sh] * len(self.residual_specs)
        self.floating = floating

    def residual_local_shape(self, i: int):
        """The shape of residual ``i`` on this rank."""
        _, shape, _ = self.residual_specs[i]
        return (shape[0] // self.fsdp,) if self.use_rs else shape

    def _sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        from ..parallel import collectives as C
        for a in axes:
            if self.layout.axis_size(a) > 1:
                x = C.psum(x, a, self.layout.mesh)
        return x

    def __call__(self, grads, residuals):
        from ..parallel import collectives as C
        grads = list(grads)
        lay, block = self.layout, self.store._gc.block
        if lay is not None:
            batch = (lay.data_axis, lay.fsdp_axis)
            # the sum over the batch: in the reduce-scatter below for the
            # payloads, here for the rest (and all of it without fsdp)
            grads = [g if self.use_rs and self.floating[p] else
                     self._sum(g, batch) for p, g in enumerate(grads)]
        new_res = []
        for (poss, n, npad), res in zip(self.payloads, residuals):
            flat = torch.cat([grads[p].reshape(-1) for p in poss]) \
                if len(poss) > 1 else grads[poss[0]].reshape(-1)
            if not self.use_rs:
                deq, nr = _qops.roundtrip_int8_blocks(flat, res, block)
            else:
                if npad > n:
                    flat = torch.cat([flat, flat.new_zeros(npad - n)])
                flat = self._sum(flat, (lay.data_axis,))
                shard = C.scatter_sum_along(flat, lay.mesh, lay.fsdp_axis, 0)
                deq, nr = _qops.rs_roundtrip_int8(shard, res, block)
                deq = C.gather_along(deq, lay.mesh, lay.fsdp_axis, 0)[:n]
            new_res.append(nr)
            off = 0
            for p in poss:
                size = self.sizes[p]
                grads[p] = deq[off:off + size].view(grads[p].shape).to(
                    grads[p].dtype)
                off += size
        return grads, new_res


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
                _engine.count_dispatch()
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
        _engine.count_wire_bytes(payload.numel() * payload.element_size())
        _engine.count_dispatch()
        dist.all_reduce(payload)
        if orig_dtype is not None:
            payload = payload.to(orig_dtype)
        return NDArray(payload, merged.context)

    def _wire_nbytes(self, n_elems: int, itemsize: int,
                     floating: bool = True) -> int:
        if self._gc is not None and self._gc.type == "2bit" and floating:
            # the collective sums the 2-bit levels at full width; only the
            # parameter server's TCP wire carries the packed format
            return int(n_elems) * int(itemsize)
        return super()._wire_nbytes(n_elems, itemsize, floating)

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
        _engine.count_dispatch()
        dist.all_gather(qs, q.contiguous())
        dist.all_gather(ss, scales.contiguous())
        return dequant_sum_requant_int8(torch.stack(qs), torch.stack(ss))

    def _exchange_flat(self, wire_key, x: torch.Tensor) -> torch.Tensor:
        """The int8 exchange of one flat float payload: quantize with error
        feedback under ``wire_key``, exchange compact, dequantize once."""
        gc = self._gc
        _engine.count_wire_bytes(gc.wire_nbytes(x.numel()))
        _engine.count_dispatch()
        if self._size <= 1:
            return gc.quantize(wire_key, x)
        q, scales = gc.compress_device(wire_key, x)
        qo, so = self._cross_sum_quantized(q, scales)
        _engine.count_dispatch()
        return gc.decompress_device((qo, so), x.numel()).to(x.dtype)

    def _reduce(self, values: List[NDArray], key=None) -> NDArray:
        if key is not None and self._int8_active(values[0].data):
            merged = self._reduce_local(values)
            out = self._exchange_flat(key, merged.data.reshape(-1))
            return NDArray(out.reshape(merged.shape), merged.context)
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
        self._note_wire_value(NDArray(flat))   # no wire to cross
        return flat

    def _merge(self, vals: List[NDArray], key) -> NDArray:
        """A key's local merge before its bucket's exchange, with the 2-bit
        error feedback (int8 quantizes the whole bucket instead)."""
        if self._int8_active():
            return self._reduce_local(vals)
        return KVStore._reduce(self, vals, key=key)

    def _exchange_bucket(self, b, merged: List[NDArray]) -> List[NDArray]:
        """One fusion bucket's exchange, split back into its members."""
        _engine.count_dispatch()   # the concatenation
        return [NDArray(t, m.context) for t, m in zip(b.exchange(
            [m.data for m in merged],
            functools.partial(self._exchange_payload, b.name)), merged)]

    def _reduce_many(self, keys, vlists) -> List[NDArray]:
        """The batched exchange: the local merge of each key (and its 2-bit
        error feedback), then the cross-rank sum coalesced into fusion
        buckets, one collective a bucket; under int8 each bucket is
        quantized under its own name."""
        merged = [self._merge(v, k) for k, v in zip(keys, vlists)]
        if self._group is None and not self._int8_active():
            for m in merged:
                self._note_wire_value(m)
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
            else:
                self._note_wire_value(merged[p])
        return merged

    def _exchange_unit(self, kind, obj, keys, vals):
        """An overlap session's unit: a bucket is merged, exchanged and
        split; a solo key takes the per-key exchange."""
        if kind == "solo":
            m = self._reduce(vals(obj), key=keys[obj])
            if self._group is None and not self._int8_active(m.data):
                self._note_wire_value(m)
            return m
        return self._exchange_bucket(
            obj, [self._merge(vals(p), keys[p]) for p in obj.positions])

    def _barrier(self):
        if self._group is not None:
            dist.barrier()


def _ps_addr():
    """The parameter server's address from the launcher's environment
    (``MX_PS_ROOT``, or ``DMLC_PS_ROOT_URI`` with ``DMLC_PS_ROOT_PORT``),
    or None."""
    import os
    addr = get_env("MX_PS_ROOT") or os.environ.get("DMLC_PS_ROOT_URI")
    if not addr:
        return None
    if ":" not in addr:
        addr = "%s:%s" % (addr, os.environ.get("DMLC_PS_ROOT_PORT", "9600"))
    return addr


def _ps_addrs() -> List[str]:
    """Every server's address (``MX_PS_ROOTS``, comma-separated; else the
    one of :func:`_ps_addr`): keys shard across them by hash (reference:
    kvstore_dist.h's key->server assignment)."""
    roots = get_env("MX_PS_ROOTS")
    if roots:
        return [a.strip() for a in roots.split(",") if a.strip()]
    one = _ps_addr()
    return [one] if one else []


class KVStoreDistAsync(KVStore):
    """The asynchronous parameter-server store (reference: KVStoreDist in
    dist_async mode, src/kvstore/kvstore_dist_server.h's async
    DataHandleEx): each worker's push is applied by the server the moment
    it arrives (a server-side optimizer, or the accumulator's sum), pulls
    return whatever is current, and workers never wait for each other.
    The servers' addresses come from ``MX_PS_ROOTS`` (the launcher's
    ``-s N``; keys shard across the servers by hash) or ``MX_PS_ROOT``.

    The workers compute on the card and the servers on the host: a push
    concatenates a bucket's members on the device and makes one host copy
    of it (compact under 2-bit or int8 compression); a pull makes one
    copy back to the device a bucket.

    Fault tolerance (ps-lite's resender role, over :mod:`..fault`): every
    RPC is SEQ-tagged and retried under a :class:`~..fault.RetryPolicy`.
    A dropped connection or a restarted server triggers a reconnect and a
    replay of the request in flight (the server's replay cache applies it
    exactly once), and the terminal :class:`MXNetError` comes only after
    ``MX_KVSTORE_RETRY_DEADLINE`` seconds.  A heartbeat thread PINGs each
    server every ``MX_KVSTORE_HEARTBEAT`` seconds on its own connections,
    so a worker busy computing is never evicted as stale."""

    def __init__(self):
        super().__init__()
        import os
        import socket
        import threading
        import uuid
        from . import server as _srv
        from .. import fault as _fault
        self._srv_mod = _srv
        self._fault = _fault
        addrs = _ps_addrs()
        if not addrs:
            raise MXNetError(
                "kvstore 'dist_async' needs a parameter server: launch "
                "with python -m mxnet_tpu_torch.tools.launch -n <workers> "
                "-s <servers> (MX_PS_ROOTS/MX_PS_ROOT unset)")
        self._addrs = list(addrs)
        self._rank = int(get_env("MX_PROCESS_ID") or
                         os.environ.get("DMLC_WORKER_ID", 0))
        self._size = int(get_env("MX_NUM_PROCESSES") or
                         os.environ.get("DMLC_NUM_WORKER", 1))
        # liveness is per rank on the server; the uuid tells a restarted
        # worker's replay cache from its predecessor's
        self._client_id = "r%d:%s" % (self._rank, uuid.uuid4().hex[:12])
        self._socks = []
        # the connect budget rides the injectable clock and the retry
        # knob, so tests fast-forward it under use_virtual_time()
        connect_deadline = get_env("MX_KVSTORE_RETRY_DEADLINE", dtype=float)
        for addr in self._addrs:
            host, port = addr.rsplit(":", 1)
            deadline = _fault.Deadline(connect_deadline or 60.0)
            while True:  # the launcher starts the servers concurrently:
                try:     # retry until each binds
                    self._socks.append(socket.create_connection(
                        (host, int(port)), timeout=120))
                    break
                except (ConnectionRefusedError, OSError):
                    if deadline.expired():
                        raise
                    if _fault.is_virtual():
                        # the server binds in real time: yield briefly,
                        # then charge the tick, so a dead server still
                        # fails fast in virtual seconds
                        _real_time.sleep(0.005)
                    _fault.sleep(0.2)
        self._lock = threading.Lock()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._bucket_inited: set = set()
        # elastic membership: under MX_ELASTIC the worker JOINs at init,
        # and every worker of one incarnation plans its buckets under the
        # same epoch (MX_ELASTIC_EPOCH), agreed before the first plan
        self._elastic = bool(get_env("MX_ELASTIC", 0, int))
        self._membership_epoch = get_env("MX_ELASTIC_EPOCH", 0, int) or 0
        self._bucket_salt = self._membership_epoch or None
        # the hierarchical exchange: the pull leg comes back int8 (PULLQ);
        # opt-in, for the accumulate exchange only (a server-side
        # optimizer needs exact full-width weights back)
        self._hier = bool(get_env("MX_EXCHANGE_HIERARCHICAL", 0, int))
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._start_heartbeat()
        if self._elastic:
            self.join()

    # -- resilience --------------------------------------------------------
    def _retry_policy(self):
        return self._fault.RetryPolicy.from_env()

    def _next_seq(self):
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def _recv_timeout(self, cmd="PULL"):
        """A request's reply deadline.  BARRIER may block up to the
        server's barrier timeout, so its window is longer (a shorter one
        would replay the barrier and count this worker twice)."""
        if cmd == "BARRIER":
            t = get_env("MX_KVSTORE_BARRIER_TIMEOUT", 120.0, float)
            return (t if t and t > 0 else 120.0) + 30.0
        t = get_env("MX_KVSTORE_RECV_TIMEOUT", 0.0, float)
        return t if t and t > 0 else 30.0

    def _kill_sock(self, idx):
        sock = self._socks[idx]
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._socks[idx] = None

    def _ensure_sock(self, idx):
        """Reconnect a dead connection (a restarted server)."""
        import socket
        sock = self._socks[idx]
        if sock is not None:
            return sock
        host, port = self._addrs[idx].rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=5)
        # the 5 s bound is for the connect; sends keep the first
        # connections' generous bound
        sock.settimeout(120)
        self._socks[idx] = sock
        return sock

    def _start_heartbeat(self):
        import socket as _socket
        import threading
        interval = get_env("MX_KVSTORE_HEARTBEAT", dtype=float)
        if not interval or interval <= 0:
            return

        def run():
            # its own connections: a heartbeat must not wait behind a data
            # RPC that blocks (a worker parked in BARRIER)
            socks = [None] * len(self._addrs)
            while not self._hb_stop.wait(interval):
                for i, addr in enumerate(self._addrs):
                    try:
                        if socks[i] is None:
                            host, port = addr.rsplit(":", 1)
                            socks[i] = _socket.create_connection(
                                (host, int(port)), timeout=2)
                        self._srv_mod.send_msg(
                            socks[i], ("PING", self._client_id))
                        self._srv_mod.recv_msg(socks[i], timeout=2)
                    except (ConnectionError, OSError, TimeoutError):
                        if socks[i] is not None:
                            try:
                                socks[i].close()
                            except OSError:
                                pass
                        socks[i] = None    # reconnect at the next beat
            for s in socks:
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

        self._hb_thread = threading.Thread(target=run, daemon=True,
                                           name="mx-kvstore-heartbeat")
        self._hb_thread.start()

    @property
    def type(self):
        return "dist_async"

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def _server_of(self, key) -> int:
        """key -> server index (CRC32 of the key, as the reference)."""
        import zlib
        return zlib.crc32(str(key).encode()) % len(self._socks)

    # -- big arrays (reference: MXNET_KVSTORE_BIGARRAY_BOUND in
    # kvstore_dist.h: a value over the bound splits evenly across all the
    # servers instead of hashing whole to one) ------------------------------
    @property
    def _bigarray_bound(self):
        return get_env("MXNET_KVSTORE_BIGARRAY_BOUND", 1_000_000, int)

    def _shard_plan(self, size):
        """[(server, start, stop)] flat slices, or None for whole-key
        routing; a pure function of (size, servers, bound), so every
        worker computes the same plan."""
        n_srv = len(self._socks)
        if n_srv <= 1 or size < self._bigarray_bound:
            return None
        bounds = [size * i // n_srv for i in range(n_srv + 1)]
        return [(i, bounds[i], bounds[i + 1]) for i in range(n_srv)
                if bounds[i + 1] > bounds[i]]

    @staticmethod
    def _part_key(key, i):
        return "%s::part%d" % (key, i)

    def _send_np(self, cmd, k, arr_np):
        """INIT/PUSH routing: the whole key by hash, or sliced across all
        the servers over the big-array bound."""
        plan = self._shard_plan(arr_np.size)
        if plan is None:
            self._rpc(cmd, k, arr_np)
            return
        flat = arr_np.ravel()
        for i, s, e in plan:
            self._rpc_on(i, cmd, self._part_key(k, i), flat[s:e])

    @staticmethod
    def _count_pull_bytes(n) -> None:
        """The pull leg's wire bytes, a counter of its own beside the push
        leg's ``engine.wire_bytes``."""
        from .. import telemetry as _telemetry
        _telemetry.registry.counter(
            "kvstore.pull_wire_bytes",
            doc="bytes received on the pull leg of the dist_async "
                "exchange (PULLQ compact tuples or full-width "
                "arrays)").inc(int(n))

    def _pullq_block(self):
        gc = self._wire_gc()
        return gc.block if gc is not None and gc.type == "int8" else 256

    def _decode_pullq(self, payload):
        """A PULLQ reply: the int8 tuple dequantized on the host, or a
        non-float key's full-width array."""
        from . import wire_codec as _wc
        if _wc.is_wire_payload(payload):
            scales = np.asarray(payload[6])
            self._count_pull_bytes(len(payload[5]) + scales.nbytes)
            return _wc.decode_wire(payload)
        arr = np.asarray(payload)
        self._count_pull_bytes(arr.nbytes)
        return arr

    def _pull_hier(self, k):
        """The hierarchical return leg: PULLQ ships the merged value int8
        per block, about 4x fewer bytes than the fp32 PULL.  Its error is
        bounded by the block's scale and is not fed back (the server's
        encode keeps no state), so this tier is opt-in
        (``MX_EXCHANGE_HIERARCHICAL``)."""
        return self._decode_pullq(
            self._rpc("PULLQ", k, int(self._pullq_block())))

    # -- the as-ready hierarchical bucket pulls ----------------------------
    def _hier_pool_get(self):
        """A lazy thread pool for the as-ready bucket pulls; each pool
        thread keeps its own connections, so concurrent bucket RPCs never
        wait on the main, lock-serialised ones."""
        if getattr(self, "_hier_pool", None) is None:
            import concurrent.futures as _fut
            import threading as _threading
            n = max(1, get_env("MX_EXCHANGE_PARALLEL", 4, int) or 4)
            self._hier_pool = _fut.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="mx-kv-exchange")
            self._hier_tls = _threading.local()
        return self._hier_pool

    def _rpc_dedicated(self, idx, msg):
        """One SEQ-enveloped RPC on this pool thread's own connection to
        server ``idx``, retried under the same policy as the main path.
        The client id gets a per-thread suffix (the rank prefix, which
        liveness reads, stays), so each thread has its own replay slot."""
        import socket as _socket
        import threading as _threading
        tls = self._hier_tls
        if not hasattr(tls, "socks"):
            tls.socks = {}
        cid = "%s#x%d" % (self._client_id, _threading.get_ident())
        wrapped = ("SEQ", cid, self._next_seq(), msg)
        timeout = self._recv_timeout(msg[0])
        policy = self._retry_policy()
        for _attempt in policy:
            sock = tls.socks.get(idx)
            try:
                if sock is None:
                    host, port = self._addrs[idx].rsplit(":", 1)
                    sock = _socket.create_connection(
                        (host, int(port)), timeout=5)
                    sock.settimeout(120)
                    tls.socks[idx] = sock
                self._srv_mod.send_msg(sock, wrapped)
                ok, payload = self._srv_mod.recv_msg(sock, timeout=timeout)
            except (ConnectionError, OSError, TimeoutError) as e:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                tls.socks[idx] = None
                policy.note(e)
                continue
            if not ok:
                raise MXNetError("dist_async server %d: %s"
                                 % (idx, payload))
            return payload
        raise MXNetError(
            "dist_async server %d (%s) unreachable: %r retried for %.3gs "
            "(MX_KVSTORE_RETRY_DEADLINE exceeded); last error: %s"
            % (idx, self._addrs[idx], msg[0], policy.deadline,
               policy.last_error))

    def _hier_bucket_pull(self, name):
        """One bucket's PULLQ on a pool thread, decoded on the host."""
        return self._decode_pullq(self._rpc_dedicated(
            self._server_of(name), ("PULLQ", name,
                                    int(self._pullq_block()))))

    def _pull_np(self, k, shape, size):
        plan = self._shard_plan(size)
        if plan is None:
            if self._hier:
                return self._pull_hier(k)
            arr = self._rpc("PULL", k)
            self._count_pull_bytes(np.asarray(arr).nbytes)
            return arr
        # every part's request goes out on its own connection first, then
        # the replies are read: the wall clock is about the slowest part,
        # not the sum.  PULL is idempotent, so a failed round re-issues
        # every part with fresh seqs under the retry policy.
        from .. import telemetry as _telemetry
        policy = self._retry_policy()
        timeout = self._recv_timeout("PULL")
        with _telemetry.rpc_span("kv.client.PULL_SHARDED") as span:
            tctx = span.wire_context()
            for _attempt in policy:
                try:
                    with self._lock:
                        for i, _s, _e in plan:
                            sock = self._ensure_sock(i)
                            self._fault.fire(
                                "kvstore.send",
                                on_close=lambda i=i: self._kill_sock(i))
                            inner = ("PULL", self._part_key(k, i))
                            env = ("SEQ", self._client_id,
                                   self._next_seq(), inner)
                            self._srv_mod.send_msg(
                                sock, env if tctx is None
                                else env + (tctx,))
                        parts = []
                        bad = None
                        for i, _s, _e in plan:
                            # read every pending reply even after a
                            # failure: one left unread would be taken for
                            # the next RPC's answer
                            ok, payload = self._srv_mod.recv_msg(
                                self._socks[i], timeout=timeout)
                            if not ok and bad is None:
                                bad = (i, payload)
                            parts.append(payload)
                        if bad is not None:
                            raise MXNetError(
                                "dist_async server %d: %s" % bad)
                    arr = np.concatenate([np.asarray(p).ravel()
                                          for p in parts]).reshape(shape)
                    self._count_pull_bytes(arr.nbytes)
                    return arr
                except (ConnectionError, OSError, TimeoutError) as e:
                    for i, _s, _e in plan:
                        self._kill_sock(i)
                    policy.note(e)
                    self._note_retry(span, -1, -1, e)
        raise MXNetError(
            "dist_async sharded pull of %r failed for %.3gs "
            "(MX_KVSTORE_RETRY_DEADLINE); last error: %s"
            % (k, policy.deadline, policy.last_error))

    def _rpc_on(self, idx, *msg):
        """One RPC with transparent recovery: on a dropped or timed-out
        connection, reconnect and replay the same (client_id, seq)
        envelope -- the server's replay cache makes the retry idempotent
        (a PUSH applied before its reply was lost is answered from the
        cache, never applied again).  Gives up loudly after the retry
        deadline.  The RPC runs under a ``kv.client.<verb>`` span whose
        (trace_id, span_id) ride the envelope, so the server's handling
        span is its child; each retry is an instant event of it."""
        from .. import telemetry as _telemetry
        seq = self._next_seq()
        timeout = self._recv_timeout(msg[0])
        policy = self._retry_policy()
        if msg[0] == "STOP":
            # shutdown is best effort: no full recovery deadline for a
            # server that is already gone
            policy.deadline = min(policy.deadline, 5.0)
        with _telemetry.rpc_span("kv.client.%s" % msg[0]) as span:
            tctx = span.wire_context()
            wrapped = ("SEQ", self._client_id, seq, msg) if tctx is None \
                else ("SEQ", self._client_id, seq, msg, tctx)
            for _attempt in policy:
                with self._lock:
                    try:
                        sock = self._ensure_sock(idx)
                        self._fault.fire(
                            "kvstore.send",
                            on_close=lambda: self._kill_sock(idx))
                        self._srv_mod.send_msg(sock, wrapped)
                        self._fault.fire(
                            "kvstore.recv",
                            on_close=lambda: self._kill_sock(idx))
                        ok, payload = self._srv_mod.recv_msg(
                            sock, timeout=timeout)
                    except (ConnectionError, OSError, TimeoutError) as e:
                        self._kill_sock(idx)
                        policy.note(e)
                        self._note_retry(span, idx, seq, e)
                        continue
                if not ok:
                    raise MXNetError("dist_async server %d: %s"
                                     % (idx, payload))
                return payload
        raise MXNetError(
            "dist_async server %d (%s) unreachable: %r retried for %.3gs "
            "(MX_KVSTORE_RETRY_DEADLINE exceeded); last error: %s"
            % (idx, self._addrs[idx], msg[0], policy.deadline,
               policy.last_error))

    @staticmethod
    def _note_retry(span, idx, seq, err) -> None:
        """Count one reconnect-and-replay, and mark it on the RPC's span."""
        from .. import telemetry as _telemetry
        _telemetry.registry.counter(
            "kvstore.client_retries",
            doc="dist_async RPC reconnect-and-replay attempts").inc()
        span.event("retry", server=idx, seq=seq, error=str(err))

    def _rpc(self, *msg):
        """Route by key for the data commands; the controller commands go
        wider (SET_OPT, STOP, JOIN and LEAVE to every server; BARRIER and
        MEMBERS to server 0)."""
        cmd = msg[0]
        if cmd in ("INIT", "PUSH", "PULL", "PULLQ"):
            return self._rpc_on(self._server_of(msg[1]), *msg)
        if cmd in ("SET_OPT", "STOP", "JOIN", "LEAVE"):
            out = None
            for i in range(len(self._socks)):
                try:
                    out = self._rpc_on(i, *msg)
                except MXNetError:
                    if cmd not in ("STOP", "LEAVE"):
                        # on the way out, a server already gone is fine
                        raise
            return out
        return self._rpc_on(0, *msg)

    # -- elastic membership ------------------------------------------------
    def join(self):
        """Announce this worker's rank to every server's membership table
        (idempotent: a rank already counted bumps no epoch).  Returns
        ``(epoch, members)`` as the last server reported."""
        epoch, members = self._rpc("JOIN", self._client_id)
        self._membership_epoch = max(self._membership_epoch, int(epoch))
        return int(epoch), list(members)

    def leave(self):
        """Take this worker's rank out of the quorum (best effort per
        server)."""
        payload = self._rpc("LEAVE", self._client_id)
        if payload is not None:
            self._membership_epoch = max(self._membership_epoch,
                                         int(payload[0]))
        return payload

    def members(self):
        """``(epoch, [ranks])`` of server 0's membership table (the
        barrier's quorum lives there)."""
        epoch, members = self._rpc("MEMBERS")
        return int(epoch), list(members)

    @property
    def membership_epoch(self) -> int:
        """The epoch this store's buckets are salted under
        (``MX_ELASTIC_EPOCH`` at init, raised by JOIN replies)."""
        return self._membership_epoch

    def metrics(self, fmt: str = "json"):
        """Each server's telemetry registry over the METRICS verb: a
        snapshot dict a server (``fmt='json'``) or its Prometheus text."""
        import json as _json
        from .wire_codec import decode_text
        out = []
        for i in range(len(self._socks)):
            text = decode_text(self._rpc_on(i, "METRICS", fmt))
            out.append(_json.loads(text) if fmt == "json" else text)
        return out

    # -- the data path -----------------------------------------------------
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            vv = _nd(v[0] if isinstance(v, (list, tuple)) else v)
            self._send_np("INIT", k, vv.asnumpy())
            self._store[k] = vv.copy()       # the local mirror: shape, dtype

    def _buckets_active(self, keys):
        """Buckets only for the accumulate exchange: with a server-side
        optimizer the server must see each key (its lr, wd and state)."""
        return len(keys) > 1 and self._optimizer is None and \
            self._updater is None

    def begin_exchange(self, keys, vlists, reverse=True):
        """No overlap on the parameter server: its RPCs block the host, so
        launching them during backward would put backward behind the
        wire.  The Trainer takes the batched push and pull instead."""
        return None

    def build_exchange_body(self, keys, arrays, layout=None):
        """None: the exchange crosses a TCP socket in the middle of a step,
        so no pure function of the local gradients exists to capture."""
        return None

    def _wire_gc(self):
        """The compact-wire compressor (2-bit or int8), when one is set;
        the bf16 cast has no numpy dtype, so that wire stays full width."""
        return self._gc

    def _push_payload(self, wire_key, value: NDArray):
        """One PUSH: the compressed wire tuple (dequantized by the server)
        or the full-width array.  A key over the big-array bound is not
        compressed: INIT split it across the servers (``key::partN``), so
        it takes the sliced full-width path."""
        gc = self._wire_gc()
        if gc is not None and _floating(value.data) and \
                self._shard_plan(value.size) is None:
            wire = gc.encode(wire_key, value.data)
            _engine.count_wire_bytes(gc.wire_nbytes(value.size))
            self._rpc("PUSH", wire_key, wire)
            return
        arr = value.asnumpy()
        _engine.count_wire_bytes(arr.nbytes)
        self._send_np("PUSH", wire_key, arr)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        vlists = [[_nd(x) for x in v] if isinstance(v, (list, tuple))
                  else [_nd(v)] for v in values]
        # the local merge only: the wire compression (error feedback, a
        # residual a wire key) happens in _push_payload, once
        merged = [self._reduce_local(v) if self._wire_gc() is not None
                  else self._reduce(v, key=k)
                  for k, v in zip(keys, vlists)]
        buckets, solo = [], range(len(keys))
        if self._buckets_active(keys):
            buckets, solo = self._bucket_plans(keys, merged)
        for b in buckets:
            # one concatenation on the device, then one host copy a bucket
            flat = torch.cat([merged[p].data.reshape(-1)
                              for p in b.positions])
            if b.name not in self._bucket_inited:
                # zero first, so the accumulator (pull = init + the sum of
                # the pushes) returns exactly the pushed sums
                self._send_np("INIT", b.name,
                              np.zeros((b.total,), np.dtype(b.dtype)
                                       if b.dtype != "bfloat16"
                                       else np.float32))
                self._bucket_inited.add(b.name)
            self._push_payload(b.name, NDArray(flat))
        for p in solo:
            self._push_payload(keys[p], merged[p])

    @staticmethod
    def _write(targets, flat_t, off, size, shape):
        """Write one pulled piece of ``flat_t`` (already on the targets'
        device) into every target, in its dtype."""
        piece = flat_t[off:off + size].view(shape)
        with torch.no_grad():
            for t in targets:
                d = t.data
                d.copy_(piece if piece.device == d.device
                        else piece.to(d.device))

    def _commit_bucket(self, b, flat, target_lists):
        """Scatter one pulled bucket to its members' targets: one copy to
        the device, then one slice a member."""
        dev = target_lists[b.positions[0]][0].data.device
        flat_t = torch.from_numpy(
            np.ascontiguousarray(np.asarray(flat).ravel())).to(dev)
        for p, off, size, shape in b.slices():
            self._write(target_lists[p], flat_t, off, size, shape)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        target_lists = [[_nd(x) for x in o] if isinstance(o, (list, tuple))
                        else [_nd(o)] for o in outs]
        firsts = [ts[0] for ts in target_lists]
        buckets, solo = [], range(len(keys))
        if self._buckets_active(keys):
            # the paired push's signature (gradients pull into buffers of
            # their shapes and dtypes), so the layout agrees -- also for a
            # worker that never pushed
            buckets, solo = self._bucket_plans(keys, firsts)
        solo = list(solo)
        if self._hier and len(buckets) > 1:
            # every bucket's PULLQ flies on its own connection and is
            # committed when its reply lands (on this thread): a slow
            # server delays only its own buckets
            import concurrent.futures as _fut
            ex = self._hier_pool_get()
            futs = {ex.submit(self._hier_bucket_pull, b.name): b
                    for b in buckets}
            for f in _fut.as_completed(futs):
                b = futs[f]
                try:
                    flat = f.result()
                except MXNetError:
                    solo.extend(b.positions)
                    continue
                self._commit_bucket(b, flat, target_lists)
        else:
            for b in buckets:
                try:
                    flat = self._pull_np(b.name, (b.total,), b.total)
                except MXNetError:
                    # the bucket is not on the server (nothing pushed this
                    # layout yet, e.g. pulling the initial weights): its
                    # members' own keys, never stale values
                    solo.extend(b.positions)
                    continue
                self._commit_bucket(b, flat, target_lists)
        for p in sorted(solo):
            arr = np.asarray(self._pull_np(keys[p], firsts[p].shape,
                                           int(firsts[p].size)))
            dev = firsts[p].data.device
            flat_t = torch.from_numpy(
                np.ascontiguousarray(arr.ravel())).to(dev)
            self._write(target_lists[p], flat_t, 0, flat_t.numel(),
                        firsts[p].shape)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("KVStoreDistAsync.row_sparse_pull is not ported: "
                         "it comes with sparse storage (ROADMAP Queue 1 "
                         "item 8)")

    def set_optimizer(self, optimizer):
        """Ship the optimizer to every server (the reference's pickled
        set_optimizer message).  A server keeps the first one installed;
        with more than one worker the barrier after it makes sure no
        worker pushes before it is in place."""
        import pickle
        self._rpc("SET_OPT", pickle.dumps(optimizer))
        self._optimizer = optimizer
        self._updater = None          # the updates run on the servers
        if self._size > 1:
            self._barrier()

    def _barrier(self):
        self._rpc("BARRIER", None)

    def stop_server(self):
        try:
            self._rpc("STOP", None)
        except MXNetError:
            pass
        self.close()

    def close(self):
        """Stop the heartbeat and drop every connection (the rank stays in
        the quorum: :meth:`leave` first to depart)."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
            self._hb_thread = None
        if getattr(self, "_hier_pool", None) is not None:
            self._hier_pool.shutdown(wait=False)
            self._hier_pool = None
        with self._lock:
            for i in range(len(self._socks)):
                self._kill_sock(i)


_STORES = {
    "local": KVStoreLocal,
    "device": KVStoreDevice,
    "ici": KVStoreICI,
    # the collective path covers these transports
    "nccl": KVStoreICI,
    "dist": KVStoreICI,
    "dist_sync": KVStoreICI,
    "dist_device_sync": KVStoreICI,
    "dist_async": KVStoreDistAsync,
    "horovod": KVStoreICI,
}


def create(name: str = "local") -> KVStore:
    """Reference: kvstore.create / KVStore::Create.  ``dist_async`` is the
    parameter-server store when a server address is set (the launcher's
    ``-s``); without one it warns and gives the collective store, as the
    reference does."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    key = name.lower()
    if key == "dist_async" and _ps_addr() is None:
        import warnings
        warnings.warn("kvstore 'dist_async' requested without a parameter "
                      "server (launch with tools/launch.py -s <servers>); "
                      "using the synchronous collective store instead")
        return KVStoreICI()
    if key not in _STORES:
        raise MXNetError("unknown KVStore type %r (have %s)"
                         % (name, sorted(_STORES)))
    return _STORES[key]()


# ---------------------------------------------------------------------------
# Program contracts: the exchange bodies' error-feedback residuals are
# written in place (the reference donates them), under every compression
# mode the port's compiled exchange carries; the per-key sum donates
# nothing.  The cases are built only in the verifier.
# ---------------------------------------------------------------------------

def _exchange_contract_cases():
    from ..programs import ContractCase, contract_device
    dev = contract_device()
    shapes = [(96, 4), (256,)]
    kv = KVStoreLocal()
    kv.set_gradient_compression({"type": "int8"})
    templates = [NDArray(torch.zeros(s, dtype=torch.float32, device=dev))
                 for s in shapes]
    body = kv.build_exchange_body(list(range(len(shapes))), templates)
    grads = [torch.empty(s, dtype=torch.float32, device="meta")
             for s in shapes]
    residuals = [torch.empty(tuple(s), dtype=dt, device="meta")
                 for _wk, s, dt in body.residual_specs]
    # the port's compiled exchange carries int8 alone: the reference's
    # 2bit and uncompressed bodies raise in build_exchange_body
    return [ContractCase("kvstore.exchange_int8", (grads, residuals),
                         label="int8", fn=body)]


def _sum_contract_cases():
    from ..programs import ContractCase
    store = KVStoreLocal()

    def sum_arrays(arrs):
        return store._reduce_local([NDArray(a) for a in arrs]).data

    arrs = tuple(torch.empty((128, 8), dtype=torch.float32, device="meta")
                 for _ in range(4))
    return [ContractCase("kvstore.sum", (arrs,), label="sum4",
                         fn=sum_arrays)]


def _declare_kvstore_contracts():
    from ..programs import declare_contract
    declare_contract(
        "kvstore.exchange", _exchange_contract_cases,
        donate_argnums=(1,),
        # 28,160 temp bytes at most on an NVIDIA H100 80GB HBM3 at
        # 700.00 W (the verifier, phase_launch_tier); x 4, a power of 2
        temp_budget_bytes=1 << 17,
        description="single-worker exchange body (int8): error-feedback "
                    "residuals written in place; gradients rebind to the "
                    "returned merged values")
    declare_contract(
        "kvstore.sum", _sum_contract_cases,
        donate_argnums=(),
        # 8,192 temp bytes at most on an NVIDIA H100 80GB HBM3 at
        # 700.00 W (the verifier, phase_launch_tier); x 4, a power of 2
        temp_budget_bytes=1 << 15,
        description="per-key eager reduction body: no donations, the "
                    "summands are live parameter gradients")


_declare_kvstore_contracts()
