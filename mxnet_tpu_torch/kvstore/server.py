"""The dist_async parameter server.

Counterpart of ``mxnet_tpu/kvstore/server.py`` (reference:
``src/kvstore/kvstore_dist_server.h``, ``KVStoreDistServer`` and its
**async** ``DataHandleEx`` path -- the server applies each worker's push
the moment it arrives, with no per-key barrier -- and
``python/mxnet/kvstore/kvstore_server.py``, the run loop a
``DMLC_ROLE=server`` process enters).  Run it as
``python -m mxnet_tpu_torch.kvstore.server`` (the launcher's ``-s N``
does).

The server is host code by role: its store is numpy arrays, and a
server-side optimizer runs on explicit ``mx.cpu()`` NDArrays
(:class:`_NumpyUpdater`), so a server never creates a CUDA context,
whether or not the machine has a card.  The transport is a
length-prefixed pickle protocol over TCP (stdlib socketserver), byte for
byte the JAX package's, so a client of either package talks to a server
of the other.

Wire protocol: request = (cmd, key, payload...); response = (ok, payload).
Commands: INIT (store if absent), PUSH (updater(key, grad, store) when an
optimizer is installed, else accumulate-sum), PULL, PULLQ (quantized
pull, the hierarchical exchange's return leg), SET_OPT (pickled
optimizer), BARRIER (explicit only -- pushes never barrier), PING
(heartbeat; refreshes the sender's liveness), JOIN/LEAVE/MEMBERS
(elastic membership, below), METRICS (the telemetry registry) and STOP.

Elastic membership: the barrier quorum is a live membership table seeded
from ``num_workers``.  JOIN adds the sender's rank, LEAVE removes it, and
every change bumps a monotonic *membership epoch* -- workers salt their
fusion-bucket names with the epoch they run under, so a resize renames
every bucket and a pre-resize accumulator is never misread.  A barrier
that opened under one epoch re-checks the current one before releasing.
With ``MX_ELASTIC_EVICT_AFTER`` set, a member silent that long leaves the
table (an involuntary LEAVE).

Fault tolerance (the ps-lite resender and heartbeat roles):

* Requests may arrive wrapped as ``("SEQ", client_id, seq, inner)``: the
  retrying client tags each RPC, and the server caches each client's
  last (seq, response), so a reconnect-and-replay after a lost reply is
  applied **exactly once** (a double-applied PUSH would corrupt the
  optimizer's trajectory).
* Liveness: every SEQ/PING carries a client id whose rank prefix feeds a
  last-seen table.  BARRIER releases when all *live* workers arrived -- a
  worker silent for ``MX_KVSTORE_STALE_TIMEOUT`` seconds is left out --
  and waits at most ``MX_KVSTORE_BARRIER_TIMEOUT``.
* Durability: with ``MX_PS_SNAPSHOT=path`` the server keeps its store
  (with the installed optimizer, its states and the replay cache) in an
  atomically replaced pickle after mutations and on STOP, and reloads it
  at start-up, so a server restarted on the same port resumes with no
  data lost and the client's reconnect succeeds.
"""
from __future__ import annotations

import os
import pickle
import socket
import socketserver
import sys
import threading
import time as _time
from typing import Dict, Optional

import numpy as _np

from .. import fault as _fault
from ..base import get_env
from . import wire_codec as _wire
from .wire_codec import WireCodecError
from .wire_verbs import declare_verbs

__all__ = ["KVStoreServer", "serve_forever", "send_msg", "recv_msg",
           "WIRE_VERBS"]


def send_msg(sock: socket.socket, obj) -> None:
    """One frame: the 8-byte little-endian length, then the pickle
    (protocol 4) -- the JAX package's bytes."""
    _wire.send_msg(sock, obj)


def _env_timeout(name: str, default: str = "") -> Optional[float]:
    """Positive float via base.get_env (catalog defaults apply), else
    `default`; None = no bound."""
    raw = get_env(name)
    if raw is None or raw == "":
        raw = default
    try:
        val = float(raw)
    except (TypeError, ValueError):
        return None
    return val if val > 0 else None


def recv_msg(sock: socket.socket, timeout: Optional[float] = None,
             idle_block: bool = False):
    """Receive one length-prefixed message.

    ``timeout`` bounds how long the peer may stall; None reads the
    ``MX_KVSTORE_RECV_TIMEOUT`` env knob (empty/0 = block forever).
    With ``idle_block=True`` the wait for the FIRST byte is unbounded
    (a server handler idling between requests is healthy) but a peer
    that stalls *mid-message* still trips TimeoutError instead of
    hanging the thread forever.
    """
    if timeout is None:
        timeout = _env_timeout("MX_KVSTORE_RECV_TIMEOUT")
    return _wire.recv_msg(sock, timeout=timeout, idle_block=idle_block)


def _rank_of(client_id) -> str:
    """Liveness is tracked per RANK: a restarted worker (new uuid, same
    rank) replaces its predecessor's entry instead of leaking a stale
    ghost that would permanently shrink the barrier quorum."""
    cid = str(client_id)
    return cid.split(":", 1)[0]


# The parameter-server wire surface, declared: every client-emitted verb
# has a row here, 'replayable' rows are the exactly-once replay set
# (_MUTATING) and 'idempotent' ones are not, and a named codec has an
# encode_<name>/decode_<name> pair in kvstore/wire_codec.py.  It equals
# the JAX package's manifest.
WIRE_VERBS = declare_verbs("kvstore", {
    # mutating commands replay from the SEQ cache after a lost reply
    "INIT": {"semantics": "replayable", "replay": "cached",
             "codec": None, "mutates": ("kv",)},
    "PUSH": {"semantics": "replayable", "replay": "cached",
             "codec": "wire", "mutates": ("kv", "optimizer")},
    "SET_OPT": {"semantics": "replayable", "replay": "cached",
                "codec": None, "mutates": ("optimizer",)},
    # re-executing these on a retried envelope is harmless by design
    "PULL": {"semantics": "idempotent", "replay": "bypass",
             "codec": None, "mutates": ()},
    # quantized pull: the hierarchical exchange's cross-slice
    # return leg — same read-only contract as PULL, ~4x fewer wire bytes
    "PULLQ": {"semantics": "idempotent", "replay": "bypass",
              "codec": "wire", "mutates": ()},
    # barrier release may also evict provably-departed members (an
    # involuntary LEAVE), hence membership+epoch in its effect set
    "BARRIER": {"semantics": "idempotent", "replay": "cached",
                "codec": None,
                "mutates": ("barrier", "membership", "epoch")},
    "PING": {"semantics": "idempotent", "replay": "bypass",
             "codec": None, "mutates": ()},
    # elastic membership: JOIN of a present rank and LEAVE of
    # an absent rank are designed no-ops (no epoch bump), so a retried
    # envelope re-executes harmlessly — idempotent by construction
    "JOIN": {"semantics": "idempotent", "replay": "cached",
             "codec": None, "mutates": ("membership", "epoch")},
    "LEAVE": {"semantics": "idempotent", "replay": "cached",
              "codec": None, "mutates": ("membership", "epoch")},
    "MEMBERS": {"semantics": "idempotent", "replay": "bypass",
                "codec": None, "mutates": ()},
    # read-only telemetry scrape: a collector reads a server's live
    # instrument registry over the same wire the workers use — no
    # sidecar, no extra port.
    "METRICS": {"semantics": "idempotent", "replay": "bypass",
                "codec": "text", "mutates": ()},
    # rides the cache (the bypass tuple is read-only verbs), burns no
    # state: serve_forever owns the actual drain+exit
    "STOP": {"semantics": "idempotent", "replay": "cached",
             "codec": None, "mutates": ()},
}, role="server", durable=True, handler="KVStoreServer.handle")


class KVStoreServer:
    """The server-side store + optimizer (reference: KVStoreDistServer)."""

    def __init__(self, num_workers: int = 1,
                 snapshot_path: Optional[str] = None,
                 snapshot_every: Optional[int] = None):
        self._store: Dict = {}
        self._locks: Dict = {}
        self._global_lock = threading.Lock()
        self._updater = None
        self._opt_blob = None
        self._num_workers = num_workers
        # elastic membership: the LIVE quorum table, seeded
        # from the constructor's num_workers in the rank naming
        # _rank_of() produces.  Guarded by _barrier_cv (every mutation
        # notifies the cv — a quorum change is exactly what a parked
        # barrier waiter needs to re-check); _membership_epoch bumps
        # monotonically on every table change.
        self._members = set("r%d" % i for i in range(max(1, num_workers)))
        self._membership_epoch = 0
        # the epoch the in-progress barrier generation opened under —
        # _try_release_barrier re-checks it so a membership change racing
        # a barrier rebases the arrival count instead of deadlocking
        # waiters or double-releasing
        self._barrier_open_epoch = 0
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_cv = threading.Condition()
        # under use_virtual_time(), exactly ONE parked waiter advances the
        # shared virtual clock — N waiters each charging their tick would
        # run every deadline on that clock N times too fast
        self._vclock_pumper: Optional[int] = None
        # liveness: rank -> last activity (monotonic seconds).  Written
        # by every handler thread (touch) and read/re-stamped under the
        # barrier wait; _seen_lock makes the pair atomic.  Lock order:
        # _barrier_cv is taken FIRST when both are held (the barrier
        # path touches liveness, never the reverse).
        self._seen_lock = threading.Lock()
        self._last_seen: Dict[str, float] = {}
        # which clock regime each stamp was taken under: virtual-clock
        # stamps are meaningless against real monotonic (and vice
        # versa), so a server outliving a use_virtual_time() block
        # must never compare across the switch
        self._seen_regime: Dict[str, bool] = {}
        # ranks parked inside the current barrier generation: alive by
        # definition, excluded from stale eviction
        self._barrier_waiting: Dict[str, int] = {}
        # exactly-once replay cache: client_id -> [seq, done Event, resp]
        # (mutating commands only — PULL/PING re-execute harmlessly, and
        # skipping them keeps parameter-sized replies out of the cache)
        self._replay: Dict[str, list] = {}
        self._replay_lock = threading.Lock()
        self._snapshot_path = snapshot_path if snapshot_path is not None \
            else (get_env("MX_PS_SNAPSHOT") or None)
        try:
            self._snapshot_every = int(
                snapshot_every if snapshot_every is not None else
                get_env("MX_PS_SNAPSHOT_EVERY") or 1)
        except ValueError:
            self._snapshot_every = 1
        self._mutations = 0
        self._mutation_lock = threading.Lock()
        self._snapshot_lock = threading.Lock()
        if self._snapshot_path and os.path.exists(self._snapshot_path):
            self._load_snapshot()

    def _lock_of(self, key):
        with self._global_lock:
            return self._locks.setdefault(key, threading.Lock())

    # -- liveness -----------------------------------------------------------
    def touch(self, client_id) -> None:
        if client_id is not None:
            rank = _rank_of(client_id)
            with self._seen_lock:
                self._last_seen[rank] = _fault.now()
                self._seen_regime[rank] = _fault.is_virtual()

    def _effective_workers(self) -> int:
        """Barrier quorum = live membership table minus transiently-stale
        member ranks.  Caller holds _barrier_cv (the table is guarded by
        it).  Member ranks never heard from are NOT stale (they may still
        be starting), and ranks parked INSIDE the barrier are alive by
        definition — a waiting worker's own silence (e.g. heartbeats
        disabled) must never evict it out of the barrier it is holding."""
        base = max(1, len(self._members))
        stale = _env_timeout("MX_KVSTORE_STALE_TIMEOUT")
        if stale is None:
            return base
        regime = _fault.is_virtual()
        horizon = _fault.now() - stale
        evicted = 0
        with self._seen_lock:   # atomic vs touch() in handler threads
            for r, t in list(self._last_seen.items()):
                if self._seen_regime.get(r, regime) != regime:
                    # stamped under the other clock: re-stamp as fresh
                    # now — never evict on an apples-to-oranges compare
                    self._last_seen[r] = _fault.now()
                    self._seen_regime[r] = regime
                elif t < horizon and r in self._members \
                        and r not in self._barrier_waiting:
                    evicted += 1
        return max(1, base - evicted)

    def _evict_departed(self) -> None:
        """Permanent liveness eviction: with
        ``MX_ELASTIC_EVICT_AFTER`` armed, a member rank silent that long
        is removed from the membership TABLE itself — an involuntary
        LEAVE on behalf of a worker that died without preemption notice
        — so every later barrier sizes against the shrunken world
        instead of re-discounting the ghost each time.  Caller holds
        _barrier_cv.  Unset/0 keeps today's transient-only discounting."""
        evict_after = _env_timeout("MX_ELASTIC_EVICT_AFTER")
        if evict_after is None:
            return
        regime = _fault.is_virtual()
        horizon = _fault.now() - evict_after
        gone = []
        with self._seen_lock:
            for r in list(self._members):
                t = self._last_seen.get(r)
                if t is None or r in self._barrier_waiting:
                    continue        # never heard from, or provably alive
                if self._seen_regime.get(r, regime) != regime:
                    continue        # cross-clock stamp: not comparable
                if t < horizon:
                    gone.append(r)
                    self._last_seen.pop(r, None)
                    self._seen_regime.pop(r, None)
        if gone:
            for r in gone:
                self._members.discard(r)
            self._membership_epoch += 1
            self._note_membership_change("evict", gone)

    def _note_membership_change(self, what: str, ranks) -> None:
        """Telemetry + log for one membership-table mutation (safe to
        call with _barrier_cv held — counter/gauge updates only)."""
        from .. import telemetry as _telemetry
        _telemetry.registry.counter(
            "kvstore.membership_%ss" % what,
            doc="elastic membership %s events applied to the live "
                "table" % what).inc(len(ranks) if not
                                    isinstance(ranks, str) else 1)
        _telemetry.registry.gauge(
            "kvstore.membership_epoch",
            doc="monotonic membership epoch — bumps on every JOIN/"
                "LEAVE/evict").set(self._membership_epoch)
        _telemetry.registry.gauge(
            "kvstore.members",
            doc="live membership table size").set(len(self._members))
        print("kvstore server: membership %s %s -> epoch %d, %d member(s)"
              % (what, list(ranks), self._membership_epoch,
                 len(self._members)), file=sys.stderr)

    # -- durability ---------------------------------------------------------
    def _load_snapshot(self) -> None:
        with open(self._snapshot_path, "rb") as f:
            blob = pickle.load(f)
        self._store = {k: _np.array(v, copy=True)
                       for k, v in blob["store"].items()}
        if blob.get("opt_blob") is not None:
            self._install_optimizer(blob["opt_blob"])
            states = blob.get("opt_states")
            if states is not None:
                self._updater.inner.set_states(states)
        # exactly-once across restarts: resurrect the replay cache so a
        # PUSH that was applied+snapshotted right before the crash is
        # answered from cache when the reconnecting client replays it
        for cid, (seq, resp) in blob.get("replay", {}).items():
            done = threading.Event()
            done.set()
            self._replay[cid] = [seq, done, resp]
        # a restarted server resumes the RESIZED world, not the seeded
        # one — membership survives with the store it sized
        if blob.get("members"):
            self._members = set(blob["members"])
            self._membership_epoch = int(blob.get("membership_epoch", 0))
            self._barrier_open_epoch = self._membership_epoch

    def snapshot(self) -> None:
        """Atomically persist store + optimizer (write sibling, rename).
        Serialized under _snapshot_lock: concurrent handler threads must
        not race on the temp file (the loser's os.replace would throw)."""
        path = self._snapshot_path
        if not path:
            return
        with self._barrier_cv:      # taken ALONE (before any data lock)
            members = sorted(self._members)
            membership_epoch = self._membership_epoch
        with self._snapshot_lock:
            with self._global_lock:
                locks = list(self._locks.values())
            # quiesce in-flight per-key mutations — BOUNDED: a handler
            # wedged mid-PUSH must cost us this snapshot, not wedge the
            # snapshotting thread forever (the next mutation retries);
            # real-time bound on purpose, the holders are real threads
            acquired = []
            for lk in locks:
                if lk.acquire(timeout=30.0):
                    acquired.append(lk)
                    continue
                for got in acquired:
                    got.release()
                print("kvstore server: snapshot skipped - a per-key "
                      "lock stayed held for 30s", file=sys.stderr)
                return
            try:
                with self._replay_lock:
                    replay = {cid: (ent[0], ent[2])
                              for cid, ent in self._replay.items()
                              if ent[1].is_set()}
                with self._global_lock:
                    # one fence for everything SET_OPT/INIT mutate under
                    # it: the store dict and the installed optimizer
                    items = list(self._store.items())
                    opt_blob = self._opt_blob
                    updater = self._updater
                blob = {"store": {k: _np.array(v, copy=True)
                                  for k, v in items},
                        "opt_blob": opt_blob,
                        "opt_states": (updater.inner.get_states(False)
                                       if updater is not None
                                       else None),
                        "members": members,
                        "membership_epoch": membership_epoch,
                        "replay": replay}
            finally:
                for lk in acquired:
                    lk.release()
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "wb") as f:
                pickle.dump(blob, f, protocol=4)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    def _note_mutation(self) -> None:
        if not self._snapshot_path:
            return
        with self._mutation_lock:   # lost increments would skip the
            self._mutations += 1    # modulo boundary below
            due = self._mutations % max(1, self._snapshot_every) == 0
        if due:
            self.snapshot()

    def _install_optimizer(self, blob) -> None:
        from ..optimizer import get_updater
        optimizer = pickle.loads(blob)
        self._updater = _NumpyUpdater(get_updater(optimizer))
        self._opt_blob = blob

    # -- exactly-once replay ------------------------------------------------
    _MUTATING = ("INIT", "PUSH", "SET_OPT")

    def handle_request(self, msg, client_id=None):
        """Entry point for one wire request: unwraps SEQ envelopes and
        answers replayed sequence numbers from the cache (idempotent
        reconnect-replay), then dispatches to :meth:`handle`.

        PULL/PING bypass the cache — re-executing them is harmless, and
        skipping them keeps parameter-sized replies out of it.  The
        snapshot for a mutating command fires AFTER its cache entry
        resolves, so a persisted store state always travels with the
        cache entry that marks its push as applied (a crash between the
        two can therefore never lead to a double-apply on restart).

        Distributed tracing: a SEQ envelope may carry a fifth element
        ``(trace_id, span_id)`` stamped by the client's RPC span; the
        handling here runs under a child span with those IDs, so a
        merged chrome trace shows one causal chain per RPC —
        replay-cache hits become instant ``replay`` child events.  Envelopes without the element (older
        clients, tools) are handled identically."""
        if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
            from .. import telemetry as _telemetry
            cid, seq, inner = msg[1], msg[2], msg[3]
            tctx = msg[4] if len(msg) > 4 else None
            self.touch(cid)
            cmd = inner[0] if inner else None
            with _telemetry.rpc_span(
                    "kv.server.%s" % cmd,
                    trace_id=tctx[0] if tctx else None,
                    parent_id=tctx[1] if tctx else None) as span:
                return self._handle_seq(cid, seq, inner, cmd, span)
        resp = self.handle(msg, client_id=client_id)
        if msg and msg[0] in self._MUTATING:
            self._note_mutation()
        return resp

    def _handle_seq(self, cid, seq, inner, cmd, span):
        """SEQ-enveloped dispatch under the caller's server span.
        METRICS joins the PULL/PING cache bypass: it is read-only by
        contract, and caching a whole registry exposition per scrape
        would bloat the replay cache for nothing.  PULLQ and MEMBERS
        bypass for the same read-only reason — and PULLQ replies are
        parameter-sized, exactly what the cache must stay free of."""
        if cmd in ("PULL", "PULLQ", "PING", "METRICS", "MEMBERS"):
            return self.handle(inner, client_id=cid)
        with self._replay_lock:
            ent = self._replay.get(cid)
            if ent is not None and seq == ent[0]:
                dup = ent
            elif ent is not None and seq < ent[0]:
                span.event("stale", seq=seq, server_at=ent[0])
                return False, ("stale request seq %s (server already "
                               "at %s)" % (seq, ent[0]))
            else:
                dup = None
                ent = [seq, threading.Event(), None]
                self._replay[cid] = ent
        if dup is not None:
            # the original execution may still be in flight on the
            # dead connection's thread: wait for its result rather
            # than re-executing (PUSH must apply exactly once)
            from .. import telemetry as _telemetry
            span.event("replay", seq=seq)
            _telemetry.registry.counter(
                "kvstore.server_replays",
                doc="SEQ requests answered from the exactly-once "
                    "replay cache").inc()
            timeout = (_env_timeout("MX_KVSTORE_BARRIER_TIMEOUT")
                       or 120) + 30
            if not dup[1].wait(timeout=timeout):
                return False, "replayed request %s still in flight" % seq
            return dup[2]
        try:
            resp = self.handle(inner, client_id=cid)
        except BaseException as e:
            # the entry MUST resolve even on a handler fault — a
            # forever-pending seq would starve every future replay of
            # it (the client would burn its whole retry deadline)
            ent[2] = (False, "server error handling %r: %s"
                      % (inner[0], e))
            ent[1].set()
            raise
        ent[2] = resp
        ent[1].set()
        if cmd in self._MUTATING:
            self._note_mutation()
        return resp

    # -- command handlers ---------------------------------------------------
    def handle(self, msg, client_id=None):
        cmd = msg[0]
        if cmd == "INIT":
            _, key, value = msg
            with self._lock_of(key):
                if key not in self._store:
                    arr = _np.array(value, copy=True)
                    with self._global_lock:   # fence vs snapshot iteration
                        self._store[key] = arr
            return True, None
        if cmd == "PUSH":
            _, key, grad = msg
            # the numpy codec: the PUSH path stays on the host
            from .wire_codec import decode_wire, is_wire_payload
            if is_wire_payload(grad):
                # compact wire format (payload + scales + dtype tag):
                # dequantize BEFORE the updater/accumulator sees it — the
                # optimizer contract is full-width gradients (the worker
                # already paid the quantization error via error feedback)
                grad = decode_wire(grad)
            with self._global_lock:
                # snapshot the updater OUTSIDE the per-key lock (same
                # order as INIT: per-key -> global never reverses) — a
                # concurrent SET_OPT installs under _global_lock, and an
                # updater is never uninstalled, so the local ref stays
                # valid for the whole apply
                updater = self._updater
            with self._lock_of(key):
                stored = self._store.get(key)
                if stored is None:
                    return False, "key %r not initialized" % (key,)
                if grad.shape != stored.shape and \
                        grad.size == stored.size:
                    grad = grad.reshape(stored.shape)
                if updater is not None:
                    # async contract: apply THIS worker's gradient now
                    updater(key, grad, stored)
                else:
                    # no optimizer: the server is an ACCUMULATOR — pull
                    # returns init + sum of every push (the dist num_
                    # workers-sum contract); differs from local stores,
                    # where push replaces (documented divergence)
                    stored += grad
            return True, None
        if cmd == "PULL":
            _, key = msg
            with self._lock_of(key):
                stored = self._store.get(key)
                if stored is None:
                    return False, "key %r not initialized" % (key,)
                return True, _np.array(stored, copy=True)
        if cmd == "PULLQ":
            # hierarchical exchange, cross-slice return leg:
            # the merged value goes back per-block int8-quantized — ~4x
            # fewer wire bytes than the fp32 PULL.  Stateless encode (no
            # residual on the server), so this is the opt-in tier of
            # MX_EXCHANGE_HIERARCHICAL, never the default pull.  Non-
            # float keys fall back to the full-width PULL reply.
            from .wire_codec import encode_wire, quantize_int8_np
            key = msg[1]
            block = 256
            if len(msg) > 2 and msg[2]:
                block = int(msg[2])
            with self._lock_of(key):
                stored = self._store.get(key)
                if stored is None:
                    return False, "key %r not initialized" % (key,)
                if stored.dtype.kind != "f":
                    return True, _np.array(stored, copy=True)
                q, scales = quantize_int8_np(stored.reshape(-1), block)
                return True, encode_wire("int8", stored.shape,
                                         stored.dtype, (q, scales))
        if cmd == "SET_OPT":
            _, blob = msg
            with self._global_lock:
                # check-and-install is ATOMIC: two workers shipping the
                # optimizer concurrently (startup skew) must not both
                # pass the None check and double-install — the loser
                # would wipe accumulated momentum/Adam state.  Keep the
                # FIRST installation (reference gates the controller
                # message on rank 0 for the same reason).
                if self._updater is not None:
                    return True, "already installed"
                self._install_optimizer(blob)
            return True, None
        if cmd == "PING":
            # heartbeat: payload is the sender's client_id (also reached
            # touch() via the envelope when SEQ-wrapped)
            if len(msg) > 1:
                self.touch(msg[1])
            return True, "PONG"
        if cmd == "METRICS":
            # live telemetry scrape: the reply is this server process's
            # whole instrument registry — Prometheus text by default,
            # fmt='json' for a collector's merge path.
            # Read-only/idempotent; bypasses the replay cache.
            from .. import telemetry as _telemetry
            from .wire_codec import encode_text
            fmt = msg[1] if len(msg) > 1 else "prometheus"
            reg = _telemetry.registry
            text = reg.to_json(indent=1) if fmt == "json" \
                else reg.to_prometheus()
            return True, encode_text(text)
        if cmd == "JOIN":
            # elastic membership: admit the sender's rank to
            # the live quorum.  A JOIN of a rank already present is a
            # no-op (no epoch bump) — that is what makes the verb
            # idempotent under SEQ retry, and what lets every worker of
            # a FIXED job send JOIN at init unconditionally.
            _fault.fire("kvstore.membership")
            who = msg[1] if len(msg) > 1 and msg[1] is not None \
                else client_id
            rank = _rank_of(who) if who is not None else None
            changed = False
            with self._barrier_cv:
                if rank is not None and rank not in self._members:
                    self._members.add(rank)
                    self._membership_epoch += 1
                    changed = True
                    self._note_membership_change("join", [rank])
                    self._barrier_cv.notify_all()
                epoch = self._membership_epoch
                members = sorted(self._members)
            self.touch(who)
            if changed:
                self.snapshot()
            return True, (epoch, members)
        if cmd == "LEAVE":
            # voluntary departure (preemption drain, supervisor shrink):
            # drop the rank from the quorum NOW so no barrier ever waits
            # on it, and clear its liveness stamp so it cannot read as a
            # stale ghost.  LEAVE of an absent rank is a no-op.
            _fault.fire("kvstore.membership")
            who = msg[1] if len(msg) > 1 and msg[1] is not None \
                else client_id
            rank = _rank_of(who) if who is not None else None
            changed = False
            with self._barrier_cv:
                if rank is not None and rank in self._members:
                    self._members.discard(rank)
                    self._membership_epoch += 1
                    changed = True
                    with self._seen_lock:   # cv -> seen: documented order
                        self._last_seen.pop(rank, None)
                        self._seen_regime.pop(rank, None)
                    self._note_membership_change("leave", [rank])
                    # the quorum shrank: parked waiters may now release
                    self._barrier_cv.notify_all()
                epoch = self._membership_epoch
                members = sorted(self._members)
            if changed:
                self.snapshot()
            return True, (epoch, members)
        if cmd == "MEMBERS":
            with self._barrier_cv:
                return True, (self._membership_epoch,
                              sorted(self._members))
        if cmd == "BARRIER":
            return self._handle_barrier(client_id)
        if cmd == "STOP":
            # serve_forever snapshots once after the drain (fresher and
            # cheaper than snapshotting here too); standalone embedders
            # of KVStoreServer call .snapshot() themselves at shutdown
            return True, "stopping"
        return False, "unknown command %r" % (cmd,)

    def _handle_barrier(self, client_id=None):
        """Generation barrier (explicit _barrier() calls only; PUSH never
        blocks — that's the async contract).  Waits re-check the live-
        worker quorum every poll tick so a stale worker's eviction
        releases the survivors instead of stranding them.  The caller's
        rank registers in _barrier_waiting while parked, which shields
        it from its own stale eviction (it is alive, just waiting)."""
        timeout = _env_timeout("MX_KVSTORE_BARRIER_TIMEOUT") or 120.0
        stale = _env_timeout("MX_KVSTORE_STALE_TIMEOUT") or 30.0
        poll = min(0.25, max(0.02, stale / 5.0))
        rank = _rank_of(client_id) if client_id is not None else None
        with self._barrier_cv:
            gen = self._barrier_gen
            if self._barrier_count == 0:
                # first arrival OPENS this barrier generation: stamp the
                # membership epoch it sized against — release re-checks
                # the stamp so a racing JOIN/LEAVE
                # rebases the count instead of deadlocking/double-firing
                self._barrier_open_epoch = self._membership_epoch
            self._barrier_count += 1
            if rank is not None:
                self._barrier_waiting[rank] = \
                    self._barrier_waiting.get(rank, 0) + 1
            try:
                if self._try_release_barrier():
                    return True, None
                # Deadline (not now()+timeout): a use_virtual_time()
                # context starting/ending around this park must not make
                # the budget compare across clock regimes
                deadline = _fault.Deadline(timeout)
                while self._barrier_gen == gen:
                    remaining = deadline.remaining()
                    if remaining <= 0:
                        self._barrier_count = max(0,
                                                  self._barrier_count - 1)
                        return False, ("barrier timed out after %.3gs "
                                       "waiting for %d workers (%d arrived)"
                                       % (timeout,
                                          self._effective_workers(),
                                          self._barrier_count + 1))
                    tick = min(poll, remaining)
                    if _fault.is_virtual():
                        # a real cv.wait cannot advance a virtual clock:
                        # yield briefly for arriving workers, then charge
                        # the whole tick so the deadline math progresses
                        # and a chaos test's barrier timeout fires in
                        # milliseconds of real time.  Only the elected
                        # pumper charges (cv lock is held here): every
                        # waiter charging would advance deadlines N×.
                        me = threading.get_ident()
                        if self._vclock_pumper is None:
                            self._vclock_pumper = me
                        self._barrier_cv.wait(timeout=0.001)
                        if self._vclock_pumper == me:
                            _fault.sleep(tick)
                    else:
                        self._barrier_cv.wait(timeout=tick)
                    if self._barrier_gen == gen:
                        if self._try_release_barrier():
                            break
            finally:
                if self._vclock_pumper == threading.get_ident():
                    # hand the clock-pumping duty to whichever waiter
                    # iterates next
                    self._vclock_pumper = None
                if rank is not None:
                    n = self._barrier_waiting.get(rank, 0) - 1
                    if n <= 0:
                        self._barrier_waiting.pop(rank, None)
                    else:
                        self._barrier_waiting[rank] = n
                    self.touch(client_id)     # fresh on the way out
        return True, None

    def _try_release_barrier(self) -> bool:
        """Caller holds _barrier_cv.  Release if every live worker is in.

        Membership re-check: if the membership
        epoch moved since this barrier generation opened, the arrival
        count is REBASED to the parked waiters that are still members —
        a departed rank's ghost arrival can no longer inflate the count
        into a double-release, and a JOIN that grew the quorum mid-wait
        is sized against honestly instead of deadlocking the waiters on
        an arithmetic carried over from the old world.  (Anonymous
        arrivals — client_id=None, rank untracked — are only countable
        pre-rebase; elastic callers always identify themselves.)"""
        self._evict_departed()
        if self._membership_epoch != self._barrier_open_epoch:
            self._barrier_count = sum(
                n for r, n in self._barrier_waiting.items()
                if r in self._members)
            self._barrier_open_epoch = self._membership_epoch
        if self._barrier_count >= self._effective_workers():
            self._barrier_count = 0
            self._barrier_gen += 1
            self._barrier_cv.notify_all()
            return True
        return False


class _NumpyUpdater:
    """Bridge the mx Updater (NDArray in/out) to the numpy server store.
    The NDArrays are made on an explicit ``mx.cpu()``: the server's role
    is the host, so it never creates a CUDA context, whether or not the
    machine has a card."""

    def __init__(self, updater):
        self.inner = updater

    def __call__(self, key, grad_np, stored_np):
        import torch
        from ..device import cpu
        from ..ndarray.ndarray import NDArray, array as _arr
        grad_np = _np.asarray(grad_np)
        if stored_np.dtype == _np.float32 and grad_np.dtype == _np.float32 \
                and stored_np.flags.c_contiguous:
            # float32: the NDArrays are views of the host arrays (CPU
            # tensors by construction), and the update is written into
            # the store in place
            g = NDArray(torch.from_numpy(_np.ascontiguousarray(grad_np)))
            w = NDArray(torch.from_numpy(stored_np))
        else:
            g = _arr(grad_np, ctx=cpu())
            w = _arr(stored_np, ctx=cpu())
        self.inner(key, g, w)
        if w.data.data_ptr() != stored_np.ctypes.data:
            stored_np[...] = w.asnumpy()


def serve_forever(port=None, num_workers=None, ready_file=None,
                  snapshot_path=None):
    """Run the server loop (reference: KVStoreServer.run; entered by
    the ``DMLC_ROLE=server`` processes the launcher's ``-s`` starts).

    STOP drains gracefully: the listener closes, in-flight requests get
    their replies, THEN the process exits — so a worker's final RPC never
    races the shutdown.
    """
    port = int(port if port is not None else get_env("MX_PS_PORT"))
    num_workers = int(num_workers if num_workers is not None else
                      os.environ.get("DMLC_NUM_WORKER", 1))
    server_state = KVStoreServer(num_workers, snapshot_path=snapshot_path)
    stop_event = threading.Event()
    inflight_count = [0]
    inflight_lock = threading.Lock()
    conns = set()                           # live client sockets, severed
    conns_lock = threading.Lock()           # after the STOP drain

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            with conns_lock:
                conns.add(self.request)
            try:
                self._serve()
            finally:
                with conns_lock:
                    conns.discard(self.request)

        def _serve(self):
            while True:
                try:
                    msg = recv_msg(self.request, idle_block=True)
                except (ConnectionError, OSError, TimeoutError):
                    return
                with inflight_lock:
                    inflight_count[0] += 1
                try:
                    _fault.fire("server.handle")
                    ok, payload = server_state.handle_request(msg)
                except SystemExit:          # injected crash: die mid-request
                    os._exit(17)
                except (_fault.FaultError, WireCodecError) as e:
                    # a malformed wire frame is the CLIENT's fault: the
                    # decoder raised before any state was touched, so
                    # answer with a typed refusal on the same connection
                    # instead of severing it with a traceback
                    ok, payload = False, str(e)
                finally:
                    with inflight_lock:
                        inflight_count[0] -= 1
                try:
                    send_msg(self.request, (ok, payload))
                except (ConnectionError, OSError):
                    return
                inner = msg[3] if isinstance(msg, tuple) and msg and \
                    msg[0] == "SEQ" else msg
                if inner and inner[0] == "STOP":
                    stop_event.set()
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server(("0.0.0.0", port), Handler) as srv:
        if ready_file:
            with open(ready_file, "w") as f:
                f.write("%d" % srv.server_address[1])
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        # unbounded by design: idling until a worker sends STOP is the
        # server's whole lifetime (the launcher owns killing an abandoned
        # server)
        stop_event.wait()
        srv.shutdown()                      # stop accepting
        drain_deadline = _fault.Deadline(5.0)
        while not drain_deadline.expired():
            with inflight_lock:
                if inflight_count[0] == 0:
                    break
            if _fault.is_virtual():
                # in-flight handlers run in REAL threads: a pure virtual
                # tick would burn the whole drain budget in microseconds
                # without giving them a chance to finish (same treatment
                # as the barrier wait above)
                _time.sleep(0.001)
            _fault.sleep(0.02)
        server_state.snapshot()
        # sever surviving client connections so peers observe the stop
        # immediately (a subprocess server gets this for free at exit;
        # an in-process one must do it explicitly)
        with conns_lock:
            leftover = list(conns)
        for c in leftover:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


if __name__ == "__main__":
    serve_forever()
