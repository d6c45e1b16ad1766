"""Serving fleet front-tier: a decode-aware session router.

Counterpart of ``mxnet_tpu/serve/router.py``, host Python with the
reference's behaviour.

One ``ServeRouter`` process fronts a DYNAMIC set of serving replicas
and speaks the exact same wire surface as a replica
(``serve/server.py``): length-prefixed pickles, requests optionally
wrapped ``("SEQ", client_id, seq, inner[, tctx])``.  Clients point
``MX_SERVE_ROOTS`` at the router and nothing else changes — the router
forwards each client envelope VERBATIM to the replica it picks, so the
replica's exactly-once replay cache keys on the client's own
``(client_id, seq)`` and the end-to-end semantics survive the extra
hop with ZERO router-side replay state:

* a client retry that reaches the SAME replica (the common case:
  pinned session, lost reply) is answered from that replica's replay
  cache — no second dispatch, no second prefill;
* a retry that must move (the pinned replica died) re-executes on a
  survivor exactly like the direct client's failover — the seq still
  protects the same-replica lost-reply case there from then on.

Routing is SESSION-routing, not request-routing: the first request of
a ``client_id`` picks the least-loaded live replica (by the fleet
plane's merged signals — queue depth, decode admission queue, decode
slot occupancy; unknown load ties break round-robin) and PINS the
session there.  Decode sessions especially must stick — moving a
generation costs a re-prefill — so a pin is only abandoned when its
replica dies, starts draining, or sheds (then the request spills to
the next-best replica and the session re-pins).  Pins are a bounded
LRU (``MX_ROUTER_PIN_CAP``): serving clients are ephemeral uuids, and
an evicted pin costs locality, never correctness.

Replica lifecycle (the router's side of drain-not-kill)::

     up ──(forward fails)──▶ dead ──(probe connects)──▶ up
     up ──(left replicas-file / replied "draining:")──▶ draining
     draining ──(forward fails / gone from file)──▶ dead / forgotten

``up`` takes new sessions; ``draining`` takes nothing new (the replica
itself also refuses — the router just stops wasting the round trip);
``dead`` is probed for revival each refresh tick.  Membership comes
from ``--replicas`` / ``MX_ROUTER_REPLICAS`` (static) plus an optional
``--replicas-file`` a supervisor rewrites as it spawns and retires
replicas; load signals come from the fleet
collector's merged FLEET snapshot (``--fleet`` /MX_ROUTER_FLEET``,
projected through :func:`mxnet_tpu_torch.fleet.replica_signals`).

The router itself drains the same way a replica does: DRAIN closes
admission for NEW sessions (pinned sessions keep flowing), the serve
loop exits once the wire is idle, and past the bounded deadline the
stragglers' connections are severed so their clients replay elsewhere.

Chaos sites: ``router.request`` (crash = kill the router mid-load —
clients reconnect and replay through the restarted router) and
``router.forward`` (error/close = a dead-replica look-alike on the
upstream hop — MUST trigger router-side failover, never a double
dispatch).

Run it::

  python -m mxnet_tpu_torch.serve.router --port 9800 \\
      --replicas 127.0.0.1:9700,127.0.0.1:9701 --fleet 127.0.0.1:9137
"""
from __future__ import annotations

import os
import socket
import socketserver
import threading
from typing import Any, Dict, List, Optional

from ..base import MXNetError, get_env
from .. import fault as _fault
from .. import fleet as _fleet
from .. import telemetry as _telemetry
from ..kvstore.wire_verbs import declare_verbs
from ..kvstore.wire_codec import encode_text, recv_msg, send_msg

__all__ = ["ServeRouter", "serve_router_forever", "main"]

# The ROUTE-side wire surface, DECLARED: the same rows as the replica
# manifest in serve/server.py, because the router forwards client
# envelopes verbatim — replay semantics are the REPLICA's (this file
# keeps no replay set on purpose: adding one here would mean the router
# caches replies, and then a retry could be answered with a reply the
# replica never burned a dispatch for... or worse, re-dispatch what the
# replica already cached).
WIRE_VERBS = declare_verbs("router", {
    # forwarded verbatim to the pinned/least-loaded replica; replay
    # exactly-once lives in the REPLICA's cache, keyed on the client's
    # own (client_id, seq) because the envelope crosses unmodified
    "PREDICT": {"semantics": "replayable", "replay": "forward",
                "codec": "array", "mutates": ()},
    "GENERATE": {"semantics": "replayable", "replay": "forward",
                 "codec": None, "mutates": (), "stream": "STREAM"},
    # fan-out: one client SWAP flips every live replica
    "SWAP": {"semantics": "replayable", "replay": "forward",
             "codec": None, "mutates": ()},
    # server->client token frame of a streaming GENERATE, passed
    # through unmodified (offset-deduped by the client on re-delivery);
    # a client SENDING it is answered locally with an explicit error
    "STREAM": {"semantics": "idempotent", "replay": "local",
               "codec": None, "mutates": ()},
    # answered by the ROUTER itself (fleet-tier state, not replica
    # state) — probing the tier must work with zero live replicas
    "HEALTH": {"semantics": "idempotent", "replay": "local",
               "codec": None, "mutates": ()},
    "METRICS": {"semantics": "idempotent", "replay": "local",
                "codec": "text", "mutates": ()},
    # retire the ROUTER: new sessions refused, pinned sessions finish
    "DRAIN": {"semantics": "idempotent", "replay": "local",
              "codec": None, "mutates": ("lifecycle",)},
    # stop the fleet: forwarded best-effort to every replica, then the
    # router itself exits
    "STOP": {"semantics": "idempotent", "replay": "forward",
             "codec": None, "mutates": ()},
}, role="router", handler="serve_router_forever.Handler._dispatch")

def _split_addrs(raw) -> List[str]:
    if raw is None:
        return []
    if isinstance(raw, str):
        return [a.strip() for a in raw.split(",") if a.strip()]
    return [str(a).strip() for a in raw if str(a).strip()]


class ServeRouter:
    """Session-pinning load balancer state + forwarding engine.

    Thread-safety: ``_lock`` is the one (leaf) lock over membership,
    pins, and signals; upstream sockets are per-connection-handler
    (owned by the socket thread that forwards on them), so no socket is
    ever shared across threads.
    """

    def __init__(self, replicas=None, replicas_file: Optional[str] = None,
                 fleet_addr: Optional[str] = None,
                 refresh: Optional[float] = None,
                 timeout: Optional[float] = None, on_tick=None):
        self._lock = threading.Lock()
        self._replicas: Dict[str, str] = {}   # addr -> up|draining|dead
        self._pins: Dict[str, str] = {}       # client_id -> addr (LRU)
        self._signals: Dict[str, Dict[str, Any]] = {}
        self._rr = 0
        self._stop = threading.Event()
        self._refresh_thread: Optional[threading.Thread] = None
        self._on_tick = on_tick
        self._replicas_file = replicas_file or \
            get_env("MX_ROUTER_REPLICAS_FILE", "") or None
        self._fleet_addr = fleet_addr or \
            get_env("MX_ROUTER_FLEET", "") or None
        self._refresh = float(refresh if refresh is not None else
                              get_env("MX_ROUTER_REFRESH", 1.0, float)
                              or 1.0)
        self._timeout = float(timeout if timeout is not None else
                              get_env("MX_SERVE_TIMEOUT", 30.0, float)
                              or 30.0)
        try:
            raw_cap = get_env("MX_ROUTER_PIN_CAP", 4096, int)
            self._pin_cap = max(1, int(4096 if raw_cap is None
                                       else raw_cap))
        except (TypeError, ValueError):
            self._pin_cap = 4096
        # router drain mirrors the replica's: first deadline wins
        self._draining = threading.Event()
        self._drain_lock = threading.Lock()
        self._drain_deadline: Optional[_fault.Deadline] = None
        reg = _telemetry.registry
        self._c_requests = reg.counter(
            "router.requests", doc="requests accepted by the router")
        self._c_failovers = reg.counter(
            "router.failovers",
            doc="upstream forwards replayed on another replica after a "
                "connection failure/timeout (the dead replica's pinned "
                "sessions are unpinned)")
        self._c_spills = reg.counter(
            "router.spills",
            doc="requests re-routed after an overloaded/draining "
                "refusal from the first-choice replica")
        self._c_unpinned = reg.counter(
            "router.sessions_unpinned",
            doc="session pins dropped because their replica died or "
                "started draining")
        self._g_up = reg.gauge(
            "router.replicas_up", doc="replicas in state 'up'")
        self._g_sessions = reg.gauge(
            "router.sessions", doc="sessions currently pinned")
        seed = _split_addrs(replicas if replicas is not None
                            else get_env("MX_ROUTER_REPLICAS", ""))
        for addr in seed:
            self._replicas[addr] = "up"
        self._reconcile_file()

    # -- membership ---------------------------------------------------------
    def set_replicas(self, addrs) -> None:
        """Reconcile membership against the authoritative list: new
        addrs join as ``up`` (optimistic — the first failed forward
        demotes them), members that left start ``draining`` (nothing
        new routed there; the autoscaler DRAINs the replica itself),
        and dead members that left are forgotten entirely."""
        want = set(_split_addrs(addrs))
        dropped = 0
        with self._lock:
            for addr in want:
                if addr not in self._replicas:
                    self._replicas[addr] = "up"
            for addr in list(self._replicas):
                if addr in want:
                    continue
                if self._replicas[addr] == "dead":
                    del self._replicas[addr]
                elif self._replicas[addr] != "draining":
                    self._replicas[addr] = "draining"
                    dropped += self._unpin_addr_locked(addr)
        if dropped:
            self._c_unpinned.inc(dropped)

    def _reconcile_file(self) -> None:
        if not self._replicas_file:
            return
        try:
            with open(self._replicas_file) as f:
                addrs = [ln.strip() for ln in f if ln.strip()
                         and not ln.startswith("#")]
        except OSError:
            return          # missing/mid-rewrite: keep current view
        self.set_replicas(addrs)

    def _probe_dead(self) -> None:
        """One connect-probe per dead replica per refresh tick: a
        supervisor-restarted replica rejoins as soon as it binds."""
        with self._lock:
            dead = [a for a, st in self._replicas.items() if st == "dead"]
        for addr in dead:
            host, port = addr.rsplit(":", 1)
            try:
                s = socket.create_connection((host, int(port)),
                                             timeout=0.5)
                s.close()
            except OSError:
                continue
            with self._lock:
                if self._replicas.get(addr) == "dead":
                    self._replicas[addr] = "up"

    def _refresh_loop(self) -> None:
        while not self._stop.is_set():
            if self._on_tick is not None:
                self._on_tick()
            self._reconcile_file()
            self._probe_dead()
            if self._fleet_addr:
                try:
                    snap = _fleet.fetch_fleet(self._fleet_addr)
                    sig = _fleet.replica_signals(snap)
                except (MXNetError, OSError, ValueError):
                    sig = None      # collector blip: keep last signals
                if sig is not None:
                    with self._lock:
                        self._signals = sig
            with self._lock:
                up = sum(1 for st in self._replicas.values()
                         if st == "up")
                sessions = len(self._pins)
            self._g_up.set(up)
            self._g_sessions.set(sessions)
            self._stop.wait(timeout=self._refresh)

    def start(self) -> None:
        if self._refresh_thread is None:
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name="mx-router-refresh")
            self._refresh_thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._refresh_thread
        if t is not None:
            t.join(timeout=2)

    # -- routing ------------------------------------------------------------
    @staticmethod
    def _load_of(sig) -> float:
        """Queue-ish load from one replica's merged fleet signals; a
        replica the plane has not scraped yet scores 0 (a fresh spawn
        IS idle)."""
        if not sig:
            return 0.0
        return (float(sig.get("queue_rows", 0) or 0)
                + float(sig.get("decode_queue", 0) or 0)
                + float(sig.get("active_slots", 0) or 0))

    def _unpin_addr_locked(self, addr: str) -> int:
        stale = [cid for cid, a in self._pins.items() if a == addr]
        for cid in stale:
            del self._pins[cid]
        return len(stale)

    def route(self, cid: Optional[str], avoid=()) -> Optional[str]:
        """Pick the replica for one request: the session's pin when it
        is still ``up``, else the least-loaded up replica (round-robin
        rotation breaks ties), re-pinning the session there."""
        with self._lock:
            if cid is not None:
                pin = self._pins.get(cid)
                if pin and pin not in avoid and \
                        self._replicas.get(pin) == "up":
                    # LRU touch: an active session must not be evicted
                    self._pins[cid] = self._pins.pop(cid)
                    return pin
            up = [a for a, st in self._replicas.items()
                  if st == "up" and a not in avoid]
            if not up:
                return None
            self._rr += 1
            k = self._rr % len(up)
            order = up[k:] + up[:k]
            best = min(order,
                       key=lambda a: self._load_of(self._signals.get(a)))
            if cid is not None:
                self._pins.pop(cid, None)
                self._pins[cid] = best
                while len(self._pins) > self._pin_cap:
                    # oldest-touched pin pays the locality cost
                    oldest = next(iter(self._pins))
                    del self._pins[oldest]
            return best

    def unpin(self, cid: Optional[str]) -> None:
        if cid is None:
            return
        with self._lock:
            self._pins.pop(cid, None)

    def mark_dead(self, addr: str) -> None:
        """A failed forward: demote the replica and unpin its sessions
        (they fail over on their next request — involuntary retire)."""
        with self._lock:
            if addr in self._replicas:
                self._replicas[addr] = "dead"
            dropped = self._unpin_addr_locked(addr)
        if dropped:
            self._c_unpinned.inc(dropped)

    def mark_draining(self, addr: str) -> None:
        """The replica refused with "draining: ..." — believe it before
        the membership file catches up, and move its sessions."""
        with self._lock:
            if self._replicas.get(addr) == "up":
                self._replicas[addr] = "draining"
            dropped = self._unpin_addr_locked(addr)
        if dropped:
            self._c_unpinned.inc(dropped)

    def live_replicas(self, include_draining: bool = False) -> List[str]:
        with self._lock:
            return [a for a, st in self._replicas.items()
                    if st == "up" or (include_draining
                                      and st == "draining")]

    # -- router drain (mirrors the replica's) -------------------------------
    def drain(self, timeout=None) -> Dict:
        t = float(timeout if timeout is not None else
                  get_env("MX_ROUTER_DRAIN_TIMEOUT", 30.0, float)
                  or 30.0)
        with self._drain_lock:
            if self._drain_deadline is None:
                self._drain_deadline = _fault.Deadline(t)
            self._draining.set()
            remaining = self._drain_deadline.remaining()
        with self._lock:
            sessions = len(self._pins)
        return {"status": "draining", "deadline_seconds": remaining,
                "sessions": sessions}

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain_expired(self) -> bool:
        with self._drain_lock:
            dl = self._drain_deadline
        return dl is not None and dl.expired()

    def admits(self, cid: Optional[str]) -> bool:
        """While draining, only already-pinned sessions flow."""
        if not self._draining.is_set():
            return True
        if cid is None:
            return False
        with self._lock:
            return cid in self._pins

    # -- local verbs --------------------------------------------------------
    def health(self) -> Dict:
        reg = _telemetry.registry
        with self._lock:
            reps = dict(self._replicas)
            sessions = len(self._pins)
        return {
            "status": "draining" if self._draining.is_set()
            else "routing",
            "role": "router",
            "replicas": reps,
            "up": sum(1 for st in reps.values() if st == "up"),
            "sessions": sessions,
            "requests": reg.value("router.requests"),
            "failovers": reg.value("router.failovers"),
            "spills": reg.value("router.spills"),
            "pid": os.getpid(),
        }

    def metrics(self, fmt: str = "prometheus"):
        reg = _telemetry.registry
        text = reg.to_json(indent=1) if fmt == "json" \
            else reg.to_prometheus()
        return encode_text(text)

    # -- forwarding ---------------------------------------------------------
    def _upstream(self, ups: Dict[str, socket.socket],
                  addr: str) -> socket.socket:
        s = ups.get(addr)
        if s is not None:
            return s
        host, port = addr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=5)
        s.settimeout(self._timeout)
        ups[addr] = s
        return s

    @staticmethod
    def _drop_upstream(ups: Dict[str, socket.socket], addr: str) -> None:
        s = ups.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def forward(self, env, cid: Optional[str], ups: Dict, client_sock):
        """Forward one client envelope verbatim with failover + spill.

        Connection failures mark the replica dead, unpin its sessions,
        and replay the SAME envelope on the next pick under the
        jittered :class:`~mxnet_tpu_torch.fault.RetryPolicy` schedule;
        overloaded/draining refusals spill to the next-best replica
        (each replica tried at most once per request).  STREAM frames
        pass through to the client unmodified."""
        policy = _fault.RetryPolicy.from_env()
        start = _fault.now()
        attempt = 0
        refused = set()
        last_refusal = None
        while True:
            if attempt:
                d = policy.delay(attempt - 1)
                if _fault.now() + d - start > policy.deadline:
                    break
                _fault.sleep(d)
            attempt += 1
            addr = self.route(cid, avoid=refused)
            if addr is None:
                if refused and last_refusal is not None:
                    # every live replica refused: hand the refusal back
                    # (the client backs off / reports Overloaded)
                    return last_refusal
                policy.note(MXNetError("no live replicas"))
                continue
            try:
                up = self._upstream(ups, addr)
                _fault.fire(
                    "router.forward",
                    on_close=lambda a=addr: self._drop_upstream(ups, a))
                send_msg(up, env)
                while True:
                    resp = recv_msg(up, timeout=self._timeout)
                    if isinstance(resp, tuple) and resp and \
                            resp[0] == "STREAM":
                        send_msg(client_sock, resp)   # passthrough
                        continue
                    break
            except (ConnectionError, OSError, TimeoutError) as e:
                self._drop_upstream(ups, addr)
                self.mark_dead(addr)
                policy.note(e)
                self._c_failovers.inc()
                continue
            ok, payload = resp
            if (not ok and isinstance(payload, str)
                    and payload.startswith(("overloaded", "draining"))):
                if payload.startswith("draining"):
                    self.mark_draining(addr)
                refused.add(addr)
                last_refusal = resp
                self.unpin(cid)
                if self.live_replicas():
                    self._c_spills.inc()
                    continue
                return resp
            return resp
        return False, (
            "router: no live replica answered for %.3gs "
            "(MX_KVSTORE_RETRY_DEADLINE); last error: %s"
            % (policy.deadline, policy.last_error))

    def fan_out(self, env, ups: Dict, verb_timeout: Optional[float] = None):
        """SWAP/STOP fan-out: the client's envelope goes verbatim to
        EVERY live replica (draining included — a retiring replica
        finishing in-flight work should still flip models / stop).
        Returns the per-addr ``(ok, payload)`` map."""
        results: Dict[str, Any] = {}
        for addr in self.live_replicas(include_draining=True):
            try:
                up = self._upstream(ups, addr)
                if verb_timeout is not None:
                    up.settimeout(verb_timeout)
                send_msg(up, env)
                results[addr] = recv_msg(
                    up, timeout=verb_timeout or self._timeout)
            except (ConnectionError, OSError, TimeoutError) as e:
                self._drop_upstream(ups, addr)
                self.mark_dead(addr)
                results[addr] = (False, "unreachable: %s" % e)
            finally:
                if verb_timeout is not None and addr in ups:
                    ups[addr].settimeout(self._timeout)
        return results

    def handle_local(self, cmd: str, inner):
        """Verbs the ROUTER answers itself; None = not local."""
        if cmd == "HEALTH":
            return True, self.health()
        if cmd == "METRICS":
            fmt = inner[1] if len(inner) > 1 else "prometheus"
            return True, self.metrics(fmt)
        if cmd == "DRAIN":
            timeout = inner[1] if len(inner) > 1 else None
            return True, self.drain(timeout)
        if cmd == "STREAM":
            return False, ("STREAM is a server-to-client token frame, "
                           "not a request verb")
        return None


def serve_router_forever(port: int,
                         router: Optional[ServeRouter] = None,
                         ready_file: Optional[str] = None,
                         stop_event: Optional[threading.Event] = None,
                         abort_event: Optional[threading.Event] = None
                         ) -> None:
    """Run the router's accept loop (same skeleton as the replica's
    ``serve_forever``: threaded handlers, drain watch, abort = sever
    everything immediately like a kill)."""
    rt = router or ServeRouter()
    rt.start()
    stop_event = stop_event or threading.Event()
    abort_event = abort_event or threading.Event()
    inflight_count = [0]
    inflight_lock = threading.Lock()
    conns = set()
    conns_lock = threading.Lock()

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
            # upstream sockets are OWNED by this handler thread: one
            # client connection maps to at most one socket per replica,
            # and a streaming forward never interleaves with another
            # thread's frames
            ups: Dict[str, socket.socket] = {}
            try:
                while not abort_event.is_set():
                    try:
                        msg = recv_msg(self.request, idle_block=True)
                    except (ConnectionError, OSError, TimeoutError):
                        return
                    with inflight_lock:
                        inflight_count[0] += 1
                    try:
                        _fault.fire("router.request")
                        reply = self._dispatch(msg, ups)
                    except SystemExit:   # injected crash: die mid-route
                        os._exit(17)
                    except _fault.FaultError as e:
                        reply = (False, str(e))
                    finally:
                        with inflight_lock:
                            inflight_count[0] -= 1
                    try:
                        send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        return
                    inner = msg[3] if isinstance(msg, tuple) and msg \
                        and msg[0] == "SEQ" else msg
                    if inner and inner[0] == "STOP":
                        stop_event.set()
                        return
            finally:
                for a in list(ups):
                    ServeRouter._drop_upstream(ups, a)

        def _dispatch(self, msg, ups):
            rt._c_requests.inc()
            if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
                cid, inner = msg[1], msg[3]
            else:
                cid, inner = None, msg
            cmd = inner[0] if isinstance(inner, tuple) and inner \
                else None
            local = rt.handle_local(cmd, inner) if cmd else None
            if local is not None:
                return local
            if cmd == "STOP":
                # stop the FLEET: every replica best-effort (a replica
                # already gone must not cost a full recv timeout), then
                # the router itself (the caller sees one clean reply)
                rt.fan_out(msg, ups, verb_timeout=1.0)
                return True, "stopping"
            if cmd == "SWAP":
                results = rt.fan_out(msg, ups)
                versions = []
                for addr, resp in sorted(results.items()):
                    r_ok, r_payload = resp
                    if not r_ok:
                        return False, ("swap failed on %s: %s"
                                       % (addr, r_payload))
                    versions.append(int(r_payload))
                if not versions:
                    return False, "swap failed: no live replicas"
                return True, max(versions)
            if cmd in ("PREDICT", "GENERATE"):
                if not rt.admits(cid):
                    return False, ("draining: router is retiring, not "
                                   "admitting new sessions")
                with _telemetry.rpc_span("router.%s" % cmd):
                    return rt.forward(msg, cid, ups, self.request)
            return False, "unknown route command %r" % (cmd,)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True
        # a burst of clients connects at once: the default backlog of 5
        # would drop handshakes into a one-second retransmit
        request_queue_size = 128

    def _sever():
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

    try:
        with Server(("0.0.0.0", port), Handler) as srv:
            if ready_file:
                with open(ready_file, "w") as f:
                    f.write("%d" % srv.server_address[1])
            t = threading.Thread(target=srv.serve_forever, daemon=True,
                                 name="mx-router-accept")
            t.start()
            drain_overrun = False
            while not stop_event.is_set() and not abort_event.is_set():
                stop_event.wait(timeout=0.1)
                if rt.draining:
                    with inflight_lock:
                        wire_busy = inflight_count[0]
                    if wire_busy == 0:
                        break               # drained clean: exit 0
                    if rt.drain_expired():
                        drain_overrun = True
                        break
            if drain_overrun or abort_event.is_set():
                # stragglers (or a simulated kill): sever with NO
                # replies — clients replay through their retry policy
                _sever()
                srv.shutdown()
                return
            srv.shutdown()                  # stop accepting
            wire_deadline = _fault.Deadline(5.0)
            while not wire_deadline.expired():
                with inflight_lock:
                    if inflight_count[0] == 0:
                        break
                _fault.sleep(0.02)
            _sever()
    finally:
        rt.stop()


def main(argv=None) -> int:
    import argparse
    import sys
    import time

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serve.router",
        description="serving fleet front-tier: decode-aware session "
                    "router (forwards the serve wire surface verbatim "
                    "across a dynamic replica set)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--replicas", default=None,
                    help="comma-separated static replica addrs "
                         "(host:port,...)")
    ap.add_argument("--replicas-file", default=None,
                    help="file with one replica addr per line, "
                         "re-read every refresh tick (the autoscaler "
                         "rewrites it as the fleet resizes)")
    ap.add_argument("--fleet", default=None,
                    help="fleet collector addr for merged load signals")
    ap.add_argument("--refresh", type=float, default=None,
                    help="membership/signal refresh interval seconds")
    ap.add_argument("--ready-file", default=None,
                    help="write the bound port here once accepting")
    args = ap.parse_args(argv)

    port = args.port
    if port is None:
        port = int(get_env("MX_ROUTER_PORT", 9800, int) or 9800)

    # heartbeat-file liveness under a launcher's --hang-timeout:
    # beaten from the refresh loop, throttled, traffic-independent
    tick = None
    hb_path = get_env("MX_HEARTBEAT_FILE", "")
    if hb_path:
        from ..health import Heartbeat
        hb = Heartbeat(hb_path)
        last = [0.0]

        def tick():
            now = time.monotonic()
            if now - last[0] >= 1.0:
                last[0] = now
                hb.beat(0, 0)

        hb.beat(0, 0)

    rt = ServeRouter(replicas=args.replicas,
                     replicas_file=args.replicas_file,
                     fleet_addr=args.fleet, refresh=args.refresh,
                     on_tick=tick)
    n = len(rt.live_replicas(include_draining=True))
    print("router: fronting %d replica(s)%s%s, port %d"
          % (n,
             " file=%s" % rt._replicas_file if rt._replicas_file else "",
             " fleet=%s" % rt._fleet_addr if rt._fleet_addr else "",
             port),
          file=sys.stderr, flush=True)
    serve_router_forever(port=port, router=rt,
                         ready_file=args.ready_file)
    print("router: stopped", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
