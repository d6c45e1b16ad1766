"""Serving RPC front: PREDICT / HEALTH / STOP over the length-prefixed
wire.

Counterpart of ``mxnet_tpu/serve/server.py`` for the verbs of the serving
slice.  Requests may be wrapped ``("SEQ", client_id, seq, inner[, trace])``;
PREDICT under that envelope is exactly-once: a client that lost a reply
replays the same ``(client_id, seq)`` and is answered from the replay
cache instead of dispatching again.  Tensors cross as ``NPX`` payloads.

Verbs::

  PREDICT  (PREDICT, [npx, ...])  -> (True, (version, [npx, ...]))
  HEALTH   (HEALTH,)              -> (True, {status, version, ...})
  STOP     (STOP,)                -> (True, "stopping")

Overload is a normal reply, ``(False, "overloaded: ...")``, so a client can
tell load shedding from a dead replica.  GENERATE, SWAP, DRAIN, METRICS,
the router and tracing come with later slices.
"""
from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Sequence

from ..base import MXNetError, get_env
from ..kvstore.wire_codec import (WireCodecError, decode_array, encode_array,
                                  recv_msg, send_msg)
from .batcher import Batcher, Overloaded, result_timeout
from .servable import ModelHost

__all__ = ["ServeServer", "serve_forever"]


class ServeServer:
    """Verb handlers and the replay cache over one (ModelHost, Batcher)."""

    _CACHED = ("PREDICT",)

    def __init__(self, host: Optional[ModelHost] = None,
                 batcher: Optional[Batcher] = None, **batcher_kw):
        self.host = host or ModelHost()
        self.batcher = batcher or Batcher(self.host, **batcher_kw)
        # client_id -> [seq, done Event, reply]; dict order is recency
        # order (every touch re-inserts), and over the cap the least
        # recently touched resolved entries go
        self._replay_cap = max(1, get_env("MX_SERVE_REPLAY_CAP", 512, int)
                               or 1)
        self._replay: Dict[str, list] = {}
        self._replay_lock = threading.Lock()
        self.replays = 0

    # -- envelope -----------------------------------------------------------
    def handle_request(self, msg):
        if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
            cid, seq, inner = msg[1], msg[2], msg[3]
            if inner and inner[0] in self._CACHED:
                return self._handle_seq(cid, seq, inner)
            return self.handle(inner)
        return self.handle(msg)

    def _handle_seq(self, cid, seq, inner):
        with self._replay_lock:
            ent = self._replay.get(cid)
            if ent is not None and seq == ent[0]:
                dup = ent
                self._replay[cid] = self._replay.pop(cid)
            elif ent is not None and seq < ent[0]:
                return False, ("stale request seq %s (server already at %s)"
                               % (seq, ent[0]))
            else:
                dup = None
                ent = [seq, threading.Event(), None]
                self._replay.pop(cid, None)
                self._replay[cid] = ent
                if len(self._replay) > self._replay_cap:
                    self._evict_replay_locked()
        if dup is not None:
            with self._replay_lock:
                self.replays += 1
            if not dup[1].wait(timeout=result_timeout(None) + 5):
                return False, "replayed request %s still in flight" % seq
            return dup[2]
        try:
            resp = self.handle(inner)
        except BaseException as e:
            ent[2] = (False, "serve error handling %r: %s" % (inner[0], e))
            ent[1].set()
            raise
        ent[2] = resp
        ent[1].set()
        return resp

    def _evict_replay_locked(self) -> None:
        for cid in list(self._replay):
            if len(self._replay) <= self._replay_cap:
                break
            if self._replay[cid][1].is_set():
                del self._replay[cid]

    # -- verbs --------------------------------------------------------------
    def handle(self, msg):
        cmd = msg[0] if msg else None
        if cmd == "PREDICT":
            return self._predict(msg[1])
        if cmd == "HEALTH":
            return True, self.health()
        if cmd == "STOP":
            return True, "stopping"
        return False, "unknown serve command %r" % (cmd,)

    def _predict(self, payload: Sequence):
        try:
            arrays = [decode_array(t) for t in payload]
        except (TypeError, ValueError) as e:
            return False, "bad PREDICT payload: %s" % e
        try:
            pending = self.batcher.submit(arrays)
        except Overloaded as e:
            return False, "overloaded: %s" % e
        except MXNetError as e:
            return False, str(e)
        try:
            version, outs = pending.result(
                timeout=max(1.0, result_timeout(None) - 2.0))
        except Exception as e:
            return False, "predict failed: %s: %s" % (type(e).__name__, e)
        return True, (version, [encode_array(o) for o in outs])

    def health(self) -> Dict:
        try:
            sv = self.host.active()
            status: Dict = {"status": "serving", "version": sv.version,
                            "model": sv.name, "device": str(sv.device),
                            "buckets": list(sv.buckets.sizes),
                            "bucket_hits": sv.bucket_hits,
                            "batches": sv.batches}
        except MXNetError:
            status = {"status": "empty", "version": 0}
        status.update(self.batcher.stats())
        status["pid"] = os.getpid()
        return status

    def close(self) -> None:
        self.batcher.close()


def serve_forever(port: Optional[int] = None,
                  state: Optional[ServeServer] = None,
                  stop_event: Optional[threading.Event] = None,
                  bind: str = "0.0.0.0",
                  ready_event: Optional[threading.Event] = None) -> None:
    """Run one replica's accept loop: one thread per connection, until a
    STOP verb or ``stop_event``.  On the way out it stops accepting, waits
    (bounded) for in-flight requests, closes the batcher and severs the
    remaining connections.  ``ready_event`` is set once the port accepts."""
    port = int(port if port is not None else get_env("MX_SERVE_PORT", 9700,
                                                     int))
    server_state = state or ServeServer()
    stop_event = stop_event or threading.Event()
    inflight = [0]
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
            while not stop_event.is_set():
                try:
                    msg = recv_msg(self.request, idle_block=True)
                except (ConnectionError, OSError, TimeoutError):
                    return
                with inflight_lock:
                    inflight[0] += 1
                try:
                    ok, payload = server_state.handle_request(msg)
                except WireCodecError as e:
                    ok, payload = False, str(e)
                finally:
                    with inflight_lock:
                        inflight[0] -= 1
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
        # many clients may connect at once while the accept thread waits
        # for the interpreter lock; the default backlog of 5 would drop
        # their handshakes into a one-second retransmit
        request_queue_size = 128

    with Server((bind, port), Handler) as srv:
        accept = threading.Thread(target=srv.serve_forever, daemon=True,
                                  name="mx-serve-accept")
        accept.start()
        if ready_event is not None:
            ready_event.set()
        stop_event.wait()
        srv.shutdown()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with inflight_lock:
                if inflight[0] == 0:
                    break
            time.sleep(0.02)
        server_state.close()
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
        accept.join(timeout=5.0)
