"""Serving RPC front: PREDICT / GENERATE / HEALTH / STOP over the
length-prefixed wire.

Counterpart of ``mxnet_tpu/serve/server.py`` for the verbs of the serving
slices.  Requests may be wrapped ``("SEQ", client_id, seq, inner[,
trace])``; PREDICT and GENERATE under that envelope are exactly-once: a
client that lost a reply replays the same ``(client_id, seq)`` and is
answered from the replay cache instead of dispatching (or generating)
again.  Tensors cross as ``NPX`` payloads; tokens as plain int lists.

Verbs::

  PREDICT  (PREDICT, [npx, ...])          -> (True, (version, [npx, ...]))
  GENERATE (GENERATE, [tok, ...], opts)   -> (True, (version, [tok, ...]))
           autoregressive decode through the continuous-batching engine;
           opts = {"max_tokens": N, "stream": bool, "eos": tok,
           "model": name}.  With stream=True the terminal reply is
           preceded by zero or more ("STREAM", offset, [tok, ...]) frames
           as tokens are harvested (at least once across a failover; the
           offset lets the client dedupe); the terminal reply is
           exactly-once through the replay cache.
  HEALTH   (HEALTH,)                      -> (True, {status, version, ...})
  STOP     (STOP,)                        -> (True, "stopping")

Overload is a normal reply, ``(False, "overloaded: ...")``, so a client can
tell load shedding from a dead replica; a draining replica refuses new work
the same way (``(False, "draining: ...")``).  SWAP, DRAIN, METRICS, the
router and tracing come with later slices.
"""
from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Sequence

from ..base import MXNetError, get_env
from .. import fault as _fault
from .. import telemetry as _telemetry
from ..kvstore.wire_codec import (WireCodecError, decode_array, encode_array,
                                  recv_msg, send_msg)
from ..kvstore.wire_verbs import declare_verbs
from .batcher import Batcher, Overloaded, result_timeout
from .servable import ModelHost

__all__ = ["ServeServer", "serve_forever", "WIRE_VERBS"]

# The serving wire surface of the port, declared as the reference declares
# its own (the rows of the verbs the port serves).
WIRE_VERBS = declare_verbs("serve", {
    # one PREDICT = one dispatch, even replayed
    "PREDICT": {"semantics": "replayable", "replay": "cached",
                "codec": "array", "mutates": ("engine",)},
    # one GENERATE = one generated sequence: a replayed completed sequence
    # answers from the cache; fresh streaming runs emit STREAM frames
    # ahead of the terminal reply
    "GENERATE": {"semantics": "replayable", "replay": "cached",
                 "codec": None, "mutates": ("engine",),
                 "stream": "STREAM"},
    # the server->client token frame of a streaming GENERATE, not a
    # request verb: a client sending it gets an explicit error
    "STREAM": {"semantics": "idempotent", "replay": "bypass",
               "codec": None, "mutates": ()},
    "HEALTH": {"semantics": "idempotent", "replay": "bypass",
               "codec": None, "mutates": ()},
    "STOP": {"semantics": "idempotent", "replay": "bypass",
             "codec": None, "mutates": ()},
}, role="server", durable=False, handler="ServeServer.handle")


class ServeServer:
    """Verb handlers and the replay cache over one (ModelHost, Batcher),
    plus an optional continuous-batching decode engine (``decode=``, a
    :class:`~mxnet_tpu_torch.serve.decode.DecodeBatcher`) behind
    GENERATE."""

    _CACHED = ("PREDICT", "GENERATE")

    def __init__(self, host: Optional[ModelHost] = None,
                 batcher: Optional[Batcher] = None, decode=None,
                 **batcher_kw):
        self.host = host or ModelHost()
        self.batcher = batcher or Batcher(self.host, **batcher_kw)
        self.decode = decode
        # a decode engine joins the host's engine map, where GENERATE's
        # model routing looks a named engine up
        if decode is not None:
            self.host.engines.setdefault(decode.servable.name, decode)
        # client_id -> [seq, done Event, reply]; dict order is recency
        # order (every touch re-inserts), and over the cap the least
        # recently touched resolved entries go
        self._replay_cap = max(1, get_env("MX_SERVE_REPLAY_CAP", 512, int)
                               or 1)
        self._replay: Dict[str, list] = {}
        self._replay_lock = threading.Lock()
        self.replays = 0
        self._c_replays = _telemetry.registry.counter(
            "serve.server_replays",
            doc="PREDICT/GENERATE requests answered from the "
                "exactly-once replay cache")
        # set while the replica retires: fresh PREDICT/GENERATE are
        # refused with "draining: ..." (the DRAIN verb comes with a later
        # slice)
        self._draining = threading.Event()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # -- envelope -----------------------------------------------------------
    def handle_request(self, msg, stream_fn=None):
        """``stream_fn(offset, tokens)``, given by the socket handler,
        sends one ("STREAM", offset, tokens) frame ahead of the terminal
        reply; only a fresh streaming GENERATE uses it (a replay answers
        terminally from the cache)."""
        if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
            cid, seq, inner = msg[1], msg[2], msg[3]
            if inner and inner[0] in self._CACHED:
                return self._handle_seq(cid, seq, inner, stream_fn)
            return self.handle(inner)
        return self.handle(msg, stream_fn=stream_fn)

    def _handle_seq(self, cid, seq, inner, stream_fn=None):
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
            self._c_replays.inc()
            if not dup[1].wait(timeout=result_timeout(None) + 5):
                return False, "replayed request %s still in flight" % seq
            return dup[2]
        try:
            resp = self.handle(inner, stream_fn=stream_fn)
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
    def handle(self, msg, stream_fn=None):
        cmd = msg[0] if msg else None
        if cmd == "PREDICT":
            return self._predict(msg[1])
        if cmd == "GENERATE":
            opts = msg[2] if len(msg) > 2 else {}
            return self._generate(msg[1], opts or {}, stream_fn)
        if cmd == "STREAM":
            return False, ("STREAM is a server-to-client token frame, "
                           "not a request verb")
        if cmd == "HEALTH":
            return True, self.health()
        if cmd == "STOP":
            return True, "stopping"
        return False, "unknown serve command %r" % (cmd,)

    def _predict(self, payload: Sequence):
        if self._draining.is_set():
            return False, ("draining: replica is retiring, not "
                           "admitting new work")
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

    def _generate(self, prompt, opts, stream_fn):
        """GENERATE: submit into the decode engine, stream token chunks
        when asked, answer the whole sequence.  Every failure is a normal
        (False, reason) reply: a severed connection would make the client
        replay a poison request on every replica."""
        if self._draining.is_set():
            return False, ("draining: replica is retiring, not "
                           "admitting new sessions")
        if self.decode is None:
            return False, "no decode engine deployed on this replica"
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            return False, "bad GENERATE payload: prompt must be token ids"
        # model routing: the default engine answers unnamed requests (and
        # its own name), other names resolve through host.engines
        model = opts.get("model")
        eng = self.decode
        if model is not None and model != self.decode.servable.name:
            cand = self.host.engines.get(model)
            if cand is None or isinstance(cand, Batcher) or \
                    not hasattr(cand, "submit"):
                return False, ("unknown model %r (decode engines: %s)"
                               % (model, self.decode.servable.name))
            eng = cand
        try:
            pending = eng.submit(prompt, max_new=opts.get("max_tokens"),
                                 eos_id=opts.get("eos"))
        except Overloaded as e:
            return False, "overloaded: %s" % e
        except MXNetError as e:
            return False, str(e)
        # stay inside the client's receive window, so a slow generation
        # sheds with an explicit reply, not a dead socket
        deadline = _fault.Deadline(max(1.0, result_timeout(None) - 2.0))
        try:
            if opts.get("stream") and stream_fn is not None:
                sent = 0
                while not deadline.expired():
                    chunk, done = pending.wait_new(sent, timeout=0.25)
                    if chunk:
                        stream_fn(sent, [int(t) for t in chunk])
                        sent += len(chunk)
                    if done:
                        break
            tokens = pending.result(timeout=max(0.001,
                                                deadline.remaining()))
        except Exception as e:
            return False, "generate failed: %s: %s" % (type(e).__name__,
                                                       e)
        return True, (eng.version, [int(t) for t in tokens])

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
        if self.decode is not None:
            # a decode-only replica is serving with an empty host
            reg = _telemetry.registry
            dsv = self.decode.servable
            status["status"] = "serving"
            status["decode"] = {
                "model": dsv.name, "version": dsv.version,
                "engine": getattr(dsv, "engine", "flat"),
                "slots": dsv.config.slots,
                "active": self.decode.active_count(),
                "queued": self.decode.queue_depth(),
                "slot_buckets": list(dsv.config.slot_buckets),
                "prompt_buckets": list(dsv.config.prompt_buckets),
                "retraces": dsv.retraces,
                "tokens": reg.value("serve.decode.tokens"),
                "sequences": reg.value("serve.decode.sequences"),
            }
            page_stats = self.decode.page_stats()
            if page_stats is not None:
                status["decode"].update(page_stats)
        if self._draining.is_set():
            status["status"] = "draining"
        status.update(self.batcher.stats())
        status["pid"] = os.getpid()
        return status

    def close(self) -> None:
        self.batcher.close()
        if self.decode is not None:
            self.decode.close()


def serve_forever(port: Optional[int] = None,
                  state: Optional[ServeServer] = None,
                  stop_event: Optional[threading.Event] = None,
                  bind: str = "0.0.0.0",
                  ready_event: Optional[threading.Event] = None,
                  abort_event: Optional[threading.Event] = None) -> None:
    """Run one replica's accept loop: one thread per connection, until a
    STOP verb or ``stop_event``.  On the way out it stops accepting, waits
    (bounded) for in-flight requests, closes the engines and severs the
    remaining connections.  ``ready_event`` is set once the port accepts.
    ``abort_event`` is the crash of an in-process test: setting it severs
    the listener and every live connection at once, with no replies, which
    is what a killed replica looks like to its clients."""
    port = int(port if port is not None else get_env("MX_SERVE_PORT", 9700,
                                                     int))
    server_state = state or ServeServer()
    stop_event = stop_event or threading.Event()
    abort_event = abort_event or threading.Event()
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
            sock = self.request

            def stream_fn(offset, tokens):
                # a streaming GENERATE's token chunks ride ahead of its
                # terminal reply on the same connection
                send_msg(sock, ("STREAM", offset, tokens))

            while not stop_event.is_set() and not abort_event.is_set():
                try:
                    msg = recv_msg(sock, idle_block=True)
                except (ConnectionError, OSError, TimeoutError):
                    return
                with inflight_lock:
                    inflight[0] += 1
                try:
                    ok, payload = server_state.handle_request(
                        msg, stream_fn=stream_fn)
                except WireCodecError as e:
                    ok, payload = False, str(e)
                finally:
                    with inflight_lock:
                        inflight[0] -= 1
                if abort_event.is_set():
                    return
                try:
                    send_msg(sock, (ok, payload))
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

    with Server((bind, port), Handler) as srv:
        accept = threading.Thread(target=srv.serve_forever, daemon=True,
                                  name="mx-serve-accept")
        accept.start()
        if ready_event is not None:
            ready_event.set()
        while not stop_event.is_set() and not abort_event.is_set():
            stop_event.wait(timeout=0.1)
        if abort_event.is_set():
            # a simulated crash: live connections die first (no drain, no
            # replies), then the listener stops
            _sever()
            srv.shutdown()
            server_state.close()
            accept.join(timeout=5.0)
            return
        srv.shutdown()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with inflight_lock:
                if inflight[0] == 0:
                    break
            time.sleep(0.02)
        server_state.close()
        _sever()
        accept.join(timeout=5.0)
