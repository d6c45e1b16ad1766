"""Serving RPC front: PREDICT / GENERATE / HEALTH / METRICS / SWAP /
DRAIN / STOP over the length-prefixed wire.

Counterpart of ``mxnet_tpu/serve/server.py``.  Requests may be wrapped
``("SEQ", client_id, seq, inner[, (trace_id, span_id)])``; PREDICT, SWAP
and GENERATE under that envelope are exactly-once: a client that lost a
reply replays the same ``(client_id, seq)`` and is answered from the
replay cache instead of dispatching (or generating, or flipping) again.
Tensors cross as ``NPX`` payloads; tokens as plain int lists.

Verbs::

  PREDICT  (PREDICT, [npx, ...][, model]) -> (True, (version, [npx, ...]))
           ``model`` names a co-hosted model (default: the first
           deployed)
  GENERATE (GENERATE, [tok, ...], opts)   -> (True, (version, [tok, ...]))
           autoregressive decode through the continuous-batching engine;
           opts = {"max_tokens": N, "stream": bool, "eos": tok,
           "model": name}.  With stream=True the terminal reply is
           preceded by zero or more ("STREAM", offset, [tok, ...]) frames
           as tokens are harvested (at least once across a failover; the
           offset lets the client dedupe); the terminal reply is
           exactly-once through the replay cache.
  HEALTH   (HEALTH,)                      -> (True, {status, version, ...})
  METRICS  (METRICS[, fmt])               -> (True, (TXT, utf8-bytes)):
           the live Prometheus text exposition (fmt='json': the JSON
           registry snapshot), with ``serve.active_version{model}``
  SWAP     (SWAP, prefix, epoch, inputs)  -> (True, new_version): load an
           exported checkpoint as the default model's next version, warm,
           flip, drain; refused in-band as "budget: ..." (the packer) or
           "swap failed: ..." (anything else; the old version stays)
  DRAIN    (DRAIN[, timeout])             -> (True, {status, ...}):
           retirement: fresh PREDICT/GENERATE are refused "draining: ...",
           in-flight work finishes, then the serve loop exits; past the
           deadline (``timeout`` or MX_SERVE_DRAIN_TIMEOUT; a repeated
           DRAIN keeps the first) the stragglers' connections are severed
           with no reply, so their clients fail over
  STOP     (STOP,)                        -> (True, "stopping")

Overload is a normal reply, ``(False, "overloaded: ...")``, so a client can
tell load shedding from a dead replica; a draining replica refuses new work
the same way.  The handler opens ``serve.server.<CMD>`` as a child of the
client's wire-propagated span and hands its context to the batcher, whose
``serve_dispatch`` span links every member request.  Every request passes
the ``serve.request`` fault site (a crash fault kills the replica
mid-request).
"""
from __future__ import annotations

import os
import socket
import socketserver
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ..base import MXNetError, get_env
from .. import fault as _fault
from .. import telemetry as _telemetry
from ..kvstore.wire_codec import (WireCodecError, decode_array, encode_array,
                                  encode_text, recv_msg, send_msg)
from ..kvstore.wire_verbs import declare_verbs
from .batcher import Batcher, Overloaded, result_timeout
from .servable import BudgetExceeded, ModelHost, Servable

__all__ = ["ServeServer", "serve_forever", "WIRE_VERBS"]

#: serve_forever loops answering in this process (a verifier run,
#: ``programs.isolated``, refuses to start while one does)
_serving = [0]
_serving_lock = threading.Lock()


def serving() -> int:
    """How many ``serve_forever`` loops answer in this process."""
    with _serving_lock:
        return _serving[0]


class _Answering:
    def __enter__(self):
        with _serving_lock:
            _serving[0] += 1

    def __exit__(self, *exc):
        with _serving_lock:
            _serving[0] -= 1
        return False

# The serving wire surface of the port, declared as the reference declares
# its own.  The router forwards client envelopes verbatim, so these replay
# semantics hold end to end through it.
WIRE_VERBS = declare_verbs("serve", {
    # one PREDICT = one dispatch, even replayed; one SWAP = one flip
    "PREDICT": {"semantics": "replayable", "replay": "cached",
                "codec": "array", "mutates": ("engine",)},
    "SWAP": {"semantics": "replayable", "replay": "cached",
             "codec": None, "mutates": ("model",)},
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
    "METRICS": {"semantics": "idempotent", "replay": "bypass",
                "codec": "text", "mutates": ()},
    "STOP": {"semantics": "idempotent", "replay": "bypass",
             "codec": None, "mutates": ()},
    # re-asserting a draining replica is a no-op, so a retried DRAIN is
    # harmless
    "DRAIN": {"semantics": "idempotent", "replay": "bypass",
              "codec": None, "mutates": ("lifecycle",)},
}, role="server", durable=False, handler="ServeServer.handle")


class ServeServer:
    """Verb handlers and the replay cache over one (ModelHost, Batcher),
    plus an optional continuous-batching decode engine (``decode=``, a
    :class:`~mxnet_tpu_torch.serve.decode.DecodeBatcher`) behind
    GENERATE."""

    _CACHED = ("PREDICT", "SWAP", "GENERATE")

    def __init__(self, host: Optional[ModelHost] = None,
                 batcher: Optional[Batcher] = None, decode=None,
                 **batcher_kw):
        self.host = host or ModelHost()
        self.batcher = batcher or Batcher(self.host, **batcher_kw)
        self.decode = decode
        # a decode engine joins the host's engine map, where GENERATE's
        # model routing and the HBM packer find it
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
            doc="PREDICT/SWAP/GENERATE requests answered from the "
                "exactly-once replay cache")
        self._c_evicted = _telemetry.registry.counter(
            "serve.replay_evicted",
            doc="replay-cache entries dropped by the per-client LRU bound "
                "(MX_SERVE_REPLAY_CAP)")
        # retirement: once set, fresh PREDICT/GENERATE are refused with
        # "draining: ..." while in-flight work finishes before the
        # deadline
        self._draining = threading.Event()
        self._drain_lock = threading.Lock()
        self._drain_deadline: Optional[_fault.Deadline] = None

    # -- several models (a start-up path, never a verb branch) -------------
    def add_model(self, servable: Servable, example=None,
                  **batcher_kw) -> Servable:
        """Deploy one more named model on this replica: warm and budget
        admission through ``ModelHost.deploy`` (raises
        :class:`BudgetExceeded`, keeping nothing), then give a model that
        is not the default its own micro-batcher in ``host.engines``, so
        PREDICTs naming it coalesce apart from the default's."""
        sv = self.host.deploy(servable, example=example)
        if sv.name != self.host.default_model and \
                sv.name not in self.host.engines:
            self.host.engines[sv.name] = Batcher(self.host, model=sv.name,
                                                 **batcher_kw)
        return sv

    # -- envelope -----------------------------------------------------------
    def handle_request(self, msg, stream_fn=None):
        """``stream_fn(offset, tokens)``, given by the socket handler,
        sends one ("STREAM", offset, tokens) frame ahead of the terminal
        reply; only a fresh streaming GENERATE uses it (a replay answers
        terminally from the cache)."""
        if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
            cid, seq, inner = msg[1], msg[2], msg[3]
            tctx = msg[4] if len(msg) > 4 else None
            cmd = inner[0] if inner else None
            with _telemetry.rpc_span(
                    "serve.server.%s" % cmd,
                    trace_id=tctx[0] if tctx else None,
                    parent_id=tctx[1] if tctx else None) as span:
                return self._handle_seq(cid, seq, inner, cmd, span,
                                        stream_fn=stream_fn)
        return self.handle(msg, stream_fn=stream_fn)

    def _handle_seq(self, cid, seq, inner, cmd, span, stream_fn=None):
        if cmd not in self._CACHED:
            return self.handle(inner, span=span)
        with self._replay_lock:
            ent = self._replay.get(cid)
            if ent is not None and seq == ent[0]:
                dup = ent
                self._replay[cid] = self._replay.pop(cid)
            elif ent is not None and seq < ent[0]:
                span.event("stale", seq=seq, server_at=ent[0])
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
            span.event("replay", seq=seq)
            with self._replay_lock:
                self.replays += 1
            self._c_replays.inc()
            if not dup[1].wait(timeout=result_timeout(None) + 5):
                return False, "replayed request %s still in flight" % seq
            return dup[2]
        try:
            resp = self.handle(inner, span=span, stream_fn=stream_fn)
        except BaseException as e:
            ent[2] = (False, "serve error handling %r: %s" % (cmd, e))
            ent[1].set()
            raise
        ent[2] = resp
        ent[1].set()
        return resp

    def _evict_replay_locked(self) -> None:
        """Drop least recently touched resolved entries until back under
        the cap; in-flight entries are never evicted."""
        evicted = 0
        for cid in list(self._replay):
            if len(self._replay) <= self._replay_cap:
                break
            if self._replay[cid][1].is_set():
                del self._replay[cid]
                evicted += 1
        if evicted:
            self._c_evicted.inc(evicted)

    # -- verbs --------------------------------------------------------------
    def handle(self, msg, span=None, stream_fn=None):
        cmd = msg[0] if msg else None
        if cmd == "PREDICT":
            return self._predict(msg[1], span,
                                 model=msg[2] if len(msg) > 2 else None)
        if cmd == "GENERATE":
            opts = msg[2] if len(msg) > 2 else {}
            return self._generate(msg[1], opts or {}, span, stream_fn)
        if cmd == "STREAM":
            return False, ("STREAM is a server-to-client token frame, "
                           "not a request verb")
        if cmd == "HEALTH":
            return True, self.health()
        if cmd == "METRICS":
            fmt = msg[1] if len(msg) > 1 else "prometheus"
            return True, encode_text(self.metrics_text(fmt))
        if cmd == "SWAP":
            _, prefix, epoch, input_names = msg
            try:
                version = self.swap(prefix, epoch, input_names)
            except BudgetExceeded as e:
                # the packer said no: the replica is healthy, the model
                # does not fit, and nothing was kept
                return False, "budget: %s" % e
            except Exception as e:
                # the old version stays live; the caller gets the reason
                return False, "swap failed: %s" % e
            return True, version
        if cmd == "DRAIN":
            return True, self.drain(msg[1] if len(msg) > 1 else None)
        if cmd == "STOP":
            return True, "stopping"
        return False, "unknown serve command %r" % (cmd,)

    def metrics_text(self, fmt: str = "prometheus") -> str:
        """The registry's exposition, after publishing each hosted model's
        live version as ``serve.active_version{model}`` (where the fleet
        collector reads a replica's model label)."""
        reg = _telemetry.registry
        for name in self.host.models():
            try:
                sv = self.host.active(name)
            except MXNetError:
                continue
            reg.gauge("serve.active_version",
                      doc="live servable version per hosted model",
                      labels={"model": sv.name}).set(sv.version)
        return reg.to_json(indent=1) if fmt == "json" \
            else reg.to_prometheus()

    # -- drain --------------------------------------------------------------
    def drain(self, timeout=None) -> Dict:
        """Begin retirement: close admission, arm the drain deadline (the
        first DRAIN's deadline wins, so a retry cannot extend it) and
        report what is still in flight.  ``serve_forever`` watches
        :meth:`drain_idle` / :meth:`drain_expired` and leaves its loop
        when the replica is empty or the deadline passes."""
        t = float(timeout if timeout is not None else
                  get_env("MX_SERVE_DRAIN_TIMEOUT", 30.0, float) or 30.0)
        with self._drain_lock:
            if self._drain_deadline is None:
                self._drain_deadline = _fault.Deadline(t)
            self._draining.set()
            remaining = self._drain_deadline.remaining()
        _telemetry.registry.counter(
            "serve.drains",
            doc="DRAIN retirements accepted by this replica").inc()
        status = {"status": "draining", "deadline_seconds": remaining,
                  "queue_rows": self.batcher.queue_rows()}
        if self.decode is not None:
            status["active"] = self.decode.active_count()
            status["queued"] = self.decode.queue_depth()
        return status

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain_idle(self) -> bool:
        """True when nothing is left in flight inside the engines (the
        wire's in-flight count is ``serve_forever``'s half)."""
        if self.batcher.queue_rows() > 0:
            return False
        for eng in list(self.host.engines.values()):
            if isinstance(eng, Batcher) and eng.queue_rows() > 0:
                return False
        if self.decode is not None and (self.decode.active_count() > 0
                                        or self.decode.queue_depth() > 0):
            return False
        return True

    def drain_armed(self) -> bool:
        """True once a DRAIN was accepted (its deadline armed): the serve
        loop retires only then."""
        with self._drain_lock:
            return self._drain_deadline is not None

    def drain_expired(self) -> bool:
        with self._drain_lock:
            dl = self._drain_deadline
        return dl is not None and dl.expired()

    def _predict(self, payload: Sequence, span, model=None):
        if self._draining.is_set():
            return False, ("draining: replica is retiring, not "
                           "admitting new work")
        try:
            arrays = [decode_array(t) for t in payload]
        except (TypeError, ValueError) as e:
            return False, "bad PREDICT payload: %s" % e
        tctx = span.wire_context() if span is not None else None
        # model routing: a named model that is not the default rides its
        # own micro-batcher (host.engines, made at add_model)
        eng = self.batcher
        if model is not None and model != self.host.default_model:
            eng = self.host.engines.get(model)
            if not isinstance(eng, Batcher):
                return False, ("unknown model %r (hosted: %s)"
                               % (model,
                                  ", ".join(self.host.models()) or "none"))
        try:
            pending = eng.submit(arrays, trace_ctx=tctx)
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

    def _generate(self, prompt, opts, span, stream_fn):
        """GENERATE: submit into the decode engine, stream token chunks
        when asked, answer the whole sequence.  Every failure is a normal
        (False, reason) reply: a severed connection would make the client
        replay a poison request on every replica."""
        if self._draining.is_set():
            return False, ("draining: replica is retiring, not "
                           "admitting new sessions")
        if self.decode is None:
            return False, ("no decode engine deployed (start the replica "
                           "with --decode)")
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            return False, "bad GENERATE payload: prompt must be token ids"
        tctx = span.wire_context() if span is not None else None
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
                                 eos_id=opts.get("eos"), trace_ctx=tctx)
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
        reg = _telemetry.registry
        try:
            sv = self.host.active()
            status: Dict = {"status": "serving", "version": sv.version,
                            "model": sv.name, "device": str(sv.device),
                            "buckets": list(sv.buckets.sizes),
                            "retraces": sv.retraces,
                            "bucket_hits": sv.bucket_hits,
                            "batches": sv.batches}
        except MXNetError:
            status = {"status": "empty", "version": 0}
        # several models: per-model versions and footprints against the
        # budget
        if len(self.host.models()) > 1 or self.host.hbm_budget > 0 or \
                self.host.engines:
            status["packing"] = self.host.packing_report()
        if self.decode is not None:
            # a decode-only replica is serving with an empty host
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

    def swap(self, prefix: str, epoch: int,
             input_names: Sequence[str]) -> int:
        """Load ``prefix`` as the default model's version N+1, warm it
        with the active version's signature, admit, flip, drain: the
        wire's face of ``ModelHost.deploy``.  The loader is
        :meth:`Servable.from_checkpoint`."""
        new_version = self.host.version + 1
        kw = {}
        cur_name = self.host.default_model
        if cur_name is not None:
            # a SWAP replaces the default model's version chain (same
            # name, next version); add_model co-hosts a new one
            kw["name"] = cur_name
        sv = Servable.from_checkpoint(prefix, epoch=epoch,
                                      input_names=input_names,
                                      version=new_version, **kw)
        example = None
        try:
            want = self.host.active().warmed_signature
            if want is not None:
                example = [np.zeros((1,) + trail, dtype=dt)
                           for trail, dt in want]
        except MXNetError:
            pass
        self.host.deploy(sv, example=example)
        return new_version

    def close(self) -> None:
        self.batcher.close()
        for eng in list(self.host.engines.values()):
            if isinstance(eng, Batcher):
                eng.close()
        if self.decode is not None:
            self.decode.close()


def serve_forever(port: Optional[int] = None,
                  state: Optional[ServeServer] = None,
                  ready_file: Optional[str] = None,
                  stop_event: Optional[threading.Event] = None,
                  abort_event: Optional[threading.Event] = None,
                  bind: str = "0.0.0.0",
                  ready_event: Optional[threading.Event] = None) -> None:
    """Run one replica's accept loop: one thread per connection, until a
    STOP verb, ``stop_event``, or a DRAIN that ran idle or out of time.

    On STOP it stops accepting, waits (bounded) for in-flight requests,
    closes the engines and severs the remaining connections.  A drained
    replica leaves as soon as the wire and the engines are idle; past
    the drain deadline it severs the stragglers with no reply.
    ``ready_file`` gets the bound port and ``ready_event`` is set once the
    port accepts.  ``abort_event`` is the crash of an in-process test:
    setting it severs the listener and every live connection at once,
    with no replies, which is what a killed replica looks like."""
    port = int(port if port is not None else get_env("MX_SERVE_PORT", 9700,
                                                     int))
    server_state = state or ServeServer()
    stop_event = stop_event or threading.Event()
    abort_event = abort_event or threading.Event()
    inflight = [0]
    inflight_lock = threading.Lock()
    conns = set()
    conns_lock = threading.Lock()
    listener = []

    def _refuse_new():
        # a dead replica refuses connections at once: shutting the
        # listening socket down makes every later connect fail, where the
        # listener would otherwise accept until the accept loop is joined
        for sock in listener:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

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
                    _fault.fire("serve.request")
                    ok, payload = server_state.handle_request(
                        msg, stream_fn=stream_fn)
                except SystemExit:          # an injected crash
                    os._exit(17)
                except (_fault.FaultError, WireCodecError) as e:
                    ok, payload = False, str(e)
                finally:
                    with inflight_lock:
                        inflight[0] -= 1
                if abort_event.is_set():
                    _refuse_new()
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

    with Server((bind, port), Handler) as srv, _Answering():
        listener.append(srv.socket)
        if ready_file:
            with open(ready_file, "w") as f:
                f.write("%d" % srv.server_address[1])
        accept = threading.Thread(target=srv.serve_forever, daemon=True,
                                  name="mx-serve-accept")
        accept.start()
        if ready_event is not None:
            ready_event.set()
        drain_overrun = False
        while not stop_event.is_set() and not abort_event.is_set():
            stop_event.wait(timeout=0.02)
            if server_state.drain_armed():
                with inflight_lock:
                    wire_busy = inflight[0]
                if wire_busy == 0 and server_state.drain_idle():
                    break                   # drained clean
                if server_state.drain_expired():
                    # stragglers past the deadline: sever them with no
                    # reply, so their clients fail over to a survivor
                    drain_overrun = True
                    break
        if drain_overrun or abort_event.is_set():
            # no new connection, then the live ones die (no replies)
            _refuse_new()
            _sever()
            srv.shutdown()
            server_state.close()
            accept.join(timeout=5.0)
            return
        srv.shutdown()
        deadline = _fault.Deadline(5.0)
        while not deadline.expired():
            with inflight_lock:
                if inflight[0] == 0:
                    break
            _fault.sleep(0.02)
        server_state.close()
        _sever()
        accept.join(timeout=5.0)
