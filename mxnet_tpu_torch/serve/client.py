"""Serving client: SEQ-tagged RPCs with replica failover.

Counterpart of ``mxnet_tpu/serve/client.py``.  The client sticks to one
replica of its address list (or of ``MX_SERVE_ROOTS``); when a connection
drops or times out it reconnects, rotating to the next replica
(``serve.client_failovers``), and replays the same ``(client_id, seq)``,
so a lost reply is answered from the server's replay cache rather than
recomputed, and a generation cut by a dead replica is generated again on
the next one (greedy decode is deterministic).  Attempts back off on the
jittered exponential :class:`~mxnet_tpu_torch.fault.RetryPolicy`
schedule (``MX_KVSTORE_RETRY_*``), each slept delay observed on
``serve.client_backoff_seconds``.  An ``overloaded`` reply raises
:class:`Overloaded` (the replica is healthy and shedding load) unless
``spill=True`` tries the other replicas first; a ``draining`` reply always
moves the request to the next replica.  Each request carries the client
span's trace context, so one request is one causal trace.
"""
from __future__ import annotations

import socket
import threading
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env
from .. import fault as _fault
from .. import telemetry as _telemetry
from ..kvstore.wire_codec import (decode_array, decode_text, encode_array,
                                  recv_msg, send_msg)
from .batcher import Overloaded

__all__ = ["ServeClient"]


def _roots(addrs) -> List[str]:
    if addrs is None:
        raw = get_env("MX_SERVE_ROOTS") or ""
        addrs = [a.strip() for a in str(raw).split(",") if a.strip()]
    if isinstance(addrs, str):
        addrs = [addrs]
    if not addrs:
        raise MXNetError("ServeClient needs replica addresses "
                         "(MX_SERVE_ROOTS or addrs=[...])")
    return list(addrs)


class ServeClient:
    """Client to one serving fleet (``"host:port"`` strings: replicas or
    a router); thread-safe, one RPC at a time."""

    def __init__(self, addrs=None, timeout: Optional[float] = None):
        self._addrs = _roots(addrs)
        self._socks: List[Optional[socket.socket]] = \
            [None] * len(self._addrs)
        self._idx = 0                       # sticky current replica
        self._client_id = "serve:%s" % uuid.uuid4().hex[:12]
        self._timeout = float(timeout if timeout is not None else
                              get_env("MX_SERVE_TIMEOUT", 30.0, float)
                              or 30.0)
        self._lock = threading.Lock()
        self._seq = 0
        self._c_failover = _telemetry.registry.counter(
            "serve.client_failovers",
            doc="requests replayed on another replica after a "
                "connection failure/timeout")
        self._h_backoff = _telemetry.registry.histogram(
            "serve.client_backoff_seconds",
            doc="jittered exponential backoff slept between serve RPC "
                "retry/failover attempts",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))

    @property
    def replicas(self) -> List[str]:
        return list(self._addrs)

    # -- plumbing -----------------------------------------------------------
    def _kill_sock(self, idx: int) -> None:
        s = self._socks[idx]
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        self._socks[idx] = None

    def _ensure_sock(self, idx: int) -> socket.socket:
        s = self._socks[idx]
        if s is None:
            host, port = self._addrs[idx].rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=5)
            s.settimeout(self._timeout)
            self._socks[idx] = s
        return s

    def _rpc(self, *msg, idx: Optional[int] = None, failover: bool = True,
             on_stream=None):
        """One SEQ-enveloped RPC.  ``idx=None`` uses the sticky replica
        and rotates on connection failures; an explicit ``idx`` pins one
        replica (probes) and never fails over.  ``on_stream(offset,
        tokens)`` receives each ("STREAM", offset, tokens) frame a
        streaming GENERATE sends ahead of its terminal reply (at least
        once across a failover: the offset dedupes)."""
        pinned = idx is not None
        policy = _fault.RetryPolicy.from_env()
        if msg[0] == "STOP":
            # a replica already gone must not cost a retry deadline each
            policy.deadline = min(policy.deadline, 1.0)
        elif pinned and msg[0] in ("HEALTH", "METRICS"):
            # a pinned probe is a liveness check: a dead replica reads as
            # dead in seconds
            policy.deadline = min(policy.deadline, 5.0)
        with self._lock:
            # one seq for every attempt: a same-replica retry replays it,
            # so the server's cache answers instead of re-executing
            self._seq += 1
            seq = self._seq
        with _telemetry.rpc_span("serve.client.%s" % msg[0]) as span:
            tctx = span.wire_context()
            start = _fault.now()
            attempt = 0
            while True:
                if attempt:
                    d = policy.delay(attempt - 1)
                    if _fault.now() + d - start > policy.deadline:
                        break
                    self._h_backoff.observe(d)
                    _fault.sleep(d)
                attempt += 1
                with self._lock:
                    at = idx if pinned else self._idx
                    env = ("SEQ", self._client_id, seq, msg)
                    try:
                        sock = self._ensure_sock(at)
                        _fault.fire("serve.client.send",
                                    on_close=lambda at=at: self._kill_sock(at))
                        send_msg(sock, env if tctx is None else env + (tctx,))
                        _fault.fire("serve.client.recv",
                                    on_close=lambda at=at: self._kill_sock(at))
                        while True:
                            resp = recv_msg(sock, timeout=self._timeout)
                            if isinstance(resp, tuple) and resp and \
                                    resp[0] == "STREAM":
                                if on_stream is not None:
                                    on_stream(resp[1], resp[2])
                                continue      # a chunk; the terminal follows
                            ok, payload = resp
                            break
                    except (ConnectionError, OSError, TimeoutError) as e:
                        self._kill_sock(at)
                        policy.note(e)
                        if pinned or not failover:
                            span.event("retry", replica=at, seq=seq,
                                       error=str(e))
                            continue
                        self._idx = (at + 1) % len(self._addrs)
                        self._c_failover.inc()
                        span.event("failover", dead=at, to=self._idx,
                                   seq=seq, error=str(e))
                        continue
                return ok, payload
        raise MXNetError(
            "serve: %r unreachable on every replica %r for %.3gs "
            "(MX_KVSTORE_RETRY_DEADLINE); last error: %s"
            % (msg[0], self._addrs, policy.deadline, policy.last_error))

    def _rotate(self) -> None:
        with self._lock:
            self._idx = (self._idx + 1) % len(self._addrs)

    # -- verbs --------------------------------------------------------------
    def predict(self, arrays: Sequence, spill: bool = False,
                model: Optional[str] = None
                ) -> Tuple[int, List[np.ndarray]]:
        """One request: per-input row-batched arrays in, ``(version,
        [output, ...])`` out.  ``model`` names a co-hosted model (None:
        the replica's default).  Raises :class:`Overloaded` when the
        fleet sheds it, MXNetError on any other refusal."""
        payload = [encode_array(a) for a in arrays]
        tried = 0
        while True:
            ok, resp = self._rpc("PREDICT", payload) if model is None \
                else self._rpc("PREDICT", payload, str(model))
            if ok:
                version, outs = resp
                return int(version), [decode_array(t) for t in outs]
            if isinstance(resp, str) and resp.startswith(("overloaded",
                                                          "draining")):
                tried += 1
                # draining: retirement is routine, always move on;
                # overload spills only when asked
                if ((spill or resp.startswith("draining"))
                        and tried < len(self._addrs)):
                    self._rotate()
                    continue
                if resp.startswith("overloaded"):
                    raise Overloaded(resp)
            raise MXNetError("serve: %s" % resp)

    def generate(self, prompt: Sequence[int],
                 max_tokens: Optional[int] = None,
                 eos: Optional[int] = None, on_token=None,
                 spill: bool = False,
                 model: Optional[str] = None) -> Tuple[int, List[int]]:
        """One autoregressive generation: prompt token ids in,
        ``(servable_version, [generated token, ...])`` out, through the
        replica's continuous-batching decode engine.

        ``on_token(tokens)`` arms streaming: the callback receives each
        new token list once, in order (chunks sent again after a failover
        are deduped by offset; the replayed generation is deterministic,
        so the offsets line up).  The returned list is always the whole
        sequence.  ``spill`` moves an overloaded request to the next
        replica; a draining replica's refusal always does.  Raises
        :class:`Overloaded` when the replicas shed it, MXNetError on a
        terminal failure."""
        opts = {"stream": on_token is not None}
        if max_tokens is not None:
            opts["max_tokens"] = int(max_tokens)
        if eos is not None:
            opts["eos"] = int(eos)
        if model is not None:
            opts["model"] = str(model)
        seen = [0]

        def _dedupe(offset, tokens):
            if offset > seen[0]:       # a gap (failover skew): drop it,
                return                 # the terminal reply has everything
            fresh = tokens[seen[0] - offset:]
            if fresh:
                seen[0] = offset + len(tokens)
                on_token([int(t) for t in fresh])

        tried = 0
        while True:
            ok, resp = self._rpc(
                "GENERATE", [int(t) for t in prompt], opts,
                on_stream=_dedupe if on_token is not None else None)
            if ok:
                version, tokens = resp
                return int(version), [int(t) for t in tokens]
            if isinstance(resp, str) and resp.startswith(("overloaded",
                                                          "draining")):
                tried += 1
                # draining: the session must move (re-prefill on the next
                # replica); overload spills only when asked
                if ((spill or resp.startswith("draining"))
                        and tried < len(self._addrs)):
                    self._rotate()
                    continue
                if resp.startswith("overloaded"):
                    raise Overloaded(resp)
            raise MXNetError("serve: %s" % resp)

    def health(self, idx: Optional[int] = None) -> dict:
        """One replica's health dict (``idx`` pins; default = sticky)."""
        ok, resp = self._rpc("HEALTH", idx=idx)
        if not ok:
            raise MXNetError("serve: %s" % resp)
        return resp

    def decode_stats(self, idx: Optional[int] = None) -> Optional[dict]:
        """The replica's decode-engine section of HEALTH, or None when it
        hosts no decode engine (on a paged replica it carries the page
        headroom: ``engine='paged'``, ``kv_free_pages``,
        ``shared_saved_bytes``)."""
        return self.health(idx=idx).get("decode")

    def metrics(self, idx: Optional[int] = None,
                fmt: str = "prometheus") -> str:
        """One replica's live telemetry: the Prometheus text exposition
        (``fmt='json'``: the registry snapshot) over the serve wire."""
        ok, resp = self._rpc("METRICS", fmt, idx=idx)
        if not ok:
            raise MXNetError("serve: %s" % resp)
        return decode_text(resp)

    def swap(self, prefix: str, epoch: int = 0,
             input_names: Sequence[str] = ("data",)) -> List[int]:
        """Hot-swap every replica to the checkpoint at ``prefix``; returns
        each replica's new version."""
        versions = []
        for i in range(len(self._addrs)):
            ok, resp = self._rpc("SWAP", prefix, int(epoch),
                                 tuple(input_names), idx=i)
            if not ok:
                raise MXNetError("serve: replica %d %s" % (i, resp))
            versions.append(int(resp))
        return versions

    def drain(self, timeout: Optional[float] = None,
              idx: Optional[int] = None) -> dict:
        """Begin retirement on one replica (``idx`` pins; default =
        sticky): admission closes, in-flight work finishes before the
        deadline, then the replica's serve loop exits.  Returns its drain
        status."""
        ok, resp = self._rpc(
            "DRAIN", None if timeout is None else float(timeout), idx=idx)
        if not ok:
            raise MXNetError("serve: %s" % resp)
        return resp

    def stop(self) -> None:
        """Graceful STOP to every replica (best effort)."""
        for i in range(len(self._addrs)):
            try:
                self._rpc("STOP", idx=i)
            except MXNetError:
                pass

    def close(self) -> None:
        with self._lock:
            for i in range(len(self._socks)):
                self._kill_sock(i)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
