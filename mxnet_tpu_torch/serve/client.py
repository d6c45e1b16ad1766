"""Serving client: SEQ-tagged RPCs with replica failover.

Counterpart of ``mxnet_tpu/serve/client.py`` for PREDICT, GENERATE,
HEALTH and STOP.  The client sticks to one replica of its address list;
when a connection drops or times out it reconnects, rotating to the next
replica (``serve.client_failovers``), and replays the same ``(client_id,
seq)``, so a lost reply is answered from the server's replay cache rather
than recomputed, and a generation cut by a dead replica is generated again
on the next one (greedy decode is deterministic).  Attempts back off
exponentially (50 ms doubling to 1 s) until the request's deadline.  An
``overloaded`` reply raises :class:`Overloaded`: the replica is healthy
and shedding load; a ``draining`` reply moves the request to the next
replica.
"""
from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env
from .. import telemetry as _telemetry
from ..kvstore.wire_codec import (decode_array, encode_array, recv_msg,
                                  send_msg)
from .batcher import Overloaded

__all__ = ["ServeClient"]

_BACKOFF_BASE = 0.05
_BACKOFF_MAX = 1.0


class ServeClient:
    """Client to one or more serving replicas (``"host:port"`` strings);
    thread-safe, one RPC at a time."""

    def __init__(self, addrs, timeout: Optional[float] = None):
        if isinstance(addrs, str):
            addrs = [addrs]
        self._addrs = list(addrs)
        if not self._addrs:
            raise MXNetError("ServeClient needs replica addresses")
        self._socks: List[Optional[socket.socket]] = [None] * len(self._addrs)
        self._idx = 0
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

    def _rpc(self, *msg, idx: Optional[int] = None, on_stream=None):
        """One SEQ-enveloped RPC; ``idx`` pins one replica (no failover).
        ``on_stream(offset, tokens)`` receives each ("STREAM", offset,
        tokens) frame a streaming GENERATE sends ahead of its terminal
        reply (at least once across a failover: the offset dedupes)."""
        pinned = idx is not None
        deadline_s = {"STOP": 1.0, "HEALTH": 5.0 if pinned else
                      self._timeout}.get(msg[0], self._timeout)
        with self._lock:
            self._seq += 1
            seq = self._seq    # one seq for every attempt of this request
            start = time.monotonic()
            attempt = 0
            last_err: Optional[BaseException] = None
            while True:
                if attempt:
                    delay = min(_BACKOFF_MAX, _BACKOFF_BASE * 2 ** (attempt - 1))
                    if time.monotonic() + delay - start > deadline_s:
                        break
                    time.sleep(delay)
                attempt += 1
                at = idx if pinned else self._idx
                try:
                    sock = self._ensure_sock(at)
                    send_msg(sock, ("SEQ", self._client_id, seq, msg))
                    while True:
                        resp = recv_msg(sock, timeout=self._timeout)
                        if isinstance(resp, tuple) and resp and \
                                resp[0] == "STREAM":
                            if on_stream is not None:
                                on_stream(resp[1], resp[2])
                            continue      # a chunk; the terminal follows
                        ok, payload = resp
                        return ok, payload
                except (ConnectionError, OSError, TimeoutError) as e:
                    last_err = e
                    self._kill_sock(at)
                    if not pinned and len(self._addrs) > 1:
                        self._idx = (at + 1) % len(self._addrs)
                        self._c_failover.inc()
        raise MXNetError("serve: %r unreachable on %r for %.3gs; last error: "
                         "%s" % (msg[0], self._addrs if not pinned
                                 else self._addrs[idx], deadline_s, last_err))

    def predict(self, arrays: Sequence) -> Tuple[int, List[np.ndarray]]:
        """One request: per-input row-batched arrays in, ``(version,
        [output, ...])`` out.  Raises :class:`Overloaded` when the replica
        sheds it, MXNetError on any other refusal."""
        ok, resp = self._rpc("PREDICT", [encode_array(a) for a in arrays])
        if ok:
            version, outs = resp
            return int(version), [decode_array(t) for t in outs]
        if isinstance(resp, str) and resp.startswith("overloaded"):
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
                    with self._lock:
                        self._idx = (self._idx + 1) % len(self._addrs)
                    continue
                if resp.startswith("overloaded"):
                    raise Overloaded(resp)
            raise MXNetError("serve: %s" % resp)

    def decode_stats(self, idx: Optional[int] = None) -> Optional[dict]:
        """The replica's decode-engine section of HEALTH, or None when it
        hosts no decode engine (on a paged replica it carries the page
        headroom: ``engine='paged'``, ``kv_free_pages``,
        ``shared_saved_bytes``)."""
        return self.health(idx=idx).get("decode")

    def health(self, idx: Optional[int] = None) -> dict:
        """One replica's health dict (``idx`` pins; default = sticky)."""
        ok, resp = self._rpc("HEALTH", idx=idx)
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
