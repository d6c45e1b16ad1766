"""Wire payloads and framing, numpy only.

Counterpart of ``mxnet_tpu/kvstore/wire_codec.py`` (the ``NPX`` array,
``TXT`` text and ``JSN`` json payloads) and of ``send_msg``/``recv_msg`` in
``mxnet_tpu/kvstore/server.py`` (length-prefixed pickles), kept as the
port's own copy so the port imports nothing of the JAX package.  The bytes
on the wire are the same, so a client of either package talks to a server
of the other.

Frames are unpickled: talk only to peers you trust, as with the JAX
package's wire.
"""
from __future__ import annotations

import json
import pickle
import socket
import struct
from typing import Optional

import numpy as np

__all__ = ["WireCodecError", "encode_array", "decode_array", "encode_text",
           "decode_text", "encode_json", "decode_json", "is_array_payload",
           "send_msg", "recv_msg"]

_ARR_TAG = "NPX"
_TXT_TAG = "TXT"
_JSN_TAG = "JSN"


class WireCodecError(ValueError):
    """A payload failed validation while decoding; nothing was built."""


def _expect_bytes(what, raw) -> bytes:
    if not isinstance(raw, (bytes, bytearray)):
        raise WireCodecError("%s: payload bytes field is %s, not bytes"
                             % (what, type(raw).__name__))
    return bytes(raw)


def is_array_payload(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) == 4 and obj[0] == _ARR_TAG


def encode_array(arr) -> tuple:
    """``(NPX, shape, dtype_str, row_major_bytes)`` of a host array."""
    a = np.asarray(arr)
    shape = tuple(int(s) for s in a.shape)
    return (_ARR_TAG, shape, str(a.dtype), np.ascontiguousarray(a).tobytes())


def decode_array(obj) -> np.ndarray:
    """Inverse of :func:`encode_array`: a writable array, or
    :class:`WireCodecError` on any malformed payload."""
    if not is_array_payload(obj):
        raise WireCodecError("not an NPX array payload: %r" % (type(obj),))
    _, shape, dtype, raw = obj
    if not (isinstance(shape, tuple)
            and all(isinstance(s, int) and s >= 0 for s in shape)):
        raise WireCodecError("NPX: shape field %r is not a tuple of "
                             "non-negative ints" % (shape,))
    try:
        dt = np.dtype(dtype)
    except (TypeError, ValueError) as e:
        raise WireCodecError("NPX: bad dtype %r (%s)" % (dtype, e))
    raw = _expect_bytes("NPX", raw)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if len(raw) != n * dt.itemsize:
        raise WireCodecError("NPX: payload is %d bytes but shape %r of %s "
                             "needs %d" % (len(raw), shape, dt,
                                           n * dt.itemsize))
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def encode_text(text: str) -> tuple:
    return (_TXT_TAG, str(text).encode("utf-8"))


def decode_text(obj) -> str:
    if not (isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _TXT_TAG):
        raise WireCodecError("not a TXT payload: %r" % (type(obj),))
    try:
        return _expect_bytes("TXT", obj[1]).decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireCodecError("TXT: payload is not valid utf-8 (%s)" % (e,))


def encode_json(obj) -> tuple:
    return (_JSN_TAG, json.dumps(obj, default=str).encode("utf-8"))


def decode_json(obj):
    if not (isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _JSN_TAG):
        raise WireCodecError("not a JSN payload: %r" % (type(obj),))
    try:
        return json.loads(_expect_bytes("JSN", obj[1]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireCodecError("JSN: payload does not parse as JSON (%s)"
                             % (e,))


def send_msg(sock: socket.socket, obj) -> None:
    """One frame: 8-byte little-endian length, then the pickle."""
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def recv_msg(sock: socket.socket, timeout: Optional[float] = None,
             idle_block: bool = False):
    """Receive one frame.  ``timeout`` bounds a peer that stalls (None:
    block); with ``idle_block`` the wait for the first byte is unbounded
    but a peer that stalls mid-frame still raises TimeoutError."""
    saved = sock.gettimeout()
    try:
        sock.settimeout(None if idle_block else timeout)
        head = b""
        while len(head) < 8:
            try:
                chunk = sock.recv(8 - len(head))
            except socket.timeout:
                raise TimeoutError("recv_msg: peer sent no %s within %ss"
                                   % ("data" if not head else "full header",
                                      timeout))
            if not chunk:
                raise ConnectionError("peer closed")
            if not head:
                sock.settimeout(timeout)
            head += chunk
        (n,) = struct.unpack("<Q", head)
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = sock.recv(min(1 << 20, n - len(buf)))
            except socket.timeout:
                raise TimeoutError("recv_msg: peer stalled mid-message "
                                   "(%d/%d bytes) for %ss"
                                   % (len(buf), n, timeout))
            if not chunk:
                raise ConnectionError("peer closed mid-message")
            buf += chunk
        return pickle.loads(bytes(buf))
    finally:
        try:
            sock.settimeout(saved)
        except OSError:
            pass
