"""Wire payloads and framing, numpy only.

Counterpart of ``mxnet_tpu/kvstore/wire_codec.py`` (the ``NPX`` array,
``TXT`` text and ``JSN`` json payloads, the ``QGRAD`` compressed
gradients and the host 2-bit pack) and of ``send_msg``/``recv_msg`` in
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
           "is_text_payload", "is_json_payload",
           "is_wire_payload", "encode_wire", "decode_wire",
           "quantize_int8_np", "pack_2bit", "unpack_2bit",
           "send_msg", "recv_msg"]

_WIRE_TAG = "QGRAD"
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


def _expect_shape(what, shape) -> int:
    if not (isinstance(shape, tuple)
            and all(isinstance(s, int) and s >= 0 for s in shape)):
        raise WireCodecError("%s: shape field %r is not a tuple of "
                             "non-negative ints" % (what, shape))
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _expect_dtype(what, dtype) -> np.dtype:
    try:
        return np.dtype(dtype)
    except (TypeError, ValueError) as e:
        raise WireCodecError("%s: bad dtype %r (%s)" % (what, dtype, e))


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
    n = _expect_shape("NPX", shape)
    dt = _expect_dtype("NPX", dtype)
    raw = _expect_bytes("NPX", raw)
    if len(raw) != n * dt.itemsize:
        raise WireCodecError("NPX: payload is %d bytes but shape %r of %s "
                             "needs %d" % (len(raw), shape, dt,
                                           n * dt.itemsize))
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def is_text_payload(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _TXT_TAG


def encode_text(text: str) -> tuple:
    return (_TXT_TAG, str(text).encode("utf-8"))


def decode_text(obj) -> str:
    if not is_text_payload(obj):
        raise WireCodecError("not a TXT payload: %r" % (type(obj),))
    try:
        return _expect_bytes("TXT", obj[1]).decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireCodecError("TXT: payload is not valid utf-8 (%s)" % (e,))


def is_json_payload(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _JSN_TAG


def encode_json(obj) -> tuple:
    return (_JSN_TAG, json.dumps(obj, default=str).encode("utf-8"))


def decode_json(obj):
    if not is_json_payload(obj):
        raise WireCodecError("not a JSN payload: %r" % (type(obj),))
    try:
        return json.loads(_expect_bytes("JSN", obj[1]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireCodecError("JSN: payload does not parse as JSON (%s)"
                             % (e,))


def is_wire_payload(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) >= 2 and obj[0] == _WIRE_TAG


def encode_wire(mode: str, shape, dtype, payload) -> tuple:
    """The picklable tuple of one compressed gradient:

    int8: ``(QGRAD, 'int8', shape, dtype, n, q_bytes, scales_f32)``
    2bit: ``(QGRAD, '2bit', shape, dtype, n, words_u32, threshold)``
    """
    mode = str(mode)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if mode == "int8":
        q, scales = payload
        return (_WIRE_TAG, "int8", shape, str(dtype), n,
                np.asarray(q, np.int8).tobytes(),
                np.asarray(scales, np.float32))
    if mode == "2bit":
        words, threshold = payload
        return (_WIRE_TAG, "2bit", shape, str(dtype), n,
                np.asarray(words, np.uint32), float(threshold))
    raise ValueError("unknown gradient wire mode %r" % (mode,))


def decode_wire(obj) -> np.ndarray:
    """Inverse of :func:`encode_wire`: the dequantized full-width array,
    or :class:`WireCodecError` on any malformed tuple (wrong tag or
    length, count and shape apart, too few bytes or words, blocks that do
    not divide)."""
    if not is_wire_payload(obj):
        raise WireCodecError("not a QGRAD wire payload: %r" % (type(obj),))
    if len(obj) != 7:
        raise WireCodecError("QGRAD: tuple has %d fields, expected 7"
                             % len(obj))
    _, mode, shape, dtype, n = obj[:5]
    n_shape = _expect_shape("QGRAD", shape)
    dt = _expect_dtype("QGRAD", dtype)
    if not isinstance(n, int) or n != n_shape:
        raise WireCodecError("QGRAD: element count %r does not match shape "
                             "%r (%d elements)" % (n, shape, n_shape))
    if mode == "int8":
        raw = _expect_bytes("QGRAD int8", obj[5])
        try:
            scales = np.asarray(obj[6], np.float32)
        except (TypeError, ValueError) as e:
            raise WireCodecError("QGRAD int8: bad scales field (%s)" % (e,))
        if scales.ndim != 1 or scales.size == 0:
            raise WireCodecError("QGRAD int8: scales must be a non-empty "
                                 "1-d float array, got shape %r"
                                 % (scales.shape,))
        q = np.frombuffer(raw, dtype=np.int8).astype(np.float32)
        if q.size < n or q.size % scales.size != 0:
            raise WireCodecError("QGRAD int8: %d quantized bytes cannot "
                                 "cover %d elements in %d equal blocks"
                                 % (q.size, n, scales.size))
        block = q.size // scales.size
        flat = (q.reshape(-1, block) * scales[:, None]).reshape(-1)[:n]
    elif mode == "2bit":
        try:
            words = np.asarray(obj[5], np.uint32)
            threshold = float(obj[6])
        except (TypeError, ValueError) as e:
            raise WireCodecError("QGRAD 2bit: bad words/threshold field "
                                 "(%s)" % (e,))
        if words.ndim != 1 or words.size * 16 < n:
            raise WireCodecError("QGRAD 2bit: %r uint32 words carry %d "
                                 "codes, need %d"
                                 % (words.shape, words.size * 16, n))
        flat = unpack_2bit(words, n, threshold)
    else:
        raise WireCodecError("QGRAD: unknown gradient wire mode %r"
                             % (mode,))
    return flat.astype(dt).reshape(shape)


def quantize_int8_np(flat, block: int = 256):
    """Per-block symmetric int8 of a flat float array without error
    feedback (the stateless encode of a quantized pull): ``(q_int8,
    scales_f32)``, the last block padded with zeros."""
    flat = np.asarray(flat, np.float32).ravel()
    block = max(1, int(block))
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    scales = (np.abs(blocks).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0).astype(np.float32)
    q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scales


def pack_2bit(levels, threshold: float) -> np.ndarray:
    """+-t/0 levels in the packed 2-bit format: 16 codes a uint32 word,
    code i of a word at bits [2i, 2i+1], 00 = 0, 01 = -t, 10 = +t."""
    flat = np.asarray(levels, np.float32).ravel()
    codes = np.where(flat > 0, 2, np.where(flat < 0, 1, 0)).astype(
        np.uint32)
    pad = (-len(codes)) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint32)])
    words = codes.reshape(-1, 16)
    out = np.zeros(words.shape[0], np.uint32)
    for i in range(16):
        out |= words[:, i] << (2 * i)
    return out


def unpack_2bit(words, n: int, threshold: float,
                dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`pack_2bit`: the first ``n`` codes as levels."""
    words = np.asarray(words, np.uint32)
    codes = np.zeros((len(words), 16), np.uint32)
    for i in range(16):
        codes[:, i] = (words >> (2 * i)) & 0x3
    codes = codes.ravel()[:n]
    out = np.zeros(n, dtype)
    out[codes == 2] = threshold
    out[codes == 1] = -threshold
    return out


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
        # read straight into one buffer and unpickle from it: a frame may
        # hold a parameter-sized array, so no extra copies of it
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                k = sock.recv_into(view[got:], min(1 << 20, n - got))
            except socket.timeout:
                raise TimeoutError("recv_msg: peer stalled mid-message "
                                   "(%d/%d bytes) for %ss"
                                   % (got, n, timeout))
            if not k:
                raise ConnectionError("peer closed mid-message")
            got += k
        view.release()
        return pickle.loads(buf)
    finally:
        try:
            sock.settimeout(saved)
        except OSError:
            pass
