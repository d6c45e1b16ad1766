"""Gradient compression for the exchange wire: 2-bit and int8, with error
feedback.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (reference:
src/kvstore/gradient_compression.cc).  Both modes keep, for each wire key
and each worker, a residual of what compression dropped: the residual is
added to the next payload before it is quantized, and the emitted levels
are taken out of it, so no gradient mass is lost, only delayed.  The
receiver sums the workers' dequantized values.

The arithmetic is :mod:`..ops.quantization`'s, on the payload's device;
this module owns the residual state.  A wire key is a parameter key on the
per-key path or a fusion bucket's name on the bucketed one (the name
carries a CRC of its members, so a layout change starts a new residual).
The host-side ``QGRAD`` codec is :mod:`.wire_codec`'s, re-exported here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import dtype_name
from ..ops import quantization as _qops
from .wire_codec import (decode_wire, encode_wire, is_wire_payload,  # noqa: F401
                         pack_2bit, unpack_2bit)

__all__ = ["GradientCompression", "quantize_2bit", "wire_nbytes",
           "pack_2bit", "unpack_2bit", "encode_wire", "decode_wire",
           "is_wire_payload"]


def quantize_2bit(grad, residual, threshold: float):
    """One error-feedback quantization step: ``(levels in {-threshold, 0,
    +threshold}, new residual)`` of tensors (or NDArrays), in ``grad``'s
    dtype; ``residual`` is not written."""
    unwrap = (lambda a: a.data if hasattr(a, "asnumpy") else a)
    return _qops.quantize_2bit_ef(unwrap(grad), unwrap(residual),
                                  threshold, donate=False)


def wire_nbytes(mode: str, n: int, block: int = None) -> int:
    """Bytes the payload of an n-element gradient occupies on the wire."""
    if mode == "int8":
        return _qops.int8_wire_bytes(n, block or _qops.grad_compress_block())
    if mode == "2bit":
        return _qops.two_bit_wire_bytes(n)
    if mode == "bf16":
        return 2 * n
    return 4 * n


class GradientCompression:
    """A store's compression state: one residual a wire key, on the
    payload's device (float32 for int8, the gradient's dtype for 2-bit, as
    in the reference)."""

    def __init__(self, type: str = "2bit", threshold: float = 0.5,
                 block: int = None):
        if type not in ("2bit", "int8"):
            raise ValueError("unsupported gradient compression type %r "
                             "(GradientCompression handles '2bit'/'int8')"
                             % (type,))
        if threshold <= 0:
            raise ValueError("2bit compression threshold must be > 0, got "
                             "%r" % threshold)
        self.type = type
        self.threshold = float(threshold)
        self.block = int(block) if block else _qops.grad_compress_block()
        self._residuals: Dict = {}
        #: residuals checkpointed by an overlap session until its commit
        self._pinned: Dict = {}
        # the buffer census: error-feedback residuals under "ef_residuals"
        from .. import programs as _programs
        _programs.track_buffers(
            "ef_residuals", self,
            lambda gc: [a for a in list(gc._residuals.values())
                        + list(gc._pinned.values()) if a is not None])

    def _residual(self, key, like: torch.Tensor, dtype=None) -> torch.Tensor:
        res = self._residuals.get(key)
        if res is None or res.shape != like.shape:
            res = torch.zeros(like.shape, dtype=dtype or torch.float32,
                              device=like.device)
        return res

    def peek_residual(self, key, shape, dtype=torch.float32,
                      device=None) -> torch.Tensor:
        """The residual of ``key`` (zeros of ``shape`` when there is none
        or its shape differs: a new bucket layout starts afresh)."""
        res = self._residuals.get(key)
        if res is None or tuple(res.shape) != tuple(shape):
            return torch.zeros(tuple(shape), dtype=dtype, device=device)
        return res

    def put_residual(self, key, value: torch.Tensor) -> None:
        self._residuals[key] = value

    def _donate(self, key) -> bool:
        """Whether a quantize step may write ``key``'s residual in place:
        not while an overlap session holds it as a checkpoint."""
        return key not in self._pinned

    # -- overlap-session checkpoints -----------------------------------------
    def checkpoint(self, keys) -> None:
        """Keep the current residuals of ``keys`` until :meth:`commit`,
        so that :meth:`rollback` can restore them: until then a quantize
        step of these keys returns a new residual and writes none in place
        (:meth:`_donate`), so the kept one is never written.  A second
        checkpoint before the commit keeps the first."""
        for k in keys:
            if k not in self._pinned:
                self._pinned[k] = self._residuals.get(k)

    def rollback(self, keys) -> None:
        """Restore the checkpointed residuals of ``keys``: the exchange that
        consumed them was discarded."""
        for k in keys:
            if k not in self._pinned:
                continue
            snap = self._pinned[k]
            if snap is None:
                self._residuals.pop(k, None)
            else:
                self._residuals[k] = snap

    def commit(self, keys) -> None:
        """Drop the checkpoints of ``keys``."""
        for k in keys:
            self._pinned.pop(k, None)

    # -- the device side (the collective path) -------------------------------
    def quantize(self, key, x: torch.Tensor) -> torch.Tensor:
        """The compress-decompress roundtrip of ``x`` under wire key
        ``key``, as one worker's exchange observes it; updates the
        residual."""
        if self.type == "int8":
            flat = x.reshape(-1)
            deq, self._residuals[key] = _qops.roundtrip_int8_blocks(
                flat, self._residual(key, flat), self.block,
                donate=self._donate(key))
            return deq.reshape(x.shape)
        q, self._residuals[key] = _qops.quantize_2bit_ef(
            x, self._residual(key, x, x.dtype), self.threshold,
            donate=self._donate(key))
        return q

    def compress_device(self, key, flat: torch.Tensor):
        """A flat payload in its compact form, updating the residual: int8
        gives ``(q, scales)``, 2-bit ``(words,)`` of the packed format."""
        if self.type == "int8":
            q, scales, self._residuals[key] = _qops.quantize_int8_blocks(
                flat, self._residual(key, flat), self.block,
                donate=self._donate(key))
            return q, scales
        levels, self._residuals[key] = _qops.quantize_2bit_ef(
            flat, self._residual(key, flat, flat.dtype), self.threshold,
            donate=self._donate(key))
        return (_qops.pack_2bit_words(levels),)

    def decompress_device(self, payload, n: int) -> torch.Tensor:
        """Inverse of :meth:`compress_device` (float32)."""
        if self.type == "int8":
            q, scales = payload
            return _qops.dequantize_int8_blocks(q, scales, n)
        return _qops.unpack_2bit_words(payload[0], self.threshold, n)

    # -- the host side (the parameter-server wire) ---------------------------
    def encode(self, key, x: torch.Tensor) -> tuple:
        """Compress ``x`` and encode it as a ``QGRAD`` tuple (one host copy
        of the compact payload)."""
        payload = self.compress_device(key, x.reshape(-1))
        dtype = dtype_name(x.dtype)
        if self.type == "int8":
            q, scales = payload
            return encode_wire("int8", x.shape, dtype,
                               (q.cpu().numpy(), scales.cpu().numpy()))
        return encode_wire("2bit", x.shape, dtype,
                           (np.asarray(payload[0].cpu().numpy(), np.uint32),
                            self.threshold))

    def wire_nbytes(self, n: int) -> int:
        return wire_nbytes(self.type, n, self.block)
