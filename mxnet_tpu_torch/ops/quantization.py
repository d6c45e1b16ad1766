"""Gradient-compression arithmetic of the exchange wire.

Counterpart of the gradient-compression half of
``mxnet_tpu/ops/quantization.py`` (reference:
src/kvstore/gradient_compression.cc; the int8 mode follows EQuARX,
arXiv:2506.17615): plain torch functions on whatever device the payload
lives on, bitwise the JAX package's arithmetic.

* int8: symmetric per-block quantization (scale = max|block| / 127,
  zero-point 0) with a float32 error-feedback residual: what a step's
  quantization drops is carried into the next step's payload.
* 2bit: the reference's +-threshold/0 levels with the same residual
  contract, and a 16-codes-per-uint32 packed format (code i of a word at
  bits [2i, 2i+1], 00 = 0, 01 = -t, 10 = +t), bit-compatible with
  ``kvstore.wire_codec.pack_2bit``.

Each function returns new tensors and never writes its inputs, so a
residual the caller keeps (``GradientCompression.checkpoint``) stays
valid; the JAX package donates the residual instead.  The inference ops
of the reference module (``_contrib_quantize`` and the quantized layers)
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import get_env

__all__ = ["GRAD_BLOCK_DEFAULT", "grad_compress_block", "int8_wire_bytes",
           "two_bit_wire_bytes", "quantize_int8_blocks",
           "dequantize_int8_blocks", "roundtrip_int8_blocks",
           "rs_block_bytes", "rs_roundtrip_int8",
           "dequant_sum_requant_int8", "quantize_2bit_ef",
           "pack_2bit_words", "unpack_2bit_words"]

GRAD_BLOCK_DEFAULT = 256
_INT8_MAX = 127.0
#: 1/127 rounded to float32: XLA turns the reference's division of the
#: block maximum by 127 into this product, and the port keeps its bits
_INV_INT8_MAX = float(np.float32(1.0 / 127.0))


def grad_compress_block() -> int:
    """Elements per int8 scale block (``MX_GRAD_COMPRESS_BLOCK``)."""
    return max(1, int(get_env("MX_GRAD_COMPRESS_BLOCK", GRAD_BLOCK_DEFAULT,
                              int)))


def int8_wire_bytes(n: int, block: int) -> int:
    """Wire footprint of an n-element int8 payload: padded codes and one
    float32 scale a block."""
    nblocks = -(-n // block)
    return nblocks * block + 4 * nblocks


def two_bit_wire_bytes(n: int) -> int:
    """Wire footprint of the packed 2-bit format: 16 codes a uint32 word
    and the float32 threshold."""
    return 4 * (-(-n // 16)) + 4


def _requantize(blocks: torch.Tensor):
    """Codes and scales of float32 ``blocks`` (nb, block), one scale a
    row."""
    amax = blocks.abs().amax(dim=1)
    scales = torch.clamp(amax, min=1e-30) * _INV_INT8_MAX
    q = torch.clamp(torch.round(blocks / scales[:, None]), -_INT8_MAX,
                    _INT8_MAX)
    return q, scales


def quantize_int8_blocks(flat: torch.Tensor, residual: torch.Tensor,
                         block: int = None):
    """One error-feedback int8 step over a flat payload: ``(q, scales,
    new_residual)``, the int8 codes padded to a whole number of blocks,
    one float32 scale a block, and the float32 residual for the next
    step."""
    block = int(block or grad_compress_block())
    acc = flat.float() + residual
    n = acc.shape[0]
    pad = (-n) % block
    if pad:
        acc = torch.cat([acc, acc.new_zeros(pad)])
    blocks = acc.reshape(-1, block)
    q, scales = _requantize(blocks)
    # one rounding of blocks - q * scales, as the reference's fused
    # multiply-subtract gives it: the product of an int8 code and a
    # float32 scale, and its difference from a value it is close to, are
    # exact in float64
    new_res = (blocks.double() - q.double() * scales.double()[:, None]
               ).float().reshape(-1)[:n]
    return q.to(torch.int8).reshape(-1), scales, new_res


def dequantize_int8_blocks(q: torch.Tensor, scales: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_blocks`: the first ``n`` values, in
    float32."""
    block = q.shape[0] // scales.shape[0]
    return (q.reshape(-1, block).float() * scales[:, None]).reshape(-1)[:n]


def roundtrip_int8_blocks(flat: torch.Tensor, residual: torch.Tensor,
                          block: int = None):
    """Quantize and dequantize: what a single worker's exchange observes
    of int8 compression.  ``(values in flat's dtype, new_residual)``."""
    q, scales, new_res = quantize_int8_blocks(flat, residual, block)
    return (dequantize_int8_blocks(q, scales, flat.shape[0]).to(flat.dtype),
            new_res)


def rs_block_bytes(n: int, block: int, fsdp: int) -> int:
    """Padded flat length of the reduce-scatter int8 grain: whole blocks
    per fsdp shard, so that shard-local blockwise quantization is the
    whole payload's blockwise quantization."""
    grain = block * max(1, int(fsdp))
    return -(-int(n) // grain) * grain


def rs_roundtrip_int8(shard: torch.Tensor, residual: torch.Tensor,
                      block: int):
    """The error-feedback int8 roundtrip of one fsdp rank's shard of a
    reduce-scattered payload (padded by :func:`rs_block_bytes`, so the
    shard is whole blocks) against its own residual shard:
    ``(dequantized shard, new residual shard)``, the same values as
    :func:`roundtrip_int8_blocks` gives these blocks of the whole payload.
    The reference runs it under ``shard_map`` over the fsdp axis; here
    each rank calls it on its shard."""
    block = int(block)
    if shard.shape[0] % block:
        raise ValueError("rs_roundtrip_int8: a shard of %d is not whole "
                         "blocks of %d" % (shard.shape[0], block))
    return roundtrip_int8_blocks(shard, residual, block)


def dequant_sum_requant_int8(q_stacked: torch.Tensor,
                             scales_stacked: torch.Tensor):
    """The scale-merged reduction of W workers' int8 payloads: each
    dequantized at its own scales, summed, and the sum requantized at a
    fresh scale (EQuARX's allreduce body).  ``q_stacked`` (W, nb * block)
    int8, ``scales_stacked`` (W, nb) float32 -> (nb * block int8, nb
    float32)."""
    w, nb = scales_stacked.shape
    block = q_stacked.shape[1] // nb
    q_all = q_stacked.reshape(w, nb, block)
    # the reference's reduction: the first product rounded, then each
    # further one added by a fused multiply-add (one rounding a worker)
    f = q_all[0].float() * scales_stacked[0][:, None]
    for i in range(1, w):
        f = (f.double() + q_all[i].double()
             * scales_stacked[i].double()[:, None]).float()
    q, scales = _requantize(f)
    return q.to(torch.int8).reshape(-1), scales


def quantize_2bit_ef(grad: torch.Tensor, residual: torch.Tensor,
                     threshold: float):
    """The reference's Quantize2BitImpl with error feedback:
    ``(levels in {-t, 0, +t}, new_residual)``, both in ``grad``'s
    dtype."""
    t = torch.tensor(threshold, dtype=grad.dtype, device=grad.device)
    acc = residual + grad
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    q = (torch.where(acc >= t, t, zero)
         + torch.where(acc <= -t, -t, zero)).to(grad.dtype)
    return q, (acc - q).to(grad.dtype)


_SHIFTS = tuple(2 * i for i in range(16))


def pack_2bit_words(levels: torch.Tensor) -> torch.Tensor:
    """Levels as the packed 2-bit format: uint32 words, 16 codes each."""
    flat = levels.reshape(-1)
    codes = torch.where(flat > 0, 2, torch.where(flat < 0, 1, 0)).to(
        torch.int64)
    pad = (-codes.shape[0]) % 16
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=flat.device)
    # the shifted codes sit in disjoint bit lanes: their sum is their or
    return (codes.reshape(-1, 16) << shifts).sum(dim=1).to(torch.uint32)


def unpack_2bit_words(words: torch.Tensor, threshold: float,
                      n: int) -> torch.Tensor:
    """Inverse of :func:`pack_2bit_words`: the first ``n`` codes as
    float32 levels."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    codes = ((words.to(torch.int64)[:, None] >> shifts) & 0x3).reshape(-1)
    codes = codes[:n]
    t = torch.tensor(threshold, dtype=torch.float32, device=words.device)
    zero = torch.zeros((), dtype=torch.float32, device=words.device)
    return torch.where(codes == 2, t, torch.where(codes == 1, -t, zero))
