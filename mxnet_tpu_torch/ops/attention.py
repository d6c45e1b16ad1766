"""Attention ops: the hand-written flash-attention forward and its gate.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layout is (B, H, T, D) at
every public function, as in the JAX package.

* :func:`flash_attention_with_lse` / :func:`flash_attention` run the CUDA
  kernel ``csrc/flash_fwd.cu`` (the port of the TPU kernel
  ``_flash_fwd_kernel``) on CUDA tensors.  For CPU tensors, and only for
  them, they compute the kernel's plain PyTorch version
  :func:`flash_attention_plain`.  A CUDA input the kernel does not take
  raises; nothing falls back.  Forward only: the backward kernels and the
  VJP rules come with the training slice.
* :func:`attention_core` dispatches between the kernel and the plain
  composition :func:`attention_composition`.  The JAX package's gate
  (``D % 128 == 0``, ``T % 256 == 0``) came from the TPU's (8, 128) tiling;
  the port's gate is the CUDA kernel's own: no mask, D in {64, 128},
  float32 or bfloat16, not causal or Tq == Tk, any T (the kernel masks the
  ragged edge).  A gated CUDA input that needs a gradient raises
  ``NotImplementedError`` (the kernel is forward-only until the training
  slice); CPU tensors that need one take the composition.
* :func:`set_attention_impl` / :class:`attention_impl_scope` pick the
  implementation: ``"pallas"`` (or None) means the kernel wherever the gate
  holds, ``"xla"`` means the composition.  The names are the JAX package's,
  so callers port unchanged.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from . import _kernels

__all__ = ["attention_core", "attention_composition", "flash_attention",
           "flash_attention_with_lse", "flash_attention_plain",
           "set_attention_impl", "current_attention_impl",
           "attention_impl_scope", "flash_eligible", "KERNEL_HEAD_DIMS",
           "KERNEL_DTYPES"]

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = (None, "pallas", "xla")

# Process-wide default (set_attention_impl) and a thread-local scope stack
# (attention_impl_scope); the innermost scope wins.
_FORCED_IMPL: Optional[str] = None
_IMPL_TLS = threading.local()


def set_attention_impl(impl: Optional[str]) -> Optional[str]:
    """Set the process-wide implementation; returns the previous one."""
    global _FORCED_IMPL
    if impl not in _IMPLS:
        raise ValueError("attention impl must be None, 'pallas' or 'xla'")
    prev = _FORCED_IMPL
    _FORCED_IMPL = impl
    return prev


def current_attention_impl() -> Optional[str]:
    stack = getattr(_IMPL_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _FORCED_IMPL


class attention_impl_scope:
    """Scoped, thread-local override of the attention implementation."""

    def __init__(self, impl: Optional[str]):
        if impl not in _IMPLS:
            raise ValueError("attention impl must be None, 'pallas' or "
                             "'xla'")
        self._impl = impl

    def __enter__(self):
        if not hasattr(_IMPL_TLS, "stack"):
            _IMPL_TLS.stack = []
        _IMPL_TLS.stack.append(self._impl)
        return self

    def __exit__(self, *exc):
        _IMPL_TLS.stack.pop()
        return False


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash kernel computes, in plain PyTorch: (O, LSE) with O in
    q's dtype and LSE (B, H, Tq) float32.  Float32 throughout; the causal
    mask is the kernel's top-left ``q_pos >= k_pos``; a row that sees no
    key gives LSE = -inf and O = 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        keep = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(s - lse_safe[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def attention_composition(q, k, v, scale: float, causal: bool = False,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's jnp composition: fp32 logits, the bottom-right
    causal mask ``tril(ones, Tk - Tq)``, a key mask with finite -1e30,
    softmax cast to q's dtype, then the value product."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        cm = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(
            tk - tq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_grad(*ts: torch.Tensor) -> None:
    if _needs_grad(*ts):
        raise NotImplementedError(
            "flash attention is forward-only in the serving slice; its "
            "backward (the dq and dkv kernels and the VJP rules) comes with "
            "the training slice. Run under torch.no_grad()/inference_mode, "
            "or select the composition with attention_impl_scope('xla').")


def _check_kernel_inputs(q, k, v) -> None:
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise MXNetError("flash_attention: q, k, v on different devices %s"
                         % sorted(map(str, devs)))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k, v must be (B, H, T, D)")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError("flash_attention: the kernel takes float32 or "
                         "bfloat16 q, k, v of one dtype, got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    B, H, Tq, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise MXNetError("flash_attention: head dim %d not in %s"
                         % (D, KERNEL_HEAD_DIMS))
    if k.shape[:2] != (B, H) or k.shape[3] != D or v.shape != k.shape:
        raise MXNetError("flash_attention: shapes q %s, k %s, v %s do not "
                         "agree" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if Tq < 1 or B * H < 1:
        raise MXNetError("flash_attention: empty query %s" % (tuple(q.shape),))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention: the kernel takes contiguous "
                         "(B, H, T, D) tensors")


def _flash_fwd_cuda(q, k, v, scale: float, causal: bool):
    """Launch ``mx_flash_fwd`` on the current stream; (O, LSE (B, H, Tq))."""
    _check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    lib = _kernels.FLASH_FWD.load()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), B * H, Tq, Tk,
                               D, _DTYPE_CODE[q.dtype], float(scale),
                               int(bool(causal)), stream)
    _kernels.FLASH_FWD.check(err, "flash_fwd launch")
    _kernels.FLASH_FWD.count_launch()
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float, causal: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise flash attention returning (O, LSE (B, H, Tq) float32).

    CUDA tensors go through the kernel (or raise); CPU tensors through
    :func:`flash_attention_plain`."""
    _refuse_grad(q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, scale, causal)
    return _flash_fwd_cuda(q, k, v, scale, causal)


def flash_attention(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Blockwise flash attention, (B, H, T, D) layout."""
    return flash_attention_with_lse(q, k, v, scale, causal)[0]


def flash_eligible(q, k, v, causal: bool = False, mask=None) -> bool:
    """The port's dispatch gate: the CUDA kernel's own constraints."""
    if current_attention_impl() == "xla" or mask is not None:
        return False
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS or k.shape[-1] != D or v.shape[-1] != D:
        return False
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        return False
    # K1 is top-left causal, the composition bottom-right
    return not causal or q.shape[2] == k.shape[2]


def attention_core(q, k, v, scale: Optional[float] = None,
                   causal: bool = False,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: the flash kernel where :func:`flash_eligible` holds, the
    composition otherwise.  q, k, v: (B, H, T, D).  A gated input that
    needs a gradient takes the composition on the CPU and raises
    ``NotImplementedError`` on the card (the kernel is forward-only)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    on_cpu = all(t.device.type == "cpu" for t in (q, k, v))
    if flash_eligible(q, k, v, causal, mask) and not (
            on_cpu and _needs_grad(q, k, v)):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), float(scale), bool(causal))
    return attention_composition(q, k, v, float(scale), causal, mask)
