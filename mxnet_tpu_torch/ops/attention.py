"""Attention ops: the hand-written flash-attention kernels, their VJP rules
and the gate.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layout is (B, H, T, D) at
every public function, as in the JAX package.

* :func:`flash_attention_with_lse` / :func:`flash_attention` are
  ``torch.autograd.Function``s, the counterparts of the JAX package's
  ``custom_vjp`` rules.  Forward runs K1, ``csrc/flash_fwd.cu`` (the port of
  the TPU kernel ``_flash_fwd_kernel``), and saves q, k, v, O and LSE;
  backward runs K2 and K3, ``csrc/flash_bwd.cu`` (the ports of
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``), which recompute
  the probabilities from LSE.  The LSE cotangent of
  :func:`flash_attention_with_lse` costs one more K1 pass (v := k) and one
  more K2 + K3 pass, each skipped when its cotangent is unused, as the JAX
  rule skips symbolic zeros.
* Every kernel's wrapper launches it on CUDA tensors and computes its
  plain PyTorch version (:func:`flash_attention_plain`,
  :func:`flash_bwd_dq_plain`, :func:`flash_bwd_dkv_plain`) for CPU
  tensors, and only for them.  A CUDA input a kernel does not take raises;
  nothing falls back.  The CPU tests therefore run the same VJP rules as
  the card.
* :func:`attention_core` dispatches between the Functions and the plain
  composition :func:`attention_composition`.  The JAX package's gate
  (``D % 128 == 0``, ``T % 256 == 0``) came from the TPU's (8, 128) tiling;
  the port's gate is the CUDA kernels' own: no mask, D in {64, 128},
  float32 or bfloat16, not causal or Tq == Tk, any T (the kernels mask the
  ragged edge).  Whether an input needs a gradient plays no part in it.
* :func:`set_attention_impl` / :class:`attention_impl_scope` pick the
  implementation: ``"pallas"`` (or None) means the kernels wherever the
  gate holds, ``"xla"`` means the composition.  The names are the JAX
  package's, so callers port unchanged.
* The decode-time attention (:func:`cached_attention`,
  :func:`cached_attention_multi`, :func:`paged_attention`,
  :func:`paged_attention_multi`) is a composition in both packages (XLA
  gather + softmax in the reference), so it launches none of the kernels.
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
           "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
           "set_attention_impl", "current_attention_impl",
           "attention_impl_scope", "flash_eligible", "KERNEL_HEAD_DIMS",
           "KERNEL_DTYPES", "cached_attention", "cached_attention_multi",
           "paged_attention", "paged_attention_multi"]

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16     # bytes: the kernels' cp.async copies and TMA maps
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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, as in the kernels, or
    float64 for float64 inputs (CPU only, for gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    """The kernels' top-left causal mask ``q_pos >= k_pos``, (Tq, Tk)."""
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes, in plain PyTorch: (O, LSE) with O in q's dtype and
    LSE (B, H, Tq) float32.  Float32 throughout (float64 for float64
    inputs); the causal mask is the kernel's top-left ``q_pos >= k_pos``; a
    row that sees no key gives LSE = -inf and O = 0."""
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc) * scale, k.to(acc))
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], k.shape[2], q.device),
                          float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(s - lse_safe[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, o, lse, g, scale: float, causal: bool):
    """(P, dS) of the flash backward, recomputed from LSE as K2 and K3 do:
    P = exp(scale QK^T - LSE) with the top-left causal mask and the
    ``isfinite`` guards, dS = P * (dO V^T - rowsum(dO * O))."""
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], k.shape[2], q.device),
                          float("-inf"))
    lse = lse.to(acc)[..., None]
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(torch.isfinite(s) & torch.isfinite(lse),
                    torch.exp(s - lse_safe), torch.zeros_like(s))
    g32 = g.to(acc)
    delta = (g32 * o.to(acc)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, v.to(acc))
    return p, p * (dp - delta)


def flash_bwd_dq_plain(q, k, v, o, lse, g, scale: float, causal: bool
                       ) -> torch.Tensor:
    """What K2 computes, in plain PyTorch: dQ = scale * dS K, in q's
    dtype.  ``o`` is the forward's output, ``lse`` its (B, H, Tq) LSE and
    ``g`` the cotangent of ``o``."""
    _, ds = _bwd_probs(q, k, v, o, lse, g, scale, causal)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ds.dtype)) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, o, lse, g, scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K3 computes, in plain PyTorch: (dK, dV) = (scale * dS^T Q,
    P^T dO) in k's and v's dtypes; arguments as for
    :func:`flash_bwd_dq_plain`."""
    p, ds = _bwd_probs(q, k, v, o, lse, g, scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ds.dtype)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_composition(q, k, v, scale: float, causal: bool = False,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's jnp composition: fp32 logits (float64 for float64
    inputs), the bottom-right causal mask ``tril(ones, Tk - Tq)``, a key
    mask with finite -1e30, softmax cast to q's dtype, then the value
    product."""
    acc = _acc_dtype(q)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
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
# the kernels' wrappers
# ---------------------------------------------------------------------------


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned("flash_attention", name, t)


def _check_aligned(what: str, name: str, t: torch.Tensor) -> None:
    """Every kernel loads 16-byte chunks of every row (TMA in K1 bf16,
    whose tensor maps need a 16-byte-aligned base and 16-byte-multiple row
    strides; ``cp.async`` in K1 fp32 and in K2 and K3, fp32 and bf16), so
    a tensor must start on a 16-byte boundary (rows of D in {64, 128} then
    do too)."""
    if t.data_ptr() % _ALIGN:
        raise MXNetError("%s: the kernels need %s 16-byte aligned, got "
                         "address %#x (a view at storage offset %d)"
                         % (what, name, t.data_ptr(), t.storage_offset()))


def _check_bwd_inputs(q, k, v, o, lse, g) -> None:
    """What the backward kernels take beyond :func:`_check_kernel_inputs`:
    O and its cotangent like q, 16-byte aligned, and LSE (B, H, Tq)
    float32, all contiguous on q's device."""
    _check_kernel_inputs(q, k, v)
    for name, t in (("O", o), ("the gradient of O", g)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise MXNetError("flash_attention backward: %s must be a "
                             "contiguous %s %s tensor on %s, got %s %s on %s"
                             % (name, tuple(q.shape), q.dtype, q.device,
                                tuple(t.shape), t.dtype, t.device))
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise MXNetError("flash_attention backward: LSE must be a contiguous "
                         "%s float32 tensor on %s" % (tuple(q.shape[:3]),
                                                      q.device))
    for name, t in (("O", o), ("the gradient of O", g)):
        _check_aligned("flash_attention backward", name, t)


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _flash_fwd_cuda(q, k, v, scale: float, causal: bool):
    """K1 on CUDA tensors; (O, LSE (B, H, Tq)).  The inputs are made
    contiguous and aligned here, as :func:`_flash_bwd_cuda` makes its own:
    a contiguous view at any 4-byte offset reaches the kernel as an aligned
    copy."""
    return _flash_fwd_launch(*map(_kernel_layout, (q, k, v)), scale, causal)


def _flash_fwd_launch(q, k, v, scale: float, causal: bool):
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
    _kernels.FLASH_FWD.count_launch("flash_fwd")
    return out, lse


def _bwd_launch(q, k, v, o, lse, g, scale: float, causal: bool):
    """The checked arguments both backward kernels share: the input
    pointers, then (B*H, Tq, Tk, D, dtype, scale, causal)."""
    _check_bwd_inputs(q, k, v, o, lse, g)
    B, H, Tq, D = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), lse.data_ptr())
    dims = (B * H, Tq, k.shape[2], D, _DTYPE_CODE[q.dtype], float(scale),
            int(bool(causal)))
    return ptrs, dims


def _flash_bwd_dq_cuda(q, k, v, o, lse, g, scale: float, causal: bool):
    """Launch ``mx_flash_bwd_dq`` (K2) on the current stream; dQ."""
    ptrs, dims = _bwd_launch(q, k, v, o, lse, g, scale, causal)
    lib = _kernels.FLASH_BWD.load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_bwd_dq(*ptrs, dq.data_ptr(), *dims, stream)
    _kernels.FLASH_BWD.check(err, "flash_bwd_dq launch")
    _kernels.FLASH_BWD.count_launch("flash_bwd_dq")
    return dq


def _flash_bwd_dkv_cuda(q, k, v, o, lse, g, scale: float, causal: bool):
    """Launch ``mx_flash_bwd_dkv`` (K3) on the current stream; (dK, dV)."""
    ptrs, dims = _bwd_launch(q, k, v, o, lse, g, scale, causal)
    lib = _kernels.FLASH_BWD.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                   *dims, stream)
    _kernels.FLASH_BWD.check(err, "flash_bwd_dkv launch")
    _kernels.FLASH_BWD.count_launch("flash_bwd_dkv")
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, g, scale: float, causal: bool):
    """K2 then K3 on CUDA tensors; (dQ, dK, dV).  The inputs are made
    contiguous and aligned here: ``g`` arrives transposed from the head
    merge of ``multi_head_attention``, and the Function saves q, k and v as
    the caller passed them."""
    q, k, v, o, g = map(_kernel_layout, (q, k, v, o, g))
    dq = _flash_bwd_dq_cuda(q, k, v, o, lse, g, scale, causal)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, o, lse, g, scale, causal)
    return dq, dk, dv


def _flash_fwd(q, k, v, scale: float, causal: bool):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale, causal)
    return _flash_fwd_cuda(q, k, v, scale, causal)


def _flash_bwd(q, k, v, o, lse, g, scale: float, causal: bool):
    """K2 and K3 on CUDA tensors, their plain versions on CPU tensors;
    (dQ, dK, dV)."""
    if _on_cpu(q, k, v, o, lse, g):
        dk, dv = flash_bwd_dkv_plain(q, k, v, o, lse, g, scale, causal)
        return flash_bwd_dq_plain(q, k, v, o, lse, g, scale, causal), dk, dv
    return _flash_bwd_cuda(q, k, v, o, lse, g, scale, causal)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``'s VJP rule (the JAX package's
    ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, g, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    """``flash_attention_with_lse``'s VJP rule (the JAX package's
    ``_flash_lse_vjp_fwd`` / ``_flash_lse_vjp_bwd``), term for term.  An
    unused output's cotangent arrives as None and its passes are skipped."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.set_materialize_grads(False)
        out, lse = _flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal = ctx.scale, ctx.causal
        if g_out is None:
            dq, dk, dv = (torch.zeros_like(q), torch.zeros_like(k),
                          torch.zeros_like(v))
        else:
            dq, dk, dv = _flash_bwd(q, k, v, o, lse, g_out, scale, causal)
        if g_lse is not None:
            # dq += scale * g_lse * (P K), which is K1 with v := k, and
            # dk += scale * P^T (g_lse * q), which is K3's dV with v and O
            # zeroed and g_lse * q as the cotangent
            acc = _acc_dtype(q)
            gl = torch.where(torch.isfinite(lse), g_lse.to(acc),
                             torch.zeros((), dtype=acc, device=lse.device)
                             )[..., None]
            pk = _flash_fwd(q, k, k.to(q.dtype), scale, causal)[0]
            dq = (dq.to(acc) + scale * gl * pk.to(acc)).to(dq.dtype)
            g2 = (gl * q.to(acc)).to(q.dtype)
            _, _, dk2 = _flash_bwd(q, k, torch.zeros_like(v),
                                   torch.zeros_like(o), lse, g2, scale,
                                   causal)
            dk = (dk.to(acc) + scale * dk2.to(acc)).to(dk.dtype)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float, causal: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise flash attention returning (O, LSE (B, H, Tq) float32),
    differentiable in both outputs.

    CUDA tensors go through the kernels (or raise); CPU tensors through
    their plain versions."""
    return _FlashAttentionWithLse.apply(q, k, v, float(scale), bool(causal))


def flash_attention(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Blockwise flash attention, (B, H, T, D) layout, differentiable."""
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))


def flash_eligible(q, k, v, causal: bool = False, mask=None) -> bool:
    """The port's dispatch gate: the CUDA kernels' own constraints."""
    if current_attention_impl() == "xla" or mask is not None:
        return False
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS or k.shape[-1] != D or v.shape[-1] != D:
        return False
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        return False
    # the kernels are top-left causal, the composition bottom-right
    return not causal or q.shape[2] == k.shape[2]


def attention_core(q, k, v, scale: Optional[float] = None,
                   causal: bool = False,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: the flash Function where :func:`flash_eligible` holds, the
    composition otherwise.  q, k, v: (B, H, T, D).  The same gate holds on
    the CPU and the card, with or without a gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_eligible(q, k, v, causal, mask):
        return flash_attention(_kernel_layout(q), _kernel_layout(k),
                               _kernel_layout(v), float(scale), bool(causal))
    return attention_composition(q, k, v, float(scale), causal, mask)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels take it: a
    copy unless it already is (BERT's heads always are: they are split from
    the fused projection by a transpose, so ``contiguous`` copies them)."""
    t = t.contiguous()
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


# ---------------------------------------------------------------------------
# cached (decode-time) attention: one query token per sequence over a
# fixed-capacity KV page buffer under a valid-length mask — the decode
# engine's path (serve/decode.py).  The buffer is the slot's whole extent,
# so the shapes never depend on how far a generation has progressed.
# ---------------------------------------------------------------------------


def _masked_softmax_dtype(logits: torch.Tensor, valid: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Softmax of ``logits`` (float32, or float64 for float64 inputs) with
    the invalid keys at a finite -1e30 (never -inf: every row keeps a live
    key, so even a scratch lane stays NaN-free), cast to ``dtype``."""
    logits = logits.masked_fill(~valid, -1e30)
    return torch.softmax(logits, dim=-1).to(dtype)


def cached_attention(q, k_pages, v_pages, cur_len, scale=None):
    """Single-position attention over per-sequence KV cache pages.

    ``q``: (B, H, D), the current token's query per sequence;
    ``k_pages``/``v_pages``: (B, P, H, D), each sequence's buffer at its
    full capacity P (positions >= ``cur_len`` hold stale or zero entries);
    ``cur_len``: (B,) integer, the valid leading positions (the current
    token's just-written entry included; >= 1).  Returns (B, H, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    P = k_pages.shape[1]
    acc = _acc_dtype(q)
    logits = torch.einsum("bhd,bphd->bhp", q.to(acc), k_pages.to(acc)) \
        * scale
    valid = torch.arange(P, device=q.device)[None, None, :] < \
        cur_len.to(q.device)[:, None, None]
    probs = _masked_softmax_dtype(logits, valid, q.dtype)
    return torch.einsum("bhp,bphd->bhd", probs, v_pages)


def cached_attention_multi(q, k_pages, v_pages, pos, scale=None):
    """Multi-position attention over per-sequence KV cache pages (the
    speculative verify's form): T query rows per sequence, row t attending
    keys [0, pos[b, t]] (its own entry already written).

    ``q``: (B, T, H, D); ``k_pages``/``v_pages``: (B, P, H, D); ``pos``:
    (B, T) integer absolute positions.  Returns (B, T, H, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    P = k_pages.shape[1]
    acc = _acc_dtype(q)
    logits = torch.einsum("bthd,bphd->bthp", q.to(acc), k_pages.to(acc)) \
        * scale
    valid = torch.arange(P, device=q.device)[None, None, :] <= \
        pos.to(q.device)[:, :, None]
    probs = _masked_softmax_dtype(logits, valid[:, :, None, :], q.dtype)
    return torch.einsum("bthp,bphd->bthd", probs, v_pages)


def _gather_pages(heap, block_tables):
    """Each lane's pages of one layer's heap (n_pages, page_len, H, D),
    through its block table (B, pages_per_slot), as the lane's logical
    extent (B, pages_per_slot * page_len, H, D)."""
    B = block_tables.shape[0]
    extent = block_tables.shape[1] * heap.shape[1]
    return heap[block_tables.long()].reshape((B, extent) + heap.shape[2:])


def paged_attention(q, k_heap, v_heap, block_tables, cur_len, scale=None):
    """Single-position attention over a paged KV heap: gathers each lane's
    pages into the (B, extent, H, D) view :func:`cached_attention` takes
    and delegates, so the masking and softmax are the same.

    ``q``: (B, H, D); ``k_heap``/``v_heap``: (n_pages, page_len, H, D),
    one layer's heap; ``block_tables``: (B, pages_per_slot) physical page
    ids (scratch lanes: all zeros, page 0 is reserved); ``cur_len``: (B,).
    Returns (B, H, D)."""
    return cached_attention(q, _gather_pages(k_heap, block_tables),
                            _gather_pages(v_heap, block_tables), cur_len,
                            scale=scale)


def paged_attention_multi(q, k_heap, v_heap, block_tables, pos,
                          scale=None):
    """Multi-position attention over a paged KV heap (the speculative
    verify's core): :func:`paged_attention`'s gather, then
    :func:`cached_attention_multi`.  ``q``: (B, T, H, D); ``pos``: (B, T).
    Returns (B, T, H, D)."""
    return cached_attention_multi(q, _gather_pages(k_heap, block_tables),
                                  _gather_pages(v_heap, block_tables), pos,
                                  scale=scale)
