"""Sequence (context) parallelism: ring attention and Ulysses.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  The sequence is split over
an ``sp`` mesh axis; each rank calls these on its own shard (B, L/n, H, D)
over that axis's process group (where the reference calls them inside
``shard_map``), and gets its shard of the output.

* :func:`ring_attention`: K/V blocks travel round the ring while each
  rank's Q stays.  Two routes, as the reference's:

  - the kernel route, wherever :func:`~..ops.attention.flash_eligible`
    holds for the shards: each hop runs K1 (``csrc/flash_fwd.cu``) on its
    block, and the normalised partials merge in float32 by their LSEs
    (the reference's ``_ring_attention_flash``).  The whole ring is one
    autograd Function: its backward goes round the ring again, runs K2
    and K3 (``csrc/flash_bwd.cu``) on each hop against the global O and
    LSE, and sends dK/dV accumulators round with the blocks, so that they
    arrive home after n hops.  Every rank therefore issues the same
    collectives in the same order, forward and backward, whatever the
    causal skips, and no LSE cotangent pass is needed.
  - the composition route elsewhere: the reference's online-softmax block
    recurrence, differentiated by autograd through :func:`~.collectives.
    ppermute`; every rank runs the same hops with a mask, so its graph,
    and its collectives, are every other rank's.

  Causal attention is over the global sequence: an earlier shard is seen
  whole, the rank's own causally (the kernels are top-left causal and the
  shards are equal), a later one not at all.  A skipped hop launches no
  kernel but still passes its block on.
* :func:`ulysses_attention`: all-to-alls turn the sequence split into a
  head split, attention runs on whole sequences through
  :func:`~..ops.attention.attention_core` (K1-K3 where eligible), and the
  split is turned back.
* :func:`context_parallel_attention`: either, by name, on a mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import attention as _att
from . import collectives as C
from .mesh import Mesh

__all__ = ["ring_attention", "ulysses_attention",
           "context_parallel_attention"]


def _hop(src: int, idx: int, causal: bool) -> str:
    """What the block of rank ``src`` is to the queries of rank ``idx``."""
    if not causal or src < idx:
        return "full"
    return "diag" if src == idx else "skip"


def _merge(out, lse, out_b, lse_b):
    """The (out, lse) combine of two normalised partials, in float32."""
    lse_new = torch.logaddexp(lse, lse_b)
    zero = torch.zeros((), dtype=lse.dtype, device=lse.device)
    safe = torch.where(torch.isfinite(lse_new), lse_new, zero)
    wa = torch.where(torch.isfinite(lse), torch.exp(lse - safe), zero)
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - safe), zero)
    out = out * wa[..., None] + out_b.float() * wb[..., None]
    return out, lse_new


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> the kernels' contiguous, aligned (B, H, L, D)."""
    return _att._kernel_layout(t.transpose(1, 2))


class _RingFlash(torch.autograd.Function):
    """The kernel route: forward and backward of the whole ring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n, idx = C.axis_size(axis, mesh), C.axis_index(axis, mesh)
        qh = _heads_first(q)
        kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        out = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qh.shape[:3], float("-inf"), dtype=torch.float32,
                         device=q.device)
        for t in range(n):
            mode = _hop((idx - t) % n, idx, causal)
            if mode != "skip":
                out_b, lse_b = _att._flash_fwd(qh, kv[0], kv[1], scale,
                                               mode == "diag")
                out, lse = _merge(out, lse, out_b, lse_b)
            if t != n - 1:
                kv = C._shift(kv, mesh, axis, 1)
        o = out.to(q.dtype)
        ctx.save_for_backward(qh, k, v, o, lse)
        ctx.args = mesh, axis, causal, scale
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        qh, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.args
        n, idx = C.axis_size(axis, mesh), C.axis_index(axis, mesh)
        gh = _heads_first(g.to(o.dtype))
        kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=qh.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=qh.device)
        for t in range(n):
            mode = _hop((idx - t) % n, idx, causal)
            if mode != "skip":
                dq_t, dk_t, dv_t = _att._flash_bwd(
                    qh, kv[0], kv[1], o, lse, gh, scale, mode == "diag")
                dq += dq_t
                dkv[0] += dk_t
                dkv[1] += dv_t
            if t != n - 1:
                kv = C._shift(kv, mesh, axis, 1)
            # the accumulators travel with their block, and the n-th shift
            # brings each home
            dkv = C._shift(dkv, mesh, axis, 1)
        return (dq.to(qh.dtype).transpose(1, 2),
                dkv[0].to(k.dtype).transpose(1, 2),
                dkv[1].to(v.dtype).transpose(1, 2), None, None, None, None)


def _block_attn(q, k, v, q_off, k_off, causal, scale):
    """One (q-block x kv-block) partial flash step of the reference:
    (unnormalised out (B, Lq, H, D), row max, row sum (B, H, Lq))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, l


def _ring_composition(q, k, v, mesh, axis, causal, scale):
    n, idx = C.axis_size(axis, mesh), C.axis_index(axis, mesh)
    lq, lk = q.shape[1], k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    qa = q.to(acc)
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    m = torch.full((q.shape[0], q.shape[2], lq), float("-inf"), dtype=acc,
                   device=q.device)
    l = torch.zeros_like(m)
    kt, vt = k.to(acc), v.to(acc)
    for t in range(n):
        src = (idx - t) % n
        ob, mb, lb = _block_attn(qa, kt, vt, idx * lq, src * lk, causal,
                                 scale)
        m_new = torch.maximum(m, mb)
        alpha = torch.exp(m - m_new)            # rescales the old partial
        beta = torch.exp(mb - m_new)
        l = l * alpha + lb * beta
        o = o * alpha.transpose(1, 2)[..., None] + \
            ob * beta.transpose(1, 2)[..., None]
        m = m_new
        if t != n - 1:
            kt = C.ppermute(kt, axis, mesh)
            vt = C.ppermute(vt, axis, mesh)
    l = torch.clamp(l, min=1e-38)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``axis_name``: q, k, v are this rank's
    sequence shards (B, L_local, H, D); returns its (B, L_local, H, D)
    shard of the output.  The kernel route where
    :func:`~..ops.attention.flash_eligible` holds for the shards, the
    composition route otherwise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    if _att.flash_eligible(*heads, causal=causal):
        return _RingFlash.apply(q, k, v, mesh, axis_name, bool(causal),
                                float(scale))
    return _ring_composition(q, k, v, mesh, axis_name, bool(causal),
                             float(scale))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Mesh, axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses: all-to-all from a sequence split to a head split,
    exact attention on whole sequences for H/n heads, and back.  q, k, v
    (B, L_local, H, D) with H divisible by the axis's size."""
    n = C.axis_size(axis_name, mesh)
    if q.shape[2] % n != 0:
        raise ValueError(
            "ulysses_attention: heads (%d) must divide by the %r axis size "
            "(%d); use ring_attention otherwise" % (q.shape[2], axis_name, n))
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def seq_to_heads(x):
        return C.all_to_all(x, axis_name, 2, 1, mesh)

    qh, kh, vh = (seq_to_heads(x).transpose(1, 2) for x in (q, k, v))
    out = _att.attention_core(qh, kh, vh, scale=scale, causal=causal)
    return C.all_to_all(out.transpose(1, 2).to(q.dtype), axis_name, 1, 2,
                        mesh)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mesh: Mesh, *,
                               sp_axis: str = "sp", causal: bool = False,
                               method: str = "ring",
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """This rank's shards (B, L/n, H, D) of q, k, v on ``mesh``'s
    ``sp_axis`` through ``method`` (``"ring"`` or ``"ulysses"``); returns
    its shard of the output."""
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[method]
    return fn(q, k, v, axis_name=sp_axis, causal=causal, scale=scale,
              mesh=mesh)
