"""Autoregressive decode serving: a device-resident KV cache and continuous
batching.

Counterpart of ``mxnet_tpu/serve/decode.py``.  What it keeps, and what
differs, and why:

* **Split prefill / decode, bucketed.**  Prefill (the whole prompt into
  the slot's KV pages, the first token out) has one program per
  prompt-length bucket (``MX_SERVE_DECODE_PROMPT_BUCKETS``); a decode step
  (one token for every active sequence) has one per active-slot-count
  bucket (powers of two up to ``MX_SERVE_DECODE_SLOTS``).  PyTorch runs
  eagerly, so a "program" here is the bucket's entry in the servable's
  table, a callable over the bucket's shapes; building one counts as a
  retrace (``serve.retraces``), :meth:`DecodeServable.warm` builds and
  runs them all, and every later dispatch is a table hit
  (``serve.bucket_hits``).  Registering them with ``programs.py`` (the
  HBM census, the program contracts, ``footprint_bytes``) waits for its
  port.
* **The KV pool is allocated once and updated in place.**  K and V live
  in two arrays ``(layers, slots+1, max_len, heads, head_dim)`` on the
  device (+1: the scratch slot that padded lanes park on).  torch has no
  buffer donation, so every body writes the pool and the per-slot
  ``tok`` / ``len`` arrays in place (index assignment); the step's token
  output is what the reference's functional body returns.  Retiring a
  sequence is bookkeeping: the slot's length resets on reuse and stale
  entries past it are masked, never read.
* **Continuous batching.**  The pump packs all active sequences into the
  smallest covering slot bucket each step (one dispatch whatever the
  active count), retires finished sequences and admits queued prefills at
  step boundaries.  The next input token stays on the device between
  steps.  The pump never reads the device: each dispatch's token output
  is copied without blocking into pinned host memory behind a CUDA event
  (:class:`_Readback`), and the harvester thread waits on that event,
  appends the tokens, stamps per-token latency and flags EOS or the limit
  for the next boundary.  ``mode="request"`` is the request-level
  strawman (admit a batch, run it to completion).
* **The paged engine** (:class:`PagedDecodeServable` /
  :class:`PagedDecodeBatcher`): one shared page heap ``(L, kv_pages,
  kv_page_len, H, Dh)`` addressed through per-session block tables, so
  admission is bounded by free pages, not slots; full prompt pages are
  shared by a chained content hash with copy-on-write of a partial last
  page (:mod:`.paging`); prompts prefill as page-aligned chunks that
  alternate with decode steps, one dispatch a tick.
* **Speculative decode** (:class:`DraftDecodeServable`,
  :class:`SpeculativeDecodeBatcher`): ``spec_k`` draft steps write their
  proposals into a device buffer, and one verify dispatch of the target
  over all ``spec_k + 1`` positions accepts the longest agreeing prefix;
  the tokens are the target's own argmax, so the output equals plain
  greedy decode.

The attention of every body is a composition
(:func:`~mxnet_tpu_torch.ops.attention.cached_attention` and friends, and
``attention_core`` with a mask for prefill), as in the reference, so decode
launches none of the flash kernels.  Nothing falls back: a servable made
for the GPU raises without CUDA.

Telemetry: ``prefill`` / ``decode_step`` / ``kv_evict`` phases land in
``step_phase_seconds``; ``serve.decode.token_seconds`` histograms
per-token latency; counters ``serve.decode.requests`` / ``tokens`` /
``steps`` / ``prefills`` / ``sequences`` / ``rejected``.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError, get_env
from ..device import DeviceLike, resolve
from .. import fault as _fault
from .. import telemetry as _telemetry
from ..ops.attention import (attention_core, cached_attention,
                             paged_attention, paged_attention_multi)
from .batcher import Overloaded, result_timeout as _result_timeout
from .paging import PageAllocator, page_hashes

__all__ = ["DecodeConfig", "DecodeServable", "DecodeBatcher",
           "PagedDecodeServable", "PagedDecodeBatcher",
           "DraftDecodeServable", "SpeculativeDecodeBatcher",
           "demo_lm_params", "demo_lm_numpy", "demo_spec_pair",
           "params_to_device", "reference_generate"]

# extra pool positions past prompt+generation capacity: the pump may run a
# few steps ahead of the harvester (bounded by the harvest queue) before a
# finished sequence is retired, and those overrun writes must still land
# inside the slot's pages
_OVERRUN_MARGIN = 8

_PROGRAMS = ("%s waits for programs.py (the program registry, the HBM "
             "census and the program contracts; ROADMAP Queue 1 item 6)")


class DecodeConfig:
    """Decode-engine geometry: model dims + pool/bucket layout.

    Slot buckets are the powers of two up to ``slots`` (plus ``slots``
    itself), so every active-set size packs into the smallest covering
    bucket.  ``max_len`` is the per-slot page capacity: top prompt bucket
    + ``max_tokens`` + the pipeline overrun margin, rounded up to whole
    ``page``-sized pages.  The same knobs as the reference, read from the
    same environment variables.
    """

    def __init__(self, vocab: int = 48, dim: int = 32, heads: int = 4,
                 layers: int = 2, slots: Optional[int] = None,
                 max_tokens: Optional[int] = None,
                 page: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, seed: int = 7,
                 kv_pages: Optional[int] = None,
                 kv_page_len: Optional[int] = None,
                 prefix_share: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 spec_k: Optional[int] = None):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.heads = int(heads)
        if self.dim % self.heads:
            raise MXNetError("decode: dim %d must divide by heads %d"
                             % (self.dim, self.heads))
        self.head_dim = self.dim // self.heads
        self.layers = int(layers)
        self.slots = int(slots if slots is not None else
                         get_env("MX_SERVE_DECODE_SLOTS", 8, int))
        if self.slots < 1:
            raise MXNetError("decode: need >= 1 slot")
        self.max_tokens = int(max_tokens if max_tokens is not None else
                              get_env("MX_SERVE_DECODE_MAX_TOKENS", 32,
                                      int))
        self.page = int(page if page is not None else
                        get_env("MX_SERVE_DECODE_PAGE", 16, int))
        if prompt_buckets is None:
            raw = get_env("MX_SERVE_DECODE_PROMPT_BUCKETS") or "4,8,16"
            prompt_buckets = [int(p) for p in str(raw).split(",")
                              if p.strip()]
        self.prompt_buckets: Tuple[int, ...] = \
            tuple(sorted({int(b) for b in prompt_buckets}))
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise MXNetError("decode: prompt buckets must be positive, "
                             "got %r" % (prompt_buckets,))
        sizes = set()
        b = 1
        while b < self.slots:
            sizes.add(b)
            b *= 2
        sizes.add(self.slots)
        self.slot_buckets: Tuple[int, ...] = tuple(sorted(sizes))
        self.eos_id = None if eos_id is None else int(eos_id)
        need = self.prompt_buckets[-1] + self.max_tokens + _OVERRUN_MARGIN
        self.pages = -(-need // self.page)
        self.max_len = self.pages * self.page
        self.seed = int(seed)
        # -- the paged pool's geometry: one shared page heap; a session
        # holds only the pages its prompt + generation extent needs
        self.kv_page_len = int(
            kv_page_len if kv_page_len is not None else
            get_env("MX_SERVE_KV_PAGE_LEN", 0, int) or self.page)
        if self.kv_page_len < 1:
            raise MXNetError("decode: MX_SERVE_KV_PAGE_LEN must be "
                             ">= 1, got %d" % self.kv_page_len)
        self.pages_per_slot = -(-need // self.kv_page_len)
        self.slot_extent = self.pages_per_slot * self.kv_page_len
        n_pages = int(kv_pages if kv_pages is not None else
                      get_env("MX_SERVE_KV_PAGES", 0, int))
        if n_pages <= 0:
            # auto: the bytes the flat pool's (slots+1) extents take
            n_pages = (self.slots + 1) * self.pages_per_slot
        # floor: the scratch page plus one worst-case session
        self.kv_pages = max(n_pages, self.pages_per_slot + 1)
        share = (prefix_share if prefix_share is not None else
                 get_env("MX_SERVE_PREFIX_SHARE", 1, int))
        self.prefix_share = bool(int(share))
        chunk = int(prefill_chunk if prefill_chunk is not None else
                    get_env("MX_SERVE_PREFILL_CHUNK", 0, int))
        if chunk <= 0:
            chunk = self.kv_page_len
        # chunks are page-aligned by construction: round up
        self.prefill_chunk = \
            -(-chunk // self.kv_page_len) * self.kv_page_len
        # -- the speculative window: the verify writes positions
        # len..len+k before acceptance truncates back, so k may never
        # exceed the overrun margin the pool geometry reserves
        k = int(spec_k if spec_k is not None else
                get_env("MX_SERVE_SPEC_K", 4, int))
        self.spec_k = max(1, min(k, _OVERRUN_MARGIN))

    def prompt_bucket_for(self, n: int) -> Optional[int]:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return None

    def slot_bucket_for(self, n: int) -> int:
        for b in self.slot_buckets:
            if b >= n:
                return b
        return self.slot_buckets[-1]

    def __repr__(self):
        return ("DecodeConfig(vocab=%d, dim=%d, heads=%d, layers=%d, "
                "slots=%d, max_tokens=%d, page=%d, max_len=%d)"
                % (self.vocab, self.dim, self.heads, self.layers,
                   self.slots, self.max_tokens, self.page, self.max_len))


# ---------------------------------------------------------------------------
# the demo LM's weights
# ---------------------------------------------------------------------------


def demo_lm_numpy(config: Optional[DecodeConfig] = None
                  ) -> Dict[str, _np.ndarray]:
    """The demo LM's parameters as float32 numpy arrays, drawn from
    ``numpy.random.RandomState(config.seed)`` in the reference's order,
    so both packages build the same weights.  The unembedding is scaled
    up so that greedy-argmax margins are decisive."""
    cfg = config or DecodeConfig()
    rs = _np.random.RandomState(cfg.seed)
    d = cfg.dim

    def mat(rows, cols, scale):
        return rs.randn(rows, cols).astype(_np.float32) * \
            _np.float32(scale)

    params = {"emb": mat(cfg.vocab, d, 1.0),
              "unemb": mat(d, cfg.vocab, 4.0 / (d ** 0.5))}
    for l in range(cfg.layers):
        for name in ("wq", "wk", "wv", "wo"):
            params["l%d.%s" % (l, name)] = mat(d, d, 1.0 / (d ** 0.5))
        params["l%d.w1" % l] = mat(d, 2 * d, 1.0 / (d ** 0.5))
        params["l%d.w2" % l] = mat(2 * d, d, 1.0 / ((2 * d) ** 0.5))
    return params


def params_to_device(params, device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
    """A decode model's parameters (numpy arrays, the reference's arrays
    or tensors, by the reference's names) as tensors on ``device``
    (default: the GPU): the weight carrier between the two packages.
    float64 parameters stay float64 (the float64 model); any other dtype
    becomes float32."""
    dev = resolve(device)
    out = {}
    for name, v in params.items():
        if not isinstance(v, torch.Tensor):
            a = _np.asarray(v)
            v = torch.from_numpy(_np.array(
                a, dtype=_np.float64 if a.dtype == _np.float64
                else _np.float32))
        dt = torch.float64 if v.dtype == torch.float64 else torch.float32
        out[str(name)] = v.detach().to(device=dev, dtype=dt).contiguous()
    return out


def demo_lm_params(config: Optional[DecodeConfig] = None,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The seeded demo LM (:func:`demo_lm_numpy`) on ``device``."""
    return params_to_device(demo_lm_numpy(config), device)


def demo_spec_pair(config: DecodeConfig, draft_layers: int = 1,
                   residual_eps: float = 1e-4,
                   device: DeviceLike = None):
    """A draft-friendly (target, draft) parameter pair for speculative
    decoding: the target is ``config.layers`` deep, every layer past
    ``draft_layers`` with its residual write-back (``wo`` / ``w2``)
    scaled by ``residual_eps``, so its greedy argmax almost always equals
    what the first ``draft_layers`` layers alone predict; the draft is
    that shallow prefix, sharing the embedding tables.

    Returns ``(target_params, draft_config, draft_params)``; the draft
    config shares every pool and bucket dimension with ``config``."""
    cfg = config
    draft_layers = max(1, min(int(draft_layers), cfg.layers))
    target = demo_lm_params(cfg, device)
    for l in range(draft_layers, cfg.layers):
        target["l%d.wo" % l] = target["l%d.wo" % l] * residual_eps
        target["l%d.w2" % l] = target["l%d.w2" % l] * residual_eps
    draft_cfg = DecodeConfig(
        vocab=cfg.vocab, dim=cfg.dim, heads=cfg.heads,
        layers=draft_layers, slots=cfg.slots,
        max_tokens=cfg.max_tokens, page=cfg.page,
        prompt_buckets=cfg.prompt_buckets, eos_id=cfg.eos_id,
        seed=cfg.seed, kv_pages=cfg.kv_pages,
        kv_page_len=cfg.kv_page_len, prefix_share=cfg.prefix_share,
        prefill_chunk=cfg.prefill_chunk, spec_k=cfg.spec_k)
    draft = {"emb": target["emb"], "unemb": target["unemb"]}
    for l in range(draft_layers):
        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            key = "l%d.%s" % (l, name)
            draft[key] = target[key]
    return target, draft_cfg, draft


# ---------------------------------------------------------------------------
# the program bodies: each takes the state dict and writes it in place;
# what a body returns is what the reference's functional body returns
# besides the state
# ---------------------------------------------------------------------------


def _block_mlp(params, l, x):
    h = torch.clamp_min(x @ params["l%d.w1" % l], 0.0)
    return x + h @ params["l%d.w2" % l]


def _heads(cfg, t, *lead):
    return t.reshape(*lead, cfg.heads, cfg.head_dim)


def _greedy(logits):
    """argmax over the last axis (the first of equal maxima, as
    ``jnp.argmax``), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _decode_body(cfg: DecodeConfig, params, st, slot_ids):
    """One decode step over the packed active set.

    ``st``: ``k``/``v`` (L, S+1, P, H, Dh) and ``tok``/``len`` (S+1,)
    int32, written in place (``tok`` = each slot's next input token);
    ``slot_ids``: (b,) int64, padded lanes carry the scratch index S.
    Returns the (b,) int32 sampled tokens.

    A finished lane the pump keeps stepping until its retirement (the
    harvester may lag by more than the overrun margin) can pass the slot's
    extent: its write goes to the scratch slot instead, as the reference's
    scatter drops an out-of-range update."""
    tok = st["tok"][slot_ids].long()
    lens = st["len"][slot_ids].long()
    x = params["emb"][tok]                              # (b, D)
    b = x.shape[0]
    pos = lens                     # this token's KV write position
    inside = pos < st["k"].shape[2]
    w_slot = torch.where(inside, slot_ids, cfg.slots)
    w_pos = torch.where(inside, pos, 0)
    for l in range(cfg.layers):
        st["k"][l, w_slot, w_pos] = _heads(cfg, x @ params["l%d.wk" % l], b)
        st["v"][l, w_slot, w_pos] = _heads(cfg, x @ params["l%d.wv" % l], b)
        q = _heads(cfg, x @ params["l%d.wq" % l], b)
        att = cached_attention(q, st["k"][l, slot_ids], st["v"][l, slot_ids],
                               lens + 1)
        x = x + att.reshape(b, cfg.dim) @ params["l%d.wo" % l]
        x = _block_mlp(params, l, x)
    nxt = _greedy(x @ params["unemb"])                  # (b,)
    st["tok"][slot_ids] = nxt
    st["len"][slot_ids] = (lens + 1).to(torch.int32)
    # park the scratch slot: padded lanes read/write it every step, so its
    # bookkeeping must reset or its fake length would creep past the pool
    st["tok"][cfg.slots] = 0
    st["len"][cfg.slots] = 0
    return nxt


def _prefill_body(cfg: DecodeConfig, params, st, slot_id: int, prompt,
                  n: int):
    """One padded prompt (``prompt``: (Lp,) int64) into slot ``slot_id``:
    causal attention over the prompt with the keys masked to the true
    length ``n`` (a mask: the composition, never the flash kernels), KV
    written for every position, the first token sampled from the last
    real position.  Returns it as a () int32 tensor."""
    Lp = prompt.shape[0]
    x = params["emb"][prompt]                           # (Lp, D)
    valid = torch.arange(Lp, device=x.device) < n
    for l in range(cfg.layers):
        k = _heads(cfg, x @ params["l%d.wk" % l], Lp)
        v = _heads(cfg, x @ params["l%d.wv" % l], Lp)
        st["k"][l, slot_id, :Lp] = k
        st["v"][l, slot_id, :Lp] = v
        q = _heads(cfg, x @ params["l%d.wq" % l], Lp)
        att = attention_core(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                             v.transpose(0, 1)[None], causal=True,
                             mask=valid[None, None, None, :])
        x = x + att[0].transpose(0, 1).reshape(Lp, cfg.dim) \
            @ params["l%d.wo" % l]
        x = _block_mlp(params, l, x)
    t0 = _greedy(x[max(n - 1, 0)] @ params["unemb"])
    st["tok"][slot_id] = t0
    st["len"][slot_id] = n
    return t0


def _paged_decode_body(cfg: DecodeConfig, params, st, slot_ids,
                       block_tbls):
    """One decode step over the packed active set, paged pool.

    ``st["k"]``/``st["v"]``: (L, kv_pages, kv_page_len, H, Dh), the one
    shared heap; ``block_tbls``: (b, pages_per_slot) int64 physical page
    ids per lane (padded lanes: zeros, page 0 is the scratch page).  The
    new token's KV entry goes to ``block_tbls[lane][pos // page_len]`` at
    offset ``pos % page_len``; attention gathers each lane's pages.
    Decode never writes a shared page: generation positions lie past the
    prompt, in pages the session allocated privately."""
    pl = cfg.kv_page_len
    tok = st["tok"][slot_ids].long()
    lens = st["len"][slot_ids].long()
    x = params["emb"][tok]                              # (b, D)
    b = x.shape[0]
    pos = lens
    page_idx = torch.clamp(pos // pl, 0, cfg.pages_per_slot - 1)
    phys = torch.gather(block_tbls, 1, page_idx[:, None])[:, 0]
    off = pos % pl
    for l in range(cfg.layers):
        st["k"][l, phys, off] = _heads(cfg, x @ params["l%d.wk" % l], b)
        st["v"][l, phys, off] = _heads(cfg, x @ params["l%d.wv" % l], b)
        q = _heads(cfg, x @ params["l%d.wq" % l], b)
        att = paged_attention(q, st["k"][l], st["v"][l], block_tbls,
                              lens + 1)
        x = x + att.reshape(b, cfg.dim) @ params["l%d.wo" % l]
        x = _block_mlp(params, l, x)
    nxt = _greedy(x @ params["unemb"])
    st["tok"][slot_ids] = nxt
    st["len"][slot_ids] = (lens + 1).to(torch.int32)
    st["tok"][cfg.slots] = 0
    st["len"][cfg.slots] = 0
    return nxt


def _prefill_chunk_body(cfg: DecodeConfig, params, st, slot_id: int,
                        block_tbl, chunk, start: int, nvalid: int,
                        emit: bool, cow_src: int, cow_dst: int):
    """One page-aligned prefill chunk into the paged heap.

    ``chunk``: (prefill_chunk,) token ids for absolute positions
    ``start ..`` (rows past ``nvalid`` are padding: their KV writes land
    in the session's own reserved pages or the scratch page and are never
    attended); ``block_tbl``: (pages_per_slot,) int64.  Row ``r`` attends
    causally over absolute keys ``0 .. start+r`` gathered through the
    block table (earlier chunks' or a donor's shared pages included), so
    chunking computes what one monolithic prefill computes.  Page
    ``cow_src`` is first copied to ``cow_dst`` (the copy-on-write fork of
    a full-coverage prefix hit; src == dst means none).  ``emit`` samples
    the first generated token and arms the slot's next input token;
    ``len[slot]`` becomes ``start + nvalid`` either way.  Returns the
    chunk's sampled token, () int32."""
    pl = cfg.kv_page_len
    Lc = chunk.shape[0]
    if cow_src != cow_dst:
        st["k"][:, cow_dst] = st["k"][:, cow_src]
        st["v"][:, cow_dst] = st["v"][:, cow_src]
    x = params["emb"][chunk]                            # (Lc, D)
    p = start + torch.arange(Lc, device=x.device)       # absolute pos
    page_idx = torch.clamp(p // pl, 0, cfg.pages_per_slot - 1)
    phys = block_tbl[page_idx]
    off = p % pl
    ext = cfg.pages_per_slot * pl
    # causal-prefix mask: row r sees absolute keys 0..start+r (>= 1 live
    # key a row, so the finite -1e30 masking stays NaN-free)
    mask = torch.arange(ext, device=x.device)[None, :] <= p[:, None]
    for l in range(cfg.layers):
        k = _heads(cfg, x @ params["l%d.wk" % l], Lc)
        v = _heads(cfg, x @ params["l%d.wv" % l], Lc)
        st["k"][l, phys, off] = k
        st["v"][l, phys, off] = v
        q = _heads(cfg, x @ params["l%d.wq" % l], Lc)
        k_all = st["k"][l, block_tbl].reshape(ext, cfg.heads, cfg.head_dim)
        v_all = st["v"][l, block_tbl].reshape(ext, cfg.heads, cfg.head_dim)
        att = attention_core(q.transpose(0, 1)[None],
                             k_all.transpose(0, 1)[None],
                             v_all.transpose(0, 1)[None],
                             mask=mask[None, None])
        x = x + att[0].transpose(0, 1).reshape(Lc, cfg.dim) \
            @ params["l%d.wo" % l]
        x = _block_mlp(params, l, x)
    t0 = _greedy(x[max(nvalid - 1, 0)] @ params["unemb"])
    if emit:
        st["tok"][slot_id] = t0
    st["len"][slot_id] = start + nvalid
    return t0


def _draft_step_body(cfg: DecodeConfig, params, st, slot_ids, col: int):
    """One draft step: the flat decode body on the draft's own pool, the
    sampled token also written into column ``col`` of the proposals
    buffer ``st["props"]`` (slots+1, spec_k), from which the verify
    dispatch reads the whole window.  Returns the proposals buffer."""
    nxt = _decode_body(cfg, params, st, slot_ids)
    st["props"][slot_ids, col] = nxt
    # park the scratch row (padded lanes write it every step)
    st["props"][cfg.slots] = 0
    return st["props"]


def _draft_prefill_body(cfg: DecodeConfig, params, st, tgt_tokens,
                        slot_id: int, prompt, n: int):
    """Prefill the draft's KV pool for one admitted session: the flat
    prefill body, except that the slot's next input token is the target's
    (``tgt_tokens[slot_id]``, read on the same stream after the target's
    emitting chunk): draft and target agree on (next token, length) at
    every window boundary."""
    _prefill_body(cfg, params, st, slot_id, prompt, n)
    st["tok"][slot_id] = tgt_tokens[slot_id]


def _verify_body(cfg: DecodeConfig, params, tst, dst, slot_ids,
                 block_tbls):
    """Verify one speculative window in one dispatch.

    On entry (per lane: slot ``s``, length ``L``, next token ``t``) the
    draft ran k steps from (t, L), so ``dst["props"][s]`` holds its
    proposals d_1..d_k.  The target runs over the k+1 inputs ``[t,
    d_1..d_k]`` at positions ``L..L+k`` through the paged heap and takes
    the argmax at every position: ``a_j``.  Acceptance is the longest
    prefix with d_j == a_{j-1}, capped at k-1; a_0..a_{m'} are emitted,
    the next token is a_{m'} and the new length L + m' + 1, written into
    the target's and the draft's (token, length) arrays alike.

    Returns (emitted (b, k) int32, n_em (b,) int32): the first
    ``n_em[lane]`` of a lane's row are real."""
    pl = cfg.kv_page_len
    K = dst["props"].shape[1]
    E = K + 1
    lens = tst["len"][slot_ids].long()                  # (b,) = L
    cur = tst["tok"][slot_ids].long()
    d = dst["props"][slot_ids].long()                   # (b, K)
    inp = torch.cat([cur[:, None], d], dim=1)           # (b, E)
    x = params["emb"][inp]                              # (b, E, D)
    b = x.shape[0]
    pos = lens[:, None] + torch.arange(E, device=x.device)[None, :]
    page_idx = torch.clamp(pos // pl, 0, cfg.pages_per_slot - 1)
    phys = torch.gather(block_tbls, 1, page_idx)        # (b, E)
    off = pos % pl
    for l in range(cfg.layers):
        tst["k"][l, phys, off] = _heads(cfg, x @ params["l%d.wk" % l], b, E)
        tst["v"][l, phys, off] = _heads(cfg, x @ params["l%d.wv" % l], b, E)
        q = _heads(cfg, x @ params["l%d.wq" % l], b, E)
        att = paged_attention_multi(q, tst["k"][l], tst["v"][l], block_tbls,
                                    pos)
        x = x + att.reshape(b, E, cfg.dim) @ params["l%d.wo" % l]
        x = _block_mlp(params, l, x)
    a = _greedy(x @ params["unemb"])                    # (b, E)
    # accept d_{i+1} while it equals a_i: the longest prefix, capped k-1
    match = (d == a[:, :K].long()).to(torch.int32)
    m = torch.cumprod(match, dim=1).sum(dim=1)          # (b,) 0..K
    m_cap = torch.clamp(m, max=K - 1)
    n_em = (m_cap + 1).to(torch.int32)                  # (b,) 1..K
    emitted = a[:, :K]
    new_tok = torch.gather(a, 1, m_cap[:, None].long())[:, 0]
    new_len = (lens + n_em).to(torch.int32)
    for s in (tst, dst):
        s["tok"][slot_ids] = new_tok
        s["len"][slot_ids] = new_len
        # park the scratch slot on both state pairs (padded lanes)
        s["tok"][cfg.slots] = 0
        s["len"][cfg.slots] = 0
    return emitted, n_em


# ---------------------------------------------------------------------------
# the greedy oracle
# ---------------------------------------------------------------------------


def reference_generate(prompt: Sequence[int], max_new: int,
                       params: Optional[Dict] = None,
                       config: Optional[DecodeConfig] = None,
                       eos_id: Optional[int] = None,
                       device: DeviceLike = None) -> List[int]:
    """Local greedy-decode oracle: the same prefill and decode bodies over
    a private single-slot state (no pool sharing, no batching), what a
    correct replica must answer.  Runs on the device of ``params`` when
    they are tensors, else on ``device`` (default: the GPU), and in their
    dtype (:func:`params_to_device`: float64 parameters give the float64
    oracle)."""
    cfg = config or DecodeConfig()
    if params is None:
        params = demo_lm_params(cfg, device)
    elif not all(isinstance(v, torch.Tensor) for v in params.values()):
        params = params_to_device(params, device)
    dev = params["emb"].device
    lp = cfg.prompt_bucket_for(len(prompt))
    if lp is None:
        raise MXNetError("reference_generate: prompt of %d tokens "
                         "exceeds the top prompt bucket %d"
                         % (len(prompt), cfg.prompt_buckets[-1]))
    shape = (cfg.layers, cfg.slots + 1, cfg.max_len, cfg.heads,
             cfg.head_dim)
    with torch.no_grad():
        dt = params["emb"].dtype
        st = {"k": torch.zeros(shape, dtype=dt, device=dev),
              "v": torch.zeros(shape, dtype=dt, device=dev),
              "tok": torch.zeros(cfg.slots + 1, dtype=torch.int32,
                                 device=dev),
              "len": torch.zeros(cfg.slots + 1, dtype=torch.int32,
                                 device=dev)}
        padded = torch.zeros(lp, dtype=torch.int64, device=dev)
        padded[:len(prompt)] = torch.tensor([int(t) for t in prompt],
                                            device=dev)
        out = [int(_prefill_body(cfg, params, st, 0, padded, len(prompt)))]
        ids = torch.zeros(1, dtype=torch.int64, device=dev)
        while len(out) < max_new:
            if eos_id is not None and out[-1] == eos_id:
                break
            out.append(int(_decode_body(cfg, params, st, ids)[0]))
    return out[:max_new]


# ---------------------------------------------------------------------------
# host <-> device plumbing of the pump and the harvester
# ---------------------------------------------------------------------------


def _device_scope(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """A host integer array as an int64 tensor on ``device``: through
    pinned memory and a copy that does not block the host on the card."""
    t = torch.from_numpy(_np.ascontiguousarray(arr, dtype=_np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class _Readback:
    """One dispatch's token output on its way to the host without
    stalling the pump: on the card, a non-blocking copy into pinned host
    memory and a CUDA event recorded after it, which the harvester waits
    on (:meth:`get`); on the CPU the output itself."""

    __slots__ = ("_host", "_event")

    def __init__(self, out):
        outs = out if isinstance(out, tuple) else (out,)
        if outs[0].device.type == "cuda":
            self._host = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                .copy_(o, non_blocking=True) for o in outs)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tuple(o.detach() for o in outs)
            self._event = None
        if not isinstance(out, tuple):
            self._host = self._host[0]

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        if isinstance(self._host, tuple):
            return tuple(h.numpy() for h in self._host)
        return self._host.numpy()


# ---------------------------------------------------------------------------
# servables
# ---------------------------------------------------------------------------


def _counter(name, doc):
    return _telemetry.registry.counter(name, doc=doc)


class DecodeServable:
    """One immutable decode-model version: parameters, the KV pool on the
    device, and the two bucketed program tables (prefill by prompt bucket,
    decode by slot bucket).

    ``device`` (default: the GPU; without CUDA that raises) holds the
    parameters and the state.  ``_state`` is the only copy of the KV
    state, updated in place by every dispatch, so its bytes are constant
    for the servable's lifetime.  Only the pump thread may dispatch."""

    #: engine discriminator on the health surface
    engine = "flat"
    census_owner = "kv_cache"

    def _alloc_state(self) -> Dict[str, torch.Tensor]:
        cfg = self.config
        shape = (cfg.layers, cfg.slots + 1, cfg.max_len, cfg.heads,
                 cfg.head_dim)
        return self._zeros_state(shape)

    def _zeros_state(self, kv_shape) -> Dict[str, torch.Tensor]:
        """The KV state in the parameters' dtype, the token and length
        arrays in int32."""
        cfg = self.config
        dev = self.device
        dt = self.params["emb"].dtype
        return {
            "k": torch.zeros(kv_shape, dtype=dt, device=dev),
            "v": torch.zeros(kv_shape, dtype=dt, device=dev),
            "tok": torch.zeros(cfg.slots + 1, dtype=torch.int32,
                               device=dev),
            "len": torch.zeros(cfg.slots + 1, dtype=torch.int32,
                               device=dev),
        }

    def __init__(self, params: Optional[Dict] = None,
                 config: Optional[DecodeConfig] = None,
                 name: str = "demo-lm", version: int = 1,
                 device: DeviceLike = None):
        self.config = config or DecodeConfig()
        self.device = resolve(device)
        self.params = params_to_device(
            params if params is not None else demo_lm_numpy(self.config),
            self.device)
        self.name = str(name)
        self.version = int(version)
        with torch.no_grad():
            self._state: Dict[str, torch.Tensor] = self._alloc_state()
        self._lock = threading.Lock()
        self._step_programs: Dict[int, object] = {}
        self._prefill_programs: Dict[int, object] = {}
        self._verify_programs: Dict[int, object] = {}
        self.retraces = 0            # program builds (warm pays them)
        self.hits = 0                # dispatches answered by the table
        self.warmed = False
        self._c_retrace = _counter(
            "serve.retraces", "serve-side program builds (0 after warm-up; "
            "warm() pays them at deploy)")
        self._c_hits = _counter(
            "serve.bucket_hits", "dispatches answered by a pre-built "
            "bucket program")

    # -- the HBM census (waits for programs.py) ----------------------------
    def program_prefix(self) -> str:
        raise NotImplementedError(_PROGRAMS % "program_prefix")

    def footprint_bytes(self) -> int:
        raise NotImplementedError(_PROGRAMS % "footprint_bytes")

    def live_bytes(self) -> int:
        """Resident bytes: the parameters and the whole KV state."""
        return sum(int(a.nbytes) for a in self.params.values()) + \
            self.kv_state_bytes()

    # -- program tables -----------------------------------------------------
    def _program(self, table: Dict[int, object], key: int, build):
        """``table[key]``, built (and counted as a retrace) on a miss."""
        with self._lock:
            prog = table.get(key)
            if prog is not None:
                self.hits += 1
        if prog is not None:
            self._c_hits.inc()
            return prog
        with _telemetry.phase("retrace"):
            prog = build()
        with self._lock:
            prog = table.setdefault(key, prog)
            self.retraces += 1
        self._c_retrace.inc()
        return prog

    def step_program(self, bucket: int):
        """The decode program of one slot bucket (built on a miss, counted
        as a retrace; warm() builds every bucket)."""
        cfg = self.config

        def build():
            def run_decode(params, st, slot_ids):
                return _decode_body(cfg, params, st, slot_ids)
            return run_decode
        return self._program(self._step_programs, int(bucket), build)

    def prefill_program(self, prompt_bucket: int):
        cfg = self.config

        def build():
            def run_prefill(params, st, slot_id, prompt, n):
                return _prefill_body(cfg, params, st, slot_id, prompt, n)
            return run_prefill
        return self._program(self._prefill_programs, int(prompt_bucket),
                             build)

    # -- dispatch (pump thread only; no host read) -------------------------
    def _run(self, prog, *args):
        from ..engine import engine as _engine
        with _device_scope(self.device), torch.no_grad():
            out = prog(self.params, *args)
        _engine.count_dispatch(1)
        return out

    def dispatch_step(self, slot_ids: _np.ndarray):
        """One decode program over the packed active set; returns the (b,)
        emitted tokens on the device (the harvester reads them)."""
        prog = self.step_program(len(slot_ids))
        return self._run(prog, self._state,
                         _to_device(slot_ids, self.device))

    def dispatch_prefill(self, slot: int, prompt: _np.ndarray, n: int):
        """One program filling ``slot``'s KV pages from a padded prompt;
        returns the first generated token as a () device tensor."""
        prog = self.prefill_program(prompt.shape[0])
        return self._run(prog, self._state, int(slot),
                         _to_device(prompt, self.device), int(n))

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reset_bookkeeping(self) -> None:
        with torch.no_grad():
            self._state["tok"].zero_()
            self._state["len"].zero_()

    def warm(self) -> "DecodeServable":
        """Build and run every prefill and decode bucket (against the
        scratch slot), then reset the generation bookkeeping: after this,
        serving builds nothing."""
        cfg = self.config
        for lp in cfg.prompt_buckets:
            self.dispatch_prefill(cfg.slots, _np.zeros(lp, _np.int32), lp)
        for b in cfg.slot_buckets:
            self.dispatch_step(_np.full(b, cfg.slots, _np.int32))
        self._synchronize()
        # the pool's warm-up garbage is masked by zero lengths and
        # overwritten on reuse
        self._reset_bookkeeping()
        self.warmed = True
        return self

    def kv_state_bytes(self) -> int:
        """The KV state's bytes (pool pages + token/length arrays): the
        number that stays flat across generations."""
        return sum(int(a.nbytes) for a in self._state.values())

    def kv_slot_bytes(self) -> int:
        """One slot's share of the pool (the scratch lane counts: the pool
        is ``slots + 1`` lanes wide), the bytes a free slot stands for as
        admission headroom."""
        return self.kv_state_bytes() // (self.config.slots + 1)


class PagedDecodeServable(DecodeServable):
    """The paged decode servable: the same model, the KV store one shared
    page heap ``(L, kv_pages, kv_page_len, H, Dh)`` addressed per session
    through host-side block tables.  Two program tables replace the flat
    pair: the decode step per slot bucket (with per-lane block tables)
    and one chunk program (the chunk length is the unit, so any prompt
    prefills as a train of chunks, with the copy-on-write fork in the
    same program).  There is no monolithic prefill:
    :meth:`dispatch_prefill` raises; the pump schedules
    :meth:`dispatch_chunk` trains."""

    engine = "paged"
    census_owner = "kv_pages"

    def _alloc_state(self) -> Dict[str, torch.Tensor]:
        cfg = self.config
        return self._zeros_state((cfg.layers, cfg.kv_pages, cfg.kv_page_len,
                                  cfg.heads, cfg.head_dim))

    # -- program tables -----------------------------------------------------
    def step_program(self, bucket: int):
        cfg = self.config

        def build():
            def run_decode(params, st, slot_ids, block_tbls):
                return _paged_decode_body(cfg, params, st, slot_ids,
                                          block_tbls)
            return run_decode
        return self._program(self._step_programs, int(bucket), build)

    def chunk_program(self):
        """The prefill program: one chunk length (``prefill_chunk``)
        covers every admitted prompt as a chunk train."""
        cfg = self.config

        def build():
            def run_chunk(params, st, slot_id, block_tbl, chunk, start,
                          nvalid, emit, cow_src, cow_dst):
                return _prefill_chunk_body(cfg, params, st, slot_id,
                                           block_tbl, chunk, start, nvalid,
                                           emit, cow_src, cow_dst)
            return run_chunk
        return self._program(self._prefill_programs, cfg.prefill_chunk,
                             build)

    def prefill_program(self, prompt_bucket: int):
        raise MXNetError("paged decode servable has no monolithic "
                         "prefill program; prompts prefill as chunk "
                         "trains (chunk_program)")

    # -- dispatch (pump thread only; no host read) -------------------------
    def dispatch_step(self, slot_ids: _np.ndarray,
                      block_tbls: _np.ndarray):
        """One program over the packed active set and its block tables."""
        prog = self.step_program(len(slot_ids))
        return self._run(prog, self._state,
                         _to_device(slot_ids, self.device),
                         _to_device(block_tbls, self.device))

    def dispatch_prefill(self, slot: int, prompt: _np.ndarray, n: int):
        raise MXNetError("paged decode servable has no monolithic "
                         "prefill dispatch; use dispatch_chunk")

    def dispatch_chunk(self, slot: int, block_tbl: _np.ndarray,
                       chunk: _np.ndarray, start: int, nvalid: int,
                       emit: bool, cow_src: int = 0, cow_dst: int = 0):
        """One program writing one page-aligned prefill chunk (and the
        optional copy-on-write page fork) through ``slot``'s block table;
        returns the chunk's sampled token as a () device tensor
        (meaningful only when ``emit``)."""
        prog = self.chunk_program()
        return self._run(prog, self._state, int(slot),
                         _to_device(block_tbl, self.device),
                         _to_device(chunk, self.device), int(start),
                         int(nvalid), bool(emit), int(cow_src),
                         int(cow_dst))

    def verify_program(self, bucket: int):
        """The speculative verify program of one slot bucket: all k+1
        window positions of every lane in one dispatch."""
        cfg = self.config

        def build():
            def run_verify(params, tst, dst, slot_ids, block_tbls):
                return _verify_body(cfg, params, tst, dst, slot_ids,
                                    block_tbls)
            return run_verify
        return self._program(self._verify_programs, int(bucket), build)

    def dispatch_verify(self, draft: "DraftDecodeServable",
                        slot_ids: _np.ndarray, block_tbls: _np.ndarray):
        """One verify dispatch over the packed window set: writes the
        target's heap state and the draft's token/length arrays in place,
        reads the draft's proposals on the device; the (emitted, n_em)
        pair goes to the harvester."""
        prog = self.verify_program(len(slot_ids))
        return self._run(prog, self._state, draft._state,
                         _to_device(slot_ids, self.device),
                         _to_device(block_tbls, self.device))

    def warm(self) -> "PagedDecodeServable":
        """Build and run the chunk program and every decode bucket against
        the scratch page and slot, then reset the bookkeeping."""
        cfg = self.config
        tbl = _np.zeros(cfg.pages_per_slot, _np.int32)
        self.dispatch_chunk(cfg.slots, tbl,
                            _np.zeros(cfg.prefill_chunk, _np.int32),
                            0, cfg.prefill_chunk, False)
        for b in cfg.slot_buckets:
            self.dispatch_step(
                _np.full(b, cfg.slots, _np.int32),
                _np.zeros((b, cfg.pages_per_slot), _np.int32))
        self._synchronize()
        self._reset_bookkeeping()
        self.warmed = True
        return self

    def page_bytes(self) -> int:
        """One physical page's K+V bytes across all layers."""
        cfg = self.config
        return (2 * cfg.layers * cfg.kv_page_len * cfg.heads *
                cfg.head_dim * 4)

    def kv_slot_bytes(self) -> int:
        """A worst-case session's heap share (its whole block-table
        extent): what one admission can cost at most."""
        return self.page_bytes() * self.config.pages_per_slot


class DraftDecodeServable(DecodeServable):
    """The draft servable of speculative decoding: a small flat-pool
    decode model whose steps write their tokens into a proposals buffer
    ``(slots+1, spec_k)`` on the device instead of feeding the harvester;
    the target's verify reads the whole window from it.  Its slots,
    buckets and pool length match the target's, so slot ids and lengths
    line up one to one; only its depth differs."""

    engine = "draft"

    def _alloc_state(self) -> Dict[str, torch.Tensor]:
        st = super()._alloc_state()
        cfg = self.config
        st["props"] = torch.zeros((cfg.slots + 1, cfg.spec_k),
                                  dtype=torch.int32, device=self.device)
        return st

    # -- program tables -----------------------------------------------------
    def step_program(self, bucket: int):
        cfg = self.config

        def build():
            def run_draft(params, st, slot_ids, col):
                return _draft_step_body(cfg, params, st, slot_ids, col)
            return run_draft
        return self._program(self._step_programs, int(bucket), build)

    def prefill_program(self, prompt_bucket: int):
        cfg = self.config

        def build():
            def run_prefill(params, st, tgt_tokens, slot_id, prompt, n):
                return _draft_prefill_body(cfg, params, st, tgt_tokens,
                                           slot_id, prompt, n)
            return run_prefill
        return self._program(self._prefill_programs, int(prompt_bucket),
                             build)

    # -- dispatch (pump thread only; no host read) -------------------------
    def dispatch_step(self, slot_ids: _np.ndarray, col: int):
        """One draft step over the packed window set, writing window
        column ``col`` of the proposals buffer."""
        prog = self.step_program(len(slot_ids))
        return self._run(prog, self._state,
                         _to_device(slot_ids, self.device), int(col))

    def dispatch_prefill(self, slot: int, prompt: _np.ndarray, n: int,
                         tgt_tokens=None):
        """One draft-prefill dispatch; ``tgt_tokens`` is the target's
        token array (read only), whose ``slot`` entry arms the draft's
        next input token."""
        prog = self.prefill_program(prompt.shape[0])
        if tgt_tokens is None:
            tgt_tokens = torch.zeros_like(self._state["tok"])
        self._run(prog, self._state, tgt_tokens, int(slot),
                  _to_device(prompt, self.device), int(n))
        return None

    def _reset_bookkeeping(self) -> None:
        super()._reset_bookkeeping()
        with torch.no_grad():
            self._state["props"].zero_()

    def warm(self) -> "DraftDecodeServable":
        """Build and run every draft prefill and step bucket against the
        scratch slot, then reset the bookkeeping."""
        cfg = self.config
        for lp in cfg.prompt_buckets:
            self.dispatch_prefill(cfg.slots, _np.zeros(lp, _np.int32), lp)
        for b in cfg.slot_buckets:
            self.dispatch_step(_np.full(b, cfg.slots, _np.int32), 0)
        self._synchronize()
        self._reset_bookkeeping()
        self.warmed = True
        return self


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


class _PendingGen:
    """One admitted generation request: prompt in, tokens accumulating
    out.  The pump owns its slot; the harvester appends tokens, stamps
    per-token latency and flags completion; handler threads block in
    :meth:`result` or stream through :meth:`wait_new`."""

    __slots__ = ("prompt", "max_new", "eos_id", "trace_ctx", "submit_t",
                 "slot", "token_times", "_cv", "_tokens", "_done",
                 "_err", "_last_t")

    def __init__(self, prompt: List[int], max_new: int,
                 eos_id: Optional[int],
                 trace_ctx: Optional[Tuple[str, str]] = None):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.trace_ctx = trace_ctx
        self.submit_t = time.perf_counter()
        self.slot: Optional[int] = None
        self.token_times: List[float] = []   # per-token latency (s)
        self._cv = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._err: Optional[BaseException] = None
        self._last_t: Optional[float] = None

    # -- harvester side -----------------------------------------------------
    def _append(self, tok: int, now: float) -> Tuple[bool, bool]:
        """Record one harvested token; returns (appended, finished).
        Tokens arriving after completion (pipeline overrun) are
        dropped."""
        with self._cv:
            if self._done:
                return False, True
            base = self._last_t if self._last_t is not None \
                else self.submit_t
            self.token_times.append(now - base)
            self._last_t = now
            self._tokens.append(int(tok))
            finished = len(self._tokens) >= self.max_new or (
                self.eos_id is not None and int(tok) == self.eos_id)
            if finished:
                self._done = True
            self._cv.notify_all()
            return True, finished

    def _fail(self, err: BaseException) -> None:
        with self._cv:
            if not self._done:
                self._err = err
                self._done = True
            self._cv.notify_all()

    # -- consumer side ------------------------------------------------------
    def done(self) -> bool:
        with self._cv:
            return self._done

    def tokens_so_far(self) -> List[int]:
        with self._cv:
            return list(self._tokens)

    def wait_new(self, have: int, timeout: float
                 ) -> Tuple[List[int], bool]:
        """Block until more than ``have`` tokens exist (or the generation
        completes, or the wait times out); returns (the tokens past
        ``have``, done)."""
        deadline = _fault.Deadline(timeout)
        with self._cv:
            while len(self._tokens) <= have and not self._done:
                remaining = deadline.remaining()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(0.05, remaining))
            return list(self._tokens[have:]), self._done

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block (bounded) for the whole generation; raises on an engine
        failure or a timeout."""
        timeout = _result_timeout(timeout)
        deadline = _fault.Deadline(timeout)
        with self._cv:
            while not self._done:
                remaining = deadline.remaining()
                if remaining <= 0:
                    raise MXNetError(
                        "serve: generation timed out after %.3gs "
                        "(%d/%d tokens)" % (timeout, len(self._tokens),
                                            self.max_new))
                self._cv.wait(timeout=min(0.1, remaining))
            if self._err is not None:
                raise self._err
            return list(self._tokens)


class DecodeBatcher:
    """The continuous-batching decode engine: admission queue + slot
    allocator + decode pump (dispatch only) + token harvester (the only
    reader of the device's tokens)."""

    def __init__(self, servable: DecodeServable,
                 queue_cap: Optional[int] = None,
                 mode: str = "continuous", on_tick=None,
                 autostart: bool = True):
        if mode not in ("continuous", "request"):
            raise MXNetError("DecodeBatcher mode must be 'continuous' "
                             "or 'request', got %r" % (mode,))
        self._sv = servable
        if not servable.warmed:
            servable.warm()
        self._cap = int(queue_cap if queue_cap is not None else
                        get_env("MX_SERVE_QUEUE_CAP", 256, int))
        self._mode = mode
        self._on_tick = on_tick
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._slot_lk = threading.Lock()
        self._slots: List[Optional[_PendingGen]] = \
            [None] * servable.config.slots
        # bounded pump -> harvester handoff: one step boundary emits at
        # most `slots` prefill items + 1 step item, so the bound never
        # wedges a synchronous (autostart=False) caller, and in threaded
        # mode it caps how far the pump runs ahead of the token reads
        self._harvest_q: _queue.Queue = _queue.Queue(
            maxsize=servable.config.slots + 4)
        self._stop = threading.Event()
        reg = _telemetry.registry
        self._c_requests = reg.counter(
            "serve.decode.requests", doc="admitted generation requests")
        self._c_rejected = reg.counter(
            "serve.decode.rejected", doc="generation requests shed at "
            "admission (queue cap) or refused (prompt too long)")
        self._c_tokens = reg.counter(
            "serve.decode.tokens", doc="generated tokens harvested")
        self._c_steps = reg.counter(
            "serve.decode.steps", doc="decode-step device dispatches "
            "(exactly 1 per step regardless of the active count)")
        self._c_prefills = reg.counter(
            "serve.decode.prefills", doc="prefill device dispatches "
            "(one per admitted sequence)")
        self._c_seqs = reg.counter(
            "serve.decode.sequences", doc="generations retired complete")
        # per-model labeled twins of the aggregates
        _lbl = {"model": servable.name}
        self._c_requests_m = reg.counter(
            "serve.decode.requests", doc="admitted generation requests",
            labels=_lbl)
        self._c_tokens_m = reg.counter(
            "serve.decode.tokens", doc="generated tokens harvested",
            labels=_lbl)
        self._c_seqs_m = reg.counter(
            "serve.decode.sequences", doc="generations retired complete",
            labels=_lbl)
        self._g_queue = reg.gauge(
            "serve.decode.queue", doc="generation requests queued")
        self._g_active = reg.gauge(
            "serve.decode.active_slots", doc="sequences in decode slots")
        self._g_occupancy = reg.gauge(
            "serve.decode.slot_occupancy",
            doc="fraction of decode slots holding an active sequence "
                "(0..1; router load signal)")
        self._g_headroom = reg.gauge(
            "serve.decode.kv_headroom_bytes",
            doc="KV-pool bytes behind currently-FREE decode slots "
                "(admission headroom)")
        self._h_occ = reg.histogram(
            "serve.decode.occupancy", doc="active sequences per decode "
            "step", buckets=(1, 2, 4, 8, 16, 32, 64))
        self._h_token = reg.histogram(
            "serve.decode.token_seconds", doc="per-token latency: first "
            "token = submit->harvest (queue + prefill included), then "
            "inter-token gaps",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
        self._set_capacity_gauges(0)
        self._pump = threading.Thread(
            target=self._loop, daemon=True, name="mx-serve-decode-pump")
        self._harvester = threading.Thread(
            target=self._harvest_loop, daemon=True,
            name="mx-serve-decode-harvest")
        if autostart:
            self._pump.start()
            self._harvester.start()

    @property
    def servable(self) -> DecodeServable:
        return self._sv

    @property
    def version(self) -> int:
        return self._sv.version

    @property
    def mode(self) -> str:
        return self._mode

    # -- admission ----------------------------------------------------------
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    def active_count(self) -> int:
        with self._slot_lk:
            return sum(1 for g in self._slots if g is not None)

    def page_stats(self) -> Optional[Dict]:
        """Paged-engine capacity detail for the health surface; the flat
        engine has none."""
        return None

    def _set_capacity_gauges(self, active: int) -> None:
        """Publish the capacity signals for ``active`` occupied slots."""
        slots = self._sv.config.slots
        self._g_occupancy.set(active / float(slots) if slots else 0.0)
        self._g_headroom.set(
            max(0, slots - active) * self._sv.kv_slot_bytes())

    def submit(self, prompt: Sequence[int],
               max_new: Optional[int] = None,
               eos_id: Optional[int] = None,
               trace_ctx: Optional[Tuple[str, str]] = None
               ) -> _PendingGen:
        """Admit one generation request.  ``eos_id`` overrides the
        config's stop token for this request.  Raises :class:`Overloaded`
        when the bounded queue is full, MXNetError when the request can
        never be served (empty or over-bucket prompt, bad token ids)."""
        cfg = self._sv.config
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            self._c_rejected.inc()
            raise MXNetError("serve: GENERATE prompt must be a sequence "
                             "of token ids")
        if not prompt:
            self._c_rejected.inc()
            raise MXNetError("serve: GENERATE needs >= 1 prompt token")
        if any(t < 0 or t >= cfg.vocab for t in prompt):
            self._c_rejected.inc()
            raise MXNetError("serve: prompt token out of vocab range "
                             "[0, %d)" % cfg.vocab)
        if cfg.prompt_bucket_for(len(prompt)) is None:
            self._c_rejected.inc()
            raise MXNetError(
                "serve: prompt of %d tokens exceeds the top prompt "
                "bucket %d (MX_SERVE_DECODE_PROMPT_BUCKETS)"
                % (len(prompt), cfg.prompt_buckets[-1]))
        limit = cfg.max_tokens if max_new is None \
            else max(1, min(int(max_new), cfg.max_tokens))
        stop = cfg.eos_id if eos_id is None else int(eos_id)
        gen = _PendingGen(prompt, limit, stop, trace_ctx=trace_ctx)
        with self._cv:
            if len(self._q) >= self._cap:
                self._c_rejected.inc()
                raise Overloaded(
                    "serve: decode admission queue full (%d/%d; "
                    "MX_SERVE_QUEUE_CAP) - retry later or add replicas"
                    % (len(self._q), self._cap))
            self._q.append(gen)
            self._g_queue.set(len(self._q))
            self._cv.notify_all()
        self._c_requests.inc()
        self._c_requests_m.inc()
        return gen

    # -- the decode pump ----------------------------------------------------
    def _loop(self) -> None:
        with _device_scope(self._sv.device):
            while not self._stop.is_set():
                idle = self._tick()
                if self._on_tick is not None:
                    self._on_tick()
                if idle:
                    with self._cv:
                        if not self._q:
                            self._cv.wait(timeout=0.01)
        # stop: refuse whatever is still queued so no handler thread is
        # left waiting on a generation nobody will advance
        with self._cv:
            leftover = list(self._q)
            self._q.clear()
            self._g_queue.set(0)
        with self._slot_lk:
            leftover += [g for g in self._slots if g is not None]
            self._slots = [None] * len(self._slots)
        for g in leftover:
            g._fail(MXNetError("serve: decode engine stopped"))

    def _tick(self) -> bool:
        """One step boundary: retire finished sequences, admit queued
        prefills into the freed slots, then one decode dispatch over the
        packed active set.  Returns True when there was nothing to do."""
        self._retire()
        self._admit()
        active = self._active()
        if not active:
            return True
        try:
            self._step(active)
        except BaseException as e:            # device failure: fail the set
            for _slot, g in active:
                g._fail(e)
        return False

    # -- locked slot/queue helpers (the only direct touches of _slots / _q
    # outside __init__ / _loop / submit) --------------------------------------
    def _finished_slots(self) -> List[Tuple[int, _PendingGen]]:
        with self._slot_lk:
            return [(i, g) for i, g in enumerate(self._slots)
                    if g is not None and g.done()]

    def _free_slot_ids(self) -> List[int]:
        with self._slot_lk:
            return [i for i, g in enumerate(self._slots) if g is None]

    def _clear_slots(self, ids: Sequence[int]) -> None:
        with self._slot_lk:
            for i in ids:
                self._slots[i] = None

    def _bind_slot(self, slot: int, gen: _PendingGen) -> None:
        with self._slot_lk:
            self._slots[slot] = gen

    def _peek_queued(self) -> Optional[_PendingGen]:
        """Head of the admission queue without taking it (the pump is the
        only consumer, so a later pop returns the same request)."""
        with self._cv:
            return self._q[0] if self._q else None

    def _pop_queued(self) -> Optional[_PendingGen]:
        with self._cv:
            if not self._q:
                return None
            gen = self._q.popleft()
            self._g_queue.set(len(self._q))
            return gen

    def _retire(self) -> None:
        """Step boundary, phase ``kv_evict``: free the slots of completed
        sequences.  Eviction is bookkeeping: the next prefill into the
        slot resets its length and overwrites from position 0, and stale
        entries past the new length are masked, never read."""
        done = self._finished_slots()
        if not done:
            return
        with _telemetry.phase("kv_evict"):
            self._clear_slots([i for i, _g in done])
        self._c_seqs.inc(len(done))
        self._c_seqs_m.inc(len(done))
        active = self.active_count()
        self._g_active.set(active)
        self._set_capacity_gauges(active)

    def _admit(self) -> None:
        """Fill free slots from the queue at the step boundary, one
        prefill dispatch each.  Request-level mode admits only when the
        whole previous batch has retired."""
        free = self._free_slot_ids()
        occupied = self._sv.config.slots - len(free)
        if self._mode == "request" and occupied:
            return
        while free:
            gen = self._pop_queued()
            if gen is None:
                break
            slot = free.pop(0)
            gen.slot = slot
            self._bind_slot(slot, gen)
            try:
                self._dispatch_prefill(gen, slot)
            except BaseException as e:
                self._clear_slots([slot])
                gen._fail(e)

    def _active(self) -> List[Tuple[int, _PendingGen]]:
        with self._slot_lk:
            return [(i, g) for i, g in enumerate(self._slots)
                    if g is not None and not g.done()]

    def _dispatch_prefill(self, gen: _PendingGen, slot: int) -> None:
        cfg = self._sv.config
        lp = cfg.prompt_bucket_for(len(gen.prompt))
        padded = _np.zeros(lp, _np.int32)
        padded[:len(gen.prompt)] = gen.prompt
        with _telemetry.phase("prefill") as span:
            if gen.trace_ctx is not None:
                span.event("request", req_trace=gen.trace_ctx[0],
                           req_span=gen.trace_ctx[1], slot=slot)
            t0 = self._sv.dispatch_prefill(slot, padded,
                                           len(gen.prompt))
        self._c_prefills.inc()
        active = self.active_count()
        self._g_active.set(active)
        self._set_capacity_gauges(active)
        self._hq_put(([gen], t0))

    def _step(self, active: List[Tuple[int, _PendingGen]]) -> None:
        """One decode dispatch: pack the active slots into the smallest
        covering bucket (padded lanes park on the scratch slot); the
        token output goes to the harvester."""
        cfg = self._sv.config
        bucket = cfg.slot_bucket_for(len(active))
        ids = _np.full(bucket, cfg.slots, _np.int32)
        ids[:len(active)] = [slot for slot, _g in active]
        with _telemetry.phase("decode_step") as span:
            for _slot, g in active:
                if g.trace_ctx is not None:
                    span.event("request", req_trace=g.trace_ctx[0],
                               req_span=g.trace_ctx[1])
            out = self._sv.dispatch_step(ids)
        self._c_steps.inc()
        self._h_occ.observe(len(active))
        self._hq_put(([g for _slot, g in active], out))

    def _hq_put(self, item) -> None:
        """Bounded handoff to the harvester: the pump may run at most the
        queue depth ahead of the token reads (that bound sizes the pool's
        overrun margin).  The tokens start their way to the host here,
        without blocking (:class:`_Readback`)."""
        gens, out = item
        item = (gens, _Readback(out))
        while not self._stop.is_set():
            try:
                self._harvest_q.put(item, timeout=0.05)
                return
            except _queue.Full:
                continue

    # -- the harvester (the only reader of the device's tokens) ------------
    def _harvest_loop(self) -> None:
        while not (self._stop.is_set() and self._harvest_q.empty()):
            self._harvest_once(block=True)

    def _harvest_once(self, block: bool = False) -> bool:
        """Read one dispatch's emitted tokens (the wait for the device is
        here, overlapping the pump's next dispatch), append them to their
        generations, stamp per-token latency, flag EOS / limit completions
        for the next boundary's retire."""
        try:
            if block:
                gens, rb = self._harvest_q.get(timeout=0.05)
            else:
                gens, rb = self._harvest_q.get_nowait()
        except _queue.Empty:
            return False
        out = rb.get()
        now = time.perf_counter()
        appended = 0
        if isinstance(out, tuple):
            # a speculative verify's (emitted (b, k), n_em (b,)): lane i
            # contributed its first n_em[i] tokens this window; _append
            # drops tokens past done, so a mid-window EOS truncates here
            em, ne = out
            ne = ne.reshape(-1)
            for lane, g in enumerate(gens):
                for t in em[lane, :int(ne[lane])]:
                    did, finished = g._append(int(t), now)
                    if did:
                        appended += 1
                        self._h_token.observe(g.token_times[-1])
                    if finished:
                        break
        else:
            toks = out.reshape(-1)
            for g, t in zip(gens, toks[:len(gens)]):
                did, _finished = g._append(int(t), now)
                if did:
                    appended += 1
                    self._h_token.observe(g.token_times[-1])
        if appended:
            self._c_tokens.inc(appended)
            self._c_tokens_m.inc(appended)
        return True

    # -- synchronous driving (tests, the dispatch budget) -------------------
    def step_sync(self) -> bool:
        """One boundary + dispatch + synchronous harvest, the
        deterministic test face (requires ``autostart=False``).  Returns
        False once idle with an empty queue."""
        with _device_scope(self._sv.device):
            idle = self._tick()
        while self._harvest_once(block=False):
            pass
        with self._cv:
            empty = not self._q
        return not (idle and empty)

    def drain_sync(self, max_ticks: int = 10000) -> None:
        """step_sync until idle (tests)."""
        for _ in range(max_ticks):
            if not self.step_sync():
                return
        raise MXNetError("decode: drain_sync did not converge in %d "
                         "ticks" % max_ticks)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DecodeBatcher":
        if not self._pump.is_alive():
            self._pump.start()
        if not self._harvester.is_alive():
            self._harvester.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._pump.is_alive():
            self._pump.join(timeout=timeout)
        if self._harvester.is_alive():
            self._harvester.join(timeout=timeout)


class _PagedSeq:
    """Host bookkeeping of one admitted paged session: its block table,
    the page references it holds, the remaining prefill-chunk train, and
    the full-page hashes to publish once the train is dispatched.
    Pump thread only."""

    __slots__ = ("gen", "table", "held", "chunks", "publish", "t0")

    def __init__(self, gen, table, held, chunks, publish):
        self.gen = gen
        self.table = table          # np.int32 (pages_per_slot,)
        self.held = held            # page ids to release at retire
        self.chunks = chunks        # deque of pending chunk dispatches
        self.publish = publish      # [(chain_hash, page)] after the train
        self.t0 = None              # the emit chunk's first token (the
        #                             speculative engine harvests it only
        #                             after the draft-prefill sentinel)


class PagedDecodeBatcher(DecodeBatcher):
    """The paged continuous-batching engine: the flat pump's loop with
    three changes.

    * **Admission is bounded by pages, not slots.**  ``_admit`` plans the
      head-of-queue request against the :class:`PageAllocator`: full
      prompt pages shared by hash, private pages for the rest of the
      worst-case extent, the prefill-chunk train.  Without pages the
      request waits (head of line; nothing is half-allocated).
    * **Chunked prefill interleaves with decode.**  Each tick dispatches
      exactly one program: a pending prefill chunk and the decode step
      over the decoding set alternate (``_chunk_turn``).
    * **Prefix reuse.**  A full-coverage hash hit admits with one
      copy-on-write replay chunk (fork the donor's last page, recompute
      its final position, emit the first token); a partial hit prefills
      only the suffix.  Decode never writes a shared page, and
      publication comes strictly after the owning chunks' dispatches,
      so sharing never changes a token.

    Continuous only: the request-level strawman stays on the flat
    engine."""

    def __init__(self, servable: PagedDecodeServable,
                 queue_cap: Optional[int] = None,
                 mode: str = "continuous", on_tick=None,
                 autostart: bool = True):
        if not isinstance(servable, PagedDecodeServable):
            raise MXNetError("PagedDecodeBatcher needs a "
                             "PagedDecodeServable")
        if mode != "continuous":
            raise MXNetError("the paged engine is continuous-only; "
                             "mode=%r belongs to the flat engine's "
                             "bench strawman" % (mode,))
        # before super(): the base __init__ publishes capacity gauges
        # through our override, which needs the allocator in place
        self._sv = servable
        self._alloc = PageAllocator(servable.config.kv_pages)
        self._seqs: Dict[int, _PagedSeq] = {}
        self._chunk_turn = False
        self._chunk_rr = -1      # last slot whose chunk was served
        reg = _telemetry.registry
        self._c_chunks = reg.counter(
            "serve.decode.prefill_chunks",
            doc="prefill-chunk device dispatches (a prompt admits as a "
                "train of page-aligned chunks interleaved with decode "
                "steps)")
        self._c_shared = reg.counter(
            "serve.decode.shared_page_hits",
            doc="prompt pages adopted from the prefix hash table "
                "instead of prefilled")
        self._c_cow = reg.counter(
            "serve.decode.cow_forks",
            doc="copy-on-write page forks (full prompt-coverage prefix "
                "hits replaying only their final position)")
        self._g_free_pages = reg.gauge(
            "serve.decode.kv_free_pages",
            doc="KV heap pages currently allocatable (free + evictable "
                "cached prefix pages)")
        self._g_shared_saved = reg.gauge(
            "serve.decode.kv_shared_saved_bytes",
            doc="KV heap bytes prefix sharing is saving right now "
                "(extra references on hashed pages x page bytes)")
        super().__init__(servable, queue_cap=queue_cap, mode=mode,
                         on_tick=on_tick, autostart=autostart)

    # -- capacity surface ---------------------------------------------------
    def _set_capacity_gauges(self, active: int) -> None:
        slots = self._sv.config.slots
        self._g_occupancy.set(active / float(slots) if slots else 0.0)
        pb = self._sv.page_bytes()
        free = self._alloc.free_pages()
        self._g_headroom.set(free * pb)
        self._g_free_pages.set(free)
        self._g_shared_saved.set(self._alloc.shared_extra_refs() * pb)

    def page_stats(self) -> Dict:
        cfg = self._sv.config
        pb = self._sv.page_bytes()
        st = self._alloc.stats()
        return {
            "engine": "paged",
            "kv_pages": cfg.kv_pages,
            "kv_page_len": cfg.kv_page_len,
            "prefill_chunk": cfg.prefill_chunk,
            "prefix_share": cfg.prefix_share,
            "kv_free_pages": st["free"],
            "kv_cached_pages": st["cached"],
            "shared_hits": st["shared_hits"],
            "shared_saved_bytes":
                self._alloc.shared_extra_refs() * pb,
        }

    # -- the paged pump -----------------------------------------------------
    def _tick(self) -> bool:
        """One boundary, one dispatch: retire, admit (bookkeeping only),
        then either the next pending prefill chunk or the decode step,
        alternating while both kinds of work exist."""
        self._retire()
        self._admit()
        chunk_slot = self._next_chunk_slot()
        active = self._active()
        if chunk_slot is not None and (self._chunk_turn or not active):
            self._chunk_turn = False
            self._dispatch_chunk_for(chunk_slot)
            return False
        self._chunk_turn = True
        if not active:
            return chunk_slot is None
        try:
            self._step(active)
        except BaseException as e:            # device failure: fail the set
            for _slot, g in active:
                g._fail(e)
        return False

    def _retire(self) -> None:
        """Step boundary, phase ``kv_evict``: release finished sessions'
        page references.  A released page published under a prefix hash
        parks in the allocator's LRU cache, still adoptable; the heap
        itself is never reallocated."""
        done = self._finished_slots()
        if not done:
            return
        with _telemetry.phase("kv_evict"):
            self._clear_slots([i for i, _g in done])
            for i, _g in done:
                seq = self._seqs.pop(i, None)
                if seq is not None:
                    for p in seq.held:
                        self._alloc.release(p)
        self._c_seqs.inc(len(done))
        self._c_seqs_m.inc(len(done))
        active = self.active_count()
        self._g_active.set(active)
        self._set_capacity_gauges(active)

    def _admit(self) -> None:
        """Admission bounded by pages: plan the head-of-queue request
        (prefix lookup + private pages + chunk train) and take a slot only
        when its worst-case extent fits.  Bookkeeping only: the chunks
        dispatch on later ticks."""
        while True:
            free = self._free_slot_ids()
            if not free:
                return
            gen = self._peek_queued()
            if gen is None:
                return
            plan = self._plan(gen)
            if plan is None:
                return            # head of line waits for free pages
            self._pop_queued()    # == gen: the pump is the only consumer
            slot = free[0]
            gen.slot = slot
            table, held, chunks, publish = plan
            self._bind_slot(slot, gen)
            self._seqs[slot] = _PagedSeq(gen, table, held, chunks,
                                         publish)
            active = self.active_count()
            self._g_active.set(active)
            self._set_capacity_gauges(active)

    def _plan(self, gen: _PendingGen):
        """Map one request onto the heap: shared prefix pages adopted by
        hash, private pages for the rest of the worst-case extent, the
        prefill chunks laid out page-aligned.  Returns (table, held,
        chunks, publish), or None when the pages do not fit (nothing is
        retained then)."""
        cfg = self._sv.config
        pl = cfg.kv_page_len
        prompt = gen.prompt
        n = len(prompt)
        need_pages = min(
            cfg.pages_per_slot,
            -(-(n + gen.max_new + _OVERRUN_MARGIN) // pl))
        hashes = page_hashes(prompt, pl) if cfg.prefix_share else []
        shared: List[int] = []
        for h in hashes:
            p = self._alloc.lookup(h)
            if p is None:
                break
            shared.append(p)
        cow_src = None
        if shared and len(shared) * pl == n:
            # full coverage: fork the donor's last page (copy on write)
            # and replay only the final position to emit the first token
            cow_src = shared.pop()
        priv = self._alloc.alloc(need_pages - len(shared))
        if priv is None:
            for p in shared:
                self._alloc.release(p)
            if cow_src is not None:
                self._alloc.release(cow_src)
            return None
        if shared or cow_src is not None:
            self._c_shared.inc(len(shared) +
                               (1 if cow_src is not None else 0))
        table = _np.zeros(cfg.pages_per_slot, _np.int32)
        table[:len(shared)] = shared
        table[len(shared):need_pages] = priv
        held = shared + priv
        if cow_src is not None:
            held.append(cow_src)   # keep the donor page live until
            #                        retire: its fork copy must not race
            #                        a reuse of the page
        chunks: deque = deque()
        publish: List[Tuple[int, int]] = []
        Lc = cfg.prefill_chunk
        if cow_src is not None:
            self._c_cow.inc()
            buf = _np.zeros(Lc, _np.int32)
            buf[0] = prompt[n - 1]
            chunks.append((buf, n - 1, 1, True, int(cow_src),
                           int(priv[0])))
        else:
            start0 = len(shared) * pl
            for s in range(start0, n, Lc):
                e = min(n, s + Lc)
                buf = _np.zeros(Lc, _np.int32)
                buf[:e - s] = prompt[s:e]
                chunks.append((buf, s, e - s, e == n, 0, 0))
            if cfg.prefix_share:
                for i in range(len(shared), n // pl):
                    publish.append((hashes[i], int(table[i])))
        return table, held, chunks, publish

    def _active(self) -> List[Tuple[int, _PendingGen]]:
        """The decoding set: sessions whose prefill-chunk train has been
        fully dispatched."""
        return [(i, g) for i, g in super()._active()
                if not (i in self._seqs and self._seqs[i].chunks)]

    def _next_chunk_slot(self) -> Optional[int]:
        # round robin over chunk-pending sessions: a long train must not
        # starve a later admission's one-chunk prefill of its first token
        pending = sorted(i for i in self._seqs if self._seqs[i].chunks)
        if not pending:
            return None
        for i in pending:
            if i > self._chunk_rr:
                return i
        return pending[0]

    def _dispatch_chunk_for(self, slot: int) -> None:
        """One prefill-chunk dispatch.  The train's last chunk emits the
        first token (to the harvester, like the flat prefill's) and then
        publishes the train's page hashes, strictly after the pages'
        writes are on the device's stream."""
        seq = self._seqs[slot]
        gen = seq.gen
        self._chunk_rr = slot
        chunk, start, nvalid, emit, cow_src, cow_dst = \
            seq.chunks.popleft()
        try:
            with _telemetry.phase("prefill") as span:
                if gen.trace_ctx is not None:
                    span.event("request", req_trace=gen.trace_ctx[0],
                               req_span=gen.trace_ctx[1], slot=slot)
                t0 = self._sv.dispatch_chunk(slot, seq.table, chunk,
                                             start, nvalid, emit,
                                             cow_src, cow_dst)
        except BaseException as e:
            self._drop_seq(slot)
            gen._fail(e)
            return
        self._c_chunks.inc()
        if not seq.chunks:
            self._finish_train(seq, t0)

    def _finish_train(self, seq: _PagedSeq, t0) -> None:
        """A complete train is the flat engine's "prefill" unit: count it,
        publish its pages, hand its first token to the harvester."""
        self._c_prefills.inc()
        for h, page in seq.publish:
            self._alloc.publish(h, page)
        seq.publish = []
        active = self.active_count()
        self._g_active.set(active)
        self._set_capacity_gauges(active)
        self._hq_put(([seq.gen], t0))

    def _drop_seq(self, slot: int) -> None:
        self._clear_slots([slot])
        seq = self._seqs.pop(slot, None)
        if seq is not None:
            for p in seq.held:
                self._alloc.release(p)

    def _dispatch_prefill(self, gen: _PendingGen, slot: int) -> None:
        raise MXNetError("paged engine prefills via chunk trains, "
                         "never the monolithic prefill")

    def _lanes(self, active):
        """The packed slot ids and block-table rows of a decoding set
        (padded lanes: the scratch slot and all-zero rows)."""
        cfg = self._sv.config
        bucket = cfg.slot_bucket_for(len(active))
        ids = _np.full(bucket, cfg.slots, _np.int32)
        ids[:len(active)] = [slot for slot, _g in active]
        tbls = _np.zeros((bucket, cfg.pages_per_slot), _np.int32)
        for lane, (slot, _g) in enumerate(active):
            tbls[lane] = self._seqs[slot].table
        return ids, tbls

    def _step(self, active: List[Tuple[int, _PendingGen]]) -> None:
        """One decode dispatch over the packed decoding set, each lane
        with its block-table row."""
        ids, tbls = self._lanes(active)
        with _telemetry.phase("decode_step") as span:
            for _slot, g in active:
                if g.trace_ctx is not None:
                    span.event("request", req_trace=g.trace_ctx[0],
                               req_span=g.trace_ctx[1])
            out = self._sv.dispatch_step(ids, tbls)
        self._c_steps.inc()
        self._h_occ.observe(len(active))
        self._hq_put(([g for _slot, g in active], out))


class SpeculativeDecodeBatcher(PagedDecodeBatcher):
    """The speculative paged engine: the paged pump, but decode advances
    in windows of ``spec_k`` tokens.

    * **k draft ticks + 1 verify tick a window.**  The window's active
      set freezes at its first draft tick; each draft tick is one
      dispatch of the draft servable writing its proposal into the
      proposals buffer on the device; the verify tick is one target
      dispatch over all k+1 positions of every lane, which accepts the
      longest agreeing prefix, corrects the next token from the target's
      own argmax and rewrites the draft's (token, length) state.  No
      host read anywhere in the window, one dispatch a tick.
    * **The output equals plain greedy decode**: every emitted token is
      the target's argmax under the committed prefix; the draft only
      decides how many of them one dispatch yields.
    * **Admission ends with a draft-prefill sentinel**: a session's chunk
      train ends with one extra dispatch that prefills the draft's pool
      and adopts the target's first token; the first token is harvested
      only then, so no session enters a window with a cold draft."""

    def __init__(self, servable: PagedDecodeServable,
                 draft: DraftDecodeServable,
                 queue_cap: Optional[int] = None,
                 mode: str = "continuous", on_tick=None,
                 autostart: bool = True):
        if not isinstance(draft, DraftDecodeServable):
            raise MXNetError("SpeculativeDecodeBatcher needs a "
                             "DraftDecodeServable draft")
        tcfg = servable.config
        dcfg = draft.config
        if (tcfg.slots != dcfg.slots or tcfg.vocab != dcfg.vocab
                or tcfg.prompt_buckets != dcfg.prompt_buckets
                or tcfg.max_tokens != dcfg.max_tokens
                or tcfg.spec_k != dcfg.spec_k):
            raise MXNetError(
                "speculative decode: draft/target geometry mismatch "
                "(slots, vocab, prompt buckets, max_tokens and spec_k "
                "must agree; got target=%r draft=%r)" % (tcfg, dcfg))
        if draft.device != servable.device:
            raise MXNetError("speculative decode: the draft is on %s, the "
                             "target on %s" % (draft.device,
                                               servable.device))
        self._draft = draft
        self._win_active: Optional[List[Tuple[int, _PendingGen]]] = \
            None
        self._win_step = 0
        reg = _telemetry.registry
        self._c_draft_steps = reg.counter(
            "serve.decode.draft_steps",
            doc="draft-model decode dispatches (spec_k per speculative "
                "window)")
        self._c_draft_prefills = reg.counter(
            "serve.decode.draft_prefills",
            doc="draft KV prefill dispatches (the sentinel ending each "
                "admission's chunk train)")
        self._c_windows = reg.counter(
            "serve.decode.spec_windows",
            doc="speculative verify dispatches (each commits 1..spec_k "
                "tokens for every window lane)")
        # warm everything before the pump threads exist: the target's
        # buckets and chunk program, the draft's, and the verify table
        # (scratch lanes only)
        if not servable.warmed:
            servable.warm()
        if not draft.warmed:
            draft.warm()
        for b in tcfg.slot_buckets:
            servable.dispatch_verify(
                draft, _np.full(b, tcfg.slots, _np.int32),
                _np.zeros((b, tcfg.pages_per_slot), _np.int32))
        servable._synchronize()
        super().__init__(servable, queue_cap=queue_cap, mode=mode,
                         on_tick=on_tick, autostart=autostart)

    @property
    def draft(self) -> DraftDecodeServable:
        return self._draft

    def page_stats(self) -> Dict:
        st = super().page_stats()
        st["engine"] = "speculative"
        st["spec_k"] = self._sv.config.spec_k
        st["draft_model"] = self._draft.name
        st["draft_layers"] = self._draft.config.layers
        return st

    # -- the speculative pump -----------------------------------------------
    def _tick(self) -> bool:
        """One boundary, one dispatch.  Mid-window ticks only advance the
        window (the active set is frozen; retire/admit/chunks wait for the
        boundary); boundary ticks run the paged engine's
        retire/admit/chunk alternation and open the next window."""
        if self._win_active is not None:
            self._window_tick()
            return False
        self._retire()
        self._admit()
        chunk_slot = self._next_chunk_slot()
        active = self._active()
        if chunk_slot is not None and (self._chunk_turn or not active):
            self._chunk_turn = False
            self._dispatch_chunk_for(chunk_slot)
            return False
        self._chunk_turn = True
        if not active:
            return chunk_slot is None
        self._win_active = active
        self._win_step = 0
        self._window_tick()
        return False

    def _window_tick(self) -> None:
        """One dispatch of the current window: draft step ``_win_step``
        while < spec_k, else the verify that closes the window and hands
        (emitted, n_em) to the harvester."""
        active = self._win_active
        cfg = self._sv.config
        ids, tbls = self._lanes(active)
        try:
            if self._win_step < cfg.spec_k:
                with _telemetry.phase("draft_step"):
                    self._draft.dispatch_step(ids, self._win_step)
                self._c_draft_steps.inc()
                self._win_step += 1
                return
            with _telemetry.phase("decode_step") as span:
                for _slot, g in active:
                    if g.trace_ctx is not None:
                        span.event("request", req_trace=g.trace_ctx[0],
                                   req_span=g.trace_ctx[1])
                out = self._sv.dispatch_verify(self._draft, ids, tbls)
        except BaseException as e:            # device failure: fail the set
            self._win_active = None
            self._win_step = 0
            for _slot, g in active:
                g._fail(e)
            return
        self._c_steps.inc()
        self._c_windows.inc()
        self._h_occ.observe(len(active))
        self._win_active = None
        self._win_step = 0
        self._hq_put(([g for _slot, g in active], out))

    # -- admission: chunk train + draft-prefill sentinel --------------------
    def _plan(self, gen: _PendingGen):
        plan = super()._plan(gen)
        if plan is None:
            return None
        table, held, chunks, publish = plan
        # sentinel: chunk=None marks the draft prefill ending the train
        chunks.append((None, 0, len(gen.prompt), False, 0, 0))
        return table, held, chunks, publish

    def _dispatch_chunk_for(self, slot: int) -> None:
        """One train dispatch: a target prefill chunk, or the
        draft-prefill sentinel that completes the train.  The emit chunk's
        first token parks on the session (``seq.t0``) and is harvested
        only when the sentinel has been dispatched."""
        seq = self._seqs[slot]
        gen = seq.gen
        self._chunk_rr = slot
        chunk, start, nvalid, emit, cow_src, cow_dst = \
            seq.chunks.popleft()
        try:
            with _telemetry.phase("prefill") as span:
                if gen.trace_ctx is not None:
                    span.event("request", req_trace=gen.trace_ctx[0],
                               req_span=gen.trace_ctx[1], slot=slot)
                if chunk is None:
                    lp = self._draft.config.prompt_bucket_for(
                        len(gen.prompt))
                    padded = _np.zeros(lp, _np.int32)
                    padded[:len(gen.prompt)] = gen.prompt
                    self._draft.dispatch_prefill(
                        slot, padded, len(gen.prompt),
                        tgt_tokens=self._sv._state["tok"])
                    self._c_draft_prefills.inc()
                else:
                    t0 = self._sv.dispatch_chunk(slot, seq.table,
                                                 chunk, start, nvalid,
                                                 emit, cow_src, cow_dst)
                    self._c_chunks.inc()
                    if emit:
                        seq.t0 = t0
        except BaseException as e:
            self._drop_seq(slot)
            gen._fail(e)
            return
        if not seq.chunks:
            self._finish_train(seq, seq.t0)
