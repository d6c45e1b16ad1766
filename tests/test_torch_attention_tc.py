"""The arithmetic of the bf16 tensor-core kernels K1, K2 and K3, on the CPU.

``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (K2, K3) compute in
bf16 on the tensor cores, which this machine cannot run.  Their arithmetic
is emulated here tile for tile (``tc_flash_fwd``, ``tc_flash_bwd_dq``,
``tc_flash_bwd_dkv``): 64-key tiles, the online softmax in fp32 on
log2-scaled scores, P, P^T, dS and dS^T carried as two bf16 values (hi =
bf16(x), lo = bf16(x - hi)) into their products, fp32 accumulation, and O,
dQ, dK, dV rounded once to bf16.  The emulation is held against the JAX
package's Pallas kernels in interpret mode (``_flash_fwd`` / ``_flash_bwd``
at 64-row blocks) on the same bf16-rounded inputs, and against the port's
plain versions at a ragged T, under ``chip_smoke.py``'s ``compare`` rule at
2e-3: |d| <= 2e-3 + (2e-3 + 2^-8) |ref| for a bf16 result, the rule the
kernels meet on the card.  Two pinned cases show one bf16 rounding of P
and of dS missing that rule where hi + lo meets it, and one case gives K2
and K3 a score past the fp32 range on a finite LSE (P = 0 there, as in the
reference).  The remaining tests cover what the kernels need around them:
16-byte aligned inputs (bf16 and fp32, and the aligned copies the wrappers
make), and a library name that follows the shared headers.

Run as a script, the module prints how far K1's emulated O and LSE (the
warp-specialised tiling, ``tc_flash_fwd_ws``) land from the rule at
``chip_smoke.py``'s forward shapes, with P split and rounded once, and how
far K2's emulated dQ lands at its backward shapes, with dS split and
rounded once::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_attention_tc.py
"""
import math
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops import attention as tatt

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 2e-3
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BLOCK = 64
# the warp-specialised K1: query tile, rows a consumer warpgroup, key tile
WS_BLOCK_Q, WS_ROWS, WS_BLOCK_K = 128, 64, 128


def _bf16(x):
    """``x`` rounded to bf16, as float32."""
    return x.to(torch.bfloat16).float()


def _bf16_trunc(x):
    """``x`` cut to bf16 by truncation (its low 16 bits cleared), as
    float32."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _split_matmul(a, b, split=True, trunc=False):
    """``a @ b`` with ``a`` entering the product as bf16 values: hi + lo
    (two products, as the kernels issue them) or, with ``split=False``, hi
    alone (one rounding).  ``trunc`` cuts hi and lo by truncation, as the
    warp-specialised K1 does, where the other kernels round to nearest."""
    cut = _bf16_trunc if trunc and split else _bf16
    hi = cut(a)
    out = hi @ b
    return out + cut(a - hi) @ b if split else out


def _fwd_rows(q, k, v, row0, scale, causal, split, block_k, trunc=False):
    """The online softmax of K1 for query rows row0 .. row0 + len(q) over
    key tiles of ``block_k``: (O bf16, LSE float32)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    m = torch.full((B, H, Tq, 1), -math.inf)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    qpos = torch.arange(row0, row0 + Tq)[:, None]
    for k0 in range(0, Tk, block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = (q @ kt.transpose(-1, -2)) * (scale * LOG2E)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(qpos < kpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp2(m - m_safe),
                            torch.zeros_like(m))
        p = torch.where(torch.isfinite(s), torch.exp2(s - m_safe),
                        torch.zeros_like(s))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _split_matmul(p, vt, split, trunc)
        m = m_new
    o = acc * (1.0 / l.clamp_min(1e-30))
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.where(l > 0, m_fin * LN2 + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, -math.inf))
    return o.to(torch.bfloat16), lse[..., 0]


def tc_flash_fwd(q, k, v, scale, causal, split=True):
    """K1's bf16 arithmetic on 64-key tiles (the ``mma.sync`` tiling the
    backward emulations were built against): (O bf16, LSE float32
    (B, H, Tq))."""
    q, k, v = (t.float() for t in (q, k, v))
    return _fwd_rows(q, k, v, 0, scale, causal, split, BLOCK)


def tc_flash_fwd_ws(q, k, v, scale, causal, split=True):
    """K1's bf16 arithmetic as the warp-specialised ``wgmma`` kernel tiles
    it: 128-row query tiles, each split into two 64-row warpgroups that run
    the online softmax over 128-key tiles, up to the last key tile the
    128-row tile sees when causal; P enters P V as hi + lo, both cut by
    truncation (one rounding to nearest with ``split=False``).  (O bf16,
    LSE float32 (B, H, Tq))."""
    q, k, v = (t.float() for t in (q, k, v))
    Tq, Tk = q.shape[2], k.shape[2]
    outs, lses = [], []
    for q0 in range(0, Tq, WS_BLOCK_Q):
        n_kt = -(-Tk // WS_BLOCK_K)
        if causal:
            n_kt = min(n_kt, -(-(q0 + WS_BLOCK_Q) // WS_BLOCK_K))
        kv = slice(0, n_kt * WS_BLOCK_K)
        for r0 in range(q0, min(q0 + WS_BLOCK_Q, Tq), WS_ROWS):
            o, lse = _fwd_rows(q[:, :, r0:r0 + WS_ROWS], k[:, :, kv],
                               v[:, :, kv], r0, scale, causal, split,
                               WS_BLOCK_K, trunc=True)
            outs.append(o)
            lses.append(lse)
    return torch.cat(outs, 2), torch.cat(lses, 2)


def tc_flash_bwd_dkv(q, k, v, o, lse, do, scale, causal, split=True):
    """K3's bf16 arithmetic: (dK, dV) in bf16, accumulated over slices of
    32 queries as the kernel adds them; P^T = 0 where exp2's argument is
    not finite (a query whose LSE is not finite, or a score outside the
    fp32 range)."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    bq = 32
    delta = (do * o).sum(-1)
    lse2 = lse.float() * LOG2E
    dk = torch.zeros((B, H, Tk, D))
    dv = torch.zeros((B, H, Tk, D))
    kpos = torch.arange(Tk)[:, None]
    for q0 in range(0, Tq, bq):
        qt, dot = q[:, :, q0:q0 + bq], do[:, :, q0:q0 + bq]
        l2 = lse2[:, :, None, q0:q0 + bq]
        x = (k @ qt.transpose(-1, -2)) * (scale * LOG2E) - l2
        ok = torch.isfinite(x)
        if causal:
            qpos = torch.arange(q0, q0 + qt.shape[2])[None, :]
            ok = ok & (qpos >= kpos)
        pt = torch.where(ok, torch.exp2(x), torch.zeros_like(x))
        dpt = v @ dot.transpose(-1, -2)
        dst = pt * (dpt - delta[:, :, None, q0:q0 + bq])
        dv += _split_matmul(pt, dot, split)
        dk += _split_matmul(dst, qt, split)
    return (dk * scale).to(torch.bfloat16), dv.to(torch.bfloat16)


def tc_flash_bwd_dq(q, k, v, o, lse, do, scale, causal, split=True):
    """K2's bf16 arithmetic: dQ in bf16, accumulated over 64-key tiles as
    the kernel adds them.  A row with a non-finite LSE takes LSE = +inf,
    and P is 0 where exp2's argument is not finite (such a row, or a score
    outside the fp32 range)."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    delta = (do * o).sum(-1, keepdim=True)
    lse = lse.float()
    lse2 = torch.where(torch.isfinite(lse), lse * LOG2E,
                       torch.full_like(lse, math.inf))[..., None]
    dq = torch.zeros((B, H, Tq, D))
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, BLOCK):
        kt, vt = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
        x = (q @ kt.transpose(-1, -2)) * (scale * LOG2E) - lse2
        p = torch.where(torch.isfinite(x), torch.exp2(x),
                        torch.zeros_like(x))
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            p = p.masked_fill(qpos < kpos, 0.0)
        ds = p * (do @ vt.transpose(-1, -2) - delta)
        dq += _split_matmul(ds, kt, split)
    return (dq * scale).to(torch.bfloat16)


def _bf16_inputs(seed, shapes):
    """Seeded normal arrays rounded to bf16, as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    return [_bf16(torch.from_numpy(rng.randn(*s).astype(np.float32))
                  ).numpy() for s in shapes]


def _holds(got, want, what):
    err, ok = cs.compare(got, torch.as_tensor(np.array(want)), TOL)
    assert ok, "%s misses the bf16 rule by max|d| %.3g" % (what, err)


CASES = [(T, D, causal) for T in (128, 192) for D in (64, 128)
         for causal in (False, True)]


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tc_forward_matches_pallas_kernel(T, D, causal):
    """K1's bf16 arithmetic against ``_flash_fwd`` in interpret mode at
    64-row blocks, fp32 throughout, on the same bf16-rounded inputs."""
    q, k, v = _bf16_inputs(T + D + int(causal), [(1, 2, T, D)] * 3)
    scale = 1.0 / math.sqrt(D)
    o_j, lse_j = jatt._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal,
                                 block_q=BLOCK, block_k=BLOCK)
    o_t, lse_t = tc_flash_fwd(*map(torch.from_numpy, (q, k, v)), scale,
                              causal)
    assert o_t.dtype == torch.bfloat16 and lse_t.shape == (1, 2, T)
    _holds(o_t, o_j, "O")
    _holds(lse_t, lse_j, "LSE")


@pytest.mark.parametrize("T,D,causal", CASES)
def test_ws_forward_matches_pallas_kernel(T, D, causal):
    """K1's bf16 arithmetic as the warp-specialised kernel tiles it (two
    64-row warpgroups of a 128-row query tile, 128-key tiles) against
    ``_flash_fwd`` in interpret mode at 64-row blocks, on the same
    bf16-rounded inputs."""
    q, k, v = _bf16_inputs(T + D + int(causal), [(1, 2, T, D)] * 3)
    scale = 1.0 / math.sqrt(D)
    o_j, lse_j = jatt._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal,
                                 block_q=BLOCK, block_k=BLOCK)
    o_t, lse_t = tc_flash_fwd_ws(*map(torch.from_numpy, (q, k, v)), scale,
                                 causal)
    assert o_t.dtype == torch.bfloat16 and lse_t.shape == (1, 2, T)
    _holds(o_t, o_j, "O")
    _holds(lse_t, lse_j, "LSE")


@pytest.mark.parametrize("Tq,Tk,D,causal", [
    (200, 200, 128, True), (64, 128, 64, True), (77, 333, 64, False),
    (200, 333, 128, False)])
def test_ws_forward_matches_plain_version_at_ragged_shapes(Tq, Tk, D,
                                                           causal):
    """The warp-specialised tiling at ``chip_smoke.KERNEL_CASES``' ragged
    shapes (a partial query tile, a partial or half-used key tile, top-left
    causal with Tq < Tk) against the port's plain version in fp32 on the
    same bf16 inputs, as the card holds the kernel."""
    q, k, v = (torch.from_numpy(a) for a in _bf16_inputs(
        Tq + Tk + D, [(1, 2, Tq, D), (1, 2, Tk, D), (1, 2, Tk, D)]))
    scale = 1.0 / math.sqrt(D)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, scale, causal)
    o, lse = tc_flash_fwd_ws(q, k, v, scale, causal)
    assert o.shape == (1, 2, Tq, D) and lse.shape == (1, 2, Tq)
    _holds(o, o_ref, "O")
    _holds(lse, lse_ref, "LSE")


def test_ws_forward_without_keys_gives_zero_and_minus_inf():
    """Tk = 0 (the kernel loads no tile): O = 0 and LSE = -inf, as the
    plain version gives."""
    q = torch.ones(1, 2, 5, 64)
    k = v = torch.zeros(1, 2, 0, 64)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, 0.125, False)
    o, lse = tc_flash_fwd_ws(q, k, v, 0.125, False)
    assert torch.equal(o.float(), o_ref) and torch.equal(o_ref,
                                                         torch.zeros_like(q))
    assert torch.equal(lse, lse_ref) and bool((lse == -math.inf).all())


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tc_dkv_matches_pallas_kernel(T, D, causal):
    """K3's bf16 arithmetic against ``_flash_bwd``'s dK and dV in
    interpret mode at 64-row blocks, on the same bf16-rounded q, k, v, dO,
    the forward's O rounded to bf16 (as K1 returns it) and its LSE."""
    q, k, v, do = _bf16_inputs(7 * T + D + int(causal), [(1, 2, T, D)] * 4)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse_lanes = jatt._flash_fwd_res(jq, jk, jv, scale, causal,
                                       block_q=BLOCK, block_k=BLOCK)
    o = _bf16(torch.from_numpy(np.array(o))).numpy()
    _, dk_j, dv_j = jatt._flash_bwd(jq, jk, jv, jnp.asarray(o), lse_lanes,
                                    jdo, scale, causal, block_q=BLOCK,
                                    block_k=BLOCK)
    lse = np.array(jatt._lse_from_lanes(lse_lanes, 1, 2, T))
    dk_t, dv_t = tc_flash_bwd_dkv(*map(torch.from_numpy, (q, k, v, o, lse,
                                                          do)),
                                  scale, causal)
    assert dk_t.dtype == dv_t.dtype == torch.bfloat16
    _holds(dk_t, dk_j, "dK")
    _holds(dv_t, dv_j, "dV")


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tc_dq_matches_pallas_kernel(T, D, causal):
    """K2's bf16 arithmetic against ``_flash_bwd``'s dQ in interpret mode
    at 64-row blocks, on the same bf16-rounded q, k, v, dO, the forward's O
    rounded to bf16 (as K1 returns it) and its LSE."""
    q, k, v, do = _bf16_inputs(5 * T + D + int(causal), [(1, 2, T, D)] * 4)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse_lanes = jatt._flash_fwd_res(jq, jk, jv, scale, causal,
                                       block_q=BLOCK, block_k=BLOCK)
    o = _bf16(torch.from_numpy(np.array(o))).numpy()
    dq_j, _, _ = jatt._flash_bwd(jq, jk, jv, jnp.asarray(o), lse_lanes, jdo,
                                 scale, causal, block_q=BLOCK, block_k=BLOCK)
    lse = np.array(jatt._lse_from_lanes(lse_lanes, 1, 2, T))
    dq_t = tc_flash_bwd_dq(*map(torch.from_numpy, (q, k, v, o, lse, do)),
                           scale, causal)
    assert dq_t.dtype == torch.bfloat16 and dq_t.shape == (1, 2, T, D)
    _holds(dq_t, dq_j, "dQ")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_dq_matches_plain_version_at_ragged_t(D, causal):
    """K2's bf16 arithmetic at T = 200 (a partial last tile of 8 rows and 8
    keys) against the port's plain version in fp32, on the same bf16
    inputs and K1's emulated O and LSE, as the card holds the kernel; a row
    whose LSE is -inf gets dQ = 0."""
    T = 200
    q, k, v, do = (torch.from_numpy(a) for a in _bf16_inputs(
        3 * D + int(causal), [(1, 2, T, D)] * 4))
    scale = 1.0 / math.sqrt(D)
    o, lse = tc_flash_fwd(q, k, v, scale, causal)
    o = o.float()
    dq_ref = tatt.flash_bwd_dq_plain(q, k, v, o, lse, do, scale, causal)
    dq = tc_flash_bwd_dq(q, k, v, o, lse, do, scale, causal)
    _holds(dq, dq_ref, "dQ")
    lse[:, :, -1] = -math.inf
    dq = tc_flash_bwd_dq(q, k, v, o, lse, do, scale, causal)
    assert torch.equal(dq[:, :, -1].float(), torch.zeros(1, 2, D))
    assert torch.isfinite(dq.float()).all()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_arithmetic_matches_plain_versions_at_ragged_t(D, causal):
    """At T = 200 (a partial last tile of 8 rows) against the port's plain
    versions, which the kernels are held to on the card, in fp32 on the
    same bf16 inputs."""
    T = 200
    q, k, v, do = (torch.from_numpy(a) for a in _bf16_inputs(
        D + int(causal), [(1, 2, T, D)] * 4))
    scale = 1.0 / math.sqrt(D)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, scale, causal)
    o, lse = tc_flash_fwd(q, k, v, scale, causal)
    _holds(o, o_ref, "O")
    _holds(lse, lse_ref, "LSE")
    o = o.float()
    dk_ref, dv_ref = tatt.flash_bwd_dkv_plain(q, k, v, o, lse_ref, do,
                                              scale, causal)
    dk, dv = tc_flash_bwd_dkv(q, k, v, o, lse_ref, do, scale, causal)
    _holds(dk, dk_ref, "dK")
    _holds(dv, dv_ref, "dV")
    if causal:
        # the last key sees one query: its P^T is 0 before any product
        assert torch.isfinite(dk.float()).all()


@pytest.mark.parametrize("D,causal", [(64, True), (128, False)])
def test_a_score_past_the_bf16_range_gets_p_zero(D, causal):
    """As in the reference, P = 0 where a score is not finite, also where
    its row's LSE is finite: the bf16 twin of the fp32 case in
    ``test_torch_attention_tf32.py``.  Query r and key j0 see only each
    other (``chip_smoke.isolate_pair``), the forward gives O (rounded to
    bf16, as K1 returns it) and a finite LSE, and then their score alone
    is pushed to +inf by bf16 inputs holding 1e20
    (``chip_smoke.overflow_pair``).  The emulated K2 and K3 meet
    ``_flash_bwd`` in interpret mode and the plain versions under the bf16
    rule and stay finite; exp(+inf) there would make dQ row r, dK row j0
    and dV row j0 inf or NaN."""
    T, r, j0 = 128, 100, 37
    rng = np.random.RandomState(13 * D + int(causal))
    q, k, v, do = (rng.randn(1, 2, T, D).astype(np.float32)
                   for _ in range(4))
    cs.isolate_pair(q, k, r, j0)
    q, k, v, do = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    o, lse_lanes = jatt._flash_fwd_res(*map(jnp.asarray, (q, k, v)), scale,
                                       causal, block_q=BLOCK, block_k=BLOCK)
    o = _bf16(torch.from_numpy(np.array(o))).numpy()
    lse = np.array(jatt._lse_from_lanes(lse_lanes, 1, 2, T))
    cs.overflow_pair(q, k, r, j0)
    q, k = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k))
    want_j = jatt._flash_bwd(*map(jnp.asarray, (q, k, v, o)), lse_lanes,
                             jnp.asarray(do), scale, causal, block_q=BLOCK,
                             block_k=BLOCK)
    args = tuple(map(torch.from_numpy, (q, k, v, o, lse, do))) + (scale,
                                                                   causal)
    s = torch.einsum("bhd,bhd->bh", args[0][:, :, r], args[1][:, :, j0])
    assert bool(torch.isinf(s).all()) and bool(torch.isfinite(args[4]).all())
    want_p = (tatt.flash_bwd_dq_plain(*args),) + tatt.flash_bwd_dkv_plain(
        *args)
    got = (tc_flash_bwd_dq(*args),) + tc_flash_bwd_dkv(*args)
    for what, g, wj, wp in zip(("dQ", "dK", "dV"), got, want_j, want_p):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), what
        _holds(g, wj, what + " against the Pallas kernel")
        _holds(g, wp, what + " against the plain version")


def test_one_bf16_rounding_of_p_misses_the_rule_the_split_meets():
    """Why P enters the products as hi + lo: a causal row that sees two
    keys, P = (1/(1+e), e/(1+e)), whose value rows cancel (10.875 and -4):
    O is ~5e-4, and rounding P once to bf16 moves it by ~9e-3, more than
    the rule's 2e-3.  The hi + lo pair meets the rule."""
    D = 64
    q = torch.zeros(1, 1, 2, D)
    k = torch.zeros(1, 1, 2, D)
    v = torch.zeros(1, 1, 2, D)
    q[..., 1, 0] = 1.0
    k[..., 1, 0] = 8.0                  # row 1 scores (0, 1) at scale 1/8
    v[..., 0, :] = 10.875
    v[..., 1, :] = -4.0
    want, _ = tatt.flash_attention_plain(q, k, v, 0.125, True)
    once, _ = tc_flash_fwd(q, k, v, 0.125, True, split=False)
    split, _ = tc_flash_fwd(q, k, v, 0.125, True)
    assert not cs.compare(once, want, TOL)[1]
    assert cs.compare(split, want, TOL)[1]


def test_truncated_hi_plus_lo_of_p_meets_the_rule_one_rounding_misses():
    """The warp-specialised K1 cuts P's hi and lo by truncation (no
    conversion instruction): on the pinned two-key row of the test above,
    that pair meets the rule as the rounded pair does, and one rounding
    still misses it."""
    D = 64
    q, k, v = (torch.zeros(1, 1, 2, D) for _ in range(3))
    q[..., 1, 0] = 1.0
    k[..., 1, 0] = 8.0
    v[..., 0, :] = 10.875
    v[..., 1, :] = -4.0
    want, _ = tatt.flash_attention_plain(q, k, v, 0.125, True)
    once, _ = tc_flash_fwd_ws(q, k, v, 0.125, True, split=False)
    split, _ = tc_flash_fwd_ws(q, k, v, 0.125, True)
    assert not cs.compare(once, want, TOL)[1]
    assert cs.compare(split, want, TOL)[1]
    x = torch.tensor([1 / 3, 0.7853981, 2.0 ** -20 * 3.1, 0.999999])
    hi = _bf16_trunc(x)
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)
    assert float(((hi + _bf16_trunc(x - hi) - x).abs() / x).max()) < 2 ** -14


def test_one_bf16_rounding_of_ds_misses_the_rule_the_split_meets():
    """Why dS enters dQ = dS K as hi + lo: a causal row that sees three
    keys, scores (0, 1, 2), dP = (3, -5, 7), and keys equal (60) in every
    column the query does not touch.  There dQ = scale * 60 * sum(dS) = 0,
    since the row's dS sums to 0; rounding dS once to bf16 leaves a sum of
    ~1e-3 and moves dQ by ~7e-3, past the rule's 2e-3.  The hi + lo pair
    stays below 1e-4."""
    D, T = 64, 3
    q, k, v, do = (torch.zeros(1, 1, T, D) for _ in range(4))
    q[..., 0] = 1.0
    k[..., 0] = torch.tensor([0.0, 8.0, 16.0])
    k[..., 1:] = 60.0
    v[..., 0] = torch.tensor([3.0, -5.0, 7.0])
    do[..., 0] = 1.0
    o, lse = tatt.flash_attention_plain(q, k, v, 0.125, True)
    want = tatt.flash_bwd_dq_plain(q, k, v, o, lse, do, 0.125, True)
    once = tc_flash_bwd_dq(q, k, v, o, lse, do, 0.125, True, split=False)
    split = tc_flash_bwd_dq(q, k, v, o, lse, do, 0.125, True)
    assert not cs.compare(once, want, TOL)[1]
    assert cs.compare(split, want, TOL)[1]
    assert float((split.float() - want)[..., 1:].abs().max()) < 1e-4


def _misaligned_bf16(shape):
    """A contiguous bf16 view that starts 8 bytes past a 16-byte
    boundary."""
    base = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    t = base[4:4 + int(np.prod(shape))].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 8
    return t


def _misaligned_fp32(shape, seed):
    """A contiguous fp32 view 4 bytes past a 16-byte boundary, holding
    seeded normal values."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 1)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    t.copy_(torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32)))
    return t


def test_attention_core_hands_the_kernels_aligned_copies(monkeypatch):
    """A misaligned contiguous bf16 input reaches the kernels as an aligned
    copy with the same values; an aligned one is passed as it is.  A public
    fp32 call on a view 4 bytes past a 16-byte boundary takes K1's path as
    on the card (``_flash_fwd_launch``, the check and the launch, stands in
    for the card): the launch receives an aligned copy with the same
    values, and the answer is the plain version's on the view."""
    t = _misaligned_bf16((1, 2, 16, 64))
    t.normal_()
    out = tatt._kernel_layout(t)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, t)
    aligned = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    assert tatt._kernel_layout(aligned) is aligned

    seen = []

    def launch(q, k, v, scale, causal):
        tatt._check_kernel_inputs(q, k, v)
        seen.append(q)
        return tatt.flash_attention_plain(q, k, v, scale, causal)

    monkeypatch.setattr(tatt, "_flash_fwd_launch", launch)
    monkeypatch.setattr(tatt, "_on_cpu", lambda *ts: False)
    q = _misaligned_fp32((1, 2, 16, 64), 0)
    k = torch.from_numpy(
        np.random.RandomState(1).randn(1, 2, 16, 64).astype(np.float32))
    got = tatt.flash_attention(q, k, k, 0.125, False)
    assert len(seen) == 1
    assert seen[0].data_ptr() % 16 == 0 and torch.equal(seen[0], q)
    want, _ = tatt.flash_attention_plain(q, k, k, 0.125, False)
    assert torch.equal(got, want)


def test_fp32_inputs_must_be_16_byte_aligned_too(monkeypatch):
    """Every fp32 kernel copies 16-byte chunks with ``cp.async`` as the
    bf16 kernels do (K1 fp32 too, on the tensor cores): a contiguous fp32
    view 4 bytes past a 16-byte boundary is refused by the forward's check
    and the backward's, and reaches K1 from ``_flash_fwd_cuda`` and K2 and
    K3 from ``_flash_bwd_cuda`` as an aligned copy with the same values."""
    from mxnet_tpu_torch.base import MXNetError
    t = _misaligned_fp32((1, 2, 16, 64), 2)
    k = v = o = g = torch.zeros(1, 2, 16, 64)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(MXNetError, match="16-byte"):
        tatt._check_kernel_inputs(t, k, v)
    with pytest.raises(MXNetError, match="16-byte"):
        tatt._check_kernel_inputs(k, t, v)
    with pytest.raises(MXNetError, match="16-byte"):
        tatt._check_bwd_inputs(t, k, v, o, lse, g)
    with pytest.raises(MXNetError, match="16-byte"):
        tatt._check_bwd_inputs(k, k, v, t, lse, g)
    seen = []

    def launch(*args):
        tatt._check_bwd_inputs(*args[:6])
        seen.append(args[0])
        return args[0]

    def launch_fwd(q, k, v, scale, causal):
        tatt._check_kernel_inputs(q, k, v)
        seen.append(q)
        return q, lse

    monkeypatch.setattr(tatt, "_flash_fwd_launch", launch_fwd)
    monkeypatch.setattr(tatt, "_flash_bwd_dq_cuda", launch)
    monkeypatch.setattr(tatt, "_flash_bwd_dkv_cuda",
                        lambda *a: (launch(*a), a[1]))
    tatt._flash_fwd_cuda(t, k, v, 0.125, False)
    tatt._flash_bwd_cuda(t, k, v, o, lse, g, 0.125, False)
    assert len(seen) == 3
    for q in seen:
        assert q.data_ptr() % 16 == 0 and torch.equal(q, t)


def test_library_name_follows_every_header(tmp_path):
    """The library of a ``csrc/`` source is named by a hash of the source,
    of every ``*.cuh`` beside it and of the flags: editing the shared
    header, or adding one, names a new library, so a stale build is never
    loaded.  A user kernel's library follows its own text only."""
    for src in [_kernels.CSRC / "flash_fwd.cu"] + sorted(
            _kernels.CSRC.glob("*.cuh")):
        shutil.copy(src, tmp_path / src.name)
    lib = _kernels.KernelLibrary("flash_fwd", {}, ["flash_fwd"])
    lib.source = tmp_path / "flash_fwd.cu"
    first = lib.library_path()
    assert first.name.startswith("libflash_fwd-")
    assert lib.library_path() == first
    assert first == _kernels.FLASH_FWD.library_path()
    header = tmp_path / "mma_bf16.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = lib.library_path()
    assert edited != first
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert lib.library_path() not in (first, edited)
    (tmp_path / "extra.cuh").unlink()
    shutil.copy(_kernels.CSRC / "mma_bf16.cuh", header)
    assert lib.library_path() == first
    for real in (_kernels.FLASH_FWD, _kernels.FLASH_BWD):
        assert b"mma_bf16.cuh\0" in real.header_bytes()
    user = _kernels.SourceLibrary("body", "__global__ void f() {}", {},
                                  ["f"])
    assert user.header_bytes() == b""


def _worst_ratio(got, want):
    """max |got - want| / the limit of ``chip_smoke.compare``'s bf16 rule
    at 2e-3; the rule holds where this is at most 1 (0 for no entries)."""
    want = torch.as_tensor(want).float()
    limit = TOL + (TOL + 2.0 ** -8) * want.abs()
    ratio = (got.float() - want).abs() / limit
    return float(ratio.max()) if ratio.numel() else 0.0


def dq_rounding_margins(seed):
    """For each bf16 case of ``chip_smoke.BWD_CASES``: the worst |d| /
    limit of K2's emulated dQ against ``flash_bwd_dq_plain`` (fp32, on the
    same bf16 inputs and K1's emulated O and LSE), with dS entering dQ =
    dS K as hi + lo and rounded once."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for name, B, H, Tq, Tk, D, dtype, causal, _ in cs.BWD_CASES:
        if dtype != torch.bfloat16:
            continue
        q, k, v = (torch.randn((B, H, T, D), generator=g).bfloat16()
                   for T in (Tq, Tk, Tk))
        do = torch.randn((B, H, Tq, D), generator=g).bfloat16()
        scale = 1.0 / D ** 0.5
        o, lse = tc_flash_fwd(q, k, v, scale, causal)
        args = (q, k, v, o, lse, do, scale, causal)
        want = tatt.flash_bwd_dq_plain(*(t.float() for t in args[:6]),
                                       scale, causal)
        out.append((name, causal,
                    _worst_ratio(tc_flash_bwd_dq(*args), want),
                    _worst_ratio(tc_flash_bwd_dq(*args, split=False), want)))
    return out


def fwd_rounding_margins(seed):
    """For each bf16 case of ``chip_smoke.KERNEL_CASES``: the worst |d| /
    limit of K1's emulated O (warp-specialised tiling, P as hi + lo, and P
    rounded once) and LSE against ``flash_attention_plain`` in fp32 on the
    same bf16 inputs, under ``chip_smoke.compare``'s rules (bf16 for O,
    fp32 for the fp32 LSE)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for name, B, H, Tq, Tk, D, dtype, causal, _ in cs.KERNEL_CASES:
        if dtype != torch.bfloat16:
            continue
        q, k, v = (torch.randn((B, H, T, D), generator=g).bfloat16()
                   for T in (Tq, Tk, Tk))
        scale = 1.0 / D ** 0.5
        o_ref, lse_ref = tatt.flash_attention_plain(
            q.float(), k.float(), v.float(), scale, causal)
        o, lse = tc_flash_fwd_ws(q, k, v, scale, causal)
        once, _ = tc_flash_fwd_ws(q, k, v, scale, causal, split=False)
        lse_d = torch.where(lse == lse_ref, 0.0, (lse - lse_ref).abs())
        out.append((name, causal, _worst_ratio(o, o_ref),
                    _worst_ratio(once, o_ref),
                    float((lse_d / (TOL + TOL * lse_ref.abs())).max())
                    if lse_d.numel() else 0.0))
    return out


if __name__ == "__main__":
    for seed in (0, 1, 2):
        for name, causal, split, once, lse in fwd_rounding_margins(seed):
            print("seed %d %-16s causal=%-5s K1 (wgmma tiling) worst |d|/"
                  "limit: O hi + lo %.3f, O one rounding %.3f, LSE %.2g"
                  % (seed, name, causal, split, once, lse))
    for seed in (0, 1, 2):
        for name, causal, split, once in dq_rounding_margins(seed):
            print("seed %d %-16s causal=%-5s dQ worst |d|/limit: hi + lo "
                  "%.3f, one rounding %.3f" % (seed, name, causal, split,
                                               once))
