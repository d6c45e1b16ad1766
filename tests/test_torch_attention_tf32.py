"""The arithmetic of the fp32 tensor-core kernels K1, K2 and K3, on the CPU.

``csrc/flash_fwd.cu`` computes K1 (O, LSE) and ``csrc/flash_bwd.cu`` K2
(dQ) and K3 (dK, dV) in fp32 on the tensor cores with ``mma.sync.m16n8k8``
on TF32 operands, which this machine cannot run.  Their arithmetic is
emulated here tile for tile (``tf32_flash_fwd``, ``tf32_flash_bwd_dq``,
``tf32_flash_bwd_dkv``): K1 and K2 over 32-key tiles, K3 over 16-query
tiles; every product over k-steps of 8, each operand x entering as two
TF32 values, three products a step in the kernels' order (a_lo b_hi, a_hi
b_lo, a_hi b_hi) summed in fp32.  The tensor core reads
the top 19 bits of a register and ignores the low 13, and the kernels feed
it x itself as hi and lo = x - hi as it is: so hi is x truncated to TF32
(``_tf32_trunc``) and lo is x - hi truncated.  P and dS (P^T, dS^T) come
from fp32 accumulators into the next product with the k index of each
step permuted as the kernels permute it (k-slot t <- column 2t, k-slot t +
4 <- column 2t + 1), which changes only the order of summation.  K1 runs
the online softmax on exp2 of scores in log2 units (Q pre-multiplied by
scale log2e) with the reference's guards; K2 and K3 take probabilities as
exp2(scale log2e S - log2e LSE) in fp32, and 0 where that argument is not
finite (a score or an LSE outside the fp32 range).  The emulation is held
against the JAX package's Pallas kernels in interpret mode
(``_flash_fwd_res`` and ``_flash_bwd`` at 64-row blocks) and against the
port's plain versions at ragged shapes, under ``chip_smoke.py``'s
``compare`` rule at 1e-4: |d| <= 1e-4 + 1e-4 |ref|, the rule the kernels
meet on the card.  Pinned cases show one TF32 product, its operands
rounded as a TF32 GEMM rounds them (``_tf32``: ``cvt.rna.tf32.f32`` bit
for bit), missing that rule where the split meets it, in the forward and
in the backward.

Which register holds which element is a separate question, and the tile
emulation cannot see it: a kernel whose A k-slot and B row disagree would
still sum the right products here.  ``test_fragments_*`` take it up at the
level of the lanes: they mirror the kernels' index arithmetic
(``tf32::ldsm_a``, ``ldsm_b_nk``, ``mma3_abt``, ``mma3_cb`` and the padded
tile layout of ``csrc/mma_tf32.cuh``) by hand and hold it against the PTX
ISA's m16n8k8 fragment layouts.  That the CUDA source does what the mirror does is shown only on
the card, where ``chip_smoke.py`` holds the kernels to the plain versions.

Run as a script, the module prints how far the emulated O and LSE, and dQ,
dK and dV, land from the rule, as the split and as one TF32 product, at
``chip_smoke.py``'s fp32 shapes and the pinned cases'::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_attention_tf32.py
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import chip_smoke as cs
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.ops import attention as tatt

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BLOCK = 64          # the Pallas kernels' blocks
TILE_K = 32         # keys of K1's and K2's streamed tiles
TILE_Q = 16         # queries of K3's streamed tiles
K_STEP = 8          # the reduction depth of one m16n8k8
# the columns of an accumulator-fed A fragment, by k-slot
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32(x):
    """``cvt.rna.tf32.f32``: ``x`` (float32) rounded to 10 mantissa bits,
    to nearest with ties away from zero (add half of the 13 dropped bits'
    range to the magnitude, then clear them); +-inf and NaN pass
    through."""
    bits = x.float().contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & -0x2000).view(
        torch.float32)


def _tf32_trunc(x):
    """The TF32 value the tensor core reads from a register holding the
    float32 ``x``: its low 13 bits cleared."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _split(x):
    """(hi, lo) as the tensor core reads the kernels' split of ``x``: hi =
    x truncated to TF32, lo = x - hi (exact in fp32) truncated."""
    hi = _tf32_trunc(x)
    return hi, _tf32_trunc(x - hi)


def _mm3(a, b, split=True, perm=False):
    """``a @ b`` in fp32 as the kernels issue it: over k-steps of 8, each
    adding a_lo b_hi, then a_hi b_lo, then a_hi b_hi to the fp32 sum.  With
    ``split=False``, one TF32 product per step, the operands rounded by
    ``cvt.rna`` as a TF32 GEMM rounds them.  ``perm`` takes each step's k
    index in the order of an A fragment made from accumulators.  A ragged k
    is padded with zeros, as the kernels' tiles are.  (The permutation
    changes only the order of summation; ``test_fragments_*`` check the
    register mapping itself.)"""
    pad = (-a.shape[-1]) % K_STEP
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    if split:
        ah, al = _split(a)
        bh, bl = _split(b)
    else:
        ah, bh = _tf32(a), _tf32(b)
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    order = PERM if perm else tuple(range(K_STEP))
    for k0 in range(0, a.shape[-1], K_STEP):
        idx = [k0 + j for j in order]
        if split:
            acc = acc + al[..., idx] @ bh[..., idx, :]
            acc = acc + ah[..., idx] @ bl[..., idx, :]
        acc = acc + ah[..., idx] @ bh[..., idx, :]
    return acc


def tf32_flash_fwd(q, k, v, scale, causal, split=True):
    """K1's fp32 arithmetic: (O, LSE (B, H, Tq)) over 32-key tiles as the
    kernel adds them.  Q enters multiplied by scale * log2e (both rounded
    to fp32, as the kernel takes them), so S is in log2 units; the online
    softmax runs on exp2 with the reference's three guards (m_safe = 0 on
    a row with no finite score yet, alpha = 0 while m is -inf, P = 0 where
    S is not finite); O = alpha O + P V with P in the k permutation of an
    accumulator-fed A fragment; O = acc times 1 / max(l, 1e-30) and LSE =
    m ln 2 + ln l, -inf where l = 0.  (The kernel also skips the key tiles
    a causal query tile cannot see; with every score -inf, such a tile
    leaves m, l and O as they are here.)"""
    q, k, v = (t.float() for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qs = q * sl2
    m = torch.full((B, H, Tq, 1), -math.inf)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TILE_K):
        kt, vt = k[:, :, k0:k0 + TILE_K], v[:, :, k0:k0 + TILE_K]
        s = _mm3(qs, kt.transpose(-1, -2), split)
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
        acc = alpha * acc + _mm3(p, vt, split, perm=True)
        m = m_new
    o = acc * (1.0 / l.clamp_min(1e-30))
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.where(l > 0, m_fin * LN2 + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, -math.inf))
    return o, lse[..., 0]


def tf32_flash_bwd_dq(q, k, v, o, lse, do, scale, causal, split=True):
    """K2's fp32 arithmetic: dQ accumulated over 32-key tiles as the kernel
    adds them.  A row with a non-finite LSE takes LSE = +inf, and P is 0
    where exp2's argument is not finite (such a row, or a score outside the
    fp32 range).  (The kernel also skips the key tiles a causal query tile
    cannot see; their P is 0 here, which adds nothing.)"""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    delta = (do * o).sum(-1, keepdim=True)
    lse = lse.float()
    lse2 = torch.where(torch.isfinite(lse), lse * LOG2E,
                       torch.full_like(lse, math.inf))[..., None]
    dq = torch.zeros((B, H, Tq, D))
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TILE_K):
        kt, vt = k[:, :, k0:k0 + TILE_K], v[:, :, k0:k0 + TILE_K]
        s = _mm3(q, kt.transpose(-1, -2), split)
        x = s * (scale * LOG2E) - lse2
        p = torch.where(torch.isfinite(x), torch.exp2(x),
                        torch.zeros_like(x))
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            p = p.masked_fill(qpos < kpos, 0.0)
        ds = p * (_mm3(do, vt.transpose(-1, -2), split) - delta)
        dq = dq + _mm3(ds, kt, split, perm=True)
    return dq * scale


def tf32_flash_bwd_dkv(q, k, v, o, lse, do, scale, causal, split=True):
    """K3's fp32 arithmetic: (dK, dV) accumulated over 16-query tiles as
    the kernel adds them; P^T = 0 where exp2's argument is not finite (a
    query whose LSE is not finite, or a score outside the fp32 range).
    (The kernel also skips the query tiles before a causal key tile; their
    P^T is 0 here.)"""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    delta = (do * o).sum(-1)
    lse2 = lse.float() * LOG2E
    dk = torch.zeros((B, H, Tk, D))
    dv = torch.zeros((B, H, Tk, D))
    kpos = torch.arange(Tk)[:, None]
    for q0 in range(0, Tq, TILE_Q):
        qt, dot = q[:, :, q0:q0 + TILE_Q], do[:, :, q0:q0 + TILE_Q]
        l2 = lse2[:, :, None, q0:q0 + TILE_Q]
        x = _mm3(k, qt.transpose(-1, -2), split) * (scale * LOG2E) - l2
        ok = torch.isfinite(x)
        if causal:
            qpos = torch.arange(q0, q0 + qt.shape[2])[None, :]
            ok = ok & (qpos >= kpos)
        pt = torch.where(ok, torch.exp2(x), torch.zeros_like(x))
        dpt = _mm3(v, dot.transpose(-1, -2), split)
        dst = pt * (dpt - delta[:, :, None, q0:q0 + TILE_Q])
        dv = dv + _mm3(pt, dot, split, perm=True)
        dk = dk + _mm3(dst, qt, split, perm=True)
    return dk * scale, dv


def _inputs(seed, shapes):
    """Seeded normal float32 arrays."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _holds(got, want, what):
    err, ok = cs.compare(got, torch.as_tensor(np.array(want)), TOL)
    assert ok, "%s misses the fp32 rule by max|d| %.3g" % (what, err)


def _worst_ratio(got, want):
    """max |got - want| / the limit of ``chip_smoke.compare``'s fp32 rule
    at 1e-4; the rule holds where this is at most 1 (0 for no entries)."""
    want = torch.as_tensor(want).float()
    ratio = (got.float() - want).abs() / (TOL + TOL * want.abs())
    return float(ratio.max()) if ratio.numel() else 0.0


def test_tf32_rounds_as_cvt_rna():
    """``_tf32`` is ``cvt.rna.tf32.f32``: a tie (1 + 2^-11, half of the
    last kept bit 2^-10) rounds away from zero, in both signs, where ties
    to even would give 1; just under the tie rounds down, just above up;
    the low 13 bits are clear; +-inf and NaN pass through."""
    ulp = 2.0 ** -23
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - ulp,
                      1 + 2 ** -11 + ulp, 1 + 3 * 2 ** -11, 3.0,
                      math.inf, -math.inf], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         1 + 2 ** -9, 3.0, math.inf, -math.inf])
    got = _tf32(x)
    assert torch.equal(got, want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(torch.isnan(_tf32(torch.tensor([math.nan]))).all())


def test_the_kernels_split_keeps_twenty_bits():
    """hi = trunc(x) and lo = trunc(x - hi) as the tensor core reads them:
    hi clears x's low 13 bits (1 + 2^-11 + 2^-23 reads as 1, -1.75 - 2^-12
    as -1.75), lo keeps the next 11 bits, so hi + lo is within 2^-20 |x|
    and never farther from 0 than x; NaN stays NaN."""
    x = torch.tensor([1 + 2 ** -11 + 2 ** -23, -(1.75 + 2 ** -12)])
    hi, lo = _split(x)
    assert torch.equal(hi, torch.tensor([1.0, -1.75]))
    assert torch.equal(lo, torch.tensor([2 ** -11, -2 ** -12]))
    y = torch.from_numpy(_inputs(3, [(4096,)])[0])
    hi, lo = _split(y)
    assert bool(((hi + lo).abs() <= y.abs()).all())
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -20
    assert bool(torch.isnan(sum(_split(torch.tensor([math.nan])))).all())


CASES = [(T, D, causal) for T in (128, 192) for D in (64, 128)
         for causal in (False, True)]


def _pallas_fwd(q, k, v, scale, causal):
    """``_flash_fwd_res`` in interpret mode at 64-row blocks: (O, LSE
    (B, H, T)) as numpy arrays, and the laned LSE the backward takes."""
    o, lse_lanes = jatt._flash_fwd_res(*map(jnp.asarray, (q, k, v)), scale,
                                       causal, block_q=BLOCK, block_k=BLOCK)
    B, H, T = q.shape[:3]
    lse = jatt._lse_from_lanes(lse_lanes, B, H, T)
    return np.array(o), np.array(lse), lse_lanes


def _pallas_bwd(q, k, v, do, scale, causal):
    """:func:`_pallas_fwd`, then ``_flash_bwd`` in interpret mode at 64-row
    blocks: (O, LSE (B, H, T), dQ, dK, dV) as numpy arrays."""
    o, lse, lse_lanes = _pallas_fwd(q, k, v, scale, causal)
    dq, dk, dv = jatt._flash_bwd(*map(jnp.asarray, (q, k, v, o)), lse_lanes,
                                 jnp.asarray(do), scale, causal,
                                 block_q=BLOCK, block_k=BLOCK)
    return (o, lse) + tuple(np.array(a) for a in (dq, dk, dv))


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tf32_forward_matches_pallas_kernel(T, D, causal):
    """K1's 3xTF32 arithmetic against ``_flash_fwd_res``'s O and LSE in
    interpret mode at 64-row blocks, on the same fp32 q, k and v."""
    q, k, v = _inputs(3 * T + D + int(causal), [(1, 2, T, D)] * 3)
    scale = 1.0 / math.sqrt(D)
    o_j, lse_j, _ = _pallas_fwd(q, k, v, scale, causal)
    o_t, lse_t = tf32_flash_fwd(*map(torch.from_numpy, (q, k, v)), scale,
                                causal)
    assert o_t.dtype == lse_t.dtype == torch.float32
    assert o_t.shape == (1, 2, T, D) and lse_t.shape == (1, 2, T)
    _holds(o_t, o_j, "O")
    _holds(lse_t, lse_j, "LSE")


@pytest.mark.parametrize("Tq,Tk,D,causal", [
    (77, 333, 64, False), (200, 200, 128, True), (200, 200, 64, True),
    (64, 128, 64, True)])
def test_tf32_forward_matches_plain_version_at_ragged_shapes(Tq, Tk, D,
                                                             causal):
    """At ``chip_smoke.KERNEL_CASES``' ragged shapes (a partial last tile
    of rows and of keys, top-left causal with Tq < Tk) against the port's
    plain version, which the kernel is held to on the card."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        2 * Tq + Tk + D + int(causal),
        [(1, 2, Tq, D), (1, 2, Tk, D), (1, 2, Tk, D)]))
    scale = 1.0 / math.sqrt(D)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, scale, causal)
    o, lse = tf32_flash_fwd(q, k, v, scale, causal)
    assert o.shape == (1, 2, Tq, D) and lse.shape == (1, 2, Tq)
    _holds(o, o_ref, "O")
    _holds(lse, lse_ref, "LSE")


def test_tf32_forward_without_keys_gives_zero_and_minus_inf():
    """Tk = 0 (K1 loads no key tile): O = 0 and LSE = -inf, as the plain
    version gives."""
    q = torch.ones(1, 2, 5, 64)
    k = v = torch.zeros(1, 2, 0, 64)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, 0.125, False)
    o, lse = tf32_flash_fwd(q, k, v, 0.125, False)
    assert torch.equal(o, o_ref) and torch.equal(o, torch.zeros_like(q))
    assert torch.equal(lse, lse_ref) and bool((lse == -math.inf).all())


def test_a_score_of_minus_inf_gets_p_zero_in_the_forward():
    """One score past the fp32 range, -inf (``chip_smoke.overflow_pair``
    with column 0 cleared elsewhere, as ``chip_smoke.py`` runs it on the
    card): P = 0 there, and the row's max and sum come from its other
    keys, as in the reference and the plain version, both finite."""
    T, r, j0, D = 128, 100, 37, 64
    q, k, v = _inputs(17, [(1, 2, T, D)] * 3)
    q[..., 0] = k[..., 0] = 0.0
    cs.overflow_pair(q, k, r, j0, sign=-1.0)
    o_j, lse_j, _ = _pallas_fwd(q, k, v, 0.125, False)
    q, k, v = map(torch.from_numpy, (q, k, v))
    assert bool((torch.einsum("bhd,bhd->bh", q[:, :, r], k[:, :, j0])
                 == -math.inf).all())
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, 0.125, False)
    o, lse = tf32_flash_fwd(q, k, v, 0.125, False)
    for got, want_j, want_p, what in ((o, o_j, o_ref, "O"),
                                      (lse, lse_j, lse_ref, "LSE")):
        assert bool(torch.isfinite(got).all()), what
        _holds(got, want_j, what + " against the Pallas kernel")
        _holds(got, want_p, what + " against the plain version")


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tf32_dq_matches_pallas_kernel(T, D, causal):
    """K2's 3xTF32 arithmetic against ``_flash_bwd``'s dQ in interpret mode
    at 64-row blocks, on the same fp32 q, k, v, dO and the forward's O and
    LSE."""
    q, k, v, do = _inputs(5 * T + D + int(causal), [(1, 2, T, D)] * 4)
    scale = 1.0 / math.sqrt(D)
    o, lse, dq_j, _, _ = _pallas_bwd(q, k, v, do, scale, causal)
    dq_t = tf32_flash_bwd_dq(*map(torch.from_numpy, (q, k, v, o, lse, do)),
                             scale, causal)
    assert dq_t.dtype == torch.float32 and dq_t.shape == (1, 2, T, D)
    _holds(dq_t, dq_j, "dQ")


@pytest.mark.parametrize("T,D,causal", CASES)
def test_tf32_dkv_matches_pallas_kernel(T, D, causal):
    """K3's 3xTF32 arithmetic against ``_flash_bwd``'s dK and dV in
    interpret mode at 64-row blocks, on the same fp32 q, k, v, dO and the
    forward's O and LSE."""
    q, k, v, do = _inputs(7 * T + D + int(causal), [(1, 2, T, D)] * 4)
    scale = 1.0 / math.sqrt(D)
    o, lse, _, dk_j, dv_j = _pallas_bwd(q, k, v, do, scale, causal)
    dk_t, dv_t = tf32_flash_bwd_dkv(
        *map(torch.from_numpy, (q, k, v, o, lse, do)), scale, causal)
    assert dk_t.dtype == dv_t.dtype == torch.float32
    _holds(dk_t, dk_j, "dK")
    _holds(dv_t, dv_j, "dV")


@pytest.mark.parametrize("Tq,Tk,D,causal", [
    (200, 200, 64, False), (200, 200, 64, True), (200, 200, 128, False),
    (200, 200, 128, True), (64, 128, 64, True), (77, 333, 64, False)])
def test_tf32_arithmetic_matches_plain_versions_at_ragged_shapes(Tq, Tk, D,
                                                                 causal):
    """At ``chip_smoke.BWD_CASES``' ragged shapes (a partial last tile of
    rows and of keys, top-left causal with Tq < Tk) against the port's
    plain versions, which the kernels are held to on the card, on the
    plain forward's O and LSE; a query whose LSE is -inf gets dQ = 0 and
    adds nothing to dK and dV."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        Tq + Tk + D + int(causal),
        [(1, 2, Tq, D), (1, 2, Tk, D), (1, 2, Tk, D), (1, 2, Tq, D)]))
    scale = 1.0 / math.sqrt(D)
    o, lse = tatt.flash_attention_plain(q, k, v, scale, causal)
    args = (q, k, v, o, lse, do, scale, causal)
    _holds(tf32_flash_bwd_dq(*args), tatt.flash_bwd_dq_plain(*args), "dQ")
    for got, want, what in zip(tf32_flash_bwd_dkv(*args),
                               tatt.flash_bwd_dkv_plain(*args), ("dK", "dV")):
        _holds(got, want, what)
    lse[:, :, -1] = -math.inf
    args = (q, k, v, o, lse, do, scale, causal)
    dq = tf32_flash_bwd_dq(*args)
    assert torch.equal(dq[:, :, -1], torch.zeros(1, 2, D))
    for got, want, what in zip(tf32_flash_bwd_dkv(*args),
                               tatt.flash_bwd_dkv_plain(*args), ("dK", "dV")):
        _holds(got, want, what + " (a row without LSE)")
        assert torch.isfinite(got).all()


def test_tf32_dq_without_keys_is_zero():
    """Tk = 0 (K2 loads no key tile): dQ = 0, as the plain version
    gives."""
    q = o = do = torch.ones(1, 2, 5, 64)
    k = v = torch.zeros(1, 2, 0, 64)
    lse = torch.full((1, 2, 5), -math.inf)
    args = (q, k, v, o, lse, do, 0.125, False)
    assert torch.equal(tf32_flash_bwd_dq(*args),
                       tatt.flash_bwd_dq_plain(*args))
    assert torch.equal(tf32_flash_bwd_dq(*args), torch.zeros(1, 2, 5, 64))


@pytest.mark.parametrize("D,causal", [(64, True), (128, False)])
def test_a_score_past_the_fp32_range_gets_p_zero(D, causal):
    """As in the reference, P = 0 where a score is not finite, also where
    its row's LSE is finite.  Query r and key j0 see only each other
    (``chip_smoke.isolate_pair``), the forward gives O and a finite LSE,
    and then their score alone is pushed to +inf
    (``chip_smoke.overflow_pair``).  The emulated K2 and K3 meet
    ``_flash_bwd`` in interpret mode and the plain versions at 1e-4 and
    stay finite; exp(+inf) there would make dQ row r, dK row j0 and dV row
    j0 inf or NaN."""
    T, r, j0 = 128, 100, 37
    q, k, v, do = _inputs(11 * D + int(causal), [(1, 2, T, D)] * 4)
    cs.isolate_pair(q, k, r, j0)
    scale = 1.0 / math.sqrt(D)
    o, lse_lanes = jatt._flash_fwd_res(*map(jnp.asarray, (q, k, v)), scale,
                                       causal, block_q=BLOCK, block_k=BLOCK)
    lse = np.array(jatt._lse_from_lanes(lse_lanes, 1, 2, T))
    cs.overflow_pair(q, k, r, j0)
    want_j = jatt._flash_bwd(*map(jnp.asarray, (q, k, v)), o, lse_lanes,
                             jnp.asarray(do), scale, causal, block_q=BLOCK,
                             block_k=BLOCK)
    args = tuple(map(torch.from_numpy, (q, k, v, np.array(o), lse, do))) + (
        scale, causal)
    s = torch.einsum("bhd,bhd->bh", args[0][:, :, r], args[1][:, :, j0])
    assert bool(torch.isinf(s).all()) and bool(torch.isfinite(args[4]).all())
    want_p = (tatt.flash_bwd_dq_plain(*args),) + tatt.flash_bwd_dkv_plain(
        *args)
    got = (tf32_flash_bwd_dq(*args),) + tf32_flash_bwd_dkv(*args)
    for what, g, wj, wp in zip(("dQ", "dK", "dV"), got, want_j, want_p):
        assert bool(torch.isfinite(g).all()), what
        _holds(g, wj, what + " against the Pallas kernel")
        _holds(g, wp, what + " against the plain version")


# -- the fragments, lane by lane ---------------------------------------------

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def _padded_tile(m, D):
    """``m`` (rows x D) in the kernels' fp32 tile layout, flat at a row
    stride of D + 4 (``tf32::Padded``), the padding NaN so that a read of
    it shows in every product it enters."""
    tile = np.full((m.shape[0], D + 4), np.nan)
    tile[:, :D] = m
    return tile.reshape(-1)


def _ldsm_x4(tile, stride, rows, cols):
    """``ldmatrix.x4`` (b16) on an fp32 tile: lane i gives (rows[i],
    cols[i]), the start of row i % 8 of matrix i // 8, whose 16 bytes are
    four fp32 words; register j of lane 4g + t receives word t of row g of
    matrix j."""
    regs = np.empty((32, 4))
    for j in range(4):
        src = 8 * j + _G
        regs[:, j] = tile[rows[src] * stride + cols[src] + _T]
    return regs


def _ldsm_a(tile, D, m0, k0):
    """``tf32::ldsm_a``'s addresses."""
    return _ldsm_x4(tile, D + 4, m0 + (_LANE & 15), k0 + ((_LANE >> 4) << 2))


def _ldsm_b_nk(tile, D, n0, k0):
    """``tf32::ldsm_b_nk``'s addresses."""
    return _ldsm_x4(tile, D + 4, n0 + (_LANE & 7) + ((_LANE >> 4) << 3),
                    k0 + (((_LANE >> 3) & 1) << 2))


def _mma(d, a, b0, b1):
    """d += A B by the PTX ISA's m16n8k8 (.tf32) fragment layouts, lane
    4g + t: a[0] = A(g, t), a[1] = A(g + 8, t), a[2] = A(g, t + 4), a[3] =
    A(g + 8, t + 4); b0 = B(t, g), b1 = B(t + 4, g); d[0], d[1] = D(g, 2t),
    D(g, 2t + 1) and d[2], d[3] the same at row g + 8."""
    A, B = np.empty((16, 8)), np.empty((8, 8))
    A[_G, _T], A[_G + 8, _T] = a[:, 0], a[:, 1]
    A[_G, _T + 4], A[_G + 8, _T + 4] = a[:, 2], a[:, 3]
    B[_T, _G], B[_T + 4, _G] = b0, b1
    d += _to_acc(A @ B)[0]


def _to_acc(m):
    """A 16 x 8N matrix as the accumulators of N m16n8 tiles: (N, 32, 4)."""
    n = m.shape[1] // 8
    acc = np.empty((n, 32, 4))
    for j in range(n):
        for e in range(4):
            acc[j, :, e] = m[_G + 8 * (e >> 1), 8 * j + 2 * _T + (e & 1)]
    return acc


def _from_acc(acc):
    """The inverse of :func:`_to_acc`."""
    m = np.empty((16, 8 * acc.shape[0]))
    for j in range(acc.shape[0]):
        for e in range(4):
            m[_G + 8 * (e >> 1), 8 * j + 2 * _T + (e & 1)] = acc[j, :, e]
    return m


def _frag_abt(a_tile, m0, b_tile, n, D):
    """``tf32::mma3_abt`` lane by lane, one product a step: the
    accumulators of rows m0 .. m0 + 15 of A times rows 0 .. 8n - 1 of B,
    transposed."""
    acc = np.zeros((n, 32, 4))
    for kk in range(D // 8):
        a = _ldsm_a(a_tile, D, m0, 8 * kk)
        for np_ in range(n // 2):
            b = _ldsm_b_nk(b_tile, D, 16 * np_, 8 * kk)
            _mma(acc[2 * np_], a, b[:, 0], b[:, 1])
            _mma(acc[2 * np_ + 1], a, b[:, 2], b[:, 3])
    return acc


def _frag_cb(c, b_tile, D, slots=(0, 2, 1, 3), b_rows=(2, 0, 1)):
    """``tf32::mma3_cb`` lane by lane, one product a step: C (the
    accumulators ``c`` of K m16n8 tiles) times rows 0 .. 8K - 1 of B.  The
    A fragment takes accumulator registers ``slots`` (the kernel's: c[0],
    c[2], c[1], c[3], so k-slot t <- column 2t and t + 4 <- 2t + 1), and
    the B fragment rows m t and m t + o, (m, 0, o) = ``b_rows`` (the
    kernel's: 2t and 2t + 1), columns g + 8n, by scalar reads."""
    m, _, o = b_rows
    acc = np.zeros((D // 8, 32, 4))
    for kk in range(c.shape[0]):
        a = c[kk][:, list(slots)]
        row = (8 * kk + m * _T) * (D + 4) + _G
        for n in range(D // 8):
            _mma(acc[n], a, b_tile[row + 8 * n],
                 b_tile[row + o * (D + 4) + 8 * n])
    return acc


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n", [2, 4])
def test_fragments_of_the_shared_tile_products(D, n):
    """S = A B^T as ``mma3_abt`` gathers it (the A rows of warp 2, n n8
    tiles of B: 4 in K1's and K2's 32-key tiles, 2 in K3's 16-query tiles)
    is the matrix product exactly, on integer values, and never reads the
    tiles' padding."""
    rng = np.random.RandomState(D + n)
    a = rng.randint(-8, 9, size=(64, D)).astype(np.float64)
    b = rng.randint(-8, 9, size=(8 * n, D)).astype(np.float64)
    got = _from_acc(_frag_abt(_padded_tile(a, D), 32, _padded_tile(b, D), n,
                              D))
    assert np.array_equal(got, a[32:48] @ b.T)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("K", [2, 4])
def test_fragments_of_the_accumulator_fed_products(D, K):
    """C B as ``mma3_cb`` gathers it, C in accumulators (P or dS: K = 4 n8
    tiles in K1 and K2, 2 in K3) and B a k-major tile, is the matrix product
    exactly and never reads the padding.  A's k-slots and B's rows must
    agree: the accumulator registers in their own order, or B's rows t and
    t + 4 as an unpermuted fragment has them, give another matrix, which
    the tile emulation could not tell from the right one."""
    rng = np.random.RandomState(10 * D + K)
    c = rng.randint(-8, 9, size=(16, 8 * K)).astype(np.float64)
    b = rng.randint(-8, 9, size=(8 * K, D)).astype(np.float64)
    tile = _padded_tile(b, D)
    assert np.array_equal(_from_acc(_frag_cb(_to_acc(c), tile, D)), c @ b)
    for wrong in (dict(slots=(0, 1, 2, 3)), dict(b_rows=(1, 0, 4))):
        got = _from_acc(_frag_cb(_to_acc(c), tile, D, **wrong))
        assert not np.array_equal(got, c @ b), wrong


def _pinned_case():
    """randn q, k, v, dO at B = 1, H = 4, T = 512, D = 64 (as
    ``chip_smoke.py`` draws them), with the plain forward's O and LSE."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        20261017, [(1, 4, 512, 64)] * 4))
    o, lse = tatt.flash_attention_plain(q, k, v, 0.125, False)
    return q, k, v, o, lse, do, 0.125, False


def test_one_tf32_product_misses_the_rule_the_split_meets():
    """Why every fp32 product is three TF32 products: on randn inputs at T
    = 512, one TF32 product (each operand rounded to 10 mantissa bits)
    puts dQ, dK and dV past the 1e-4 rule; the hi + lo split meets it with
    room to spare."""
    args = _pinned_case()
    want = (tatt.flash_bwd_dq_plain(*args),) + tatt.flash_bwd_dkv_plain(
        *args)
    once = (tf32_flash_bwd_dq(*args, split=False),) + tf32_flash_bwd_dkv(
        *args, split=False)
    split = (tf32_flash_bwd_dq(*args),) + tf32_flash_bwd_dkv(*args)
    for what, o1, s3, ref in zip(("dQ", "dK", "dV"), once, split, want):
        assert not cs.compare(o1, ref, TOL)[1], what
        assert cs.compare(s3, ref, TOL)[1], what
        assert _worst_ratio(s3, ref) < 0.1, what


def test_one_tf32_product_misses_the_forward_rule_the_split_meets():
    """Why K1's two products are three TF32 products each: on the pinned
    case's randn q, k and v at T = 512, one TF32 product (each operand
    rounded to 10 mantissa bits) puts O past the 1e-4 rule; the hi + lo
    split meets it with room to spare, O and LSE alike."""
    q, k, v, _, _, _, scale, causal = _pinned_case()
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, scale, causal)
    o1, _ = tf32_flash_fwd(q, k, v, scale, causal, split=False)
    o3, lse3 = tf32_flash_fwd(q, k, v, scale, causal)
    assert not cs.compare(o1, o_ref, TOL)[1]
    for got, want in ((o3, o_ref), (lse3, lse_ref)):
        assert cs.compare(got, want, TOL)[1]
        assert _worst_ratio(got, want) < 0.1


def _fwd_margins(q, k, v, scale, causal):
    """(worst |d| / limit of O and LSE as 3xTF32, the same as one TF32
    product) of K1's emulation against the plain version."""
    want = tatt.flash_attention_plain(q, k, v, scale, causal)
    split = tf32_flash_fwd(q, k, v, scale, causal)
    once = tf32_flash_fwd(q, k, v, scale, causal, split=False)
    return ([_worst_ratio(a, b) for a, b in zip(split, want)],
            [_worst_ratio(a, b) for a, b in zip(once, want)])


def fwd_rounding_margins(seed):
    """For the pinned case and each fp32 case of ``chip_smoke.KERNEL_CASES``
    with keys (inputs drawn with ``torch.randn`` from ``seed``; batch cut
    to 2): the name and the margins of :func:`_fwd_margins`."""
    q, k, v, _, _, _, scale, causal = _pinned_case()
    out = [("pinned B=1 H=4 T=512 D=64", _fwd_margins(q, k, v, scale,
                                                     causal))]
    g = torch.Generator().manual_seed(seed)
    for name, B, H, Tq, Tk, D, dtype, causal, _ in cs.KERNEL_CASES:
        if dtype != torch.float32 or Tk == 0:
            continue
        B = min(B, 2)
        q, k, v = (torch.randn((B, H, T, D), generator=g)
                   for T in (Tq, Tk, Tk))
        out.append(("%s B=%d causal=%s" % (name, B, causal),
                    _fwd_margins(q, k, v, 1.0 / D ** 0.5, causal)))
    return out


def _margins(args):
    """(worst |d| / limit as 3xTF32, as one TF32 product) for dQ, dK and
    dV against the plain versions."""
    want = (tatt.flash_bwd_dq_plain(*args),) + tatt.flash_bwd_dkv_plain(
        *args)
    split = (tf32_flash_bwd_dq(*args),) + tf32_flash_bwd_dkv(*args)
    once = (tf32_flash_bwd_dq(*args, split=False),) + tf32_flash_bwd_dkv(
        *args, split=False)
    return ([_worst_ratio(a, b) for a, b in zip(split, want)],
            [_worst_ratio(a, b) for a, b in zip(once, want)])


def rounding_margins(seed):
    """For the pinned case and each fp32 case of ``chip_smoke.BWD_CASES``
    (inputs drawn with ``torch.randn`` from ``seed``; the training shape
    cut to batch 2): the name and the margins of :func:`_margins`."""
    out = [("pinned B=1 H=4 T=512 D=64", _margins(_pinned_case()))]
    g = torch.Generator().manual_seed(seed)
    for name, B, H, Tq, Tk, D, dtype, causal, _ in cs.BWD_CASES:
        if dtype != torch.float32:
            continue
        B = min(B, 2)
        q, k, v = (torch.randn((B, H, T, D), generator=g)
                   for T in (Tq, Tk, Tk))
        do = torch.randn((B, H, Tq, D), generator=g)
        scale = 1.0 / D ** 0.5
        o, lse = tatt.flash_attention_plain(q, k, v, scale, causal)
        out.append(("%s B=%d causal=%s" % (name, B, causal),
                    _margins((q, k, v, o, lse, do, scale, causal))))
    return out


if __name__ == "__main__":
    for name, (split, once) in fwd_rounding_margins(0):
        print("K1 %-27s worst |d|/limit O, LSE: 3xTF32 %s, one TF32 product "
              "%s" % (name, ", ".join("%.4f" % r for r in split),
                      ", ".join("%.3f" % r for r in once)))
    for name, (split, once) in rounding_margins(0):
        print("%-28s worst |d|/limit dQ, dK, dV: 3xTF32 %s, one TF32 "
              "product %s" % (name, ", ".join("%.4f" % r for r in split),
                              ", ".join("%.3f" % r for r in once)))
