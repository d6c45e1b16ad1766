"""The port's flash-attention backward against the JAX reference, on the CPU.

``flash_bwd_dq_plain`` / ``flash_bwd_dkv_plain`` (the plain versions of K2
and K3, what CPU tensors compute) are held against the JAX package's
``_flash_bwd``, whose Pallas kernels run in interpret mode on the CPU, on
the same O and LSE; the autograd Functions ``flash_attention`` and
``flash_attention_with_lse`` against ``jax.vjp`` / ``jax.grad`` of the
reference's ``custom_vjp`` rules.  Inputs are made with numpy from a seed.
Tolerance: rtol = atol = 1e-4 in float32 (the repo's fp32 bound); bf16 as
stated at its test.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.ops import attention as tatt

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4


def _arrays(seed, B, H, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tq, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 128, 128),
                                          (True, 128, 128),
                                          (True, 64, 128)])
def test_bwd_plain_versions_match_pallas_kernels(D, causal, tq, tk):
    """dQ, dK, dV against K2 and K3 in interpret mode at 64-row blocks, on
    the O and LSE of K1; causal Tq=64, Tk=128 pins the top-left mask (the
    second key block sees no query and gets dK = dV = 0)."""
    q, k, v, g = _arrays(D + tq + int(causal), 2, 2, tq, tk, D)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse_lanes = jatt._flash_fwd_res(jq, jk, jv, scale, causal,
                                       block_q=64, block_k=64)
    dq_j, dk_j, dv_j = jatt._flash_bwd(jq, jk, jv, o, lse_lanes, jg, scale,
                                       causal, block_q=64, block_k=64)
    lse = jatt._lse_from_lanes(lse_lanes, 2, 2, tq)
    args = _t(q, k, v, o, lse, g) + [scale, causal]
    dq_t = tatt.flash_bwd_dq_plain(*args)
    dk_t, dv_t = tatt.flash_bwd_dkv_plain(*args)
    assert dq_t.dtype == dk_t.dtype == dv_t.dtype == torch.float32
    _close(dq_t, dq_j)
    _close(dk_t, dk_j)
    _close(dv_t, dv_j)
    if causal and tk > tq:
        assert not dk_t[:, :, tq:].any() and not dv_t[:, :, tq:].any()


@pytest.mark.parametrize("causal", [False, True])
def test_function_matches_reference_vjp(causal):
    """The port's ``flash_attention`` Function against ``jax.vjp`` of the
    reference's ``flash_attention`` (its Pallas kernels in interpret mode;
    T = 256, its block size)."""
    q, k, v, g = _arrays(21 + int(causal), 1, 2, 256, 256, 64)
    scale = 0.125
    out_j, vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, scale, causal),
        *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt, gt = _t(q, k, v, g)
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    out_t = tatt.flash_attention(qt, kt, vt, scale, causal)
    _close(out_t, out_j)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), gt)
    for got, want in zip(grads_t, grads_j):
        _close(got, want)


@pytest.mark.parametrize("used", ["out", "lse", "both"])
def test_lse_rule_matches_reference(used, monkeypatch):
    """``flash_attention_with_lse`` under each cotangent against
    ``jax.grad`` of the reference.  An unused output is a symbolic zero in
    JAX and a None cotangent here, and its K2 + K3 pass is skipped."""
    q, k, v, g = _arrays(31, 1, 2, 256, 256, 64)
    gl = np.random.RandomState(32).randn(1, 2, 256).astype(np.float32)
    scale, causal = 0.125, True

    def objective(out, lse, ga, gla):
        total = 0.0
        if used in ("out", "both"):
            total = total + (out * ga).sum()
        if used in ("lse", "both"):
            total = total + (lse * gla).sum()
        return total

    grads_j = jax.grad(
        lambda q, k, v: objective(
            *jatt.flash_attention_with_lse(q, k, v, scale, causal),
            jnp.asarray(g), jnp.asarray(gl)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    passes = []
    real = tatt._flash_bwd
    monkeypatch.setattr(tatt, "_flash_bwd",
                        lambda *a: passes.append(1) or real(*a))
    qt, kt, vt = _t(q, k, v)
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    out, lse = tatt.flash_attention_with_lse(qt, kt, vt, scale, causal)
    grads_t = torch.autograd.grad(
        objective(out, lse, *_t(g, gl)), (qt, kt, vt))
    for got, want in zip(grads_t, grads_j):
        _close(got, want)
    assert len(passes) == {"out": 1, "lse": 1, "both": 2}[used]


def test_lse_rule_with_rows_that_see_no_key():
    """A row with LSE = -inf adds nothing, whatever its LSE cotangent: the
    kernels' isfinite guards, and the rule's where(isfinite(lse), g, 0)."""
    q, k, v, _ = _arrays(41, 1, 1, 8, 0, 64)
    qt, kt, vt = _t(q, k, v)
    qt.requires_grad_(True)
    out, lse = tatt.flash_attention_with_lse(qt, kt, vt, 0.125, False)
    assert torch.isinf(lse).all() and not out.any()
    (dq,) = torch.autograd.grad((out.sum() + lse.clamp(min=-1.0).sum()),
                                (qt,))
    assert torch.isfinite(dq).all() and not dq.any()


def test_bf16_grads_near_fp32_reference():
    """bf16 q, k, v through the Function: gradients come back bf16, within
    2e-3 + (2e-3 + 2^-8)|ref| of the reference's fp32 gradients on the same
    bf16-rounded inputs (2^-8 is bf16's unit roundoff: each output is
    rounded once to bf16)."""
    q, k, v, g = _arrays(51, 1, 2, 128, 128, 64)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    qb, kb, vb, gb = map(to_bf16, (q, k, v, g))
    scale = 0.125
    grads_j = jax.vjp(
        lambda q, k, v: jatt._attention_jnp(q, k, v, scale, False),
        *(jnp.asarray(x.float().numpy()) for x in (qb, kb, vb)))[1](
            jnp.asarray(gb.float().numpy()))
    for x in (qb, kb, vb):
        x.requires_grad_(True)
    out = tatt.flash_attention(qb, kb, vb, scale, False)
    assert out.dtype == torch.bfloat16
    grads_t = torch.autograd.grad(out, (qb, kb, vb), gb)
    for got, want in zip(grads_t, grads_j):
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want)
        bound = 2e-3 + (2e-3 + 2.0 ** -8) * np.abs(want)
        assert (np.abs(got - want) <= bound).all(), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("causal,tq,tk", [(False, 5, 7), (True, 6, 6),
                                          (True, 4, 7)])
def test_functions_pass_float64_gradcheck(causal, tq, tk):
    """Both Functions through the plain versions, in float64, against
    finite differences."""
    gen = torch.Generator().manual_seed(tq * 10 + tk)
    q, k, v = (torch.randn(1, 2, t, 4, dtype=torch.float64, generator=gen,
                           requires_grad=True) for t in (tq, tk, tk))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt.flash_attention(q, k, v, 0.5, causal),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt.flash_attention_with_lse(q, k, v, 0.5, causal),
        (q, k, v))


@pytest.mark.parametrize("bad,match", [
    ("lse_dtype", "LSE"),
    ("lse_shape", "LSE"),
    ("o_shape", "O must"),
    ("g_dtype", "gradient of O"),
    ("g_strided", "gradient of O"),
    ("o_misaligned", "16-byte"),
    ("g_misaligned", "16-byte"),
    ("g_misaligned_fp32", "16-byte"),
])
def test_bwd_input_checks_refuse_what_the_kernels_do_not_take(bad, match):
    from mxnet_tpu_torch.base import MXNetError
    q, k, v, g = _t(*_arrays(61, 1, 2, 16, 16, 64))
    o = torch.zeros_like(q)
    lse = torch.zeros(1, 2, 16)
    if bad == "lse_dtype":
        lse = lse.double()
    elif bad == "lse_shape":
        lse = torch.zeros(1, 2, 8)
    elif bad == "o_shape":
        o = torch.zeros(1, 2, 8, 64)
    elif bad == "g_dtype":
        g = g.to(torch.bfloat16)
    elif bad == "g_strided":
        g = torch.zeros(1, 16, 2, 64).transpose(1, 2)
    elif bad == "g_misaligned_fp32":
        # fp32 throughout, the gradient of O a contiguous view 4 bytes past
        # its storage's start
        g = torch.zeros(g.numel() + 1)[1:].view(g.shape)
    else:
        # bf16 throughout, O or its gradient a contiguous view 8 bytes
        # past its storage's start
        q, k, v, o, g = (t.to(torch.bfloat16) for t in (q, k, v, o, g))
        view = torch.zeros(o.numel() + 4, dtype=torch.bfloat16)[4:].view(
            o.shape)
        if bad == "o_misaligned":
            o = view
        else:
            g = view
    with pytest.raises(MXNetError, match=match):
        tatt._check_bwd_inputs(q, k, v, o, lse, g)


def test_launch_counters_are_per_kernel():
    from mxnet_tpu_torch.ops import _kernels
    saved = _kernels.launch_counts()
    try:
        _kernels.reset_launches()
        _kernels.FLASH_BWD.count_launch("flash_bwd_dkv")
        _kernels.FLASH_BWD.count_launch("flash_bwd_dkv")
        _kernels.FLASH_FWD.count_launch("flash_fwd")
        assert _kernels.launch_counts() == {
            "flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 2}
        _kernels.reset_launches()
        assert set(_kernels.launch_counts().values()) == {0}
    finally:
        for lib in _kernels.LIBRARIES:
            for name in lib.launches:
                lib.launches[name] = saved[name]
