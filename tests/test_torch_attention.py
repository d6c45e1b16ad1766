"""The port's attention against the JAX reference, on the CPU.

``mxnet_tpu_torch.ops.attention`` computes the flash kernel's plain version
for CPU tensors; here it is held against ``mxnet_tpu.ops.attention``'s
``_flash_fwd``, which runs the Pallas kernel in interpret mode on the CPU,
and ``attention_core`` against ``attention_core``.  Inputs are made with
numpy from a seed and fed to both.  Tolerance: the repo's fp32 bound,
rtol = atol = 1e-4 (tests/test_torch_parity.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import nn as tnn

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4


def _qkv(seed, B, H, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 128, 128),
                                          (True, 128, 128),
                                          (True, 64, 128)])
def test_flash_with_lse_matches_pallas_kernel(D, causal, tq, tk):
    """O and LSE against K1 in interpret mode at 64-row blocks; causal
    Tq=64, Tk=128 pins the kernel's top-left convention."""
    q, k, v = _qkv(D + tq + int(causal), 2, 2, tq, tk, D)
    scale = 1.0 / np.sqrt(D)
    o_j, lse_j = jatt._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal,
                                 block_q=64, block_k=64)
    o_t, lse_t = tatt.flash_attention_with_lse(*_t(q, k, v), scale, causal)
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == (2, 2, tq)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=TOL,
                               atol=TOL)
    o_only = tatt.flash_attention(*_t(q, k, v), scale, causal)
    np.testing.assert_array_equal(o_only.numpy(), o_t.numpy())


def test_flash_row_without_keys_is_zero_with_minus_inf_lse():
    """A row that sees no key gives O = 0 and LSE = -inf, as K1 does,
    never NaN."""
    q, k, v = _qkv(3, 1, 1, 4, 8, 64)
    q0, k0, v0 = _t(q, k[:, :, :0], v[:, :, :0])
    o0, lse0 = tatt.flash_attention_plain(q0, k0, v0, 1.0, False)
    assert tuple(o0.shape) == (1, 1, 4, 64)
    assert (o0 == 0).all() and torch.isinf(lse0).all() and (lse0 < 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_core_matches_reference(masked, causal):
    """Unmasked D=64 takes the flash path in the port and the composition
    in the JAX package (its TPU gate needs D % 128 == 0); a
    valid_length-style key mask takes the composition in both."""
    B, H, T, D = 2, 2, 64, 64
    q, k, v = _qkv(11, B, H, T, T, D)
    mask = None
    if masked:
        vl = np.array([64, 37], np.float32)
        mask = (np.arange(T)[None, None, None, :]
                < vl[:, None, None, None]).astype(np.float32)
    out_j = jatt.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                mask=None if mask is None
                                else jnp.asarray(mask))
    qt, kt, vt = _t(q, k, v)
    out_t = tatt.attention_core(qt, kt, vt, causal=causal,
                                mask=None if mask is None
                                else torch.from_numpy(mask))
    assert tatt.flash_eligible(qt, kt, vt, causal,
                               None if mask is None else mask) == (not masked)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)


def test_composition_bottom_right_causal_matches_reference():
    """Causal Tq != Tk stays on the composition, whose causal mask is
    bottom-right (tril(ones, Tk - Tq)) in both packages."""
    q, k, v = _qkv(5, 1, 2, 32, 96, 64)
    out_j = jatt.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
    qt, kt, vt = _t(q, k, v)
    assert not tatt.flash_eligible(qt, kt, vt, causal=True)
    out_t = tatt.attention_core(qt, kt, vt, causal=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)


def test_multi_head_attention_matches_reference_op():
    """The (B, T, H*D) <-> (B, H, T, D) layout of ops/nn.py:395."""
    from mxnet_tpu.ops.nn import _mha
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 32, 128).astype(np.float32) for _ in range(3))
    out_j = _mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 num_heads=2)
    out_t = tnn.multi_head_attention(*_t(q, k, v), num_heads=2)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL,
                               atol=TOL)


def test_gate_follows_the_kernel_constraints():
    def mk(D=64, Tq=64, Tk=64, dtype=torch.float32):
        return (torch.zeros(1, 2, Tq, D, dtype=dtype),
                torch.zeros(1, 2, Tk, D, dtype=dtype),
                torch.zeros(1, 2, Tk, D, dtype=dtype))

    assert tatt.flash_eligible(*mk())
    assert tatt.flash_eligible(*mk(D=128, Tq=200, Tk=200), causal=True)
    assert tatt.flash_eligible(*mk(Tq=77, Tk=333))          # any T
    assert tatt.flash_eligible(*mk(dtype=torch.bfloat16))
    assert not tatt.flash_eligible(*mk(D=32))
    assert not tatt.flash_eligible(*mk(D=256))
    assert not tatt.flash_eligible(*mk(dtype=torch.float16))
    assert not tatt.flash_eligible(*mk(Tq=32), causal=True)
    assert not tatt.flash_eligible(*mk(), mask=torch.ones(1, 1, 1, 64))
    with tatt.attention_impl_scope("xla"):
        assert not tatt.flash_eligible(*mk())
        with tatt.attention_impl_scope("pallas"):
            assert tatt.flash_eligible(*mk())
    q, k, v = mk()
    q.requires_grad_(True)
    assert tatt.flash_eligible(q, k, v)     # a gradient is not a gate term
    # and a gated CPU input that needs one goes through the flash Function
    out = tatt.attention_core(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()


def test_impl_setters_validate_and_restore():
    prev = tatt.set_attention_impl("xla")
    try:
        assert tatt.current_attention_impl() == "xla"
        with tatt.attention_impl_scope("pallas"):
            assert tatt.current_attention_impl() == "pallas"
        assert tatt.current_attention_impl() == "xla"
    finally:
        tatt.set_attention_impl(prev)
    with pytest.raises(ValueError):
        tatt.set_attention_impl("cudnn")
    with pytest.raises(ValueError):
        tatt.attention_impl_scope("sdpa")


def test_attention_core_routes_through_flash_when_gated(monkeypatch):
    calls = []
    real = tatt.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    q, k, v = _t(*_qkv(1, 1, 2, 16, 16, 64))
    tatt.attention_core(q, k, v)
    assert calls == [(1, 2, 16, 64)]
    tatt.attention_core(q, k, v, mask=torch.ones(1, 1, 1, 16))
    with tatt.attention_impl_scope("xla"):
        tatt.attention_core(q, k, v)
    assert len(calls) == 1


def test_cpu_tensors_never_launch_the_kernel():
    before = _kernels.launch_counts()
    assert set(before) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    q, k, v = _t(*_qkv(2, 1, 2, 64, 64, 64))
    q.requires_grad_(True)
    tatt.flash_attention_with_lse(q, k, v, 0.125, False)
    tatt.attention_core(q, k, v).sum().backward()
    assert _kernels.launch_counts() == before


def test_flash_is_forward_only(monkeypatch):
    """Holds that flash attention is no longer forward-only: a gradient
    flows through the Function on the CPU (the plain versions of K1-K3) and,
    on a non-CPU device (a meta tensor stands in for the card), through the
    CUDA wrappers of K1 and of K2/K3, never the composition."""
    q, k, v = _t(*_qkv(4, 1, 1, 8, 8, 64))
    q.requires_grad_(True)
    out, lse = tatt.flash_attention_with_lse(q, k, v, 0.125, False)
    (out.sum() + lse.sum()).backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    q.grad = None
    tatt.attention_core(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()

    launched = []

    def fake_fwd(q, k, v, scale, causal):
        launched.append("fwd")
        return (torch.empty_like(q),
                torch.empty(q.shape[:3], dtype=torch.float32,
                            device=q.device))

    def fake_bwd(q, k, v, o, lse, g, scale, causal):
        launched.append("bwd")
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    monkeypatch.setattr(tatt, "_flash_fwd_cuda", fake_fwd)
    monkeypatch.setattr(tatt, "_flash_bwd_cuda", fake_bwd)
    qm, km, vm = (t.detach().to("meta").requires_grad_(True)
                  for t in (q, k, v))
    dq, dk, dv = torch.autograd.grad(tatt.attention_core(qm, km, vm).sum(),
                                     (qm, km, vm))
    assert launched == ["fwd", "bwd"]
    assert dq.shape == qm.shape and dk.shape == km.shape
    with tatt.attention_impl_scope("xla"):
        assert tatt.attention_core(qm, km, vm).shape == qm.shape
    assert launched == ["fwd", "bwd"]


@pytest.mark.parametrize("bad,match", [
    (dict(D=96), "head dim"),
    (dict(dtype=torch.float16), "float32 or"),
    (dict(transpose=True), "contiguous"),
    (dict(k_heads=3), "do not"),
    (dict(dtype=torch.bfloat16, offset=4), "16-byte"),
    (dict(offset=1), "16-byte"),
])
def test_kernel_input_checks_refuse_what_the_kernel_does_not_take(bad, match):
    D = bad.get("D", 64)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 2, 16, D, dtype=dtype)
    k = torch.zeros(1, bad.get("k_heads", 2), 16, D, dtype=dtype)
    v = torch.zeros_like(k)
    if bad.get("transpose"):
        q = torch.zeros(1, 16, 2, D).transpose(1, 2)
    if bad.get("offset"):
        # a contiguous view 8 (bf16) or 4 (fp32) bytes past the storage's
        # start
        base = torch.zeros(q.numel() + bad["offset"], dtype=dtype)
        q = base[bad["offset"]:].view(q.shape)
    with pytest.raises(MXNetError, match=match):
        tatt._check_kernel_inputs(q, k, v)


def test_kernel_library_is_not_built_at_import():
    """Importing the port builds nothing: each library is built at first
    launch on a card."""
    for lib in (_kernels.FLASH_FWD, _kernels.FLASH_BWD):
        assert lib._lib is None
        assert lib.source.is_file()
        assert lib.library_path().name.startswith("lib%s-" % lib.name)
