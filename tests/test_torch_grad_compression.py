"""The port's gradient compression against the JAX reference, on the CPU.

The same seeded numpy payloads go through ``mxnet_tpu.ops.quantization``
(jitted, residual not donated) and ``mxnet_tpu_torch.ops.quantization``:
the 2-bit levels and residuals, the packed words, the int8 codes, scales
and residuals, and the dequant-sum-requant merge of two workers are
bitwise equal; dequantized values agree within 1e-6 x |ref|.  The
``QGRAD`` wire tuples of both packages hold the same bytes and decode
alike, and a ``GradientCompression`` of each package carries the same
residuals over three pushes.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.kvstore import gradient_compression as jgc
from mxnet_tpu.kvstore import wire_codec as jwc
from mxnet_tpu.ops import quantization as jq

from mxnet_tpu_torch.kvstore import gradient_compression as tgc
from mxnet_tpu_torch.kvstore import wire_codec as twc
from mxnet_tpu_torch.ops import quantization as tq

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

SEEDS = (0, 1, 2)
SIZES = (77, 1000, 4096, 65536)
DEQ_RTOL = 1e-6


def _payload(seed, n, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * scale * (seed + 1)).astype(np.float32)
    r = (rng.randn(n) * 0.01).astype(np.float32)
    return x, r


def _same(j, t):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_int8_codes_scales_and_residuals_are_bitwise(seed, n):
    x, r = _payload(seed, n)
    jq8, js, jr = jq.quantize_int8_blocks(jnp.asarray(x), jnp.asarray(r),
                                          256, donate=False)
    tq8, ts, tr = tq.quantize_int8_blocks(torch.from_numpy(x),
                                          torch.from_numpy(r), 256)
    _same(jq8, tq8)
    _same(js, ts)
    _same(jr, tr)
    jd = np.asarray(jq.dequantize_int8_blocks(jq8, js, n))
    td = tq.dequantize_int8_blocks(tq8, ts, n).numpy()
    np.testing.assert_allclose(td, jd, rtol=DEQ_RTOL, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("block", (64, 256))
def test_int8_roundtrip_matches(seed, block):
    x, r = _payload(seed, 3000)
    jd, jr = jq.roundtrip_int8_blocks(jnp.asarray(x), jnp.asarray(r), block,
                                      donate=False)
    td, tr = tq.roundtrip_int8_blocks(torch.from_numpy(x),
                                      torch.from_numpy(r), block)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DEQ_RTOL,
                               atol=0)
    _same(jr, tr)


@pytest.mark.parametrize("seed", SEEDS)
def test_dequant_sum_requant_of_two_workers_is_bitwise(seed):
    xs = [_payload(seed, 5000)[0], _payload(seed + 10, 5000, 0.2)[0]]
    qs, ss = [], []
    for x in xs:
        q, s, _ = jq.quantize_int8_blocks(jnp.asarray(x),
                                          jnp.zeros(5000, jnp.float32), 256,
                                          donate=False)
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    jo, jso = jq.dequant_sum_requant_int8(jnp.asarray(np.stack(qs)),
                                          jnp.asarray(np.stack(ss)))
    to, tso = tq.dequant_sum_requant_int8(torch.from_numpy(np.stack(qs)),
                                          torch.from_numpy(np.stack(ss)))
    _same(jo, to)
    _same(jso, tso)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("threshold", (0.5, 0.25))
def test_two_bit_levels_residuals_and_words_are_bitwise(seed, threshold):
    x, r = _payload(seed, 1003, 0.3)
    jl, jr = jq.quantize_2bit_ef(jnp.asarray(x), jnp.asarray(r), threshold,
                                 donate=False)
    tl, tr = tq.quantize_2bit_ef(torch.from_numpy(x), torch.from_numpy(r),
                                 threshold)
    _same(jl, tl)
    _same(jr, tr)
    jw = jq.pack_2bit_words(jl)
    tw = tq.pack_2bit_words(tl)
    _same(jw, tw)
    _same(jwc.pack_2bit(np.asarray(jl), threshold), tw)
    _same(jq.unpack_2bit_words(jw, threshold, 1003),
          tq.unpack_2bit_words(tw, threshold, 1003))
    _same(jwc.unpack_2bit(np.asarray(jw), 1003, threshold),
          twc.unpack_2bit(tw.numpy(), 1003, threshold))


def test_wire_sizes_and_block_knob(monkeypatch):
    for n in (1, 255, 256, 257, 100000):
        assert tq.int8_wire_bytes(n, 256) == jq.int8_wire_bytes(n, 256)
        assert tq.two_bit_wire_bytes(n) == jq.two_bit_wire_bytes(n)
        for mode in ("int8", "2bit", "bf16", None):
            assert tgc.wire_nbytes(mode, n, 64) == jgc.wire_nbytes(mode, n, 64)
    assert tq.grad_compress_block() == jq.grad_compress_block() == 256
    monkeypatch.setenv("MX_GRAD_COMPRESS_BLOCK", "64")
    assert tq.grad_compress_block() == jq.grad_compress_block() == 64
    monkeypatch.setenv("MX_GRAD_COMPRESS_BLOCK", "junk")
    assert tq.grad_compress_block() == jq.grad_compress_block() == 256


@pytest.mark.parametrize("seed", SEEDS)
def test_quantize_int8_np_matches(seed):
    x, _ = _payload(seed, 777)
    x[:256] = 0.0                      # one all-zero block: scale 0
    for got, want in zip(twc.quantize_int8_np(x, 128),
                         jwc.quantize_int8_np(x, 128)):
        _same(want, got)


@pytest.mark.parametrize("mode", ("int8", "2bit"))
@pytest.mark.parametrize("shape", ((33, 7), (4096,)))
def test_encode_wire_gives_the_same_bytes_and_decodes_alike(mode, shape):
    x, _ = _payload(3, int(np.prod(shape)))
    if mode == "int8":
        q, s = jwc.quantize_int8_np(x, 256)
        payload = (q, s)
    else:
        lv = np.where(x > 0.5, 0.5, np.where(x < -0.5, -0.5, 0.0))
        payload = (jwc.pack_2bit(lv, 0.5), 0.5)
    jt = jwc.encode_wire(mode, shape, "float32", payload)
    tt = twc.encode_wire(mode, shape, "float32", payload)
    assert len(jt) == len(tt) == 7 and tt[:5] == jt[:5]
    assert twc.is_wire_payload(tt) and jwc.is_wire_payload(tt)
    for a, b in zip(jt[5:], tt[5:]):
        if isinstance(a, bytes):
            assert a == b
        elif isinstance(a, float):
            assert a == b
        else:
            _same(a, b)
    np.testing.assert_array_equal(twc.decode_wire(jt), jwc.decode_wire(jt))
    np.testing.assert_array_equal(twc.decode_wire(tt), jwc.decode_wire(tt))


@pytest.mark.parametrize("bad", [
    ("NOPE", "int8", (2,), "float32", 2, b"\0\0", np.ones(1, np.float32)),
    ("QGRAD", "int8", (2,), "float32", 2, b"\0\0"),
    ("QGRAD", "int8", (2,), "float32", 3, b"\0\0", np.ones(1, np.float32)),
    ("QGRAD", "int8", (4,), "float32", 4, b"\0", np.ones(1, np.float32)),
    ("QGRAD", "2bit", (40,), "float32", 40, np.zeros(2, np.uint32), 0.5),
    ("QGRAD", "3bit", (2,), "float32", 2, b"", 0.5),
    ("QGRAD", "int8", (2,), "nodtype", 2, b"\0\0", np.ones(1, np.float32)),
])
def test_malformed_wire_tuples_raise_alike(bad):
    with pytest.raises(jwc.WireCodecError):
        jwc.decode_wire(bad)
    with pytest.raises(twc.WireCodecError):
        twc.decode_wire(bad)


@pytest.mark.parametrize("mode", ("int8", "2bit"))
def test_gradient_compression_carries_the_same_residuals(mode):
    jc = jgc.GradientCompression(mode, threshold=0.5, block=128)
    tc = tgc.GradientCompression(mode, threshold=0.5, block=128)
    rng = np.random.RandomState(7)
    for push in range(3):
        g = (rng.randn(40, 13) * 0.4).astype(np.float32)
        jv = np.asarray(jc.quantize("k", jnp.asarray(g)))
        tv = tc.quantize("k", torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(tv, jv, rtol=DEQ_RTOL, atol=0)
        _same(jc._residuals["k"], tc._residuals["k"])
        flat = g.reshape(-1) * 2
        jp = jc.compress_device("b", jnp.asarray(flat))
        tp = tc.compress_device("b", torch.from_numpy(flat))
        for a, b in zip(jp, tp):
            _same(a, b)
        _same(jc._residuals["b"], tc._residuals["b"])
        np.testing.assert_allclose(
            tc.decompress_device(tp, flat.size).numpy(),
            np.asarray(jc.decompress_device(jp, flat.size)),
            rtol=DEQ_RTOL, atol=0)
    jt, tt = (c.encode("e", x) for c, x in (
        (jc, jnp.asarray(g)), (tc, torch.from_numpy(g))))
    np.testing.assert_array_equal(twc.decode_wire(tt), jwc.decode_wire(jt))
    assert tc.wire_nbytes(1000) == jc.wire_nbytes(1000)


def test_checkpoint_rollback_and_commit():
    tc = tgc.GradientCompression("2bit", threshold=0.5)
    g = torch.full((4,), 0.3)
    tc.quantize("k", g)
    first = tc._residuals["k"].clone()
    tc.checkpoint(["k", "new"])
    tc.quantize("k", g)
    tc.quantize("new", g)
    tc.checkpoint(["k"])             # a second checkpoint keeps the first
    tc.rollback(["k", "new"])
    assert torch.equal(tc._residuals["k"], first)
    assert "new" not in tc._residuals
    tc.commit(["k", "new"])
    assert tc._pinned == {}


@pytest.mark.parametrize("kwargs", [{"type": "1bit"},
                                    {"type": "2bit", "threshold": 0}])
def test_bad_compression_settings_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        jgc.GradientCompression(**kwargs)
    with pytest.raises(ValueError):
        tgc.GradientCompression(**kwargs)
