"""The port's BERT and gluon layers against the JAX reference, on the CPU.

A tiny BERT (2 layers, 128 units, 2 heads, vocab 100, T = 64) is built in
``mxnet_tpu``, given random parameters made with numpy from a seed, and
carried into ``mxnet_tpu_torch`` by ``params_from_mxnet_tpu``; both then
run the same inputs.  Head dim 64 sends the port's unmasked attention
through the flash path (its plain version on the CPU) while the JAX
package takes its composition.  Tolerance: rtol = atol = 1e-4, the repo's
fp32 bound (tests/test_torch_parity.py).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import nn as tnn

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
CFG = dict(vocab_size=100, max_length=64, dropout=0.0)
B, T = 2, 64


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32)
    types = (np.arange(T)[None, :] >= rng.randint(1, T, size=(B, 1))) \
        .astype(np.int32)
    valid = np.array([T, 37], np.float32)
    return tokens, types, valid


def _jax_bert(seed=1):
    """Tiny JAX BERT with every parameter drawn from numpy (not just the
    weights the initializer touches), materialised by one forward."""
    net = jbert.get_bert(2, 128, 2, **CFG)
    net.initialize(mx.init.Normal(0.02))
    tokens, types, _ = _inputs()
    net(nd.array(tokens, dtype="int32"), nd.array(types, dtype="int32"))
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        shape = p.data().shape
        if name.endswith("gamma"):
            val = 1.0 + 0.1 * rng.randn(*shape)
        else:
            val = 0.05 * rng.randn(*shape)
        p.set_data(nd.array(val.astype(np.float32)))
    return net


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_bert()
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = tbert.get_bert(2, 128, 2, **CFG)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    return jnet, tnet, named


@pytest.mark.parametrize("with_valid_length", [False, True])
def test_bert_outputs_match_reference(pair, with_valid_length):
    jnet, tnet, _ = pair
    tokens, types, valid = _inputs()
    jargs = [nd.array(tokens, dtype="int32"), nd.array(types, dtype="int32")]
    targs = [torch.from_numpy(tokens), torch.from_numpy(types)]
    if with_valid_length:
        jargs.append(nd.array(valid))
        targs.append(torch.from_numpy(valid))
    j_out = jnet(*jargs)
    with torch.inference_mode():
        t_out = tnet(*targs)
    assert len(t_out) == len(j_out) == 4     # seq, pooled, nsp, mlm
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=TOL,
                                   atol=TOL)


def test_parameter_names_and_shapes_match_reference(pair):
    _, tnet, named = pair
    tparams = tnet.collect_params()
    assert list(tparams) == list(named)
    for n, arr in named.items():
        assert tuple(tparams[n].shape) == arr.shape, n
    assert "encoder.transformer_cells.0.attention.query_key_value.weight" \
        in tparams
    assert tuple(tparams["encoder.transformer_cells.0.attention."
                         "query_key_value.weight"].shape) == (3 * 128, 128)
    sel = tnet.collect_params("layer_norm_att")
    assert sorted(sel) == sorted(n for n in named if "layer_norm_att" in n)


def test_bert_base_and_large_names_match_reference():
    """Full-width structures, no memory: the port builds on the meta
    device; the JAX package's names come from its block tree."""
    for ctor in ("bert_12_768_12", "bert_24_1024_16"):
        jnet = getattr(jbert, ctor)(use_decoder=False)
        tnet = getattr(tbert, ctor)(use_decoder=False)
        assert list(tnet.collect_params()) == list(jnet.collect_params())
        assert all(p.device.type == "meta" for p in tnet.parameters())
    tnet = tbert.bert_12_768_12(use_decoder=False)
    w = tnet.collect_params()["encoder.transformer_cells.11.ffn.ffn_1.weight"]
    assert tuple(w.shape) == (3072, 768)


def test_strict_load_refuses_missing_and_extra_names(pair):
    _, _, named = pair
    missing = dict(named)
    missing.pop("pooler.bias")
    with pytest.raises(RuntimeError, match="pooler.bias"):
        params_from_mxnet_tpu(missing, net=tbert.get_bert(2, 128, 2, **CFG),
                              device="cpu")
    extra = dict(named, **{"pooler.extra": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="pooler.extra"):
        params_from_mxnet_tpu(extra, net=tbert.get_bert(2, 128, 2, **CFG),
                              device="cpu")
    tensors = params_from_mxnet_tpu(named)
    assert all(t.device.type == "cpu" for t in tensors.values())


def test_layers_match_reference_ops():
    """LayerNorm (eps 1e-5), erf GELU, Dense with activation, Embedding
    (int32 indices, jnp.take's wrap and NaN fill) against the JAX ops."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.matrix import _embedding
    from mxnet_tpu.ops.nn import (_activation, _fully_connected,
                                  _layer_norm, _leaky_relu)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 16).astype(np.float32)
    g, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    w, bias = rng.randn(8, 16).astype(np.float32), \
        rng.randn(8).astype(np.float32)
    tx = torch.from_numpy(x)
    pairs = [
        (tnn.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b)),
         _layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
        (tnn.gelu(tx), _leaky_relu(jnp.asarray(x), act_type="gelu")),
        (tnn.activation(tx, "tanh"), _activation(jnp.asarray(x), "tanh")),
        (tnn.fully_connected(tx, torch.from_numpy(w), torch.from_numpy(bias),
                             flatten=False),
         _fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                          flatten=False)),
        (tnn.fully_connected(tx, torch.from_numpy(
            rng.randn(8, 80).astype(np.float32))),
         None),
    ]
    for t, j in pairs[:4]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    assert tuple(pairs[4][0].shape) == (2, 8)
    table = rng.randn(6, 4).astype(np.float32)
    idx = np.array([[0, 5, -1, 6, -7, 2]], np.int32)
    t_emb = tnn.embedding(torch.from_numpy(idx), torch.from_numpy(table))
    j_emb = np.asarray(_embedding(jnp.asarray(idx), jnp.asarray(table)))
    np.testing.assert_array_equal(np.isnan(t_emb.numpy()), np.isnan(j_emb))
    np.testing.assert_allclose(t_emb.numpy(), j_emb, rtol=TOL, atol=TOL)


def test_blocks_start_in_inference_mode_and_dropout_follows_train():
    d = tgnn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(64, 64)
    assert not d.training
    assert torch.equal(d(x), x)
    d.train()
    y = d(x)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}


def test_initialize_defaults_to_the_gpu_and_raises_without_one():
    net = tgnn.Dense(4, in_units=3)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal is not testable")
    with pytest.raises(MXNetError, match="device='cpu'"):
        net.initialize()
    with pytest.raises(MXNetError, match="device='cpu'"):
        from mxnet_tpu_torch.serve import Servable
        Servable(tgnn.Dense(4, in_units=3).initialize(device="cpu"))


def test_initializers_draw_from_the_generator():
    def draw(init, seed):
        net = tgnn.HybridSequential()
        net.add(tgnn.Dense(64, in_units=32), tgnn.LayerNorm(in_channels=64))
        net.initialize(init, device="cpu", seed=seed)
        return {n: p.detach() for n, p in net.named_parameters()}

    a = draw(tinit.Normal(0.02), 5)
    b = draw(tinit.Normal(0.02), 5)
    c = draw(tinit.Normal(0.02), 6)
    assert torch.equal(a["0.weight"], b["0.weight"])
    assert not torch.equal(a["0.weight"], c["0.weight"])
    assert abs(float(a["0.weight"].std()) - 0.02) < 0.005
    assert (a["0.bias"] == 0).all() and (a["1.gamma"] == 1).all() \
        and (a["1.beta"] == 0).all()
    x = draw(tinit.Xavier(), 0)["0.weight"]
    bound = np.sqrt(3.0 / ((32 + 64) / 2.0))
    assert float(x.abs().max()) <= bound
    xg = draw(tinit.Xavier(rnd_type="gaussian"), 0)["0.weight"]
    assert abs(float(xg.std()) - bound) < 0.03
    with pytest.raises(ValueError):
        tinit.Xavier(factor_type="sideways")
    assert isinstance(tinit.create(None), tinit.Uniform)


def test_cast_and_hybridize(pair):
    _, _, named = pair
    net = tbert.get_bert(2, 128, 2, **CFG)
    params_from_mxnet_tpu(named, net=net, device="cpu")
    net.hybridize()                     # documented no-op
    tokens, types, _ = _inputs()
    with torch.inference_mode():
        ref = net(torch.from_numpy(tokens), torch.from_numpy(types))
        net.cast("bfloat16")
        assert all(p.dtype == torch.bfloat16 for p in net.parameters())
        out = net(torch.from_numpy(tokens), torch.from_numpy(types))
    assert out[0].dtype == torch.bfloat16
    assert torch.isfinite(out[0].float()).all()
    # bf16 keeps about three significant digits
    assert float((out[1].float() - ref[1]).abs().max()) < 0.1
