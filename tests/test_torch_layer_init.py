"""The layers' initializer keywords (Queue 3 F1) and the names the port's
ported modules lacked (F2), against the JAX reference on the CPU.

F1: each layer takes the reference's ``*_initializer`` keywords, and each
keyword gives the reference's values after ``initialize`` (a fixed
initializer, so the two packages agree exactly), the reference's name
rule included: a ``bias``, ``gamma``, ``beta`` or ``running_*`` parameter
gets its fixed leaf whatever its keyword asked for.  A keyword the
reference's ``HybridBlock.__init__`` rejects raises the same
``TypeError`` in both packages; ``Embedding(sparse_grad=True)`` raises in
the port, naming Queue 1 item 8.

F2: ``mx.NDArray``, the registry's functions under ``mx.ops``, the type
tuples of ``mx.base``, ``gradient_compression.quantize_2bit`` (bitwise),
``wire_codec.is_text_payload`` / ``is_json_payload`` and
``parallel.TrainStep(..., donate=...)``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)


def _init(pkg, name):
    """A fixed initializer of ``pkg`` by a short name."""
    return {"one": lambda: pkg.init.One(), "zero": lambda: pkg.init.Zero(),
            "half": lambda: pkg.init.Constant(0.5), "ones": lambda: "ones",
            "zeros": lambda: "zeros"}[name]()


# (layer, its positional arguments, its size keywords, the input shape)
LAYERS = {
    "Dense": ((4,), dict(in_units=3), (2, 3)),
    "BatchNorm": ((), dict(in_channels=3), (2, 3, 4)),
    "LayerNorm": ((), dict(in_channels=5), (2, 5)),
    "GroupNorm": ((), dict(num_groups=1, in_channels=3), (2, 3, 4)),
    "Embedding": ((5, 3), {}, None),
    "Conv1D": ((2, 3), dict(in_channels=1), (1, 1, 6)),
    "Conv2D": ((2, 3), dict(in_channels=1), (1, 1, 6, 6)),
    "Conv3D": ((2, 3), dict(in_channels=1), (1, 1, 6, 6, 6)),
    "Conv1DTranspose": ((2, 3), dict(in_channels=1), (1, 1, 6)),
    "Conv2DTranspose": ((2, 3), dict(in_channels=1), (1, 1, 6, 6)),
    "Conv3DTranspose": ((2, 3), dict(in_channels=1), (1, 1, 6, 6, 6)),
}
KEYWORDS = {
    "Dense": ["weight", "bias"],
    "BatchNorm": ["beta", "gamma", "running_mean", "running_variance"],
    "LayerNorm": ["beta", "gamma"],
    "GroupNorm": ["beta", "gamma"],
    "Embedding": ["weight"],
}
for _conv in [k for k in LAYERS if k.startswith("Conv")]:
    KEYWORDS[_conv] = ["weight", "bias"]
CASES = [(layer, kw, init) for layer, kws in sorted(KEYWORDS.items())
         for kw in kws for init in ("one", "half", "zeros")]


def _values(pkg, layer, keyword, init_name, deferred=False):
    args, sizes, shape = LAYERS[layer]
    if deferred:
        sizes = {}
    net = getattr(pkg.gluon.nn, layer)(
        *args, **sizes, **{keyword + "_initializer": _init(pkg, init_name)})
    net.initialize(ctx=pkg.cpu())
    if deferred:
        with pkg.cpu():
            net(pkg.nd.array(np.ones(shape, np.float32), ctx=pkg.cpu()))
    return {name: p.data().asnumpy()
            for name, p in net.collect_params().items()}


@pytest.mark.parametrize("layer,keyword,init", CASES,
                         ids=["%s-%s-%s" % c for c in CASES])
def test_initializer_keyword_gives_the_reference_values(layer, keyword,
                                                        init):
    want = _values(jmx, layer, keyword, init)
    got = _values(tmx, layer, keyword, init)
    assert list(got) == list(want)
    for name in want:
        if name == "weight" and keyword != "weight":
            continue            # the default initializer's random draw
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("layer", ["Dense", "Conv2D", "BatchNorm"])
def test_a_deferred_layer_keeps_its_initializer(layer):
    keyword = KEYWORDS[layer][-1 if layer == "BatchNorm" else 0]
    want = _values(jmx, layer, keyword, "half", deferred=True)
    got = _values(tmx, layer, keyword, "half", deferred=True)
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["weight"] if keyword == "weight"
                                  else got["running_var"],
                                  want["weight"] if keyword == "weight"
                                  else want["running_var"])


def test_the_reproducers_of_f1():
    for pkg in (jmx, tmx):
        nn = pkg.gluon.nn
        d = nn.Dense(4, in_units=3, weight_initializer=pkg.init.One())
        c = nn.Conv2D(2, 3, in_channels=1,
                      weight_initializer=pkg.init.Zero())
        e = nn.Embedding(5, 3, weight_initializer=pkg.init.One())
        for b in (d, c, e):
            b.initialize(ctx=pkg.cpu())
        assert (d.weight.data().asnumpy() == 1).all()
        assert (c.weight.data().asnumpy() == 0).all()
        assert (e.weight.data().asnumpy() == 1).all()


def test_the_name_rule_keeps_gamma_at_one():
    for pkg in (jmx, tmx):
        bn = pkg.gluon.nn.BatchNorm(gamma_initializer="zeros",
                                    in_channels=3)
        bn.initialize(ctx=pkg.cpu())
        assert (bn.gamma.data().asnumpy() == 1).all()


@pytest.mark.parametrize("make", [
    lambda nn: nn.Dense(4, foo=1),
    lambda nn: nn.Conv2D(2, 3, bar=2),
    lambda nn: nn.BatchNorm(momentum=0.9, baz=3),
    lambda nn: nn.Embedding(5, 3, qux=4),
    lambda nn: nn.InstanceNorm(beta_initializer="ones"),
], ids=["Dense", "Conv2D", "BatchNorm", "Embedding", "InstanceNorm"])
def test_an_unknown_keyword_raises_the_reference_type_error(make):
    with pytest.raises(TypeError) as want:
        make(jmx.gluon.nn)
    with pytest.raises(TypeError) as got:
        make(tmx.gluon.nn)
    assert str(got.value) == str(want.value)


def test_embedding_sparse_grad_raises_naming_item_8():
    with pytest.raises(tmx.MXNetError, match="Queue 1 item 8"):
        tmx.gluon.nn.Embedding(5, 3, sparse_grad=True)


# ---------------------------------------------------------------------------
# F2
# ---------------------------------------------------------------------------

def test_mx_ndarray_is_the_ndarray_class():
    assert tmx.NDArray is tmx.nd.NDArray
    assert isinstance(tmx.nd.array([1.0], ctx=tmx.cpu()), tmx.NDArray)
    assert jmx.NDArray is jmx.nd.NDArray


@pytest.mark.parametrize("name", ["register", "get_op", "list_ops",
                                  "OpDef"])
def test_the_ops_package_reexports_the_registry(name):
    assert getattr(tmx.ops, name) is getattr(tmx.ops.registry, name)
    assert hasattr(jmx.ops, name)
    if name == "get_op":
        assert tmx.ops.get_op("relu").name == "relu"


@pytest.mark.parametrize("name", ["string_types", "numeric_types",
                                  "integer_types"])
def test_the_base_type_tuples(name):
    assert getattr(tmx.base, name) == getattr(jmx.base, name)


def test_quantize_2bit_is_bitwise_the_reference():
    import jax.numpy as jnp
    from mxnet_tpu.kvstore import gradient_compression as jgc
    from mxnet_tpu_torch.kvstore import gradient_compression as tgc
    rng = np.random.RandomState(0)
    g = rng.randn(1000).astype(np.float32)
    r = (0.3 * rng.randn(1000)).astype(np.float32)
    jq, jr = jgc.quantize_2bit(jnp.asarray(g), jnp.asarray(r.copy()), 0.5)
    tq, tr = tgc.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), 0.5)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    nq, _ = tgc.quantize_2bit(tmx.nd.array(g, ctx=tmx.cpu()),
                              tmx.nd.array(r, ctx=tmx.cpu()), 0.5)
    np.testing.assert_array_equal(nq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("name", ["is_text_payload", "is_json_payload"])
def test_wire_codec_payload_checks(name):
    from mxnet_tpu.kvstore import wire_codec as jwc
    from mxnet_tpu_torch.kvstore import wire_codec as twc
    objs = [twc.encode_text("a"), twc.encode_json({"a": 1}),
            twc.encode_array(np.ones(2)), ("TXT",), ("JSN", b"", 1), b"x",
            None]
    assert [getattr(twc, name)(o) for o in objs] == \
        [getattr(jwc, name)(o) for o in objs]
    assert sum(getattr(twc, name)(o) for o in objs) == 1


def test_train_step_takes_donate():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    loss = lambda out, label: ((out - label) ** 2).mean()  # noqa: E731
    x, y = torch.ones(4, 3), torch.zeros(4, 2)
    steps = [tmx.parallel.TrainStep(net, loss, device="cpu",
                                    learning_rate=0.1, donate=d)
             for d in (True, False)]
    assert steps[0](x, y).item() == steps[1](x, y).item()
