"""The port's vision model zoo against the JAX reference, on the CPU.

Every name of the reference's ``get_model`` registry builds in both
packages with the same parameter names.  The smallest variant of each
family (``vgg11`` and ``vgg11_bn``, ``alexnet``, ``densenet121``,
``squeezenet1.0`` and ``1.1``, ``mobilenet0.25``, ``mobilenetv2_0.25``,
``inceptionv3``) is built at 10 classes and fed the smallest input the
architecture takes (alexnet 64 px; inceptionv3 299 px at batch 1, since
its fixed 8 x 8 average pool needs the 8 x 8 map that only 299 px gives;
the others 32 px at batch 2), with every parameter drawn from numpy
(BatchNorm's running statistics included) and given to both packages by
name; the predict-mode forwards agree within 1e-4 x max|ref|.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_numpy
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
CLASSES = 10
#: (the smallest input edge the architecture takes, the batch)
SMALLEST = {"vgg11": (32, 2), "vgg11_bn": (32, 2), "alexnet": (64, 2),
            "densenet121": (32, 2), "squeezenet1.0": (32, 2),
            "squeezenet1.1": (32, 2), "mobilenet0.25": (32, 2),
            "mobilenetv2_0.25": (32, 2), "inceptionv3": (299, 1)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def test_the_registry_holds_the_references_names():
    assert sorted(tvision._models) == sorted(jvision._models)
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("vgg17")


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_every_model_has_the_references_parameter_names(name):
    want = set(jvision.get_model(name).collect_params())
    got = set(tvision.get_model(name.upper()).collect_params())
    assert got == want


@pytest.mark.parametrize("name", ["alexnet", "vgg16_bn", "densenet121",
                                  "squeezenet1.1", "mobilenetv2_1.0",
                                  "inceptionv3"])
def test_pretrained_raises_without_a_weight_store(name):
    with pytest.raises(FileNotFoundError):
        tvision.get_model(name, pretrained=True)


def _drawn(named, seed):
    """Every parameter drawn from numpy: weights around the init's scale,
    running variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, v in named.items():
        if n.endswith("running_var"):
            out[n] = rng.uniform(0.5, 1.5, v.shape)
        elif n.endswith(("gamma", "running_mean", "beta", "bias")):
            base = 1.0 if n.endswith("gamma") else 0.0
            out[n] = base + 0.1 * rng.randn(*v.shape)
        else:
            fan_in = max(1, int(np.prod(v.shape[1:])))
            out[n] = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
        out[n] = out[n].astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(SMALLEST))
def test_predict_forward_matches_the_reference(name):
    hw, batch = SMALLEST[name]
    x = np.random.RandomState(1).randn(batch, 3, hw, hw).astype(np.float32)
    # the port's first call sizes its deferred parameters; the reference
    # takes them by name from numpy (set_data sizes its deferred ones and
    # checks the rest), so that its one forward is one compiled program
    tnet = tvision.get_model(name, classes=CLASSES)
    tnet.initialize(device="cpu")
    tnet(tnd.array(x))
    named = _drawn(params_to_numpy(tnet), seed=2)
    jnet = jvision.get_model(name, classes=CLASSES)
    jnet.initialize()
    for n, p in jnet.collect_params().items():
        p.set_data(jnd.array(named.pop(n)))
    assert not named, sorted(named)
    jnet.hybridize()
    want = jnet(jnd.array(x)).asnumpy()
    params_from_mxnet_tpu({n: p.data().asnumpy() for n, p in
                           jnet.collect_params().items()}, net=tnet,
                          device="cpu")
    got = tnet(tnd.array(x)).asnumpy()
    assert got.shape == want.shape == (batch, CLASSES)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_model_zoo_exports_are_the_reference_s():
    import mxnet_tpu.gluon.model_zoo as jzoo
    import mxnet_tpu_torch.gluon.model_zoo as tzoo
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    assert sorted(tzoo.__all__) == sorted(jzoo.__all__)
    assert tzoo.get_model is tvision.get_model
    assert tzoo.BERTModel is tbert.BERTModel
    assert tzoo.bert_12_768_12 is tbert.bert_12_768_12
    assert tzoo.bert_24_1024_16 is tbert.bert_24_1024_16
    assert type(tzoo.get_model("resnet18_v1")).__name__ == \
        type(jzoo.get_model("resnet18_v1")).__name__ == "ResNetV1"
