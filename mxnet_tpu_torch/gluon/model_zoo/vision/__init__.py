"""Vision models of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the ResNet family and
``get_model``, the name registry.  The reference's other vision models
(vgg, alexnet, densenet, squeezenet, mobilenet, inception) are not ported
yet; ``get_model`` refuses their names as it refuses an unknown one."""
from . import resnet
from .resnet import *       # noqa: F401,F403

_models = {
    "resnet18_v1": resnet.resnet18_v1, "resnet34_v1": resnet.resnet34_v1,
    "resnet50_v1": resnet.resnet50_v1, "resnet101_v1": resnet.resnet101_v1,
    "resnet152_v1": resnet.resnet152_v1,
    "resnet18_v2": resnet.resnet18_v2, "resnet34_v2": resnet.resnet34_v2,
    "resnet50_v2": resnet.resnet50_v2, "resnet101_v2": resnet.resnet101_v2,
    "resnet152_v2": resnet.resnet152_v2,
}


def get_model(name, **kwargs):
    """A model by registry name, built on the ``meta`` device."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models.keys())))
    return _models[name](**kwargs)
