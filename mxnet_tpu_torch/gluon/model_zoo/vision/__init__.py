"""Vision models of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ResNet v1/v2, VGG
(with the ``_bn`` variants), AlexNet, DenseNet, SqueezeNet, MobileNet v1
and v2 and Inception V3, and ``get_model``, the reference's name
registry."""
# modules first (the star-imports below rebind some of these names to the
# model-constructor functions, e.g. ``alexnet``)
from . import (resnet, alexnet as _alexnet_mod, vgg, mobilenet, squeezenet,
               densenet, inception)
from .resnet import *       # noqa: F401,F403
from .alexnet import *      # noqa: F401,F403
from .vgg import *          # noqa: F401,F403
from .mobilenet import *    # noqa: F401,F403
from .squeezenet import *   # noqa: F401,F403
from .densenet import *     # noqa: F401,F403
from .inception import *    # noqa: F401,F403

_models = {
    "resnet18_v1": resnet.resnet18_v1, "resnet34_v1": resnet.resnet34_v1,
    "resnet50_v1": resnet.resnet50_v1, "resnet101_v1": resnet.resnet101_v1,
    "resnet152_v1": resnet.resnet152_v1,
    "resnet18_v2": resnet.resnet18_v2, "resnet34_v2": resnet.resnet34_v2,
    "resnet50_v2": resnet.resnet50_v2, "resnet101_v2": resnet.resnet101_v2,
    "resnet152_v2": resnet.resnet152_v2,
    "vgg11": vgg.vgg11, "vgg13": vgg.vgg13, "vgg16": vgg.vgg16,
    "vgg19": vgg.vgg19, "vgg11_bn": vgg.vgg11_bn, "vgg13_bn": vgg.vgg13_bn,
    "vgg16_bn": vgg.vgg16_bn, "vgg19_bn": vgg.vgg19_bn,
    "alexnet": _alexnet_mod.alexnet,
    "densenet121": densenet.densenet121, "densenet161": densenet.densenet161,
    "densenet169": densenet.densenet169, "densenet201": densenet.densenet201,
    "squeezenet1.0": squeezenet.squeezenet1_0,
    "squeezenet1.1": squeezenet.squeezenet1_1,
    "inceptionv3": inception.inception_v3,
    "mobilenet1.0": mobilenet.mobilenet1_0,
    "mobilenet0.75": mobilenet.mobilenet0_75,
    "mobilenet0.5": mobilenet.mobilenet0_5,
    "mobilenet0.25": mobilenet.mobilenet0_25,
    "mobilenetv2_1.0": mobilenet.mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet.mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet.mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet.mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """A model by registry name, built on the ``meta`` device."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models.keys())))
    return _models[name](**kwargs)
