"""Vision model zoo of the port (``mxnet_tpu/gluon/model_zoo/vision``):
``get_model(name, **kwargs)`` over the reference's 34 names, the ResNet,
VGG, AlexNet, DenseNet, SqueezeNet, Inception and MobileNet families.
A net is built on the current context (``gpu(0)``; under ``with
mx.cpu():`` on the CPU), so ``get_model`` raises without CUDA outside
such a scope."""
from ....base import MXNetError
from ....context import current_context
from .resnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from . import resnet, vgg, alexnet, densenet, squeezenet, inception, \
    mobilenet

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16,  # noqa: F405
    "vgg19": vgg19, "vgg11_bn": vgg11_bn,  # noqa: F405
    "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,  # noqa: F405
    "vgg19_bn": vgg19_bn, "alexnet": alexnet,  # noqa: F405
    "densenet121": densenet121, "densenet161": densenet161,  # noqa: F405
    "densenet169": densenet169, "densenet201": densenet201,  # noqa: F405
    "squeezenet1.0": squeezenet1_0,  # noqa: F405
    "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,  # noqa
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,  # noqa
    "mobilenetv2_1.0": mobilenet_v2_1_0,  # noqa: F405
    "mobilenetv2_0.75": mobilenet_v2_0_75,  # noqa: F405
    "mobilenetv2_0.5": mobilenet_v2_0_5,  # noqa: F405
    "mobilenetv2_0.25": mobilenet_v2_0_25,  # noqa: F405
}


def get_model(name, **kwargs):
    """``get_model("mobilenetv2_1.0", classes=1000)``: the reference's
    entry point, on the current context."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"unknown model {name!r}; choices: {sorted(_models)}")
    if kwargs.get("device") is None:    # built on the current context
        current_context().torch_device()    # raises where there is no card
    return _models[name](**kwargs)
