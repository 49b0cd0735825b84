"""Vision model zoo of the port (``mxnet_tpu/gluon/model_zoo/vision``):
``get_model(name, **kwargs)`` over the ResNet family.  The reference's
other families come with later slices and raise."""
from ....base import MXNetError
from . import resnet
from .resnet import *  # noqa: F401,F403

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
}
# the reference's other families: not ported yet
_LATER = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
          "vgg16_bn", "vgg19_bn", "alexnet", "densenet121", "densenet161",
          "densenet169", "densenet201", "squeezenet1.0", "squeezenet1.1",
          "inceptionv3", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
          "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
          "mobilenetv2_0.5", "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """``get_model("resnet50_v1", classes=1000, layout="NHWC")``."""
    name = name.lower()
    if name in _LATER:
        raise MXNetError(f"model {name!r} comes with a later slice of "
                         "mxnet_tpu_torch (the ResNet family is ported)")
    if name not in _models:
        raise MXNetError(
            f"unknown model {name!r}; choices: {sorted(_models)}")
    return _models[name](**kwargs)
