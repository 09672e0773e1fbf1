"""Vision model zoo (counterpart of mxnet_tpu/gluon/model_zoo/vision):
resnet v1/v2 18-152, vgg 11-19 (+bn), alexnet, squeezenet, densenet,
mobilenet (+v2), inception-v3, with the JAX package's ``_models`` table
and parameter names. ``pretrained=True`` loads a local model store
(``model_store``)."""
from .resnet import (ResNetV1, ResNetV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
                     get_resnet)
from .alexnet import AlexNet, alexnet
from .vgg import (VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn, get_vgg)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .mobilenet import (MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_75,
                        mobilenet0_5, mobilenet0_25, mobilenet_v2_1_0,
                        mobilenet_v2_0_75, mobilenet_v2_0_5,
                        mobilenet_v2_0_25)
from .inception import Inception3, inception_v3

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t" +
            "\n\t".join(sorted(_models.keys())))
    return _models[name](**kwargs)
