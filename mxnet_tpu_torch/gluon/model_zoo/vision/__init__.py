"""``gluon.model_zoo.vision`` — the classification zoo's ResNets and
``get_model`` (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``; the
zoo's other families are not ported yet)."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

from ....base import MXNetError

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name: str, **kwargs):
    """Create a model by name (``vision.get_model``)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"model {name!r} not in the port's zoo; available: "
            f"{sorted(_models)}")
    return _models[name](**kwargs)


__all__ = list(_resnet_all) + ["get_model"]
