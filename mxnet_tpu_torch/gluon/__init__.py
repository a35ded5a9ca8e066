"""Gluon: blocks, parameters, layers, losses, the trainer and the model zoo.

Counterpart of ``mxnet_tpu/gluon/__init__.py`` (``contrib`` holds its
``nn``); ``model_zoo`` loads on
first use, and a name of the JAX package's ``__all__`` whose module the
port lacks raises :class:`~mxnet_tpu_torch.base.MXNetError` naming its
ROADMAP Queue A item.
"""
from ..base import unported
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Constant, Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import contrib, loss, nn  # noqa: F401
from .loss import Loss  # noqa: F401

__all__ = ["Block", "HybridBlock", "Parameter", "Constant", "Trainer", "nn",
           "loss", "Loss", "model_zoo", "contrib"]


def __getattr__(name):
    if name == "model_zoo":
        import importlib
        mod = importlib.import_module(".model_zoo", __name__)
        globals()[name] = mod
        return mod
    return unported(__name__, name)
