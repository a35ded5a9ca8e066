"""Neural-network layers, with ``Block`` and ``HybridBlock`` (as the JAX
package's ``gluon.nn``); a layer of its ``__all__`` that the port lacks
raises :class:`~mxnet_tpu_torch.base.MXNetError` naming its ROADMAP
Queue A item."""
from ...base import unported
from ..block import Block, HybridBlock  # noqa: F401
from .activations import *  # noqa: F401,F403
from .activations import __all__ as _act_all
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic_all
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all

__all__ = list(_basic_all) + list(_conv_all) + list(_act_all) + [
    "Block", "HybridBlock"]


def __getattr__(name):
    return unported(__name__, name)
