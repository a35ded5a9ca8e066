"""Neural-network layers, with ``Block`` and ``HybridBlock`` (as the JAX
package's ``gluon.nn``)."""
from ..block import Block, HybridBlock  # noqa: F401
from .activations import *  # noqa: F401,F403
from .activations import __all__ as _act_all
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic_all
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all

__all__ = list(_basic_all) + list(_conv_all) + list(_act_all) + [
    "Block", "HybridBlock"]
