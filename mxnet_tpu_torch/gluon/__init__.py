"""Gluon: blocks, parameters, layers, losses, the trainer and the model zoo."""
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import loss, nn  # noqa: F401
