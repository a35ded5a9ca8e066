"""Operators of the port (plain functions on tensors).

Counterpart of ``mxnet_tpu/ops/__init__.py``: the ``__all__`` of ``nn``,
``transformer``, ``quantization`` and ``boxes``, re-exported. ``rnn``, a
name of the JAX package's ``nn`` that the port lacks, raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming its ROADMAP Queue A item.
"""
from ..base import unported
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _tr_all
from .quantization import *  # noqa: F401,F403
from .quantization import __all__ as _q_all
from .boxes import *  # noqa: F401,F403
from .boxes import __all__ as _box_all

__all__ = list(_nn_all) + list(_tr_all) + list(_q_all) + list(_box_all)


def __getattr__(name):
    return unported(__name__, name)
