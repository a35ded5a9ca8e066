"""``gluon.contrib``: its experimental layers (``nn``). ``estimator`` and
``rnn`` raise :class:`~mxnet_tpu_torch.base.MXNetError` naming their
ROADMAP Queue A items."""
from ...base import unported
from . import nn  # noqa: F401

__all__ = ["nn"]


def __getattr__(name):
    return unported(__name__, name)
