"""``contrib``: experimental and auxiliary subsystems.

Counterpart of ``mxnet_tpu/contrib/``: the int8 post-training quantization
flow (``quantization``). ``onnx``, ``text``, ``svrg``, ``tensorboard``
and ``hf`` raise :class:`~mxnet_tpu_torch.base.MXNetError` naming their
ROADMAP Queue A item.
"""
from ..base import unported
from . import quantization  # noqa: F401

__all__ = ["quantization"]


def __getattr__(name):
    return unported(__name__, name)
