"""``npx`` — the operator namespace.

Counterpart of ``mxnet_tpu/npx.py``: the operators of ``ops/nn.py`` and
``ops/transformer.py``, ``set_np`` and its friends, the device helpers and
the ``mx.nd`` operators the JAX package re-exports here, and the quantized
operators of ``ops/quantization.py``. A name of its ``__all__`` that the
port lacks (``rnn``) raises :class:`~mxnet_tpu_torch.base.MXNetError`
naming its ROADMAP Queue A item.
"""
from .base import unported
from .context import (cpu, current_context, gpu, num_gpus,  # noqa: F401
                      num_tpus, tpu)
from .ndarray.ndarray import waitall  # noqa: F401
from .ndarray.ops import (arange, batch_dot, broadcast_like,  # noqa: F401
                          depth_to_space, gather_nd, khatri_rao, one_hot,
                          pad, reshape, reshape_like, scatter_nd, shuffle,
                          sigmoid, space_to_depth, spatial_transformer, tanh,
                          topk)
from .ops.nn import *  # noqa: F401,F403
from .ops.nn import __all__ as _nn_all
from .ops.transformer import *  # noqa: F401,F403
from .ops.transformer import __all__ as _tr_all
from .ops.quantization import *  # noqa: F401,F403
from .ops.quantization import __all__ as _q_all
from .util import (is_np_array, is_np_shape, reset_np, set_np,  # noqa: F401
                   use_np)

__all__ = list(_nn_all) + list(_tr_all) + list(_q_all) + [
    "set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
    "cpu", "gpu", "tpu", "num_gpus", "num_tpus", "current_context",
    "waitall", "one_hot", "topk", "pad", "arange", "reshape", "gather_nd",
    "scatter_nd", "sigmoid", "tanh", "reshape_like", "broadcast_like",
    "batch_dot", "depth_to_space", "space_to_depth", "shuffle",
    "spatial_transformer", "khatri_rao"]


def __getattr__(name):
    return unported(__name__, name)
