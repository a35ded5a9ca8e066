"""``npx`` — the operator namespace.

Counterpart of ``mxnet_tpu/npx.py``: the operators of ``ops/nn.py`` and
``ops/transformer.py`` that the port has, ``set_np`` and its friends, the
device helpers and the ``mx.nd`` operators the JAX package re-exports here.
A name of its ``__all__`` that the port lacks raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming its ROADMAP Queue A item.
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
from .ops.nn import (activation, batch_norm,  # noqa: F401
                     batch_norm_relu_conv1x1, conv_fusion_enabled,
                     convolution, dropout, embedding, fully_connected, gelu,
                     layer_norm, log_softmax, pick, pooling, relu,
                     relu_conv1x1, take_positions)
from .ops.transformer import (dot_product_attention,  # noqa: F401
                              multi_head_attention)
from .util import (is_np_array, is_np_shape, reset_np, set_np,  # noqa: F401
                   use_np)

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "log_softmax", "pick", "take_positions",
           "dot_product_attention", "multi_head_attention", "relu",
           "convolution", "pooling", "batch_norm", "conv_fusion_enabled",
           "batch_norm_relu_conv1x1", "relu_conv1x1",
           "set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
           "cpu", "gpu", "tpu", "num_gpus", "num_tpus", "current_context",
           "waitall", "one_hot", "topk", "pad", "arange", "reshape",
           "gather_nd", "scatter_nd", "sigmoid", "tanh", "reshape_like",
           "broadcast_like", "batch_dot", "depth_to_space", "space_to_depth",
           "shuffle", "spatial_transformer", "khatri_rao"]


def __getattr__(name):
    return unported(__name__, name)
