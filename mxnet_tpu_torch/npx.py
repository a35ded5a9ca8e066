"""``npx`` — the operator namespace the model zoo calls.

Counterpart of ``mxnet_tpu/npx.py``, holding only the names the BERT and
ResNet models and their loss use.
"""
from .ops.nn import (activation, batch_norm,  # noqa: F401
                     batch_norm_relu_conv1x1, conv_fusion_enabled,
                     convolution, dropout, embedding, fully_connected, gelu,
                     layer_norm, log_softmax, pick, pooling, relu,
                     relu_conv1x1, take_positions)
from .ops.transformer import (dot_product_attention,  # noqa: F401
                              multi_head_attention)

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "log_softmax", "pick", "take_positions",
           "dot_product_attention", "multi_head_attention", "relu",
           "convolution", "pooling", "batch_norm", "conv_fusion_enabled",
           "batch_norm_relu_conv1x1", "relu_conv1x1"]
