"""``npx`` — the operator namespace the model zoo calls.

Counterpart of ``mxnet_tpu/npx.py``, holding only the names the BERT model
and its loss use.
"""
from .ops.nn import (activation, dropout, embedding, fully_connected,  # noqa: F401
                     gelu, layer_norm, log_softmax, pick, take_positions)
from .ops.transformer import (dot_product_attention,  # noqa: F401
                              multi_head_attention)

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "log_softmax", "pick", "take_positions",
           "dot_product_attention",
           "multi_head_attention"]
