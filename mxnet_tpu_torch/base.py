"""Error type and the ``MXNET_*`` environment-variable registry.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, ``register_env``,
``getenv``): an own copy, so the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

__all__ = ["MXNetError", "register_env", "getenv", "unported", "QUEUE_A"]


class MXNetError(RuntimeError):
    """Default error raised by framework operations (``mxnet.base.MXNetError``)."""


_ENV_REGISTRY: Dict[str, Dict[str, Any]] = {}
_ENV_LOCK = threading.Lock()


def register_env(name: str, default: Any, doc: str = "") -> None:
    """Register a recognized ``MXNET_*`` environment variable with default+doc."""
    with _ENV_LOCK:
        _ENV_REGISTRY[name] = {"default": default, "doc": doc}


def getenv(name: str, default: Any = None, typ: Optional[type] = None) -> Any:
    """Read an environment variable with type coercion (``dmlc::GetEnv``)."""
    if name in _ENV_REGISTRY and default is None:
        default = _ENV_REGISTRY[name]["default"]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is None:
        typ = type(default) if default is not None else str
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    try:
        return typ(raw)
    except (TypeError, ValueError):
        return default



# The JAX package's names whose modules the port lacks, by namespace, with
# the ROADMAP Queue A item that ports them. Reading one raises MXNetError
# naming the item; any other missing name is an AttributeError.
QUEUE_A = {
    6: "Gluon layers, losses, initializers and the npx operators",
    7: "the rest of the imperative surface",
    8: "the vision remainder, AMP and deferred initialization",
    9: "RNN",
    10: "the other optimizers, row-sparse gradients and remat",
    11: "data and IO",
    12: "estimator, metric and checkpointing",
    13: "the distributed kvstores",
    14: "the operational remainder",
    15: "the remaining surface",
}
_UNPORTED = {
    "mxnet_tpu_torch": {
        7: "operator",
        8: "amp",
        11: "io image recordio",
        12: "metric checkpoint preemption",
        13: "kvstore kv parallel",
        14: "profiler monitor mon retry health engine bulk",
        15: "test_utils runtime callback model mod module symbol sym contrib "
            "subgraph name attribute visualization viz",
    },
    "mxnet_tpu_torch.gluon": {
        6: "Constant",
        8: "DeferredInitializationError",
        9: "rnn",
        11: "data",
        12: "contrib",
        15: "SymbolBlock utils",
    },
    "mxnet_tpu_torch.gluon.nn": {
        6: "Sequential SyncBatchNorm GroupNorm InstanceNorm Lambda "
           "HybridLambda Identity HybridConcatenate Concatenate Conv1D Conv3D "
           "Conv1DTranspose Conv2DTranspose Conv3DTranspose MaxPool1D "
           "MaxPool3D AvgPool1D AvgPool3D GlobalMaxPool1D GlobalMaxPool2D "
           "GlobalMaxPool3D GlobalAvgPool1D GlobalAvgPool3D ReflectionPad2D "
           "LeakyReLU PReLU ELU SELU GELU Swish SiLU Mish HardSigmoid "
           "HardSwish",
    },
    "mxnet_tpu_torch.npx": {
        6: "leaky_relu prelu elu selu silu swish mish softrelu softsign "
           "hard_sigmoid hard_swish log_sigmoid softmax masked_softmax "
           "masked_log_softmax deconvolution adaptive_avg_pool2d group_norm "
           "instance_norm rms_norm l2_normalization lrn sequence_mask "
           "sequence_last sequence_reverse topk_mask smooth_l1 up_sampling "
           "roi_pooling ctc_loss softmax_output linear_regression_output "
           "mae_regression_output logistic_regression_output make_loss "
           "arange_like interleaved_matmul_selfatt_qk "
           "interleaved_matmul_selfatt_valatt interleaved_matmul_encdec_qk "
           "interleaved_matmul_encdec_valatt quantize quantize_v2 dequantize "
           "requantize quantized_fully_connected quantized_conv "
           "quantized_pooling quantized_act quantized_flatten",
        9: "rnn",
    },
}
UNPORTED = {ns: {n: item for item, names in table.items()
                 for n in names.split()}
            for ns, table in _UNPORTED.items()}


def unported(namespace: str, name: str):
    """The module ``__getattr__`` of a namespace: raise MXNetError naming
    the Queue A item for a name of the JAX package that the port lacks,
    AttributeError for any other name."""
    item = UNPORTED.get(namespace, {}).get(name)
    if item is None:
        raise AttributeError(f"module {namespace!r} has no attribute "
                             f"{name!r}")
    raise MXNetError(f"{namespace}.{name} is not ported yet (ROADMAP Queue A "
                     f"{item}, {QUEUE_A[item]})")
