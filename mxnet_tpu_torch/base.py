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
        15: "test_utils runtime callback model mod module symbol sym "
            "subgraph name attribute visualization viz",
    },
    "mxnet_tpu_torch.contrib": {
        15: "onnx text svrg tensorboard hf",
    },
    "mxnet_tpu_torch.ndarray": {
        7: "FullyConnected Convolution Deconvolution Activation BatchNorm "
           "LayerNorm GroupNorm InstanceNorm Pooling Dropout Embedding "
           "LeakyReLU SoftmaxOutput LinearRegressionOutput "
           "LogisticRegressionOutput MAERegressionOutput MakeLoss "
           "SoftmaxActivation Concat Reshape Flatten Cast SwapAxis "
           "SequenceMask SequenceLast SequenceReverse L2Normalization LRN "
           "Pad SliceChannel UpSampling Custom",
    },
    "mxnet_tpu_torch.ops": {
        9: "rnn",
    },
    "mxnet_tpu_torch.gluon": {
        8: "DeferredInitializationError",
        9: "rnn",
        11: "data",
        15: "SymbolBlock utils",
    },
    "mxnet_tpu_torch.gluon.contrib": {
        9: "rnn",
        12: "estimator",
    },
    "mxnet_tpu_torch.npx": {
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
