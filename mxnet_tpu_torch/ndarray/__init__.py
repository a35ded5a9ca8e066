"""``mx.nd`` — the imperative NDArray namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: the NDArray class, every
op of ``ops.py``, ``random``, the op registry and the ``.params`` file
functions. ``mx.np`` (``mxnet_tpu_torch/numpy``) shares the same ops.
"""
from .ndarray import NDArray, waitall
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from . import ops
from . import random
from .register import get_op, invoke, list_ops, register_op
from ..ndarray_io import load, load_params, save, save_params

__all__ = (["NDArray", "waitall", "random", "get_op",
            "list_ops", "register_op", "invoke", "save", "load",
            "save_params", "load_params"] + list(_ops_all))
