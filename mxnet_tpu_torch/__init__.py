"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for Hopper GPUs.

Module names and layout mirror ``mxnet_tpu/``. Entry points take an
explicit ``device`` and default to ``cuda:0``; without CUDA they raise
:class:`MXNetError` unless the caller passes ``device="cpu"``.

``nd`` / ``np`` are the imperative NDArray namespaces, ``npx`` the
operators, ``autograd`` records on torch's autograd, ``random`` draws from
the framework generators, ``rtc`` compiles user CUDA kernels with NVRTC,
and ``metrics``, ``tracing`` and ``faults`` are the runtime's counters,
spans and fault sites.
``gluon``, ``optimizer``, ``init`` / ``initializer``, ``lr_scheduler``,
``serving`` and ``contrib`` load on first use, as the JAX package's
``_LAZY`` table does (``mxnet_tpu/__init__.py``); a name of that table
whose module the port lacks raises :class:`MXNetError` naming its ROADMAP
Queue A item.
"""
from .base import MXNetError, getenv, register_env, unported
from .context import (Context, as_device, cpu, cpu_pinned, current_context,
                      gpu, num_gpus, num_tpus, tpu)
from . import metrics
from . import tracing
from . import faults
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import numpy as np  # noqa: A004 - mirrors mx.np
from . import ndarray_io
from . import npx
from . import rtc
from . import util
from .ndarray import NDArray, waitall
# mx.random: the samplers of ndarray/random.py, with seed() and generator()
from .ndarray import random
from .util import is_np_array, is_np_shape, set_np

__version__ = "0.1.0"

# subpackages that load on first use (the JAX package's _LAZY, where ported)
_LAZY = {
    "gluon": ".gluon",
    "optimizer": ".optimizer",
    "initializer": ".initializer",
    "init": ".initializer",
    "lr_scheduler": ".lr_scheduler",
    "serving": ".serving",
    "contrib": ".contrib",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    return unported(__name__, name)
