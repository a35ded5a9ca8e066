"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for Hopper GPUs.

Module names and layout mirror ``mxnet_tpu/``. Entry points take an
explicit ``device`` and default to ``cuda:0``; without CUDA they raise
:class:`MXNetError` unless the caller passes ``device="cpu"``.

``nd`` / ``np`` are the imperative NDArray namespaces, ``autograd`` records
on torch's autograd, ``random`` draws from the framework generators and
``rtc`` compiles user CUDA kernels with NVRTC.
"""
from .base import MXNetError, getenv, register_env
from .context import Context, as_device, cpu, current_context, gpu
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import numpy as np  # noqa: A004 - mirrors mx.np
from . import rtc
from .ndarray import NDArray, waitall
# mx.random: the samplers of ndarray/random.py, with seed() and generator()
from .ndarray import random

__version__ = "0.1.0"
