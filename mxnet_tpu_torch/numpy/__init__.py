"""``mx.np`` — the numpy-style namespace over the same ops as ``mx.nd``.

Counterpart of ``mxnet_tpu/numpy/__init__.py``, with its dtype aliases and
constants (``bfloat16`` is the string ``'bfloat16'`` in both packages).
"""
import numpy as _onp

from ..ndarray.ndarray import NDArray as ndarray  # noqa: N813
from ..ndarray.ndarray import NDArray
from ..ndarray.ops import *  # noqa: F401,F403
from ..ndarray.ops import __all__ as _ops_all
from ..ndarray import random  # noqa: F401

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
bfloat16 = "bfloat16"
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
dtype = _onp.dtype

__all__ = (["ndarray", "NDArray", "random", "float16",
            "float32", "float64", "bfloat16", "int8", "int16", "int32",
            "int64", "uint8", "bool_", "pi", "e", "inf", "nan", "newaxis",
            "dtype"] + list(_ops_all))
