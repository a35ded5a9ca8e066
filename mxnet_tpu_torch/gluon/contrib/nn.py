"""Experimental Gluon layers.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py``: ``HybridConcurrent`` /
``Concurrent`` (``gluon.nn``'s concatenating container),
``Identity`` (``gluon.nn``'s) and ``PixelShuffle1D`` / ``2D`` / ``3D``
(sub-pixel upsampling: channels moved into the spatial axes).
"""
from __future__ import annotations

import math
from typing import Any

from ...base import MXNetError
from ..block import HybridBlock
from ..nn.basic_layers import HybridConcatenate
from ..nn.basic_layers import Identity  # noqa: F401  (MXNet's location)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D"]


class HybridConcurrent(HybridConcatenate):
    """Children run on the same input, their outputs concatenated along
    ``axis`` (Inception-style branches): ``gluon.nn.HybridConcatenate``
    under MXNet's contrib name."""


class Concurrent(HybridConcurrent):
    """The imperative name of :class:`HybridConcurrent`."""


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim: int, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor,) * ndim
        self._factor = tuple(int(f) for f in factor)
        if len(self._factor) != ndim:
            raise MXNetError(f"factor must have {ndim} elements")
        self._ndim = ndim

    def forward(self, x):
        f, n = self._factor, self._ndim
        N, C, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        if C % math.prod(f):
            raise MXNetError(
                f"channels {C} not divisible by shuffle factor {f}")
        cout = C // math.prod(f)
        # (N, Cout, f1..fn, d1..dn) -> (N, Cout, d1, f1, ..., dn, fn)
        x = x.reshape((N, cout) + f + spatial)
        perm = [0, 1] + [p for i in range(n) for p in (2 + n + i, 2 + i)]
        return x.permute(perm).reshape(
            (N, cout) + tuple(d * fi for d, fi in zip(spatial, f)))


class PixelShuffle1D(_PixelShuffle):
    """(N, C * f, W) -> (N, C, W * f)."""

    def __init__(self, factor, **kwargs: Any) -> None:
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """(N, C * f1 * f2, H, W) -> (N, C, H * f1, W * f2)."""

    def __init__(self, factor, **kwargs: Any) -> None:
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """(N, C * f1 * f2 * f3, D, H, W) -> (N, C, D * f1, H * f2, W * f3)."""

    def __init__(self, factor, **kwargs: Any) -> None:
        super().__init__(factor, 3, **kwargs)
