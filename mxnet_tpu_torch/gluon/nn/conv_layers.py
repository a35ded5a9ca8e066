"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv`` forward,
``Conv2D``, ``_Pool``, ``MaxPool2D``, ``AvgPool2D``, ``GlobalAvgPool2D``),
channels-first (NCHW), with the weight layout (channels, in_channels /
groups, kh, kw). Shapes are fixed at construction, so a convolution takes
``in_channels`` (the JAX package can defer it to the first forward).
"""
from __future__ import annotations

from typing import Any, Optional

from ... import npx
from ..block import HybridBlock
from ..parameter import Parameter, data_or_none

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _tuplify(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels: int, kernel_size, strides, padding, dilation,
                 groups: int, layout: str, in_channels: int = 0,
                 activation: Optional[str] = None, use_bias: bool = True,
                 weight_initializer: Any = None,
                 bias_initializer: Any = "zeros", ndim: int = 2,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tuplify(kernel_size, ndim)
        self._strides = _tuplify(strides, ndim)
        self._padding = _tuplify(padding, ndim)
        self._dilation = _tuplify(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self.weight = Parameter(
            "weight", shape=(channels, in_channels // groups) + self._kernel,
            init=weight_initializer)
        self.bias = Parameter("bias", shape=(channels,),
                              init=bias_initializer) if use_bias else None

    def forward(self, x):
        out = npx.convolution(
            x, self.weight.data(), data_or_none(self.bias),
            kernel=self._kernel,
            stride=self._strides, dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            no_bias=self.bias is None, layout=self._layout)
        if self._activation:
            out = npx.activation(out, self._activation)
        return out

    def extra_repr(self) -> str:
        return (f"{self._in_channels} -> {self._channels}, "
                f"kernel_size={self._kernel}, stride={self._strides}")


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, **kwargs)


class _Pool(HybridBlock):
    """Pooling; ``ceil_mode`` is accepted and the output size is the floor
    one either way, as in the JAX package."""

    def __init__(self, pool_size, strides, padding, ndim: int,
                 pool_type: str, layout: str, global_pool: bool = False,
                 count_include_pad: bool = True, ceil_mode: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._kernel = _tuplify(pool_size, ndim)
        self._strides = _tuplify(strides if strides is not None
                                 else pool_size, ndim)
        self._padding = _tuplify(padding, ndim)
        self._pool_type = pool_type
        self._layout = layout
        self._global = global_pool
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return npx.pooling(x, kernel=self._kernel, pool_type=self._pool_type,
                           stride=self._strides, pad=self._padding,
                           global_pool=self._global,
                           count_include_pad=self._count_include_pad,
                           layout=self._layout)

    def extra_repr(self) -> str:
        return (f"size={self._kernel}, stride={self._strides}, "
                f"padding={self._padding}")


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, 2, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, 2, "avg", layout,
                         ceil_mode=ceil_mode,
                         count_include_pad=count_include_pad, **kwargs)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(1, 1, 0, 2, "avg", layout, global_pool=True,
                         **kwargs)
