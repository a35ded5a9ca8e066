"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D`` / ``2D`` /
``3D``, their transposes (on ``npx.deconvolution``, with
``output_padding``), the max and average pools of 1-3 spatial dims, their
global forms and ``ReflectionPad2D``, channels-first, with the weight
layouts (channels, in_channels / groups, k...) and, transposed,
(in_channels, channels / groups, k...). Shapes are fixed at construction,
so a convolution takes ``in_channels`` (the JAX package can defer it to the
first forward).
"""
from __future__ import annotations

from typing import Any, Optional

import torch.nn.functional as F

from ... import npx
from ..block import HybridBlock
from ..parameter import Parameter, data_or_none

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


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
                 transpose: bool = False, output_padding=0,
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
        self._transpose = transpose
        self._output_padding = _tuplify(output_padding, ndim)
        io = (in_channels, channels // groups) if transpose else \
            (channels, in_channels // groups)
        self.weight = Parameter("weight", shape=io + self._kernel,
                                init=weight_initializer)
        self.bias = Parameter("bias", shape=(channels,),
                              init=bias_initializer) if use_bias else None

    def forward(self, x):
        kw = dict(kernel=self._kernel, stride=self._strides,
                  dilate=self._dilation, pad=self._padding,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=self.bias is None, layout=self._layout)
        if self._transpose:
            out = npx.deconvolution(x, self.weight.data(),
                                    data_or_none(self.bias),
                                    adj=self._output_padding, **kw)
        else:
            out = npx.convolution(x, self.weight.data(),
                                  data_or_none(self.bias), **kw)
        if self._activation:
            out = npx.activation(out, self._activation)
        return out

    def extra_repr(self) -> str:
        return (f"{self._in_channels} -> {self._channels}, "
                f"kernel_size={self._kernel}, stride={self._strides}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, transpose=True,
                         output_padding=output_padding, **kwargs)


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


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, 1, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, 2, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, 3, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, 1, "avg", layout,
                         ceil_mode=ceil_mode,
                         count_include_pad=count_include_pad, **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, 2, "avg", layout,
                         ceil_mode=ceil_mode,
                         count_include_pad=count_include_pad, **kwargs)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, 3, "avg", layout,
                         ceil_mode=ceil_mode,
                         count_include_pad=count_include_pad, **kwargs)


class _GlobalPool(_Pool):
    def __init__(self, ndim: int, pool_type: str, layout: str, **kwargs):
        super().__init__(1, 1, 0, ndim, pool_type, layout, global_pool=True,
                         **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflect ``padding`` pixels at each side of an NCHW image."""

    def __init__(self, padding: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._padding = padding

    def forward(self, x):
        return F.pad(x, (self._padding,) * 4, mode="reflect")
